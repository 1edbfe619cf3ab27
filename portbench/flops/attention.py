"""The Conformer's attention kernels: per (batch row, head) the scores and
``p @ V`` in the forward, and five such products in the backward (scores,
dP, dV, dQ, dK), each ``[T x keys x dh]`` over the keys the row's length
lets in (a masked key needs no work)."""

import numpy as np


def ops(out_lens, frames: int, heads: int, dh: int, n_products: int) -> float:
    keys = float(np.minimum(np.maximum(np.asarray(out_lens, np.int64), 0), frames).sum())
    return n_products * 2.0 * dh * heads * frames * keys


def forward_ops(out_lens, frames: int, heads: int, dh: int) -> float:
    return ops(out_lens, frames, heads, dh, 2)


def backward_ops(out_lens, frames: int, heads: int, dh: int) -> float:
    return ops(out_lens, frames, heads, dh, 5)


def forward_bytes(b: int, frames: int, d: int) -> float:
    """float32: qkv read once, out written once."""
    return 4.0 * (b * frames * 3 * d + b * frames * d)


def backward_bytes(b: int, frames: int, d: int) -> float:
    """float32: qkv, out and its gradient in, dqkv out."""
    return 4.0 * (2 * b * frames * 3 * d + 2 * b * frames * d)
