"""The two dropout-mask test hooks' shared body (``csrc/hashrng.cuh::
hash_masks_kernel``, launched by ``attention.py::dropout_masks`` and
``ffn.py::ffn_dropout_masks``), on the CPU by a plain model, and on the
card.

- The model walks the masks as the kernel does: the masks laid end to end
  in 16-byte chunks, a thread a chunk; its (salt, row, col) from one
  division by the width and the salt's multiply-shift (``mask_buf``), the
  row's hash terms formed once and col carried along the row, on to the
  next row and salt where one ends; each byte kept where the top 23 bits of
  the hash reach ``keep_limit(rate)``. It is bit-equal to
  ``dropout_masks_plain`` / ``ffn_dropout_masks_plain`` at t = 313, 17 and
  1 and at widths that are not multiples of 16.
- The multiply-shift is the exact quotient for every numerator below
  2**31, and the integer threshold keeps what the float comparison
  ``uniform >= rate`` keeps, for every 23-bit value and rates at and past
  the edges.

The tests marked ``cuda`` run on the card without the tests' ``conftest.py``
(which imports jax; this file does not):

    python -m pytest --noconftest -q -m cuda tests/test_torch_port_mask_hooks.py
"""

import math

import numpy as np
import pytest
import torch

from neural_speech_decoder_tpu_torch.ops.kernels.attention import (
    dropout_masks,
    dropout_masks_plain,
)
from neural_speech_decoder_tpu_torch.ops.kernels.ffn import (
    ffn_dropout_masks,
    ffn_dropout_masks_plain,
)

SEED = 20240611
C_ROW, C_COL, C_SEED, C_SALT = 0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F
ATTN_SHAPES = [(3, 313), (5, 17), (7, 1), (2, 31)]
FFN_SHAPES = [(2, 313, 20, 36), (3, 17, 16, 48), (2, 1, 4, 12), (1, 5, 1, 3)]


def mask_buf(rows, width, per_salt, salt0):
    """``hashrng.cuh::mask_buf``: the mask's bytes and the salt's
    multiply-shift (m // per_salt == m * mul >> shift for m < 2**31)."""
    lg = max(per_salt - 1, 0).bit_length()
    shift = 31 + lg
    return dict(n=rows * width, width=width, per_salt=per_salt, salt0=salt0,
                mul=((1 << shift) + per_salt - 1) // per_salt, shift=shift)


def keep_limit(rate):
    """``hashrng.cuh::keep_limit``: (h >> 9) >= it <=> uniform >= rate."""
    s = np.float32(rate) * np.float32(8388608.0)
    if s <= 0:
        return 0
    if not s < 8388608.0:
        return 1 << 23
    return math.ceil(float(s))


def _mix(h):
    h = h ^ (h >> np.uint32(15))
    h = h * np.uint32(0x2C1B3C6D)
    h = h ^ (h >> np.uint32(12))
    h = h * np.uint32(0x297A2D39)
    return h ^ (h >> np.uint32(15))


def walk_masks(seed, bufs, rate):
    """The kernel's walk over ``bufs`` (``mask_buf``s), every thread of a
    mask at once: returns each mask's bytes (uint8, flat)."""
    u32 = np.uint32
    seed_term = u32((seed * C_SEED) & 0xFFFFFFFF)
    lim = keep_limit(rate)
    out = []
    with np.errstate(over="ignore"):
        for mb in bufs:
            e0 = np.arange(0, mb["n"], 16, dtype=np.uint64)
            m = e0 // np.uint64(mb["width"])  # the one division
            col = (e0 - m * np.uint64(mb["width"])).astype(u32)
            salt = (m * np.uint64(mb["mul"])) >> np.uint64(mb["shift"])
            row = (m - salt * np.uint64(mb["per_salt"])).astype(u32)
            salt = (salt + np.uint64(mb["salt0"])).astype(u32)
            base = (row * u32(C_ROW)) ^ seed_term ^ (salt * u32(C_SALT))
            chunk = np.zeros((len(e0), 16), np.uint8)
            for i in range(16):
                wrap = col == mb["width"]
                col = np.where(wrap, u32(0), col)
                row = np.where(wrap, row + u32(1), row)
                salt_wrap = wrap & (row == mb["per_salt"])
                row = np.where(salt_wrap, u32(0), row)
                salt = np.where(salt_wrap, salt + u32(1), salt)
                base = np.where(wrap, (row * u32(C_ROW)) ^ seed_term ^ (salt * u32(C_SALT)), base)
                h = _mix(base ^ (col * u32(C_COL)))
                chunk[:, i] = (h >> u32(9)) >= lim
                col = col + u32(1)
            out.append(chunk.reshape(-1)[: mb["n"]])
    return out


@pytest.mark.parametrize("per_salt", [1, 2, 3, 7, 16, 17, 313, 1000, 4097, 65535, 2**20 + 1,
                                      2**30 + 3, 2**31 - 1])
def test_salt_multiply_shift_is_exact(per_salt):
    mb = mask_buf(1, 1, per_salt, 0)
    rng = np.random.default_rng(per_salt)
    ms = {0, 1, per_salt - 1, per_salt, per_salt + 1, 2**31 - 1, 2**31 - 2,
          *rng.integers(0, 2**31, 2000).tolist()}
    for k in (1, 2, 3, 2**31 // per_salt - 1, 2**31 // per_salt):
        ms.update({k * per_salt - 1, k * per_salt, k * per_salt + 1})
    ms = [m for m in ms if 0 <= m < 2**31]
    assert mb["mul"] <= 2**32
    assert all((m * mb["mul"]) >> mb["shift"] == m // per_salt for m in ms)


@pytest.mark.parametrize("rate", [0.0, -0.0, -0.5, 1e-40, 1e-9, 2.0**-23, 0.1, 0.3, 0.5,
                                  0.9999999, 1.0, 1.5, float("inf"), float("nan")])
def test_keep_limit_matches_the_float_comparison(rate):
    k = np.arange(1 << 23, dtype=np.uint32)
    uniform = k.astype(np.float32) * np.float32(1.0 / 8388608.0)
    assert np.array_equal(k >= keep_limit(rate), uniform >= np.float32(rate))


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("bh, t", ATTN_SHAPES)
def test_attention_mask_walk_bit_equal_to_plain(bh, t, rate):
    (got,) = walk_masks(SEED, [mask_buf(bh * t, t, t, 0)], rate)
    ref = dropout_masks_plain(bh, t, torch.tensor([SEED], dtype=torch.int32), rate)
    assert np.array_equal(got, ref.numpy().reshape(-1).astype(np.uint8))


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("b, t, d, f", FFN_SHAPES)
def test_ffn_mask_walk_bit_equal_to_plain(b, t, d, f, rate):
    g1, g2 = walk_masks(SEED, [mask_buf(b * t, f, t, 0), mask_buf(b * t, d, t, b)], rate)
    r1, r2 = ffn_dropout_masks_plain(b, t, d, f, torch.tensor([SEED], dtype=torch.int32), rate)
    assert np.array_equal(g1, r1.numpy().reshape(-1).astype(np.uint8))
    assert np.array_equal(g2, r2.numpy().reshape(-1).astype(np.uint8))


# ------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("bh, t", ATTN_SHAPES + [(512, 313)])
def test_attention_mask_hook_bit_equal_to_plain(cuda, bh, t, rate):
    seed = torch.tensor([SEED], dtype=torch.int32, device=cuda)
    before = dropout_masks.launches
    got = dropout_masks(bh, t, seed, rate)
    assert dropout_masks.launches == before + 1
    assert got.dtype == torch.bool and torch.equal(got, dropout_masks_plain(bh, t, seed, rate))


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("b, t, d, f", FFN_SHAPES + [(64, 313, 1024, 2048)])
def test_ffn_mask_hook_bit_equal_to_plain(cuda, b, t, d, f, rate):
    seed = torch.tensor([SEED], dtype=torch.int32, device=cuda)
    before = ffn_dropout_masks.launches
    m1, m2 = ffn_dropout_masks(b, t, d, f, seed, rate)
    r1, r2 = ffn_dropout_masks_plain(b, t, d, f, seed, rate)
    assert ffn_dropout_masks.launches == before + 1
    assert torch.equal(m1, r1) and torch.equal(m2, r2)
