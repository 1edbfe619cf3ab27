"""Counter-based hash RNG for dropout masks.

Port of ``neural_speech_decoder_tpu/ops/hashrng.py``: a stateless
murmur3-style finalizer over ``(seed, salt, row, col)``, bit for bit. The
JAX package computes it in int32 with wrapping multiplies and logical
shifts; here the words are held in int64 and masked to their low 32 bits
after every multiply, so that the shifts are logical (torch's ``>>`` on
int32 is arithmetic). The attention kernel draws the same bits on the card
(``csrc/hashrng.cuh``).

``key_to_seed`` (a JAX key folded into a seed) is not ported: the port
draws its int32 seeds from a ``torch.Generator`` (``draw_seed``).
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_C_ROW, _C_COL, _C_SEED, _C_SALT = 0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F
_C_MIX1, _C_MIX2 = 0x2C1B3C6D, 0x297A2D39


def _u32(x, device):
    """An int32 value as its unsigned bit pattern: a Python int stays an int
    (no copy to the device, which would wait for its stream), a tensor
    becomes int64 on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64) & _MASK
    return int(x) & _MASK


def uniform(seed, salt, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """float32 uniforms in [0, 1) at the broadcast of ``salt``, ``rows`` and
    ``cols`` (int64 index tensors; ``salt`` may also be an int): the top 23
    bits of the hash of ``(seed, salt, row, col)`` times 2**-23."""
    return (_hash_bits(seed, salt, rows, cols) >> 9).float() * (1.0 / (1 << 23))


def _hash_bits(seed, salt, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """The 32-bit hash of ``(seed, salt, row, col)`` (int64 in [0, 2**32))
    for the broadcast of ``salt``, ``rows`` and ``cols``."""
    dev = rows.device
    base = ((_u32(seed, dev) * _C_SEED) & _MASK) ^ ((_u32(salt, dev) * _C_SALT) & _MASK)
    h = ((rows * _C_ROW) & _MASK) ^ ((cols * _C_COL) & _MASK) ^ base
    h ^= h >> 15
    h.mul_(_C_MIX1).bitwise_and_(_MASK)
    h ^= h >> 12
    h.mul_(_C_MIX2).bitwise_and_(_MASK)
    h ^= h >> 15
    return h


def uniform2d(seed, salt, shape, device=None) -> torch.Tensor:
    """float32 uniforms in [0, 1) over a 2-D ``shape``, element ``[r, c]``
    a function of ``(seed, salt, r, c)`` alone: the top 23 bits of the hash
    times 2**-23. ``seed`` and ``salt`` are int32 values or scalar
    tensors."""
    dev = torch.device(device) if device is not None else (
        seed.device if isinstance(seed, torch.Tensor) else torch.device("cpu"))
    rows = torch.arange(shape[0], device=dev, dtype=torch.int64)[:, None]
    cols = torch.arange(shape[1], device=dev, dtype=torch.int64)[None, :]
    return uniform(seed, salt, rows, cols)


def keep_mask2d(seed, salt, shape, rate: float, device=None) -> torch.Tensor:
    """Bernoulli(1 - rate) keep mask over a 2-D shape."""
    return uniform2d(seed, salt, shape, device) >= rate


def hash_dropout(seed, x: torch.Tensor, rate: float) -> torch.Tensor:
    """Inverted dropout of ``x [..., N]`` with the mask of
    ``keep_mask2d(seed, 0, (prod(x.shape[:-1]), N), rate)``: kept entries
    scaled by 1/(1 - rate), dropped ones 0. ``rate <= 0`` returns x."""
    if rate <= 0:
        return x
    n = x.shape[-1]
    keep = keep_mask2d(seed, 0, (x.numel() // max(n, 1), n), rate, x.device)
    return torch.where(keep.reshape(x.shape), x / (1.0 - rate),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def draw_seed(generator: torch.Generator) -> torch.Tensor:
    """An int32 seed in ``[0, 2**31 - 1)`` as a 1-element tensor on the
    generator's device, as JAX draws the attention kernel's seed."""
    return torch.randint(0, 2**31 - 1, (1,), generator=generator,
                         device=generator.device, dtype=torch.int32)
