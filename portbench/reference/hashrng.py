"""A frozen copy of the counter-based dropout hash (a murmur3-style
finalizer over ``(seed, salt, row, col)``), so that the reference works out
the same keep masks as the program's dropout kernels from the same seed.

Words are held in int64 and masked to their low 32 bits after every
multiply, so that the shifts are logical.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_C_ROW, _C_COL, _C_SEED, _C_SALT = 0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F
_C_MIX1, _C_MIX2 = 0x2C1B3C6D, 0x297A2D39


def hash_bits(seed: torch.Tensor, salt, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """The 32-bit hash (int64 in ``[0, 2**32)``) at the broadcast of
    ``salt``, ``rows`` and ``cols`` (int64 tensors or ints)."""
    dev = rows.device
    s = seed.to(device=dev, dtype=torch.int64) & _MASK
    salt = salt.to(device=dev, dtype=torch.int64) & _MASK if isinstance(salt, torch.Tensor) \
        else int(salt) & _MASK
    base = ((s * _C_SEED) & _MASK) ^ ((salt * _C_SALT) & _MASK)
    h = ((rows * _C_ROW) & _MASK) ^ ((cols * _C_COL) & _MASK) ^ base
    h = h ^ (h >> 15)
    h = (h * _C_MIX1) & _MASK
    h = h ^ (h >> 12)
    h = (h * _C_MIX2) & _MASK
    return h ^ (h >> 15)


def uniform(seed, salt, rows, cols) -> torch.Tensor:
    """float32 uniforms in [0, 1): the hash's top 23 bits times 2**-23."""
    return (hash_bits(seed, salt, rows, cols) >> 9).float() * (1.0 / (1 << 23))


def keep_rows(seed: torch.Tensor, n_rows: int, n_cols: int, rate: float,
              device) -> torch.Tensor:
    """``bool [n_rows, n_cols]``: entry ``[r, c]`` kept where
    ``uniform(seed, 0, r, c) >= rate`` (dropout of a ``[..., n_cols]``
    activation over its flattened rows)."""
    rows = torch.arange(n_rows, device=device, dtype=torch.int64)[:, None]
    cols = torch.arange(n_cols, device=device, dtype=torch.int64)[None, :]
    return uniform(seed, 0, rows, cols) >= rate


def keep_by_salt(seed: torch.Tensor, salt0: int, n_salts: int, n_rows: int,
                 n_cols: int, rate: float, device) -> torch.Tensor:
    """``bool [n_salts, n_rows, n_cols]``: entry ``[i, r, c]`` kept where
    ``uniform(seed, salt0 + i, r, c) >= rate``."""
    salt = torch.arange(n_salts, device=device, dtype=torch.int64)[:, None, None] + salt0
    rows = torch.arange(n_rows, device=device, dtype=torch.int64)[None, :, None]
    cols = torch.arange(n_cols, device=device, dtype=torch.int64)[None, None, :]
    return uniform(seed, salt, rows, cols) >= rate
