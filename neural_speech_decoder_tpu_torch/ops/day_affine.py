"""Per-day affine input calibration.

Port of ``neural_speech_decoder_tpu/ops/day_affine.py``: one ``[C, C]``
weight and ``[C]`` bias per recording day, identity/zero initialized,
selected by each trial's day index.
"""

from __future__ import annotations

import torch


def init_day_affine(
    n_days: int, dim: int, dtype=torch.float32, device=None
) -> dict:
    """Identity weights and zero biases per day."""
    w = torch.eye(dim, dtype=dtype, device=device).repeat(n_days, 1, 1)
    b = torch.zeros((n_days, dim), dtype=dtype, device=device)
    return {"weight": w, "bias": b}


def day_affine(
    params: dict, x: torch.Tensor, day_idx: torch.Tensor
) -> torch.Tensor:
    """``x [B, T, C] @ weight[day] + bias[day]`` in x's dtype, accumulated
    in float32. The day index is clipped to ``[0, nDays-1]``: an index out
    of range would otherwise read past the table and NaN everything
    downstream."""
    n_days = params["weight"].shape[0]
    idx = day_idx.long().clamp(0, n_days - 1)
    w = params["weight"][idx].to(x.dtype)
    b = params["bias"][idx].to(x.dtype)
    y = torch.bmm(x.float(), w.float())
    return (y + b.float()[:, None, :]).to(x.dtype)
