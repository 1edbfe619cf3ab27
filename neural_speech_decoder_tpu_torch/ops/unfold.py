"""Temporal unfold and its fused form, the strided input projection.

Port of ``neural_speech_decoder_tpu/ops/unfold.py``. The unfold of the
reference (``nn.Unfold((k, 1), stride=s)``) gives ``[B, L, C*k]`` frames in
channel-major order, ``frame[l, c*k + j] = x[l*s + j, c]``, with
``L = (T - k) // s + 1``. On the serving path it is never materialized:
``unfold(x) @ w`` is a strided convolution of ``x`` (``unfold_matmul``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def unfold_output_length(t: int, kernel: int, stride: int) -> int:
    """Frames the unfold produces: ``(T - k) // s + 1``."""
    return (t - kernel) // stride + 1


def ctc_input_lengths(
    x_lens: torch.Tensor, kernel: int, stride: int
) -> torch.Tensor:
    """The reference's CTC input length ``(len - k) / s``, truncated toward
    zero (not floored: a sub-kernel length gives e.g. -2, not -3), then
    clamped at 0. One frame fewer than the unfold yields when
    ``(len - k) % s == 0``, as in the reference."""
    diff = x_lens.to(torch.int32) - kernel
    return torch.div(diff, stride, rounding_mode="trunc").clamp_min(0)


def unfold(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """Materialized unfold ``[B, T, C] -> [B, L, C*k]`` (tests only)."""
    b, _, c = x.shape
    windows = x.unfold(1, kernel, stride)  # [B, L, C, k]
    return windows.reshape(b, -1, c * kernel)


def unfold_matmul(
    x: torch.Tensor, weight: torch.Tensor, kernel: int, stride: int
) -> torch.Tensor:
    """``unfold(x) @ weight`` without materializing the unfold.

    ``x [B, T, C]``, ``weight [C*k, O]`` with row ``c*k + j`` -> ``[B, L, O]``
    in x's dtype, as the strided convolution with kernel
    ``K[o, c, j] = weight[c*k + j, o]``.
    """
    c = x.shape[-1]
    o = weight.shape[-1]
    k_conv = weight.reshape(c, kernel, o).permute(2, 0, 1).to(x.dtype)
    return F.conv1d(x.transpose(1, 2), k_conv, stride=stride).transpose(1, 2)
