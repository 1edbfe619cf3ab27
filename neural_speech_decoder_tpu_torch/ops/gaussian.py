"""Gaussian temporal smoothing as a depthwise 1-D convolution.

Port of ``neural_speech_decoder_tpu/ops/gaussian.py``: the same normalized
taps, the GRU's 20 taps with torch-"same" padding ((9, 10)) and the
Conformer's ``int(4 sigma) + 1`` taps with symmetric padding, ``[B, T, C]``
layout at the interface.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel(kernel_size: int, sigma: float) -> np.ndarray:
    """Normalized 1-D Gaussian taps (float32), summing to one."""
    x = np.arange(kernel_size, dtype=np.float64) - (kernel_size - 1) / 2.0
    k = np.exp(-(x**2) / (2.0 * sigma**2))
    k = k / k.sum()
    return k.astype(np.float32)


def same_padding(kernel_size: int) -> tuple[int, int]:
    """(left, right) padding of torch ``padding="same"``: an even kernel
    pads one more on the right, so 20 taps pad (9, 10)."""
    total = kernel_size - 1
    left = total // 2
    return (left, total - left)


def gaussian_smooth(
    x: torch.Tensor,
    kernel_size: int,
    sigma: float,
    *,
    padding: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Depthwise Gaussian smoothing along time of ``[B, T, C]`` features,
    computed in x's dtype, padded by ``padding`` (left, right), by default
    torch "same". A no-op for ``sigma <= 0``."""
    if sigma <= 0:
        return x
    if padding is None:
        padding = same_padding(kernel_size)
    c = x.shape[-1]
    taps = torch.as_tensor(
        gaussian_kernel(kernel_size, sigma), dtype=x.dtype, device=x.device
    )
    xt = F.pad(x.transpose(1, 2), padding)  # [B, C, T + pad]
    y = F.conv1d(xt, taps.expand(c, 1, kernel_size), groups=c)
    return y.transpose(1, 2)


def conformer_kernel_size(sigma: float) -> int:
    """The Conformer's tap count, ``int(4 * sigma) + 1`` (9 at sigma 2); it
    pads ``kernel_size // 2`` on both sides."""
    return int(sigma * 4) + 1
