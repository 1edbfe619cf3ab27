"""Training-time noise augmentation.

Port of ``neural_speech_decoder_tpu/ops/noise.py::apply_noise``: the
reference adds, per train step, white noise ``randn(X.shape) * whiteNoiseSD``
and a constant per-trial channel offset ``randn([B, 1, C]) *
constantOffsetSD``. The random numbers come from an explicit
``torch.Generator`` on x's device (the JAX package's come from a
``jax.random`` key; the two streams differ, the distributions agree).
"""

from __future__ import annotations

import torch


def apply_noise(
    generator: torch.Generator,
    x: torch.Tensor,
    white_noise_sd: float,
    constant_offset_sd: float,
) -> torch.Tensor:
    """White + constant-offset noise on ``[B, T, C]`` features."""
    if white_noise_sd > 0:
        x = x + torch.randn(x.shape, generator=generator, device=x.device,
                            dtype=x.dtype) * white_noise_sd
    if constant_offset_sd > 0:
        b, _, c = x.shape
        x = x + torch.randn((b, 1, c), generator=generator, device=x.device,
                            dtype=x.dtype) * constant_offset_sd
    return x
