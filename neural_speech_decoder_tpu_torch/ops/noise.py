"""Training-time noise augmentation.

Port of ``neural_speech_decoder_tpu/ops/noise.py::apply_noise``: the
reference adds, per train step, white noise ``randn(X.shape) * whiteNoiseSD``
and a constant per-trial channel offset ``randn([B, 1, C]) *
constantOffsetSD``. The random numbers come from an explicit
``torch.Generator`` on x's device (the JAX package's come from a
``jax.random`` key; the two streams differ, the distributions agree). With a
``BatchShard`` (data parallelism) both are drawn for the global batch and
sliced to the rank's rows (``ops/rows.py``), as JAX draws them for its
global array.
"""

from __future__ import annotations

import torch

from .rows import BatchShard, draw_rows


def apply_noise(
    generator: torch.Generator,
    x: torch.Tensor,
    white_noise_sd: float,
    constant_offset_sd: float,
    shard: BatchShard | None = None,
) -> torch.Tensor:
    """White + constant-offset noise on ``[B, T, C]`` features (this
    shard's rows of the global batch's noise)."""

    def randn(shape):
        return torch.randn(shape, generator=generator, device=x.device, dtype=x.dtype)

    if white_noise_sd > 0:
        x = x + draw_rows(randn, x.shape, shard) * white_noise_sd
    if constant_offset_sd > 0:
        b, _, c = x.shape
        x = x + draw_rows(randn, (b, 1, c), shard) * constant_offset_sd
    return x
