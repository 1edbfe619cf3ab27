"""SpecAugment: time and feature masks shared over the batch.

Port of ``neural_speech_decoder_tpu/ops/specaugment.py``: on the ``[B, T, F]``
latent, 2 feature masks of width ``min(int(u * freq_mask_param), F)`` and 2
time masks of width ``min(int(u * time_mask_param), T)``, each starting at
``int(u' * (size - width))``, the same for every row of the batch. The
masks are built by comparing positions on the device, with no copy from the
host (which would wait for the device's queue).

The uniforms come from a ``torch.Generator``, or are given: ``uniforms
[4, 2]`` holds (width, start) draws for the two feature masks, then the two
time masks, the order in which the JAX package splits its key.
"""

from __future__ import annotations

import torch

N_FREQ_MASKS = 2
N_TIME_MASKS = 2


def spec_augment(
    x: torch.Tensor,
    *,
    freq_mask_param: int = 100,
    time_mask_param: int = 40,
    generator: torch.Generator | None = None,
    uniforms: torch.Tensor | None = None,
) -> torch.Tensor:
    """``x [B, T, F]`` with its masked time steps and features set to 0."""
    _, t, f = x.shape
    n = N_FREQ_MASKS + N_TIME_MASKS
    if uniforms is None:
        if generator is None:
            raise ValueError("spec_augment needs a generator or the uniforms")
        uniforms = torch.rand((n, 2), generator=generator, device=x.device)
    u = uniforms.to(device=x.device, dtype=torch.float32)
    if tuple(u.shape) != (n, 2):
        raise ValueError(f"spec_augment: uniforms must be [{n}, 2], got {tuple(u.shape)}")

    def masked(i, size, param):  # [size] bool, True where mask i covers
        width = (u[i, 0] * param).to(torch.int32).clamp(max=size)
        start = (u[i, 1] * (size - width)).to(torch.int32)
        idx = torch.arange(size, device=x.device)
        return (idx >= start) & (idx < start + width)

    freq = masked(0, f, freq_mask_param) | masked(1, f, freq_mask_param)
    time = masked(2, t, time_mask_param) | masked(3, t, time_mask_param)
    drop = time[None, :, None] | freq[None, None, :]
    return torch.where(drop, torch.zeros((), dtype=x.dtype, device=x.device), x)
