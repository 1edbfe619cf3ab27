"""Parameter initializers matching the JAX package's distributions
(``neural_speech_decoder_tpu/models/common.py``), drawn from an explicit
``torch.Generator``. The random streams differ from JAX's; the families and
scales are the same: xavier-uniform input weights, orthogonal recurrent
weights, torch ``nn.Linear``'s default ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``.

Tensors are drawn on the generator's device and cast to ``dtype``.
"""

from __future__ import annotations

import math

import torch


def uniform_bound(
    shape, bound: float, generator: torch.Generator, dtype=torch.float32
) -> torch.Tensor:
    """``U(-bound, bound)``."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return ((2.0 * u - 1.0) * bound).to(dtype)


def xavier_uniform(
    shape, generator: torch.Generator, dtype=torch.float32
) -> torch.Tensor:
    """Xavier/Glorot uniform for an ``[in, out]`` matrix."""
    bound = math.sqrt(6.0 / (shape[0] + shape[-1]))
    return uniform_bound(shape, bound, generator, dtype)


def orthogonal(
    shape, generator: torch.Generator, dtype=torch.float32
) -> torch.Tensor:
    """A random 2-D matrix with orthonormal rows or columns (whichever are
    fewer), as ``jax.nn.initializers.orthogonal``: QR of a Gaussian matrix
    with the signs of R's diagonal folded into Q."""
    rows, cols = shape
    a = torch.randn(
        (max(rows, cols), min(rows, cols)), generator=generator,
        device=generator.device,
    )
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    return (q if rows >= cols else q.T).to(dtype)


def torch_linear_init(
    in_dim: int, out_dim: int, generator: torch.Generator, dtype=torch.float32
):
    """torch ``nn.Linear``'s default init: ``(weight [in, out], bias [out])``."""
    bound = 1.0 / math.sqrt(in_dim)
    w = uniform_bound((in_dim, out_dim), bound, generator, dtype)
    return w, uniform_bound((out_dim,), bound, generator, dtype)
