"""Parameter initializers matching the JAX package's distributions
(``neural_speech_decoder_tpu/models/common.py``), drawn from an explicit
``torch.Generator``. The random streams differ from JAX's; the families and
scales are the same: xavier-uniform input weights, orthogonal recurrent
weights, torch ``nn.Linear``'s default ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``.

Tensors are drawn on the generator's device and cast to ``dtype``.

``linear`` is the JAX package's ``_linear`` (``models/conformer.py``), the
product every linear layer of the port takes in a reduced compute dtype;
``partial_linear`` its float32 sum without the bias, a row-parallel
rank's share under tensor parallelism.
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


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [N, K] @ b [K, M]`` in their dtype with a float32 result: the
    card's bf16-in, f32-out product; on the CPU the float32 product of the
    same operands, exact per term."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        wc = w.to(x.dtype)
        x2 = x.reshape(-1, x.shape[-1])
        y = _mm_f32(x2, wc) + b.float()
        ctx.save_for_backward(x2, wc)
        ctx.dtypes = (w.dtype, b.dtype)
        return y.to(x.dtype).reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        x2, wc = ctx.saved_tensors
        w_dtype, b_dtype = ctx.dtypes
        g2 = g.reshape(-1, g.shape[-1])
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = (g2 @ wc.T).reshape(*g.shape[:-1], wc.shape[0])
        if ctx.needs_input_grad[1]:
            dw = (x2.T @ g2).to(w_dtype)
        if ctx.needs_input_grad[2]:
            db = g2.float().sum(0).to(b_dtype)
        return dx, dw, db


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x [..., K] @ w [K, M] + b [M]`` in x's dtype, rounded once: the
    operands in x's dtype, the product accumulated in float32, the float32
    bias added, then one rounding to x's dtype (JAX's einsum with
    ``preferred_element_type=float32``). The backward's products run in
    x's dtype, as JAX's cotangents of the cast operands do."""
    return _Linear.apply(x, w, b)


class _PartialLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        wc = w.to(x.dtype)
        x2 = x.reshape(-1, x.shape[-1])
        ctx.save_for_backward(x2, wc)
        ctx.w_dtype = w.dtype
        return _mm_f32(x2, wc).reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        x2, wc = ctx.saved_tensors
        # the cotangent of linear's rounded output, as linear's backward
        # takes it (exact: the rounded output's gradient is in x's dtype)
        g2 = g.reshape(-1, g.shape[-1]).to(x2.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = (g2 @ wc.T).reshape(*g.shape[:-1], wc.shape[0])
        if ctx.needs_input_grad[1]:
            dw = (x2.T @ g2).to(ctx.w_dtype)
        return dx, dw


def partial_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [..., K] @ w [K, M]`` as ``linear`` forms it, left in float32
    without the bias: a row-parallel rank's partial sum, which the model
    group adds up before the bias and the one rounding
    (``parallel/tensor_parallel.py::reduce_from_model``)."""
    return _PartialLinear.apply(x, w)


def torch_linear_init(
    in_dim: int, out_dim: int, generator: torch.Generator, dtype=torch.float32
):
    """torch ``nn.Linear``'s default init: ``(weight [in, out], bias [out])``."""
    bound = 1.0 / math.sqrt(in_dim)
    w = uniform_bound((in_dim, out_dim), bound, generator, dtype)
    return w, uniform_bound((out_dim,), bound, generator, dtype)
