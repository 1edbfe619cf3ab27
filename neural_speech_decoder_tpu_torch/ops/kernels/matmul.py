"""The GRU's input-projection product, forward and backward, hand-written in
CUDA (``csrc/matmul.cu``).

Replaces ``neural_speech_decoder_tpu/ops/pallas/matmul.py``:

- ``tiled_matmul(a, b, kind=...)``: ``tiled_matmul``'s three layouts
  (``_make_kernel``): ``nn`` ``a [M, K] @ b [K, N] (+ bias [N])``, ``nt``
  ``a [M, N] @ b [K, N]^T`` and ``tn`` ``a [M, K]^T @ b [M, N]``; the
  operands in one dtype (float32 or bfloat16), the sum accumulated in
  float32, the float32 bias (``nn`` only) added to it, one rounding to the
  operands' dtype;
- ``ProjectionMatmul`` / ``projection_matmul``: ``projection_matmul``'s
  custom VJP as a ``torch.autograd.Function``: the forward (``nn`` with the
  bias), dX (``nt``) and dW (``tn``) on the kernel, ``db = g.float().sum(0)``
  in plain PyTorch (the JAX package sums it outside its kernel too). The
  forward goes through the operator ``torch.ops.nsd_torch.projection_matmul``
  (``library.py``; what ``torch.export`` records), and without grad
  ``projection_matmul`` calls it alone.

``tiled_matmul`` launches a kernel for CUDA tensors and runs
``tiled_matmul_plain`` for CPU tensors; it raises for any other device, a
contraction whose dims disagree, mixed or other dtypes, or a bias on the
transposed layouts. Any M, K and N take a kernel (the ragged edge is
masked); the JAX package's K, N % 128 rule is its call site's gate
(``projection_kernel_viable``), kept in ``models/gru.py``.

Three hand-written bodies, chosen by ``matmul_body``: ``"sm90"``
(``csrc/gemm_sm90.cuh``: TMA and wgmma) for bfloat16 operands that TMA can
read (16-byte aligned, contiguous extents and cols multiples of 8),
``"f32"`` (``csrc/gemm_f32.cuh``: a two-stage float32 FMA tile fed by
cp.async and register prefetch) for float32 operands that it can read
(16-byte aligned, contiguous extents multiples of 4), and ``"tile"``
(``csrc/gemm_tile.cuh``) for every other product. ``tiled_matmul.launches``
counts the launches, ``tiled_matmul.launches_by_body`` them by body.
"""

from __future__ import annotations

import torch

from ._build import check, load_library
from .ffn import mm_f32, on_cuda

KINDS = {"nn": 0, "nt": 1, "tn": 2}
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def projection_kernel_viable(k: int, n: int) -> bool:
    """The JAX package's gate for the projection kernel: K and N are
    multiples of 128 (``matmul.py::projection_kernel_viable``)."""
    return k % 128 == 0 and n % 128 == 0


def _dims(kind: str, a: torch.Tensor, b: torch.Tensor) -> tuple[int, int, int]:
    """``(rows, cols, red)`` of the product: out ``[rows, cols]``, summed
    over ``red``."""
    if kind not in KINDS:
        raise ValueError(f"tiled_matmul: unknown kind {kind!r}")
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"tiled_matmul: operands must be 2-D, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    (a0, a1), (b0, b1) = a.shape, b.shape
    rows, cols, red, other = {"nn": (a0, b1, a1, b0), "nt": (a0, b0, a1, b1),
                              "tn": (a1, b1, a0, b0)}[kind]
    if red != other:
        raise ValueError(f"tiled_matmul(kind={kind!r}): contracted dims disagree: "
                         f"a={tuple(a.shape)} b={tuple(b.shape)}")
    return rows, cols, red


def matmul_body(dtype: torch.dtype, kind: str, rows: int, cols: int, red: int, *,
                aligned: bool = True) -> str:
    """Which kernel body computes a product, given 16-byte aligned pointers
    (``aligned``) and the operands' contiguous extents (``cols`` among
    them): ``"sm90"`` (TMA + wgmma) for bfloat16 whose extents are
    multiples of 8 (TMA's 16-byte row strides); ``"f32"`` (the pipelined
    float32 FMA tile, 16-byte copies) for float32 whose extents are multiples
    of 4; else ``"tile"``. Float32 never takes wgmma: its float32 is TF32,
    which would change the numbers."""
    contiguous = {"nn": (red, cols), "nt": (red, cols), "tn": (rows, cols)}[kind]
    if dtype == torch.bfloat16 and aligned and all(n % 8 == 0 for n in contiguous):
        return "sm90"
    if dtype == torch.float32 and aligned and all(n % 4 == 0 for n in contiguous):
        return "f32"
    return "tile"


def _check_bias(kind, bias, cols, device):
    if bias is None:
        return
    if kind != "nn":
        raise ValueError(f"tiled_matmul: a bias only with kind 'nn', not {kind!r}")
    if bias.dtype != torch.float32 or tuple(bias.shape) != (cols,) or bias.device != device:
        raise ValueError(f"tiled_matmul: bias must be float32 ({cols},) on {device}, got "
                         f"{bias.dtype} {tuple(bias.shape)} on {bias.device}")


def tiled_matmul_plain(a, b, *, kind: str = "nn", bias=None) -> torch.Tensor:
    """``tiled_matmul`` in plain PyTorch (on any device)."""
    _, cols, _ = _dims(kind, a, b)
    _check_bias(kind, bias, cols, a.device)
    x, y = {"nn": (a, b), "nt": (a, b.T), "tn": (a.T, b)}[kind]
    acc = mm_f32(x, y)
    if bias is not None:
        acc = acc + bias
    return acc.to(a.dtype)


def tiled_matmul(a, b, *, kind: str = "nn", bias=None) -> torch.Tensor:
    """One product in the layout ``kind`` (see the module docstring), in the
    operands' dtype."""
    rows, cols, red = _dims(kind, a, b)
    _check_bias(kind, bias, cols, a.device)
    if a.dtype not in _DTYPES or b.dtype != a.dtype or b.device != a.device:
        raise ValueError(f"tiled_matmul: operands must share one dtype (float32 or "
                         f"bfloat16) and device, got {a.dtype} on {a.device} and "
                         f"{b.dtype} on {b.device}")
    if not on_cuda("tiled_matmul", a):
        return tiled_matmul_plain(a, b, kind=kind, bias=bias)
    if min(rows, cols, red) < 1:
        raise ValueError(f"tiled_matmul: empty product {(rows, cols, red)}")
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty((rows, cols), dtype=a.dtype, device=a.device)
    body = matmul_body(a.dtype, kind, rows, cols, red,
                       aligned=all(t.data_ptr() % 16 == 0 for t in (a, b, out)))
    bias_ptr = None if bias is None else bias.data_ptr()
    lib = load_library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        if body in ("sm90", "f32"):
            entry = lib.nsd_matmul_sm90_bf16 if body == "sm90" else lib.nsd_matmul_pipelined_f32
            rc = entry(a.data_ptr(), b.data_ptr(), bias_ptr, out.data_ptr(), KINDS[kind],
                       rows, cols, red, stream)
        else:
            ws = torch.empty(lib.nsd_matmul_workspace(KINDS[kind], rows, cols, red),
                             dtype=torch.uint8, device=a.device)
            rc = getattr(lib, f"nsd_matmul_{_DTYPES[a.dtype]}")(
                a.data_ptr(), b.data_ptr(), bias_ptr, out.data_ptr(), ws.data_ptr(),
                KINDS[kind], rows, cols, red, stream)
    check(rc, f"tiled_matmul ({body})")
    tiled_matmul.launches += 1
    tiled_matmul.launches_by_body[body] += 1
    return out


tiled_matmul.launches = 0
tiled_matmul.launches_by_body = {"sm90": 0, "f32": 0, "tile": 0}


class ProjectionMatmul(torch.autograd.Function):
    """``x [M, K] @ w [K, N] + bias [N]`` in x's dtype with the backward's
    products on the kernel (``projection_matmul``'s custom VJP): dX = g @ w^T
    in x's dtype, dW = x^T @ g in w's, db = the float32 column sum of g.
    ``plain`` runs the plain versions."""

    @staticmethod
    def forward(ctx, x, w, bias, plain):
        ctx.save_for_backward(x, w)
        ctx.plain = plain
        return _forward(x, w, bias, plain)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        mm = tiled_matmul_plain if ctx.plain else tiled_matmul
        g = g.contiguous()
        dx = mm(g, w, kind="nt") if ctx.needs_input_grad[0] else None
        dw = mm(x, g, kind="tn") if ctx.needs_input_grad[1] else None
        db = g.float().sum(0) if ctx.needs_input_grad[2] else None
        return dx, dw, db, None


def _forward(x, w, bias, plain):
    """The forward as the model runs it: the plain version, or the operator
    ``torch.ops.nsd_torch.projection_matmul`` (``library.py``)."""
    if plain:
        return tiled_matmul_plain(x, w, kind="nn", bias=bias)
    return torch.ops.nsd_torch.projection_matmul(x, w, bias)


def projection_matmul(x, w, bias, *, plain: bool = False) -> torch.Tensor:
    """``x [M, K]`` and ``w [K, N]`` in one dtype, ``bias [N]`` float32 ->
    ``[M, N]`` in x's dtype: ``ProjectionMatmul`` when grad is enabled and
    an input requires it, otherwise the forward alone (``_forward``)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w, bias)):
        return ProjectionMatmul.apply(x, w, bias, plain)
    return _forward(x, w, bias, plain)
