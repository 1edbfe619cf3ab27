"""The serving path's kernels as PyTorch operators, ``torch.ops.nsd_torch.*``.

Every kernel wrapper of ``ops/kernels`` is a ctypes call on ``data_ptr()``
that picks its device in Python, which ``torch.export`` cannot trace (a
FakeTensor has no data pointer). The six forward entries that a serving
request reaches are registered here with ``torch.library.custom_op``, so
that an exported program records each as one operator node, and eager
callers (``gru_scan``, ``projection_matmul``, ``mhsa``, ``fused_ffn``,
``fused_conv_module`` and the autograd Functions' forwards) go through the
same operators:

| op | kernel | replaces |
| --- | --- | --- |
| ``fused_frontend`` | ``frontend.py::fused_frontend`` | ``frontend_kernel.py::fused_frontend`` |
| ``gru_sequence`` | ``gru_scan.py::gru_sequence`` | ``gru_scan.py::_fwd_kernel`` |
| ``projection_matmul`` | ``matmul.py::tiled_matmul`` (``nn`` + bias) | ``matmul.py::tiled_matmul`` |
| ``mhsa_qkv`` | ``attention.py::mhsa_qkv`` | ``attention_kernel.py::_fwd_kernel`` |
| ``ffn`` | ``ffn.py::ffn`` | ``ffn_kernel.py::_fwd_kernel`` |
| ``conv_module`` | ``conv_module.py::conv_module`` | ``conv_module_kernel.py::_fwd_kernel`` |

Each op takes tensors and int/float/bool scalars. Its CUDA implementation
is the wrapper's launch path: the body plan (``frontend_plan``,
``scan_plan``, ``fwd_plan``), the alignment checks on ``data_ptr()`` and the
launch counters run there, at call time, never at trace time; it launches
the kernel or raises. Its CPU implementation is the plain twin (as JAX's
rule: a CPU export embeds the portable twins). No other device has an
implementation, so a call there raises. ``register_fake`` gives the output's
shape and dtype for tracing.

The projection matmul serves only a GRU run with ``use_pallas_matmul``
(layers 1+), as in the JAX package's eval forward.

Not registered yet (no serving path reaches them): the backwards (the
matmul's ``nt``/``tn`` products among them), CTC, Adam and the
dropout-mask hooks.
"""

from __future__ import annotations

import torch
from torch import Tensor

from . import attention, conv_module, ffn, frontend, gru_scan, matmul

NAMESPACE = "nsd_torch"


def _on_card(what: str, x: Tensor) -> None:
    """The dispatcher takes the CUDA implementation when any argument lies
    on the card; the kernel's main input must too (the wrapper would run
    the plain twin for a CPU one)."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: input on {x.device}, not on the card")


@torch.library.custom_op(f"{NAMESPACE}::fused_frontend", mutates_args=(),
                         device_types="cuda")
def fused_frontend(x: Tensor, day_w: Tensor, day_b: Tensor, day_idx: Tensor,
                   kernel_size: int, sigma: float) -> Tensor:
    """``softsign(gaussian_smooth(x) @ day_w[day] + day_b[day])``."""
    _on_card("fused_frontend", x)
    return frontend.fused_frontend(x, day_w, day_b, day_idx, kernel_size=kernel_size,
                                   sigma=sigma)


@fused_frontend.register_kernel("cpu")
def _(x, day_w, day_b, day_idx, kernel_size, sigma):
    return frontend.fused_frontend_plain(x, day_w, day_b, day_idx,
                                         kernel_size=kernel_size, sigma=sigma)


@fused_frontend.register_fake
def _(x, day_w, day_b, day_idx, kernel_size, sigma):
    return x.new_empty(x.shape)


@torch.library.custom_op(f"{NAMESPACE}::gru_sequence", mutates_args=(),
                         device_types="cuda")
def gru_sequence(xp: Tensor, w_hh: Tensor, b_hh: Tensor) -> Tensor:
    """One GRU layer's time recurrence: ``xp [L, D, B, 3H]`` ->
    ``ys [L, D, B, H]``."""
    _on_card("gru_sequence", xp)
    return gru_scan.gru_sequence(xp, w_hh, b_hh)


@gru_sequence.register_kernel("cpu")
def _(xp, w_hh, b_hh):
    return gru_scan.gru_sequence_plain(xp, w_hh, b_hh)


@gru_sequence.register_fake
def _(xp, w_hh, b_hh):
    length, d, b, three_h = xp.shape
    return xp.new_empty((length, d, b, three_h // 3))


@torch.library.custom_op(f"{NAMESPACE}::projection_matmul", mutates_args=(),
                         device_types="cuda")
def projection_matmul(x: Tensor, w: Tensor, bias: Tensor) -> Tensor:
    """``x [M, K] @ w [K, N] + bias [N]`` (bias float32) in x's dtype."""
    _on_card("projection_matmul", x)
    return matmul.tiled_matmul(x, w, kind="nn", bias=bias)


@projection_matmul.register_kernel("cpu")
def _(x, w, bias):
    # the wrapper, which runs tiled_matmul_plain for CPU tensors
    return matmul.tiled_matmul(x, w, kind="nn", bias=bias)


@projection_matmul.register_fake
def _(x, w, bias):
    return x.new_empty((x.shape[0], w.shape[1]))


@torch.library.custom_op(f"{NAMESPACE}::mhsa_qkv", mutates_args=(), device_types="cuda")
def mhsa_qkv(qkv: Tensor, lens: Tensor, seed: Tensor, num_heads: int, rate: float,
             left_context: int | None, interleaved: bool) -> Tensor:
    """Attention over ``qkv [B, T, 3D]`` -> ``[B, T, D]``."""
    _on_card("mhsa_qkv", qkv)
    return attention.mhsa_qkv(qkv, lens, seed, num_heads=num_heads, rate=rate,
                              left_context=left_context, interleaved=interleaved)


@mhsa_qkv.register_kernel("cpu")
def _(qkv, lens, seed, num_heads, rate, left_context, interleaved):
    return attention.mhsa_qkv_plain(qkv, lens, seed, num_heads=num_heads, rate=rate,
                                    left_context=left_context, interleaved=interleaved)


@mhsa_qkv.register_fake
def _(qkv, lens, seed, num_heads, rate, left_context, interleaved):
    b, t, d3 = qkv.shape
    return qkv.new_empty((b, t, d3 // 3))


@torch.library.custom_op(f"{NAMESPACE}::ffn", mutates_args=(), device_types="cuda")
def ffn_op(x: Tensor, scale: Tensor, bias: Tensor, w1: Tensor, b1: Tensor, w2: Tensor,
           b2: Tensor, seed: Tensor, rate: float) -> Tensor:
    """The fused FF module over ``x [B, T, D]`` -> ``[B, T, D]``."""
    _on_card("ffn", x)
    return ffn.ffn(x, scale, bias, w1, b1, w2, b2, seed, rate=rate)


@ffn_op.register_kernel("cpu")
def _(x, scale, bias, w1, b1, w2, b2, seed, rate):
    return ffn.ffn_plain(x, scale, bias, w1, b1, w2, b2, seed, rate=rate)


@ffn_op.register_fake
def _(x, scale, bias, w1, b1, w2, b2, seed, rate):
    return x.new_empty(x.shape)


@torch.library.custom_op(f"{NAMESPACE}::conv_module", mutates_args=(),
                         device_types="cuda")
def conv_module_op(x: Tensor, ln_s: Tensor, ln_b: Tensor, w1: Tensor, b1: Tensor,
                   dw_w: Tensor, dw_b: Tensor, ln2_s: Tensor, ln2_b: Tensor, w2: Tensor,
                   b2: Tensor, seed: Tensor, rate: float, causal: bool) -> Tensor:
    """The fused conv module (without residual) over ``x [B, T, D]``."""
    _on_card("conv_module", x)
    return conv_module.conv_module(x, ln_s, ln_b, w1, b1, dw_w, dw_b, ln2_s, ln2_b, w2,
                                   b2, seed, rate=rate, causal=causal)


@conv_module_op.register_kernel("cpu")
def _(x, ln_s, ln_b, w1, b1, dw_w, dw_b, ln2_s, ln2_b, w2, b2, seed, rate, causal):
    return conv_module.conv_module_plain(x, ln_s, ln_b, w1, b1, dw_w, dw_b, ln2_s, ln2_b,
                                         w2, b2, seed, rate=rate, causal=causal)


@conv_module_op.register_fake
def _(x, ln_s, ln_b, w1, b1, dw_w, dw_b, ln2_s, ln2_b, w2, b2, seed, rate, causal):
    return x.new_empty(x.shape)


OPS = {"fused_frontend": fused_frontend, "gru_sequence": gru_sequence,
       "projection_matmul": projection_matmul, "mhsa_qkv": mhsa_qkv, "ffn": ffn_op, "conv_module": conv_module_op}
