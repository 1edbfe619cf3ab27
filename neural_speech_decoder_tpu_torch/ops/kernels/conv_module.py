"""The Conformer's convolution module as one fused operation, hand-written
in CUDA (``csrc/conv_module.cu``), with its backward.

Replaces ``neural_speech_decoder_tpu/ops/pallas/conv_module_kernel.py``:

- ``conv_module``: ``fused_conv_module``'s forward (``_fwd_kernel``);
- ``conv_module_bwd``: its custom VJP's backward (``_bwd_kernel``): dx and
  all ten parameter gradients.

Each launches its kernel for a CUDA tensor and runs its ``*_plain`` twin,
written step by step as the TPU kernel, for a CPU tensor; it raises for any
other device or a shape the kernel does not take (taps beyond 64).
``<wrapper>.launches`` counts its calls that launched the kernel.
The model reaches the forward through the operator
``torch.ops.nsd_torch.conv_module`` (``library.py``). ``ConvModule`` is the
``torch.autograd.Function``; it saves the inputs and
the seed, and the backward recomputes the forward. The bodies are the FF
module's (``ffn.py::bwd_plan``): ``"sm90"`` (bfloat16 with D
a multiple of 8: the products on ``csrc/gemm_sm90.cuh``, the GLU and
depthwise conv on the wide window kernel), ``"f32"`` (the float32
backward with D a multiple of 4: the products on ``csrc/gemm_f32.cuh``)
and ``"tile"``; ``conv_module.launches_by_body`` and
``conv_module_bwd.launches_by_body`` count them and ``body=`` forces one.

Semantics, the TPU kernel's (``models/conformer.py::_conv_module`` without
the residual): layer norm (float32 statistics) cast to x's dtype (cdt) ->
``@ W1 + b1`` (D -> 2D, float32 accumulation, rounded once) -> GLU in
float32 on the rounded value, rounded -> depthwise conv along time with
**float32** taps (``fused_conv_module`` casts them to float32, where the
unfused module casts them to cdt) and a float32 bias, zero padding
``(k//2, k-1-k//2)`` or, causal, ``(k-1, 0)``, rounded -> layer norm,
rounded -> SiLU in float32, rounded -> ``@ W2 + b2`` -> dropout keeping
``uniform2d(seed, b, t, d) >= rate``, scaled by the float32 inverse keep
rate. The taps' gradient multiplies the unrounded float32 GLU output, not
the rounded one the forward convolved. dW1 and dW2 are rounded to cdt; the
taps' and the vector gradients are float32; dx is in x's dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import check, load_library
from .ffn import (
    _DTYPES,
    check_args,
    check_rate,
    cuda_bwd_plan,
    fwd_plan,
    inv_keep,
    keep_mask,
    mm_f32,
    norm,
    on_cuda,
)

MAX_TAPS = 64  # csrc/conv_module.cu's kMaxTaps


def pads(kw: int, causal: bool) -> tuple[int, int]:
    """The depthwise conv's zero padding before and after the frames."""
    return (kw - 1, 0) if causal else (kw // 2, kw - 1 - kw // 2)


def _dwconv(h: torch.Tensor, w: torch.Tensor, pad_l: int, pad_r: int) -> torch.Tensor:
    """``h [B, T, D]`` convolved along T with float32 taps ``w [k, D]`` as k
    shifted multiply-adds over the zero-padded float32 block."""
    t = h.shape[1]
    hp = F.pad(h.float(), (0, 0, pad_l, pad_r))
    acc = hp[:, 0:t] * w[0]
    for k in range(1, w.shape[0]):
        acc = acc + hp[:, k:k + t] * w[k]
    return acc


def _glu(hq: torch.Tensor):
    """``(a * sigmoid(g), a, sigmoid(g))`` of the halves of ``hq``, float32."""
    d = hq.shape[-1] // 2
    a, g = hq[..., :d].float(), hq[..., d:].float()
    sig = torch.sigmoid(g)
    return a * sig, a, sig


def _front(x, ln_s, ln_b, w1, b1, dw_w, dw_b, causal):
    """The forward up to the rounded conv output: ``(xn, hq, cq)``."""
    b, t, d = x.shape
    cdt = x.dtype
    xn, _, _ = norm(x.float(), ln_s, ln_b)
    xn = xn.to(cdt).reshape(-1, d)
    hq = (mm_f32(xn, w1) + b1).to(cdt)
    glu, _, _ = _glu(hq)
    c = _dwconv(glu.to(cdt).reshape(b, t, d), dw_w, *pads(dw_w.shape[0], causal)) + dw_b
    return xn, hq, c.to(cdt).reshape(-1, d)


def conv_module_plain(x, ln_s, ln_b, w1, b1, dw_w, dw_b, ln2_s, ln2_b, w2, b2, seed, *,
                      rate: float = 0.0, causal: bool = False) -> torch.Tensor:
    """``conv_module`` in plain PyTorch, step by step as ``_fwd_kernel``."""
    check_rate(rate)
    b, t, d = x.shape
    cdt = x.dtype
    _, _, cq = _front(x, ln_s, ln_b, w1, b1, dw_w, dw_b, causal)
    cn, _, _ = norm(cq.float(), ln2_s, ln2_b)
    cnb = cn.to(cdt).float()
    s = (cnb * torch.sigmoid(cnb)).to(cdt)
    o = mm_f32(s, w2) + b2
    if rate > 0:
        o = torch.where(keep_mask(seed, 0, b, t, d, rate).reshape(-1, d),
                        o * inv_keep(rate), 0.0)
    return o.to(cdt).reshape(b, t, d)


def conv_module_bwd_plain(x, ln_s, ln_b, w1, b1, dw_w, dw_b, ln2_s, ln2_b, w2, seed, g,
                          *, rate: float = 0.0, causal: bool = False):
    """``conv_module_bwd`` in plain PyTorch, step by step as
    ``_bwd_kernel``: ``(dx, dln_s, dln_b, dw1, db1, ddw_w, ddw_b, dln2_s,
    dln2_b, dw2, db2)``."""
    check_rate(rate)
    b, t, d = x.shape
    kw = dw_w.shape[0]
    pad_l, pad_r = pads(kw, causal)
    cdt = x.dtype
    xn, hq, cq = _front(x, ln_s, ln_b, w1, b1, dw_w, dw_b, causal)
    _, xhat, rstd = norm(x.float().reshape(-1, d), ln_s, ln_b)
    glu, a_f, sig_g = _glu(hq)
    _, chat, rstd2 = norm(cq.float(), ln2_s, ln2_b)
    cnb = (chat * ln2_s + ln2_b).to(cdt).float()
    sig_s = torch.sigmoid(cnb)
    s = (cnb * sig_s).to(cdt)

    gf = g.float().reshape(-1, d)
    if rate > 0:
        keep = keep_mask(seed, 0, b, t, d, rate).reshape(-1, d)
        gf = torch.where(keep, gf * inv_keep(rate), 0.0)
    db2 = gf.sum(0)
    gq = gf.to(cdt)
    dw2 = mm_f32(s.T, gq)
    ds = mm_f32(gq, w2.T)
    dcn = ds * sig_s * (1.0 + cnb * (1.0 - sig_s))
    dln2_s = (dcn * chat).sum(0)
    dln2_b = dcn.sum(0)
    dchat = dcn * ln2_s
    dc = rstd2 * (dchat - dchat.mean(-1, keepdim=True)
                  - chat * (dchat * chat).mean(-1, keepdim=True))
    ddw_b = dc.sum(0)
    # the depthwise conv's backward: dglu[t] = sum_k dc[t + pad_l - k] w[k]
    # (the flipped taps); ddw[k] = sum_t dc[t] glu[t + k - pad_l], with the
    # unrounded float32 glu
    dc3 = dc.reshape(b, t, d)
    dcp = F.pad(dc3, (0, 0, pad_r, pad_l))
    dglu = dcp[:, kw - 1:kw - 1 + t] * dw_w[0]
    for k in range(1, kw):
        dglu = dglu + dcp[:, kw - 1 - k:kw - 1 - k + t] * dw_w[k]
    glup = F.pad(glu.reshape(b, t, d), (0, 0, pad_l, pad_r))
    ddw_w = torch.stack([(dc3 * glup[:, k:k + t]).sum((0, 1)) for k in range(kw)])
    dglu = dglu.reshape(-1, d)
    dh = torch.cat([dglu * sig_g, dglu * a_f * sig_g * (1.0 - sig_g)], dim=-1)
    db1 = dh.sum(0)
    dhq = dh.to(cdt)
    dw1 = mm_f32(xn.T, dhq)
    dxn = mm_f32(dhq, w1.T)
    dln_s = (dxn * xhat).sum(0)
    dln_b = dxn.sum(0)
    dxhat = dxn * ln_s
    dx = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                 - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    return (dx.to(x.dtype).reshape(b, t, d), dln_s, dln_b, dw1.to(w1.dtype), db1,
            ddw_w, ddw_b, dln2_s, dln2_b, dw2.to(w2.dtype), db2)


def _specs(x, ln_s, ln_b, w1, b1, dw_w, dw_b, ln2_s, ln2_b, w2, b2=None, seed=None,
           g=None):
    b, t, d = x.shape
    f32 = torch.float32
    specs = [("ln_s", ln_s, (d,), f32), ("ln_b", ln_b, (d,), f32),
             ("w1", w1, (d, 2 * d), x.dtype), ("b1", b1, (2 * d,), f32),
             ("dw_w", dw_w, (dw_w.shape[0], d), f32), ("dw_b", dw_b, (d,), f32),
             ("ln2_s", ln2_s, (d,), f32), ("ln2_b", ln2_b, (d,), f32),
             ("w2", w2, (d, d), x.dtype)]
    for name, v, shape, dtype in (("b2", b2, (d,), f32),
                                  ("seed", seed, (1,), torch.int32),
                                  ("g", g, (b, t, d), x.dtype)):
        if v is not None:
            specs.append((name, v, shape, dtype))
    return specs


def _check_taps(what: str, dw_w: torch.Tensor) -> int:
    kw = dw_w.shape[0] if dw_w.dim() == 2 else 0
    if not 1 <= kw <= MAX_TAPS:
        raise ValueError(f"{what}: the kernel takes 1 to {MAX_TAPS} taps [k, D], got "
                         f"{tuple(dw_w.shape)}")
    return kw


def _launch_args(x, kw, rate, causal):
    b, t, d = x.shape
    return (b, t, d, kw, pads(kw, causal)[0], float(rate) if rate > 0 else 0.0,
            inv_keep(rate) if rate > 0 else 1.0)


def _workspace(x, kw, bwd: bool) -> torch.Tensor:
    b, t, d = x.shape
    n = load_library().nsd_conv_workspace(b, t, d, kw, int(x.dtype == torch.bfloat16),
                                          int(bwd))
    return torch.empty(n, dtype=torch.uint8, device=x.device)


def conv_module(x, ln_s, ln_b, w1, b1, dw_w, dw_b, ln2_s, ln2_b, w2, b2, seed, *,
                rate: float = 0.0, causal: bool = False, body=None) -> torch.Tensor:
    """The conv module (without residual) over ``x [B, T, D]`` (float32 or
    bfloat16): norms' scales and biases, ``b1 [2D]``, ``b2 [D]``, ``dw_w [k,
    D]`` and ``dw_b [D]`` float32; ``w1 [D, 2D]``, ``w2 [D, D]`` in x's
    dtype; dropout ``rate`` from ``seed [1]`` int32 -> ``[B, T, D]`` in x's
    dtype. ``body`` (``"sm90"`` or ``"tile"``) overrides the plan's choice
    on the card."""
    check_rate(rate)
    if not on_cuda("conv_module", x):
        return conv_module_plain(x, ln_s, ln_b, w1, b1, dw_w, dw_b, ln2_s, ln2_b, w2, b2,
                                 seed, rate=rate, causal=causal)
    kw = _check_taps("conv_module", dw_w)
    check_args("conv_module", x, _specs(x, ln_s, ln_b, w1, b1, dw_w, dw_b, ln2_s, ln2_b,
                                        w2, b2, seed))
    x, w1, w2, dw_w = x.contiguous(), w1.contiguous(), w2.contiguous(), dw_w.contiguous()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        plan = fwd_plan("conv_module", x, w1, w2, body)
        lib = load_library()
        ptrs = (x.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                dw_w.data_ptr(), dw_b.data_ptr(), ln2_s.data_ptr(), ln2_b.data_ptr(),
                w2.data_ptr(), b2.data_ptr(), seed.data_ptr(), out.data_ptr())
        b, t, d = x.shape
        stream = torch.cuda.current_stream().cuda_stream
        if plan.body == "sm90":
            ws = torch.empty(lib.nsd_conv_fwd_sm90_workspace(b, t, d, kw), dtype=torch.uint8,
                             device=x.device)
            rc = lib.nsd_conv_fwd_sm90(*ptrs, ws.data_ptr(), *_launch_args(x, kw, rate, causal),
                                       stream)
        else:
            ws = _workspace(x, kw, False)
            rc = getattr(lib, f"nsd_conv_fwd_tile_{_DTYPES[x.dtype]}")(
                *ptrs, ws.data_ptr(), *_launch_args(x, kw, rate, causal), stream)
    check(rc, f"conv_module ({plan.body})")
    conv_module.launches += 1
    conv_module.launches_by_body[plan.body] += 1
    return out


def conv_module_bwd(x, ln_s, ln_b, w1, b1, dw_w, dw_b, ln2_s, ln2_b, w2, seed, g, *,
                    rate: float = 0.0, causal: bool = False, body=None):
    """The gradients of ``conv_module``'s output with cotangent ``g [B, T,
    D]``: ``(dx, dln_s, dln_b, dw1, db1, ddw_w, ddw_b, dln2_s, dln2_b, dw2,
    db2)``; dx in x's dtype, dw1 and dw2 in the weights' dtype, the rest
    float32. ``body`` (``"sm90"``, ``"f32"`` or ``"tile"``) overrides the
    plan's choice on the card."""
    check_rate(rate)
    if not on_cuda("conv_module_bwd", x):
        return conv_module_bwd_plain(x, ln_s, ln_b, w1, b1, dw_w, dw_b, ln2_s, ln2_b, w2,
                                     seed, g, rate=rate, causal=causal)
    kw = _check_taps("conv_module_bwd", dw_w)
    check_args("conv_module_bwd", x, _specs(x, ln_s, ln_b, w1, b1, dw_w, dw_b, ln2_s,
                                            ln2_b, w2, seed=seed, g=g))
    d = x.shape[-1]
    x, w1, w2, dw_w, g = (v.contiguous() for v in (x, w1, w2, dw_w, g))
    dx, dw1, dw2 = torch.empty_like(x), torch.empty_like(w1), torch.empty_like(w2)
    ddw_w = torch.empty_like(dw_w)
    vec = torch.empty(8 * d, dtype=torch.float32, device=x.device)
    dln_s, dln_b, db1, ddw_b, dln2_s, dln2_b, db2 = torch.split(
        vec, [d, d, 2 * d, d, d, d, d])
    with torch.cuda.device(x.device):
        plan = cuda_bwd_plan("conv_module_bwd", x, (x, w1, w2, g), ((d, d), (d, 2 * d)), body)
        lib = load_library()
        ptrs = (x.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                dw_w.data_ptr(), dw_b.data_ptr(), ln2_s.data_ptr(), ln2_b.data_ptr(),
                w2.data_ptr(), seed.data_ptr(), g.data_ptr(), dx.data_ptr(), dln_s.data_ptr(),
                dln_b.data_ptr(), dw1.data_ptr(), db1.data_ptr(), ddw_w.data_ptr(),
                ddw_b.data_ptr(), dln2_s.data_ptr(), dln2_b.data_ptr(), dw2.data_ptr(),
                db2.data_ptr())
        b, t, d, kw, pad_l, r, inv = _launch_args(x, kw, rate, causal)
        stream = torch.cuda.current_stream().cuda_stream
        if plan.body != "tile":
            ws = torch.empty(getattr(lib, f"nsd_conv_bwd_{plan.body}_workspace")(
                b, t, d, kw, *plan.splits), dtype=torch.uint8, device=x.device)
            rc = getattr(lib, f"nsd_conv_bwd_{plan.body}")(
                *ptrs, ws.data_ptr(), b, t, d, kw, pad_l, *plan.splits, r, inv, stream)
        else:
            ws = _workspace(x, kw, True)
            rc = getattr(lib, f"nsd_conv_bwd_tile_{_DTYPES[x.dtype]}")(
                *ptrs, ws.data_ptr(), b, t, d, kw, pad_l, r, inv, stream)
    check(rc, f"conv_module_bwd ({plan.body})")
    conv_module_bwd.launches += 1
    conv_module_bwd.launches_by_body[plan.body] += 1
    return dx, dln_s, dln_b, dw1, db1, ddw_w, ddw_b, dln2_s, dln2_b, dw2, db2


conv_module.launches = 0
conv_module.launches_by_body = {"sm90": 0, "tile": 0}
conv_module_bwd.launches = 0
conv_module_bwd.launches_by_body = {"sm90": 0, "f32": 0, "tile": 0}


class ConvModule(torch.autograd.Function):
    """``conv_module`` with its backward kernel (``fused_conv_module``'s
    custom VJP). Saves the inputs (not b2) and the seed; the backward
    recomputes the forward. ``plain`` runs the plain versions."""

    @staticmethod
    def forward(ctx, x, ln_s, ln_b, w1, b1, dw_w, dw_b, ln2_s, ln2_b, w2, b2, seed, rate,
                causal, plain):
        out = _forward(x, ln_s, ln_b, w1, b1, dw_w, dw_b, ln2_s, ln2_b, w2, b2, seed, rate,
                       causal, plain)
        ctx.save_for_backward(x, ln_s, ln_b, w1, b1, dw_w, dw_b, ln2_s, ln2_b, w2, seed)
        ctx.kw, ctx.plain = dict(rate=rate, causal=causal), plain
        return out

    @staticmethod
    def backward(ctx, g):
        bwd = conv_module_bwd_plain if ctx.plain else conv_module_bwd
        grads = bwd(*ctx.saved_tensors, g.contiguous(), **ctx.kw)
        return (*grads, None, None, None, None)


def fused_conv_module(x, ln_s, ln_b, w1, b1, dw_w, dw_b, ln2_s, ln2_b, w2, b2, seed, *,
                      rate: float = 0.0, causal: bool = False,
                      plain: bool = False) -> torch.Tensor:
    """``ConvModule`` under autograd when grad is enabled and an input
    requires it (otherwise the forward alone, ``_forward``), with the
    parameters cast as ``fused_conv_module`` casts them: the weights to x's
    dtype, the taps and every vector to float32."""
    f32 = torch.float32
    args = (x, ln_s.to(f32), ln_b.to(f32), w1.to(x.dtype), b1.to(f32), dw_w.to(f32),
            dw_b.to(f32), ln2_s.to(f32), ln2_b.to(f32), w2.to(x.dtype), b2.to(f32), seed,
            float(rate), bool(causal), plain)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args[:11]):
        return ConvModule.apply(*args)
    return _forward(*args)


def _forward(x, ln_s, ln_b, w1, b1, dw_w, dw_b, ln2_s, ln2_b, w2, b2, seed, rate, causal,
             plain):
    """The forward as the model runs it: the plain version, or the operator
    ``torch.ops.nsd_torch.conv_module`` (``library.py``; what
    ``torch.export`` records)."""
    if plain:
        return conv_module_plain(x, ln_s, ln_b, w1, b1, dw_w, dw_b, ln2_s, ln2_b, w2, b2,
                                 seed, rate=rate, causal=causal)
    return torch.ops.nsd_torch.conv_module(x, ln_s, ln_b, w1, b1, dw_w, dw_b, ln2_s, ln2_b,
                                           w2, b2, seed, rate, causal)
