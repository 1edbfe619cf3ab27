"""The Conformer's half-step feed-forward module as one fused operation,
hand-written in CUDA (``csrc/ffn.cu``), with its backward and dropout masks.

Replaces ``neural_speech_decoder_tpu/ops/pallas/ffn_kernel.py``:

- ``ffn``: ``fused_ffn``'s forward (``_fwd_kernel``);
- ``ffn_bwd``: its custom VJP's backward (``_bwd_kernel``): dx and all six
  parameter gradients;
- ``ffn_dropout_masks``: the two keep masks both kernels draw (the test
  hook ``dropout_masks``).

Each launches its kernel for a CUDA tensor and runs its ``*_plain`` twin,
the same function in plain PyTorch written step by step as the TPU kernel,
for a CPU tensor; it raises for any other device or a shape the kernel does
not take. ``<wrapper>.launches`` counts its calls that launched the kernel
(one call runs several kernels: the norm's statistics, the products, the
column sums). The model reaches the forward through the operator
``torch.ops.nsd_torch.ffn`` (``library.py``). ``FFN`` is the
``torch.autograd.Function``: it saves
``(x, scale, bias, w1, b1, w2, seed)``, as the TPU kernel's residuals, and
the backward recomputes the forward.

The bodies are picked by ``body_plan`` from the dtype, the widths and the
pointers' alignment before any launch, the same rule in both directions:
``"sm90"`` (bfloat16, widths multiples of 8: every product on
``csrc/gemm_sm90.cuh``'s TMA + wgmma pipeline, from bf16 operands written
once), ``"f32"`` (float32, widths multiples of 4: every product on
``csrc/gemm_f32.cuh``'s pipelined FP32 FMA tile, from float32 arrays where
they lie) and ``"tile"`` (what neither reads: ``csrc/gemm_tile.cuh``); the
backwards' dW products are cut into the K ranges the plan gives. The
forward and the backward of one body share their front (the norm, the
first product, the element pass). ``ffn.launches_by_body`` and
``ffn_bwd.launches_by_body`` count launches by body; ``body="tile"``
forces the tile body (an A/B), and a body the dtype or shape cannot take
raises. Every call that names no body asks one of two names at call time,
which an A/B harness replaces to force a body in one direction alone:
``fwd_plan`` (both modules' forwards) and ``bwd_plan`` (both modules'
backwards, through ``cuda_bwd_plan``). The conv module
(``conv_module.py``) shares the plans. The C entries are named by body:
``nsd_ffn_{fwd,bwd}_<body>`` and its ``_workspace`` for ``"sm90"`` and
``"f32"``, and ``nsd_ffn_{fwd,bwd}_tile_<dtype>`` for the tile body.

Semantics, the TPU kernel's (``models/conformer.py::_ff_module`` without the
0.5 half-step scale, DropPath and residual): layer norm with float32
statistics, ``xn`` cast to x's dtype (cdt); ``s = xn @ W1 + b1`` with float32
accumulation rounded once to cdt; SiLU in float32 on that rounded value,
rounded to cdt; dropout site 0 keeps ``h`` where ``uniform2d(seed, b, t, f)
>= rate`` and multiplies it *in cdt* by the inverse keep rate rounded to
cdt (JAX's weak-typed scalar: 1/0.7 -> 1.4296875 in bf16); ``o = h @ W2 +
b2``; dropout site 1 keeps ``o`` where ``uniform2d(seed, b + B, t, d) >=
rate`` and scales it by the float32 inverse keep rate. The backward's ``g *
inv`` and ``dh * inv`` are float32; dW1 and dW2 are rounded to the weights'
dtype (cdt), the vector gradients stay float32, dx is in x's dtype.
"""

from __future__ import annotations

from fractions import Fraction
from typing import NamedTuple

import torch

from ..hashrng import uniform
from ._build import check, load_library

LN_EPS = 1e-5  # models/conformer.py::layer_norm
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# csrc/gemm_sm90.cuh's block tile of the output (rows, cols) and k-step; at
# most MAX_SPLITS K ranges a product, each at least the ring's four k-steps
SM90_TILE = (128, 256)
SM90_BK = 64
MAX_SPLITS = 16
MIN_SPLIT_LEN = 4 * SM90_BK
# csrc/gemm_f32.cuh's block tile of the output (rows and cols), k slab and
# blocks an SM (its tn products); each K range at least 16 slabs
F32_TILE = 128
F32_SLAB = 16
F32_BLOCKS_PER_SM = 2
F32_MIN_SPLIT_LEN = 16 * F32_SLAB


class BwdPlan(NamedTuple):
    """How a fused call runs: ``body`` ``"sm90"``, ``"f32"`` or ``"tile"``,
    and for a backward on sm90 and f32 ``splits``, the K ranges of its two
    dW products (dW2, dW1), each summed over all B*T rows (the tile body
    picks its own; a forward has none)."""
    body: str
    splits: tuple[int, ...] = ()


def split_len(k: int, splits: int, step: int = SM90_BK) -> int:
    """The length of each K range when K is cut into ``splits``: a multiple
    of ``step``, the 64-deep k-step of ``gemm_sm90.cuh::split_len`` or the
    16-deep slab of ``gemm_f32.cuh::split_len``."""
    per_range = -(-k // splits)
    return -(-per_range // step) * step


def split_ranges(k: int, splits: int, step: int = SM90_BK) -> list[tuple[int, int]]:
    """The K ranges ``[lo, hi)`` of a product's blocks, in the order
    ``split_sum`` adds their partial sums."""
    kc = split_len(k, splits, step)
    return [(z * kc, min(k, z * kc + kc)) for z in range(splits)]


def _splits(tiles: int, k: int, n_sms: int, per_sm: int, step: int, min_len: int) -> int:
    """The K ranges of a product of ``tiles`` output blocks summed over
    ``k`` rows, ``per_sm`` blocks an SM: the count whose whole waves of
    blocks take least time (waves / ranges), ties to the fewest that put a
    block on every SM, each range at least ``min_len`` long; then cut back
    so that every range holds rows."""
    best = None
    for s in range(1, MAX_SPLITS + 1):
        if s > 1 and k < s * min_len:
            break
        key = (Fraction(-(-tiles * s // (per_sm * n_sms)), s), tiles * s < n_sms, s)
        best = key if best is None else min(best, key)
    return -(-k // split_len(k, best[2], step))


def dw_splits(rows: int, cols: int, k: int, n_sms: int) -> int:
    """The K ranges of a dW product (output ``[rows, cols]``, summed over
    ``k`` rows) on the sm90 body, on a card of ``n_sms`` SMs: ``_splits``
    for 128 x 256 blocks, one an SM, ranges of ``MIN_SPLIT_LEN`` or more."""
    tiles = -(-rows // SM90_TILE[0]) * -(-cols // SM90_TILE[1])
    return _splits(tiles, k, n_sms, 1, SM90_BK, MIN_SPLIT_LEN)


def f32_dw_splits(rows: int, cols: int, k: int, n_sms: int) -> int:
    """The K ranges of a dW product on the f32 body: ``_splits`` for 128 x
    128 blocks, two an SM, ranges of ``F32_MIN_SPLIT_LEN`` or more, each a
    multiple of the 16-deep slab (``split_ranges(k, s, F32_SLAB)``)."""
    tiles = -(-rows // F32_TILE) * -(-cols // F32_TILE)
    return _splits(tiles, k, n_sms, F32_BLOCKS_PER_SM, F32_SLAB, F32_MIN_SPLIT_LEN)


def body_plan(dtype: torch.dtype, rows: int, dw_shapes, n_sms: int, *,
              aligned: bool = True) -> BwdPlan:
    """The body of a fused call over ``rows`` = B*T rows whose dW products
    (a backward: dW2's, dW1's) or weights (a forward) have the shapes
    ``dw_shapes``, where the pointers are 16-byte aligned
    (``aligned``): ``"sm90"`` for bfloat16 whose widths are multiples of 8
    (TMA's 16-byte row strides), with the split counts of ``dw_splits``;
    ``"f32"`` for float32 whose widths are multiples of 4 (``gemm_f32.cuh``'s
    16-byte copies), with those of ``f32_dw_splits`` (FP32 FMAs: wgmma's
    float32 is TF32, which would change the numbers); else ``"tile"``."""
    widths = [n for shape in dw_shapes for n in shape]
    if aligned and dtype == torch.bfloat16 and all(n % 8 == 0 for n in widths):
        return BwdPlan("sm90", tuple(dw_splits(r, c, rows, n_sms) for r, c in dw_shapes))
    if aligned and dtype == torch.float32 and all(n % 4 == 0 for n in widths):
        return BwdPlan("f32", tuple(f32_dw_splits(r, c, rows, n_sms) for r, c in dw_shapes))
    return BwdPlan("tile")


# The backwards' plan, the name both modules' backwards ask at call time
# (``cuda_bwd_plan``): an A/B harness replaces it to force the backwards'
# body, the forwards keeping theirs (``fwd_plan``).
bwd_plan = body_plan


def _card_plan(what: str, x: torch.Tensor, tensors, shapes, body, rule) -> BwdPlan:
    """``rule`` (``body_plan`` or a replacement) for CUDA tensors on x's
    card (``tensors``: those whose pointers TMA, the cp.async copies or the
    row passes read), or the tile body where ``body`` asks for it; raise
    where ``body`` names one the dtype or shape cannot take."""
    plan = rule(x.dtype, x.shape[0] * x.shape[1], shapes,
                torch.cuda.get_device_properties(x.device).multi_processor_count,
                aligned=all(t.data_ptr() % 16 == 0 for t in tensors))
    if body is None or body == plan.body:
        return plan
    if body == "tile":
        return BwdPlan("tile")
    raise ValueError(f"{what}: body {body!r} does not take {x.dtype} {tuple(x.shape)} with "
                     f"shapes {shapes} ('sm90': bfloat16, widths multiples of 8; 'f32': "
                     f"float32, widths multiples of 4; both 16-byte aligned pointers)")


def cuda_bwd_plan(what: str, x: torch.Tensor, tensors, dw_shapes, body) -> BwdPlan:
    """A fused backward's plan on x's card: ``bwd_plan``, asked at call
    time, with the dW products' shapes (``_card_plan``)."""
    return _card_plan(what, x, tensors, dw_shapes, body, bwd_plan)


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [N, K] @ b [K, M]`` of operands in one dtype, accumulated and
    returned in float32 (bf16 on the card: ``torch.mm(out_dtype=float32)``;
    on the CPU the float32 product of the same values, exact per term)."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def norm(xf: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor):
    """``(xhat * scale + bias, xhat, rstd)`` over the last axis, float32
    (the TPU kernels' ``_norm``)."""
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + LN_EPS)
    xhat = (xf - mean) * rstd
    return xhat * scale + bias, xhat, rstd


def keep_mask(seed, salt0: int, b: int, t: int, n: int, rate: float) -> torch.Tensor:
    """``bool [b, t, n]``: ``uniform2d(seed, salt0 + i, t, n) >= rate`` for
    batch row i, on seed's device."""
    seed = torch.as_tensor(seed).reshape(-1)[0]
    dev = seed.device
    salt = torch.arange(b, device=dev)[:, None, None] + salt0
    rows = torch.arange(t, device=dev)[None, :, None]
    cols = torch.arange(n, device=dev)[None, None, :]
    return uniform(seed, salt, rows, cols) >= rate


def inv_keep(rate: float, dtype: torch.dtype = torch.float32) -> float:
    """1 / (1 - rate) rounded to ``dtype`` (what a weak-typed Python scalar
    becomes in a JAX product of that dtype)."""
    return float(torch.tensor(1.0 / (1.0 - rate), dtype=torch.float64).to(dtype))


def check_rate(rate: float) -> None:
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must lie in [0, 1), got {rate}")


def check_args(what: str, x: torch.Tensor, specs) -> None:
    """Raise unless x is float32 or bfloat16 ``[B, T, D]`` and each
    ``(name, tensor, shape, dtype)`` of ``specs`` matches, on x's device."""
    if x.dtype not in _DTYPES or x.dim() != 3 or min(x.shape) < 1:
        raise ValueError(f"{what}: x must be float32 or bfloat16 [B, T, D], got "
                         f"{x.dtype} {tuple(x.shape)}")
    for name, v, shape, dtype in specs:
        if tuple(v.shape) != tuple(shape) or v.dtype != dtype or v.device != x.device:
            raise ValueError(f"{what}: {name} must be {dtype} {tuple(shape)} on "
                             f"{x.device}, got {v.dtype} {tuple(v.shape)} on {v.device}")


def on_cuda(what: str, x: torch.Tensor) -> bool:
    """False for a CPU tensor (run the plain version), True for CUDA; raise
    for any other device."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    return True


def _specs(x, scale, bias, w1, b1, w2, b2=None, seed=None, g=None):
    b, t, d = x.shape
    f = w1.shape[-1]
    f32 = torch.float32
    specs = [("scale", scale, (d,), f32), ("bias", bias, (d,), f32),
             ("w1", w1, (d, f), x.dtype), ("b1", b1, (f,), f32),
             ("w2", w2, (f, d), x.dtype)]
    for name, v, shape, dtype in (("b2", b2, (d,), f32),
                                  ("seed", seed, (1,), torch.int32),
                                  ("g", g, (b, t, d), x.dtype)):
        if v is not None:
            specs.append((name, v, shape, dtype))
    return specs


def ffn_plain(x, scale, bias, w1, b1, w2, b2, seed, *, rate: float = 0.0) -> torch.Tensor:
    """``ffn`` in plain PyTorch, step by step as ``_fwd_kernel``."""
    check_rate(rate)
    b, t, d = x.shape
    f = w1.shape[-1]
    cdt = x.dtype
    xn, _, _ = norm(x.float(), scale, bias)
    s = mm_f32(xn.to(cdt).reshape(-1, d), w1) + b1
    sb = s.to(cdt).float()
    h = (sb * torch.sigmoid(sb)).to(cdt)
    if rate > 0:
        m1, m2 = ffn_dropout_masks_plain(b, t, d, f, seed, rate)
        h = torch.where(m1.reshape(-1, f), (h.float() * inv_keep(rate, cdt)).to(cdt), 0.0)
    o = mm_f32(h, w2) + b2
    if rate > 0:
        o = torch.where(m2.reshape(-1, d), o * inv_keep(rate), 0.0)
    return o.to(cdt).reshape(b, t, d)


def ffn_bwd_plain(x, scale, bias, w1, b1, w2, seed, g, *, rate: float = 0.0):
    """``ffn_bwd`` in plain PyTorch, step by step as ``_bwd_kernel``:
    ``(dx, dscale, dbias, dw1, db1, dw2, db2)``."""
    check_rate(rate)
    b, t, d = x.shape
    f = w1.shape[-1]
    cdt = x.dtype
    xf = x.float().reshape(-1, d)
    _, xhat, rstd = norm(xf, scale, bias)
    xn = (xhat * scale + bias).to(cdt)
    sc = (mm_f32(xn, w1) + b1).to(cdt).float()  # SiLU sees the rounded value
    sig = torch.sigmoid(sc)
    hq = (sc * sig).to(cdt)
    gf = g.float().reshape(-1, d)
    if rate > 0:
        m1, m2 = (m.reshape(-1, m.shape[-1])
                  for m in ffn_dropout_masks_plain(b, t, d, f, seed, rate))
        inv = inv_keep(rate)
        # the forward's cdt product with the cdt-rounded inverse
        hq = torch.where(m1, (hq.float() * inv_keep(rate, cdt)).to(cdt), 0.0)
        gf = torch.where(m2, gf * inv, 0.0)
    db2 = gf.sum(0)
    gq = gf.to(cdt)
    dw2 = mm_f32(hq.T, gq)
    dh = mm_f32(gq, w2.T)
    if rate > 0:
        dh = torch.where(m1, dh * inv, 0.0)
    ds = dh * sig * (1.0 + sc * (1.0 - sig))
    db1 = ds.sum(0)
    dsb = ds.to(cdt)
    dw1 = mm_f32(xn.T, dsb)
    dxn = mm_f32(dsb, w1.T)
    dscale = (dxn * xhat).sum(0)
    dbias = dxn.sum(0)
    dxhat = dxn * scale
    dx = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                 - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    return (dx.to(x.dtype).reshape(b, t, d), dscale, dbias, dw1.to(w1.dtype), db1,
            dw2.to(w2.dtype), db2)


def ffn_dropout_masks_plain(b: int, t: int, d: int, f: int, seed, rate: float):
    """``ffn_dropout_masks`` in plain PyTorch (on seed's device)."""
    return keep_mask(seed, 0, b, t, f, rate), keep_mask(seed, b, b, t, d, rate)


def _scalars(rate: float, dtype: torch.dtype):
    """rate, the float32 inverse keep rate, and the one rounded to dtype."""
    if rate <= 0:
        return 0.0, 1.0, 1.0
    return float(rate), inv_keep(rate), inv_keep(rate, dtype)


def _workspace(b, t, d, f, x, bwd: bool) -> torch.Tensor:
    n = load_library().nsd_ffn_workspace(b, t, d, f, int(x.dtype == torch.bfloat16),
                                         int(bwd))
    return torch.empty(n, dtype=torch.uint8, device=x.device)


def fwd_plan(what: str, x, w1, w2, body=None) -> BwdPlan:
    """A fused forward's body on x's card: ``body_plan`` with the weights'
    shapes (both modules' forwards read x, W1 and W2 by TMA, the cp.async
    copies or row passes) through ``_card_plan``, with no K ranges. Both
    modules' forwards ask this name at call time: an A/B harness replaces
    it to force the forwards' body, the backwards keeping theirs
    (``bwd_plan``)."""
    plan = _card_plan(what, x, (x, w1, w2), (tuple(w1.shape), tuple(w2.shape)), body,
                      body_plan)
    return BwdPlan(plan.body)


def ffn(x, scale, bias, w1, b1, w2, b2, seed, *, rate: float = 0.0,
        body=None) -> torch.Tensor:
    """The FF module over ``x [B, T, D]`` (float32 or bfloat16): ``scale,
    bias [D]``, ``b1 [F]``, ``b2 [D]`` float32, ``w1 [D, F]``, ``w2 [F, D]``
    in x's dtype, dropout ``rate`` drawn from ``seed [1]`` int32 -> ``[B, T,
    D]`` in x's dtype. ``body`` (``"sm90"``, ``"f32"`` or ``"tile"``)
    overrides ``fwd_plan``'s choice on the card."""
    check_rate(rate)
    if not on_cuda("ffn", x):
        return ffn_plain(x, scale, bias, w1, b1, w2, b2, seed, rate=rate)
    check_args("ffn", x, _specs(x, scale, bias, w1, b1, w2, b2, seed))
    b, t, d = x.shape
    f = w1.shape[-1]
    x, w1, w2 = x.contiguous(), w1.contiguous(), w2.contiguous()
    out = torch.empty_like(x)
    r, inv, inv_h = _scalars(rate, x.dtype)
    with torch.cuda.device(x.device):
        plan = fwd_plan("ffn", x, w1, w2, body)
        lib = load_library()
        ptrs = (x.data_ptr(), scale.data_ptr(), bias.data_ptr(), w1.data_ptr(),
                b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), seed.data_ptr(),
                out.data_ptr())
        stream = torch.cuda.current_stream().cuda_stream
        if plan.body != "tile":
            ws = torch.empty(getattr(lib, f"nsd_ffn_fwd_{plan.body}_workspace")(b, t, d, f),
                             dtype=torch.uint8, device=x.device)
            rc = getattr(lib, f"nsd_ffn_fwd_{plan.body}")(
                *ptrs, ws.data_ptr(), b, t, d, f, r, inv, inv_h, stream)
        else:
            ws = _workspace(b, t, d, f, x, False)
            rc = getattr(lib, f"nsd_ffn_fwd_tile_{_DTYPES[x.dtype]}")(
                *ptrs, ws.data_ptr(), b, t, d, f, r, inv, inv_h, stream)
    check(rc, f"ffn ({plan.body})")
    ffn.launches += 1
    ffn.launches_by_body[plan.body] += 1
    return out


def ffn_bwd(x, scale, bias, w1, b1, w2, seed, g, *, rate: float = 0.0, body=None):
    """The gradients of ``ffn``'s output with cotangent ``g [B, T, D]``:
    ``(dx, dscale, dbias, dw1, db1, dw2, db2)``; dx in x's dtype, dw1 and
    dw2 in the weights' dtype, the vectors float32. ``body`` (``"sm90"``,
    ``"f32"`` or ``"tile"``) overrides ``bwd_plan``'s choice on the card."""
    check_rate(rate)
    if not on_cuda("ffn_bwd", x):
        return ffn_bwd_plain(x, scale, bias, w1, b1, w2, seed, g, rate=rate)
    check_args("ffn_bwd", x, _specs(x, scale, bias, w1, b1, w2, seed=seed, g=g))
    b, t, d = x.shape
    f = w1.shape[-1]
    x, w1, w2, g = x.contiguous(), w1.contiguous(), w2.contiguous(), g.contiguous()
    dx, dw1, dw2 = torch.empty_like(x), torch.empty_like(w1), torch.empty_like(w2)
    vec = torch.empty(3 * d + f, dtype=torch.float32, device=x.device)
    dscale, dbias, db2, db1 = vec[:d], vec[d:2 * d], vec[2 * d:3 * d], vec[3 * d:]
    r, inv, inv_h = _scalars(rate, x.dtype)
    with torch.cuda.device(x.device):
        plan = cuda_bwd_plan("ffn_bwd", x, (x, w1, w2, g), ((f, d), (d, f)), body)
        lib = load_library()
        ptrs = (x.data_ptr(), scale.data_ptr(), bias.data_ptr(), w1.data_ptr(),
                b1.data_ptr(), w2.data_ptr(), seed.data_ptr(), g.data_ptr(),
                dx.data_ptr(), dscale.data_ptr(), dbias.data_ptr(), dw1.data_ptr(),
                db1.data_ptr(), dw2.data_ptr(), db2.data_ptr())
        stream = torch.cuda.current_stream().cuda_stream
        if plan.body != "tile":
            ws = torch.empty(getattr(lib, f"nsd_ffn_bwd_{plan.body}_workspace")(
                b, t, d, f, *plan.splits), dtype=torch.uint8, device=x.device)
            rc = getattr(lib, f"nsd_ffn_bwd_{plan.body}")(
                *ptrs, ws.data_ptr(), b, t, d, f, *plan.splits, r, inv, inv_h, stream)
        else:
            ws = _workspace(b, t, d, f, x, True)
            rc = getattr(lib, f"nsd_ffn_bwd_tile_{_DTYPES[x.dtype]}")(
                *ptrs, ws.data_ptr(), b, t, d, f, r, inv, inv_h, stream)
    check(rc, f"ffn_bwd ({plan.body})")
    ffn_bwd.launches += 1
    ffn_bwd.launches_by_body[plan.body] += 1
    return dx, dscale, dbias, dw1, db1, dw2, db2


def ffn_dropout_masks(b: int, t: int, d: int, f: int, seed: torch.Tensor, rate: float):
    """The keep masks of both dropout sites, ``(bool [b, t, f], bool [b, t,
    d])``: site 0's entry ``[i, r, c]`` is ``uniform2d(seed, i, r, c) >=
    rate``, site 1's ``uniform2d(seed, b + i, r, c) >= rate``. ``seed [1]``
    int32 picks the device."""
    if not on_cuda("ffn_dropout_masks", seed):
        return ffn_dropout_masks_plain(b, t, d, f, seed, rate)
    if tuple(seed.shape) != (1,) or seed.dtype != torch.int32 or min(b, t, d, f) < 1:
        raise ValueError(f"ffn_dropout_masks: seed must be int32 [1] and the shape "
                         f"positive, got {seed.dtype} {tuple(seed.shape)}, "
                         f"{(b, t, d, f)}")
    m1 = torch.empty((b, t, f), dtype=torch.bool, device=seed.device)
    m2 = torch.empty((b, t, d), dtype=torch.bool, device=seed.device)
    with torch.cuda.device(seed.device):
        rc = load_library().nsd_ffn_dropout_masks(
            seed.data_ptr(), m1.data_ptr(), m2.data_ptr(), b, t, d, f, float(rate),
            torch.cuda.current_stream().cuda_stream)
    check(rc, "ffn_dropout_masks")
    ffn_dropout_masks.launches += 1
    return m1, m2


ffn.launches = 0
ffn.launches_by_body = {"sm90": 0, "f32": 0, "tile": 0}
ffn_bwd.launches = 0
ffn_bwd.launches_by_body = {"sm90": 0, "f32": 0, "tile": 0}
ffn_dropout_masks.launches = 0


class FFN(torch.autograd.Function):
    """``ffn`` with its backward kernel (``fused_ffn``'s custom VJP). Saves
    ``(x, scale, bias, w1, b1, w2, seed)``; the backward recomputes the
    forward. ``plain`` runs the plain versions (the reference a card run is
    checked against)."""

    @staticmethod
    def forward(ctx, x, scale, bias, w1, b1, w2, b2, seed, rate, plain):
        out = _forward(x, scale, bias, w1, b1, w2, b2, seed, rate, plain)
        ctx.save_for_backward(x, scale, bias, w1, b1, w2, seed)
        ctx.rate, ctx.plain = rate, plain
        return out

    @staticmethod
    def backward(ctx, g):
        bwd = ffn_bwd_plain if ctx.plain else ffn_bwd
        grads = bwd(*ctx.saved_tensors, g.contiguous(), rate=ctx.rate)
        return (*grads, None, None, None)


def _forward(x, scale, bias, w1, b1, w2, b2, seed, rate, plain):
    """The forward as the model runs it: the plain version, or the operator
    ``torch.ops.nsd_torch.ffn`` (``library.py``; what ``torch.export``
    records)."""
    if plain:
        return ffn_plain(x, scale, bias, w1, b1, w2, b2, seed, rate=rate)
    return torch.ops.nsd_torch.ffn(x, scale, bias, w1, b1, w2, b2, seed, rate)


def fused_ffn(x, scale, bias, w1, b1, w2, b2, seed, *, rate: float = 0.0,
              plain: bool = False) -> torch.Tensor:
    """``FFN`` under autograd when grad is enabled and an input requires it
    (otherwise the forward alone, ``_forward``), with the parameters cast as
    ``fused_ffn`` casts them: the vectors to float32, the weights to x's
    dtype (their gradients flow back through the casts)."""
    f32 = torch.float32
    args = (x, scale.to(f32), bias.to(f32), w1.to(x.dtype), b1.to(f32), w2.to(x.dtype),
            b2.to(f32), seed, float(rate), plain)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args[:7]):
        return FFN.apply(*args)
    return _forward(*args)
