"""The Conformer's multi-head self-attention over the qkv projection,
hand-written in CUDA (``csrc/attention.cu``), with its backward and dropout
masks.

Replaces ``neural_speech_decoder_tpu/ops/pallas/attention_kernel.py``:

- ``mhsa_qkv``: ``fused_mhsa_qkv``'s forward (``_fwd_kernel``);
- ``mhsa_qkv_bwd``: its custom VJP's backward (``_bwd_kernel``), the
  gradient with respect to qkv in qkv's column layout;
- ``dropout_masks``: the keep masks both kernels draw (the test hook).

The float32 kernels run their products on FMAs; the bfloat16 forward and
backward run them on the tensor cores (``mma.sync``, bf16 operands, float32
sums), as the TPU kernel's bf16 products do.

Each launches its kernel for a CUDA tensor and runs its ``*_plain`` twin,
the same function in plain PyTorch, for a CPU tensor; it raises for any
other device. ``<wrapper>.launches`` counts its calls that launched the
kernel (``mhsa_qkv_bwd`` launches two, the dQ and the dK/dV kernel, per
call), and ``mhsa_qkv.launches_by_body`` the forward's by body (``"tc"``
for bfloat16, ``"fma"`` for float32). The model reaches the forward
through the operator ``torch.ops.nsd_torch.mhsa_qkv`` (``library.py``).
``MHSA`` is the ``torch.autograd.Function``: it saves
``(qkv, lens, seed)`` and the backward regenerates the probabilities and
the dropout mask from them.

Semantics, the TPU kernel's: for each (batch b, head h) the scores
``q k^T`` accumulate in float32 and are scaled afterwards; keys at or past
``min(len_b, T)`` and, with ``left_context``, outside ``[i - left, i]``
score -1e9; the float32 softmax of a row whose every key is masked is 0;
dropout keeps p where ``uniform2d(seed, b*H + h, i, j) >= rate`` (the
interpret-mode bits of the TPU kernel, ``ops/hashrng.py``) and scales it by
1/(1 - rate); p is cast to qkv's dtype before ``@ V``, and dS before its
products in the backward. Nothing is padded: each bit depends on
``(seed, b*H + h, i, j)`` only, so the TPU kernel's padding of T to 128
changes no value for ``len <= T``.
"""

from __future__ import annotations

import math

import torch

from ..hashrng import uniform
from ._build import check, load_library

NEG = -1e9
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _split_heads(qkv: torch.Tensor, num_heads: int, interleaved: bool):
    """``[B, T, 3D]`` -> q, k, v, each ``[B, H, T, dh]``."""
    b, t, d3 = qkv.shape
    dh = d3 // (3 * num_heads)
    if interleaved:
        z = qkv.reshape(b, t, num_heads, 3, dh)
        return tuple(z[:, :, :, i].transpose(1, 2) for i in range(3))
    z = qkv.reshape(b, t, 3, num_heads, dh)
    return tuple(z[:, :, i].transpose(1, 2) for i in range(3))


def _merge_grads(dq, dk, dv, interleaved: bool) -> torch.Tensor:
    """Three ``[B, H, T, dh]`` gradients -> ``[B, T, 3D]`` in the qkv
    column layout."""
    b, h, t, dh = dq.shape
    axis = 3 if interleaved else 2  # (head, {q,k,v}) or ({q,k,v}, head)
    z = torch.stack([x.transpose(1, 2) for x in (dq, dk, dv)], dim=axis)
    return z.reshape(b, t, 3 * h * dh)


def _keep(b, h, t, seed, rate, device) -> torch.Tensor:
    """``[B, H, T, T]`` keep masks of programs ``b*H + h``."""
    return dropout_masks_plain(b * h, t, seed, rate).to(device).reshape(b, h, t, t)


def _probs(q, k, lens, left_context):
    """The masked float32 softmax of ``q k^T * scale`` (``_probs_for``), 0
    in rows whose every key is masked."""
    t, dh = q.shape[2], q.shape[3]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(dh))
    col = torch.arange(t, device=q.device)
    limit = torch.clamp(lens.to(q.device).long(), max=t)
    masked = col[None, :] >= limit[:, None]  # [B, T] over keys
    scores = torch.where(masked[:, None, None, :], NEG, scores)
    if left_context is not None:
        row = col[:, None]
        band = (col[None, :] <= row) & (row - col[None, :] <= left_context)
        scores = torch.where(band, scores, NEG)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    p = e / e.sum(dim=-1, keepdim=True)
    return torch.where(m <= NEG, 0.0, p)


def _check_rate(rate: float) -> None:
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"attention dropout rate must lie in [0, 1), got {rate}")


def mhsa_qkv_plain(qkv, lens, seed, *, num_heads: int, rate: float = 0.0,
                   left_context: int | None = None,
                   interleaved: bool = False) -> torch.Tensor:
    """``mhsa_qkv`` in plain PyTorch, step by step as ``_fwd_kernel``."""
    _check_rate(rate)
    b, t, d3 = qkv.shape
    q, k, v = _split_heads(qkv, num_heads, interleaved)
    p = _probs(q, k, lens, left_context)
    if rate > 0:
        keep = _keep(b, num_heads, t, seed, rate, qkv.device)
        p = torch.where(keep, p * (1.0 / (1.0 - rate)), 0.0)
    out = torch.matmul(p.to(qkv.dtype).float(), v.float()).to(qkv.dtype)
    return out.transpose(1, 2).reshape(b, t, d3 // 3)


def mhsa_qkv_bwd_plain(qkv, lens, seed, g, *, num_heads: int, rate: float = 0.0,
                       left_context: int | None = None,
                       interleaved: bool = False) -> torch.Tensor:
    """``mhsa_qkv_bwd`` in plain PyTorch, step by step as ``_bwd_kernel``."""
    _check_rate(rate)
    b, t, d3 = qkv.shape
    dh = d3 // (3 * num_heads)
    scale = 1.0 / math.sqrt(dh)
    q, k, v = _split_heads(qkv, num_heads, interleaved)
    gh = g.reshape(b, t, num_heads, dh).transpose(1, 2)
    p = _probs(q, k, lens, left_context)
    dp = torch.matmul(gh.float(), v.float().transpose(-1, -2))
    dropped = p
    if rate > 0:
        keep = _keep(b, num_heads, t, seed, rate, qkv.device)
        inv = 1.0 / (1.0 - rate)
        dropped = torch.where(keep, p * inv, 0.0)
        dp = torch.where(keep, dp * inv, 0.0)
    dv = torch.matmul(dropped.to(g.dtype).float().transpose(-1, -2), gh.float())
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    ds = ds.to(qkv.dtype).float()
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    dt = qkv.dtype
    return _merge_grads(dq.to(dt), dk.to(dt), dv.to(dt), interleaved)


def dropout_masks_plain(bh: int, t: int, seed, rate: float) -> torch.Tensor:
    """``dropout_masks`` in plain PyTorch (on seed's device)."""
    seed = torch.as_tensor(seed).reshape(-1)[0]
    idx = torch.arange(t, device=seed.device)
    progs = torch.arange(bh, device=seed.device)[:, None, None]
    return uniform(seed, progs, idx[:, None], idx[None, :]) >= rate


def _check(what, qkv, lens, seed, num_heads, g=None):
    if qkv.dtype not in _DTYPES or qkv.dim() != 3:
        raise ValueError(f"{what}: qkv must be float32 or bfloat16 [B, T, 3D], "
                         f"got {qkv.dtype} {tuple(qkv.shape)}")
    b, t, d3 = qkv.shape
    if d3 % (3 * num_heads):
        raise ValueError(f"{what}: {d3} columns do not split into 3 x {num_heads} heads")
    dh = d3 // (3 * num_heads)
    if dh not in (64, 128):
        raise ValueError(f"{what}: the kernel takes head widths 64 and 128, got {dh}")
    for name, x, shape, dtype in (("lens", lens, (b,), torch.int32),
                                  ("seed", seed, (1,), torch.int32),
                                  ("g", g, (b, t, d3 // 3), qkv.dtype)):
        if x is None:
            continue
        if tuple(x.shape) != shape or x.dtype != dtype or x.device != qkv.device:
            raise ValueError(f"{what}: {name} must be {dtype} {shape} on "
                             f"{qkv.device}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    return b, t, dh


def _scalars(dh, rate, left_context, interleaved):
    """The kernels' scalar arguments: left (-1 for no band), scale, rate,
    1/(1-rate), interleaved."""
    return (-1 if left_context is None else int(left_context), 1.0 / math.sqrt(dh),
            float(rate), 1.0 / (1.0 - rate) if rate > 0 else 1.0,
            int(bool(interleaved)))


def mhsa_qkv(qkv, lens, seed, *, num_heads: int, rate: float = 0.0,
             left_context: int | None = None, interleaved: bool = False
             ) -> torch.Tensor:
    """Attention over ``qkv [B, T, 3D]`` (float32 or bfloat16; columns
    ``({q,k,v}, head, dh)``, or ``(head, {q,k,v}, dh)`` when
    ``interleaved``) with key lengths ``lens [B]`` int32, dropout ``rate``
    drawn from ``seed [1]`` int32 -> head-major ``[B, T, D]`` in qkv's
    dtype."""
    _check_rate(rate)
    if qkv.device.type == "cpu":
        return mhsa_qkv_plain(qkv, lens, seed, num_heads=num_heads, rate=rate,
                              left_context=left_context, interleaved=interleaved)
    if qkv.device.type != "cuda":
        raise ValueError(f"mhsa_qkv: unsupported device {qkv.device}")
    b, t, dh = _check("mhsa_qkv", qkv, lens, seed, num_heads)
    qkv = qkv.contiguous()
    out = torch.empty((b, t, num_heads * dh), dtype=qkv.dtype, device=qkv.device)
    if out.numel() == 0:
        return out
    left, scale, r, inv, inter = _scalars(dh, rate, left_context, interleaved)
    with torch.cuda.device(qkv.device):
        rc = getattr(load_library(), f"nsd_attn_fwd_{_DTYPES[qkv.dtype]}")(
            qkv.data_ptr(), lens.data_ptr(), seed.data_ptr(), out.data_ptr(),
            b, t, num_heads, dh, left, scale, r, inv, inter,
            torch.cuda.current_stream().cuda_stream)
    check(rc, "mhsa_qkv")
    mhsa_qkv.launches += 1
    mhsa_qkv.launches_by_body["tc" if qkv.dtype == torch.bfloat16 else "fma"] += 1
    return out


def mhsa_qkv_bwd(qkv, lens, seed, g, *, num_heads: int, rate: float = 0.0,
                 left_context: int | None = None, interleaved: bool = False
                 ) -> torch.Tensor:
    """The gradient of ``mhsa_qkv``'s output with cotangent ``g [B, T, D]``
    with respect to ``qkv``: ``dqkv [B, T, 3D]`` in qkv's column layout and
    dtype."""
    _check_rate(rate)
    if qkv.device.type == "cpu":
        return mhsa_qkv_bwd_plain(qkv, lens, seed, g, num_heads=num_heads,
                                  rate=rate, left_context=left_context,
                                  interleaved=interleaved)
    if qkv.device.type != "cuda":
        raise ValueError(f"mhsa_qkv_bwd: unsupported device {qkv.device}")
    b, t, dh = _check("mhsa_qkv_bwd", qkv, lens, seed, num_heads, g)
    qkv, g = qkv.contiguous(), g.contiguous()
    dqkv = torch.empty_like(qkv)
    if dqkv.numel() == 0:
        return dqkv
    # each row's softmax max and sum and rowsum(dP * p), from the dQ kernel
    # to the dK/dV kernel
    stats = torch.empty((3, b * num_heads * t), dtype=torch.float32, device=qkv.device)
    left, scale, r, inv, inter = _scalars(dh, rate, left_context, interleaved)
    with torch.cuda.device(qkv.device):
        rc = getattr(load_library(), f"nsd_attn_bwd_{_DTYPES[qkv.dtype]}")(
            qkv.data_ptr(), lens.data_ptr(), seed.data_ptr(), g.data_ptr(),
            dqkv.data_ptr(), stats.data_ptr(), b, t, num_heads, dh, left, scale,
            r, inv, inter, torch.cuda.current_stream().cuda_stream)
    check(rc, "mhsa_qkv_bwd")
    mhsa_qkv_bwd.launches += 1
    return dqkv


def dropout_masks(bh: int, t: int, seed: torch.Tensor, rate: float) -> torch.Tensor:
    """The keep masks of programs ``0 .. bh-1`` (program ``b*H + h``),
    ``bool [bh, t, t]``: entry ``[p, i, j]`` is
    ``uniform2d(seed, p, i, j) >= rate``. ``seed [1]`` int32 picks the
    device."""
    if seed.device.type == "cpu":
        return dropout_masks_plain(bh, t, seed, rate)
    if seed.device.type != "cuda":
        raise ValueError(f"dropout_masks: unsupported device {seed.device}")
    if tuple(seed.shape) != (1,) or seed.dtype != torch.int32:
        raise ValueError(f"dropout_masks: seed must be int32 [1], got "
                         f"{seed.dtype} {tuple(seed.shape)}")
    out = torch.empty((bh, t, t), dtype=torch.bool, device=seed.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(seed.device):
        rc = load_library().nsd_attn_dropout_masks(
            seed.data_ptr(), out.data_ptr(), bh, t, float(rate),
            torch.cuda.current_stream().cuda_stream)
    check(rc, "dropout_masks")
    dropout_masks.launches += 1
    return out


mhsa_qkv.launches = 0
mhsa_qkv.launches_by_body = {"tc": 0, "fma": 0}
mhsa_qkv_bwd.launches = 0
dropout_masks.launches = 0


class MHSA(torch.autograd.Function):
    """``mhsa_qkv`` with its backward kernel (``fused_mhsa_qkv``'s custom
    VJP). Saves ``(qkv, lens, seed)``; the probabilities and the dropout
    mask are formed again in the backward. ``plain`` runs the plain
    versions (the reference a card run is checked against)."""

    @staticmethod
    def forward(ctx, qkv, lens, seed, num_heads, rate, left_context,
                interleaved, plain):
        kw = dict(num_heads=num_heads, rate=rate, left_context=left_context,
                  interleaved=interleaved)
        out = _forward(qkv, lens, seed, kw, plain)
        ctx.save_for_backward(qkv, lens, seed)
        ctx.kw, ctx.plain = kw, plain
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, lens, seed = ctx.saved_tensors
        bwd = mhsa_qkv_bwd_plain if ctx.plain else mhsa_qkv_bwd
        dqkv = bwd(qkv, lens, seed, g.contiguous(), **ctx.kw)
        return dqkv, None, None, None, None, None, None, None


def _forward(qkv, lens, seed, kw, plain):
    """The forward as the model runs it: the plain version, or the operator
    ``torch.ops.nsd_torch.mhsa_qkv`` (``library.py``; what ``torch.export``
    records)."""
    if plain:
        return mhsa_qkv_plain(qkv, lens, seed, **kw)
    return torch.ops.nsd_torch.mhsa_qkv(qkv, lens, seed, kw["num_heads"], float(kw["rate"]),
                                        kw["left_context"], bool(kw["interleaved"]))


def mhsa(qkv, lens, seed, *, num_heads: int, rate: float = 0.0,
         left_context: int | None = None, interleaved: bool = False,
         plain: bool = False) -> torch.Tensor:
    """``mhsa_qkv`` under autograd (``MHSA``) when grad is enabled and qkv
    requires it; otherwise the forward alone (``_forward``)."""
    if torch.is_grad_enabled() and qkv.requires_grad:
        return MHSA.apply(qkv, lens, seed, num_heads, rate, left_context,
                          interleaved, plain)
    kw = dict(num_heads=num_heads, rate=rate, left_context=left_context,
              interleaved=interleaved)
    return _forward(qkv, lens, seed, kw, plain)
