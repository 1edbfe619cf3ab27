"""Kernel 1: the fused inference frontend, ``softsign(smooth(x) @ W[day] +
b[day])``, hand-written in CUDA (``csrc/frontend.cu``).

Replaces ``neural_speech_decoder_tpu/ops/pallas/frontend_kernel.py::
fused_frontend``. ``fused_frontend`` launches the kernel for a CUDA tensor
and runs ``fused_frontend_plain``, the same function in plain PyTorch, for a
CPU tensor; it raises for any other device. ``fused_frontend.launches``
counts the kernel's launches.

Three bodies in ``csrc/frontend.cu``, which ``frontend_plan`` picks
before the launch: ``"tc"`` (bfloat16 with 20 taps and C = 256, the width
of every configuration, 16-byte aligned x, W and output: the product on the
tensor cores, W staged once per block), ``"f32"`` (float32 with C a
multiple of 4 and 16-byte aligned x, W and output: the product on
``gemm_f32.cuh``'s pipelined FP32 tile, 128 rows of a trial by 128 columns
a block, the smoothing formed as its A operand loads; float32 on the tensor
cores would be TF32 and change the numbers) and ``"fma"`` (the first body,
for every other shape; bit-equal to ``"f32"`` where both run).
``fused_frontend.launches_by_body`` counts launches by body; ``body="fma"``
forces the FMA body (an A/B), and a body the call cannot take raises.
``plan_for``, which an A/B harness may replace, names the body a call that
names none runs.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..gaussian import gaussian_kernel, gaussian_smooth, same_padding
from ._build import check, load_library

_MAX_TAPS = 32  # csrc/frontend.cu kMaxTaps
# csrc/frontend.cu namespace tc: the taps, the channels and the time rows a
# tile of the tensor-core body
TC_TAPS = 20
TC_CHANNELS = 256
TC_TILE_ROWS = 64
# csrc/frontend.cu namespace f32 (csrc/gemm_f32.cuh): time rows and output
# columns a block, channels a slab of the product
F32_TILE = 128
F32_SLAB = 16


def frontend_plan(dtype: torch.dtype, n_ch: int, n_taps: int, aligned: bool = True) -> str:
    """The body ``fused_frontend`` runs on: ``"tc"`` for bfloat16 with
    ``TC_TAPS`` taps, ``TC_CHANNELS`` channels and 16-byte aligned pointers
    (``aligned``), ``"f32"`` for float32 with C a multiple of 4, aligned
    pointers and at most 32 taps, else ``"fma"``."""
    if dtype == torch.bfloat16 and n_taps == TC_TAPS and n_ch == TC_CHANNELS and aligned:
        return "tc"
    if dtype == torch.float32 and n_ch % 4 == 0 and aligned and 1 <= n_taps <= _MAX_TAPS:
        return "f32"
    return "fma"


def plan_for(dtype: torch.dtype, n_ch: int, n_taps: int, aligned: bool) -> str:
    """The body ``fused_frontend`` launches when the caller names none
    (``frontend_plan``'s; an A/B harness may replace this function)."""
    return frontend_plan(dtype, n_ch, n_taps, aligned)


def _check_args(x, day_w, day_b, day_idx, kernel_size, sigma):
    if x.dim() != 3:
        raise ValueError(f"x must be [B, T, C], got {tuple(x.shape)}")
    b, _, c = x.shape
    n_days = day_w.shape[0]
    if tuple(day_w.shape) != (n_days, c, c) or tuple(day_b.shape) != (n_days, c):
        raise ValueError(
            f"day weights {tuple(day_w.shape)} / bias {tuple(day_b.shape)} "
            f"do not match C={c}"
        )
    if tuple(day_idx.shape) != (b,):
        raise ValueError(f"day_idx must be [{b}], got {tuple(day_idx.shape)}")
    if sigma <= 0 or not 1 <= kernel_size <= _MAX_TAPS:
        raise ValueError(
            f"needs sigma > 0 and 1 <= kernel_size <= {_MAX_TAPS}, got "
            f"sigma={sigma}, kernel_size={kernel_size}"
        )


def fused_frontend_plain(
    x: torch.Tensor,
    day_w: torch.Tensor,
    day_b: torch.Tensor,
    day_idx: torch.Tensor,
    *,
    kernel_size: int,
    sigma: float,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: smooth in float32, round the
    smoothed features to x's dtype, multiply by the clipped day's matrix in
    x's dtype with float32 accumulation, add the float32 bias, Softsign."""
    _check_args(x, day_w, day_b, day_idx, kernel_size, sigma)
    idx = day_idx.to(x.device).long().clamp(0, day_w.shape[0] - 1)
    sm = gaussian_smooth(x.float(), kernel_size, sigma).to(x.dtype)
    w = day_w[idx].to(x.dtype)
    y = torch.bmm(sm.float(), w.float()) + day_b[idx].float()[:, None, :]
    return F.softsign(y).to(x.dtype)


def fused_frontend(
    x: torch.Tensor,
    day_w: torch.Tensor,
    day_b: torch.Tensor,
    day_idx: torch.Tensor,
    *,
    kernel_size: int,
    sigma: float,
    body: str | None = None,
) -> torch.Tensor:
    """``softsign(gaussian_smooth(x) @ day_w[day] + day_b[day])``.

    ``x [B, T, C]`` float32 or bfloat16, ``day_w [nDays, C, C]``,
    ``day_b [nDays, C]``, ``day_idx [B]`` (clipped to the table) ->
    ``[B, T, C]`` in x's dtype. ``body`` (``"tc"``, ``"f32"`` or ``"fma"``)
    overrides ``plan_for`` on the card.
    """
    if x.device.type == "cpu":
        return fused_frontend_plain(
            x, day_w, day_b, day_idx, kernel_size=kernel_size, sigma=sigma
        )
    if x.device.type != "cuda":
        raise ValueError(f"fused_frontend: unsupported device {x.device}")
    _check_args(x, day_w, day_b, day_idx, kernel_size, sigma)
    entry = {torch.float32: "nsd_frontend_f32",
             torch.bfloat16: "nsd_frontend_bf16"}.get(x.dtype)
    if entry is None:
        raise TypeError(f"fused_frontend: unsupported dtype {x.dtype}")
    for name, t in (("day_w", day_w), ("day_b", day_b), ("day_idx", day_idx)):
        if t.device != x.device:
            raise ValueError(f"fused_frontend: {name} on {t.device}, x on {x.device}")
    b, t, c = x.shape
    x = x.contiguous()
    w = day_w.to(x.dtype).contiguous()
    bias = day_b.float().contiguous()
    day = day_idx.to(torch.int32).contiguous()
    out = torch.empty_like(x)
    aligned = all(p.data_ptr() % 16 == 0 for p in (x, w, out))
    if body is not None and body not in (frontend_plan(x.dtype, c, kernel_size, aligned), "fma"):
        raise ValueError(f"fused_frontend: body {body!r} does not take {x.dtype} "
                         f"{tuple(x.shape)} with {kernel_size} taps ('tc': bfloat16, "
                         f"{TC_TAPS} taps, C = {TC_CHANNELS}; 'f32': float32, C a "
                         f"multiple of 4; both 16-byte aligned pointers)")
    body = body or plan_for(x.dtype, c, kernel_size, aligned)
    if out.numel() == 0:
        return out
    entry = {"tc": "nsd_frontend_tc_bf16", "f32": "nsd_frontend_f32_tile"}.get(body, entry)
    taps = gaussian_kernel(kernel_size, sigma)
    taps_c = (ctypes.c_float * len(taps))(*taps.tolist())
    pad_left, _ = same_padding(kernel_size)
    fn = getattr(load_library(), entry)
    with torch.cuda.device(x.device):
        rc = fn(
            x.data_ptr(), w.data_ptr(), bias.data_ptr(), day.data_ptr(),
            out.data_ptr(), b, t, c, day_w.shape[0], taps_c, len(taps),
            pad_left, torch.cuda.current_stream().cuda_stream,
        )
    check(rc, f"fused_frontend ({body})")
    fused_frontend.launches += 1
    fused_frontend.launches_by_body[body] += 1
    return out


fused_frontend.launches = 0
fused_frontend.launches_by_body = {"tc": 0, "f32": 0, "fma": 0}
