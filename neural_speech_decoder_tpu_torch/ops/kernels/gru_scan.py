"""The time scan of a (bi)directional GRU layer and its gradient,
hand-written in CUDA (``csrc/gru_scan.cu``, ``csrc/gru_scan_bwd.cu``).

Replaces ``neural_speech_decoder_tpu/ops/pallas/gru_scan.py::gru_sequence``
and its custom VJP, three kernels:

- ``gru_sequence``: the inference forward (``_fwd_kernel``);
- ``gru_sequence_gates``: the training forward, which also stores the gates
  ``(r, z, n, hp_n)`` (``_fwd_gates_kernel``);
- ``gru_sequence_bwd``: the backward (``_bwd_kernel``).

Each launches its kernel for a CUDA tensor and runs its ``*_plain`` twin,
the same function in plain PyTorch, for a CPU tensor; it raises for any
other device. ``<wrapper>.launches`` counts its calls that launched the
kernel (one call scans a whole layer), ``<wrapper>.launches_by_body`` the
same by body. Two bodies: ``"persistent"``, one cooperative launch a layer
whose blocks keep their slice of W_hh in shared memory for the whole walk
(bfloat16: steps on tensor cores; float32: steps on FP32 FMAs), and
``"step"``, one launch a time step on FP32 FMAs (the shapes whose slice
does not fit, in either dtype); the dtype tells which instantiation ran.
``scan_plan`` chooses from the shape and dtype before any launch; a
persistent launch that the card cannot hold at once raises, it never drops
to the step body or the plain version. ``gru_scan`` is what the model
calls: under autograd it runs ``GRUScan``, the ``torch.autograd.Function``
of the custom VJP (gates forward, then the backward kernel); otherwise the
inference forward.

Numerics follow the TPU kernel: a float32 carry, the product ``h @ W_hh``
taking h rounded to the weight's dtype with float32 accumulation, float32
gate math, output in xp's dtype. The JAX package's ``lax.scan`` twin
(``models/gru.py::_gru_layer``, ported as ``models/gru.py::gru_layer``)
rounds the carry itself to the compute dtype each step; in float32 the two
agree, in bfloat16 they differ by that rounding.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ._build import check, load_library

# The persistent bodies' tiling, as csrc/gru_scan.cu and gru_scan_bwd.cu
# have it: units a block in multiples of 8 (one mma n-tile), batch rows in
# 16-row tiles, one warp a 16-row tile and 8 units, at most _MAX_THREADS
# threads a block. bfloat16: the backward's ring of _BWD_STAGES chunks of
# _BWD_CHUNK columns of dhp. float32: each warp streams the rows of its tile
# (8 rows x 16 units where U % 16 == 0, else 16 rows x 8 units), the forward
# through a ring of _F32_STAGES chunks of _F32_CHUNK columns of h, the
# backward through a double buffer of _F32_BWD_CHUNK columns of dhp; W's
# slice is padded to the chunk width.
_UNIT_STEP = 8
_BWD_CHUNK = 128
_BWD_STAGES = 4
_F32_CHUNK = 32
_F32_STAGES = 4
_F32_BWD_CHUNK = 64
_MAX_THREADS = 256


class ScanPlan(NamedTuple):
    """A persistent scan's launch: ``units`` hidden units a block (one
    direction, all three gates), ``blocks`` in all (``dirs`` x the blocks of
    a direction), ``threads`` a block, and the dynamic shared bytes of the
    forward and the backward recurrence."""

    units: int
    blocks: int
    threads: int
    smem_fwd: int
    smem_bwd: int


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def scan_plan(hidden: int, batch: int, dirs: int, dtype: torch.dtype, n_sms: int,
              smem_per_sm: int) -> ScanPlan | str:
    """The body that runs a scan of this shape and dtype on a card of
    ``n_sms`` SMs with ``smem_per_sm`` bytes of shared memory a block may
    hold: a ``ScanPlan`` for the persistent body (bfloat16 or float32), or
    ``"step"`` for any other dtype and for a shape whose slice does not fit
    (hidden not a multiple of 8, more than ``_MAX_THREADS`` threads, or more
    shared memory than the card gives one block, in the dtype's element
    size). ``units`` is the smallest multiple of 8 that puts every block on
    its own SM; the slices ``[k * units, (k + 1) * units)`` of each
    direction cover every hidden unit once. Plans the forward and the
    backward together, so that a train step's two scans take one body."""
    if (dtype not in (torch.bfloat16, torch.float32) or hidden < 1
            or hidden % _UNIT_STEP or batch < 1):
        return "step"
    units = _UNIT_STEP
    while dirs * -(-hidden // units) > n_sms:
        units += _UNIT_STEP
        if units > hidden:
            return "step"
    rows = _round_up(batch, 16)
    if dtype == torch.bfloat16:
        smem_fwd = 2 * (3 * units + rows) * (_round_up(hidden, 16) + 8)
        smem_bwd = 2 * (units * (_round_up(3 * hidden, _BWD_CHUNK) + 8)
                        + _BWD_STAGES * rows * (_BWD_CHUNK + 8))
    else:
        # the rows of a chunk of each warp's tile, times the warps
        tile_rows = (rows // 16) * (units // _UNIT_STEP) * (8 if units % 16 == 0 else 16)
        smem_fwd = 4 * (3 * units * _round_up(hidden, _F32_CHUNK)
                        + _F32_STAGES * tile_rows * _F32_CHUNK)
        smem_bwd = 4 * (units * _round_up(3 * hidden, _F32_BWD_CHUNK)
                        + 2 * tile_rows * _F32_BWD_CHUNK)
    threads = 32 * (rows // 16) * (units // _UNIT_STEP)
    if threads > _MAX_THREADS or max(smem_fwd, smem_bwd) > smem_per_sm:
        return "step"
    return ScanPlan(units, dirs * -(-hidden // units), threads, smem_fwd, smem_bwd)


@functools.cache
def device_limits(index: int) -> tuple[int, int]:
    """(SMs, shared bytes one block may opt in to) of CUDA device ``index``."""
    n_sms, smem = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(index):
        check(load_library().nsd_device_limits(ctypes.byref(n_sms), ctypes.byref(smem)),
              "device_limits")
    return n_sms.value, smem.value


def plan_for(t: torch.Tensor, hidden: int, batch: int, dirs: int) -> ScanPlan | str:
    """``scan_plan`` for a scan whose tensors lie on CUDA tensor t's card."""
    return scan_plan(hidden, batch, dirs, t.dtype, *device_limits(t.device.index or 0))


# What a persistent entry returns, launching nothing, when the card cannot
# hold all the plan's blocks at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor
# x SMs, in csrc/common.cuh::coresident_blocks).
_TOO_LARGE = 720  # cudaErrorCooperativeLaunchTooLarge


def _raise_if_too_large(rc: int, what: str, plan: ScanPlan) -> None:
    if rc == _TOO_LARGE:
        raise RuntimeError(
            f"{what}: the persistent plan {plan} needs {plan.blocks} co-resident "
            "blocks, more than the card holds at once")


def gru_gates(
    x_t: torch.Tensor, h: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor
) -> tuple[torch.Tensor, ...]:
    """One step's gates for every direction: ``x_t [D, B, 3H]`` (input
    projections with b_ih), carry ``h [D, B, H]`` in any dtype,
    ``w_hh [D, H, 3H]``, ``b_hh [D, 3H]`` -> ``(r, z, n, hp_n)`` in float32.

    ``hp = h @ W_hh + b_hh`` with h and W_hh in x_t's dtype and float32
    accumulation; ``r, z = sigmoid(x + hp)``; ``n = tanh(x_n + r * hp_n)``
    (b_hh's n part inside the product with r).
    """
    hdim = h.shape[-1]
    w = w_hh.to(x_t.dtype).float()
    hp = torch.bmm(h.to(x_t.dtype).float(), w) + b_hh.float()[:, None, :]
    x = x_t.float()
    r = torch.sigmoid(x[..., :hdim] + hp[..., :hdim])
    z = torch.sigmoid(x[..., hdim : 2 * hdim] + hp[..., hdim : 2 * hdim])
    hp_n = hp[..., 2 * hdim :]
    n = torch.tanh(x[..., 2 * hdim :] + r * hp_n)
    return r, z, n, hp_n


def gru_cell(
    x_t: torch.Tensor, h: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor
) -> torch.Tensor:
    """One step (``gru_gates``' arguments) -> the new state
    ``h' = (1-z) n + z h`` in float32."""
    _, z, n, _ = gru_gates(x_t, h, w_hh, b_hh)
    return (1.0 - z) * n + z * h.float()


def _scan_times(length: int, d: int, device) -> torch.Tensor:
    """``[L, D]``: the time index of scan position s, s for direction 0 and
    L-1-s for direction 1 (walked in reverse)."""
    steps = torch.arange(length, device=device)
    return torch.stack([steps, length - 1 - steps], dim=1)[:, :d]


def gru_sequence_plain(
    xp: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``xp [L, D, B, 3H]`` in
    natural time order for both directions -> ``ys [L, D, B, H]`` in natural
    order, zero initial state, direction 1 walked in reverse."""
    return gru_sequence_gates_plain(xp, w_hh, b_hh)[0]


def gru_sequence_gates_plain(
    xp: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """``gru_sequence_gates`` in plain PyTorch, step by step as
    ``_fwd_gates_kernel``: ``(ys [L, D, B, H], gates [L, D, B, 4H])``, both
    in xp's dtype, ``gates = (r, z, n, hp_n)``."""
    length, d, b, three_h = xp.shape
    hdim = three_h // 3
    dirs = torch.arange(d, device=xp.device)
    t_idx = _scan_times(length, d, xp.device)
    h = torch.zeros((d, b, hdim), dtype=torch.float32, device=xp.device)
    ys = xp.new_empty((length, d, b, hdim))
    gates = xp.new_empty((length, d, b, 4 * hdim))
    for s in range(length):
        r, z, n, hp_n = gru_gates(xp[t_idx[s], dirs], h, w_hh, b_hh)
        h = (1.0 - z) * n + z * h
        ys[t_idx[s], dirs] = h.to(ys.dtype)
        gates[t_idx[s], dirs] = torch.cat([r, z, n, hp_n], dim=-1).to(xp.dtype)
    return ys, gates


def bwd_recurrence_plain(
    gates: torch.Tensor, w_hh: torch.Tensor, ys: torch.Tensor, dys: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward's reverse recurrence in plain PyTorch, step by step as
    ``_bwd_kernel``: ``(dxp [L, D, B, 3H], dhp_n [L, D, B, H])`` in the
    gates' dtype, ``dhp = (dxp's r and z thirds, dhp_n)`` being what
    ``hh_grads_plain`` contracts."""
    length, d, b, four_h = gates.shape
    hdim = four_h // 4
    dt = gates.dtype
    dirs = torch.arange(d, device=gates.device)
    t_idx = _scan_times(length, d, gates.device)
    wt = w_hh.to(dt).transpose(1, 2).float()  # [D, 3H, H]
    dh = torch.zeros((d, b, hdim), dtype=torch.float32, device=gates.device)
    dxp = gates.new_empty((length, d, b, 3 * hdim))
    dhp_n = gates.new_empty((length, d, b, hdim))
    for s in reversed(range(length)):
        t = t_idx[s]
        # h_{t-1}: the state at the previous scan position, zero at s == 0
        hprev = (ys[t_idx[s - 1], dirs].float() if s > 0
                 else torch.zeros_like(dh))
        dh_tot = dh + dys[t, dirs].float()
        r, z, n, hp_n = gates[t, dirs].float().split(hdim, dim=-1)
        dz = dh_tot * (hprev - n)
        dn = dh_tot * (1.0 - z)
        da_n = dn * (1.0 - n * n)
        dr = da_n * hp_n
        da_z = dz * z * (1.0 - z)
        da_r = dr * r * (1.0 - r)
        dxp[t, dirs] = torch.cat([da_r, da_z, da_n], dim=-1).to(dt)
        dhp_n[t, dirs] = (da_n * r).to(dt)
        dhp = torch.cat([dxp[t, dirs][..., : 2 * hdim], dhp_n[t, dirs]], dim=-1).float()
        dh = dh_tot * z + torch.bmm(dhp, wt)
    return dxp, dhp_n


def gru_sequence_bwd_plain(
    gates: torch.Tensor, w_hh: torch.Tensor, ys: torch.Tensor, dys: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``gru_sequence_bwd`` in plain PyTorch: ``bwd_recurrence_plain``, then
    ``hh_grads_plain`` -> ``(dxp [L, D, B, 3H]`` in the gates' dtype,
    ``dW_hh [D, H, 3H]`` float32, ``db_hh [D, 3H]`` float32)."""
    dxp, dhp_n = bwd_recurrence_plain(gates, w_hh, ys, dys)
    return (dxp, *hh_grads_plain(ys.to(gates.dtype), dxp, dhp_n))


def hh_grads_plain(
    ys: torch.Tensor, dxp: torch.Tensor, dhp_n: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward's dW_hh / db_hh contraction in plain PyTorch, as the
    persistent body forms it after the recurrence: ``dhp = (dxp's r and z
    thirds, dhp_n)`` in its dtype; ``dW_hh[d] = h_prev^T dhp`` summed over
    all rows, h_prev being the state at the previous scan position, so
    direction 0 takes ``ys[0:L-1]`` against ``dhp[1:L]`` and direction 1
    ``ys[1:L]`` against ``dhp[0:L-1]``; ``db_hh[d]`` sums dhp over all L*B
    rows. Products of the stored values, float32 sums: ``(dW_hh [D, H, 3H],
    db_hh [D, 3H])``."""
    length, d, b, hdim = ys.shape
    dhp = torch.cat([dxp[..., : 2 * hdim], dhp_n], dim=-1).float()
    y = ys.float()
    dw = torch.zeros((d, hdim, 3 * hdim), dtype=torch.float32, device=ys.device)
    for k in range(d):
        h_prev, g = ((y[: length - 1, 0], dhp[1:, 0]) if k == 0
                     else (y[1:, 1], dhp[: length - 1, 1]))
        dw[k] = h_prev.reshape(-1, hdim).T @ g.reshape(-1, 3 * hdim)
    return dw, dhp.sum(dim=(0, 2))


def _check_scan_args(what, xp, w_hh, b_hh):
    length, d, b, three_h = xp.shape
    hdim = three_h // 3
    if (three_h % 3 or d not in (1, 2) or tuple(w_hh.shape) != (d, hdim, three_h)
            or tuple(b_hh.shape) != (d, three_h)):
        raise ValueError(
            f"{what}: xp {tuple(xp.shape)}, w_hh {tuple(w_hh.shape)}, "
            f"b_hh {tuple(b_hh.shape)} do not fit [L,D,B,3H]/[D,H,3H]/[D,3H]"
        )
    for name, t in (("w_hh", w_hh), ("b_hh", b_hh)):
        if t.device != xp.device:
            raise ValueError(f"{what}: {name} on {t.device}, xp on {xp.device}")


def _entry(what, base, dtype):
    entry = {torch.float32: f"{base}_f32",
             torch.bfloat16: f"{base}_bf16"}.get(dtype)
    if entry is None:
        raise TypeError(f"{what}: unsupported dtype {dtype}")
    return getattr(load_library(), entry)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` (contiguous), or a copy of it where its data does not start on
    16 bytes: the float32 persistent bodies read four elements at a time."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def scan_forward(xp: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor, *,
                 gates: bool, plan: ScanPlan | str | None = None):
    """Launch the forward scan on the card (``gru_sequence_gates``' kernel
    with ``gates``, else ``gru_sequence``'s): ``(ys, gates or None)``.
    ``plan`` is ``plan_for``'s by default; ``"step"`` runs the step body
    whatever the shape (for an A/B). Counts the launch on its wrapper."""
    what = "gru_sequence_gates" if gates else "gru_sequence"
    _check_scan_args(what, xp, w_hh, b_hh)
    length, d, b, three_h = xp.shape
    hdim = three_h // 3
    if plan is None:
        plan = plan_for(xp, hdim, b, d)
    xp = _aligned(xp)
    w = w_hh.to(xp.dtype).contiguous()
    bias = b_hh.float().contiguous()
    ys = xp.new_empty((length, d, b, hdim))
    gates_out = xp.new_empty((length, d, b, 4 * hdim)) if gates else None
    if ys.numel() == 0:
        return ys, gates_out
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    g_ptr = gates_out.data_ptr() if gates else None
    with torch.cuda.device(xp.device):
        if plan == "step":
            base = "nsd_gru_scan_gates" if gates else "nsd_gru_scan"
            fn = _entry(what, base, xp.dtype)
            carry = torch.empty((2, d, b, hdim), dtype=torch.float32, device=xp.device)
            ptrs = [xp.data_ptr(), w.data_ptr(), bias.data_ptr(), ys.data_ptr()]
            rc = fn(*ptrs, *([g_ptr] if gates else []), carry.data_ptr(), length, d, b,
                    hdim, stream)
        else:
            fn = _entry(what, "nsd_gru_scan_persistent", xp.dtype)
            sync = torch.empty(2, dtype=torch.int32, device=xp.device)
            rc = fn(xp.data_ptr(), w.data_ptr(), bias.data_ptr(), ys.data_ptr(), g_ptr,
                    sync.data_ptr(), length, d, b, hdim, plan.units, plan.threads,
                    plan.smem_fwd, stream)
            _raise_if_too_large(rc, what, plan)
    check(rc, what)
    wrapper = gru_sequence_gates if gates else gru_sequence
    wrapper.launches += 1
    wrapper.launches_by_body["step" if plan == "step" else "persistent"] += 1
    return ys, gates_out


def gru_sequence(
    xp: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor
) -> torch.Tensor:
    """One GRU layer's time recurrence with zero initial state.

    ``xp [L, D, B, 3H]`` float32 or bfloat16 (b_ih added, natural time
    order for both directions), ``w_hh [D, H, 3H]``, ``b_hh [D, 3H]`` ->
    ``ys [L, D, B, H]`` in xp's dtype, natural order for both directions.
    """
    if xp.device.type == "cpu":
        return gru_sequence_plain(xp, w_hh, b_hh)
    if xp.device.type != "cuda":
        raise ValueError(f"gru_sequence: unsupported device {xp.device}")
    return scan_forward(xp, w_hh, b_hh, gates=False)[0]


def gru_sequence_gates(
    xp: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The training forward: ``gru_sequence``'s ``ys`` (bit for bit) and
    ``gates [L, D, B, 4H] = (r, z, n, hp_n)`` in xp's dtype, natural time
    order for both directions."""
    if xp.device.type == "cpu":
        return gru_sequence_gates_plain(xp, w_hh, b_hh)
    if xp.device.type != "cuda":
        raise ValueError(f"gru_sequence_gates: unsupported device {xp.device}")
    return scan_forward(xp, w_hh, b_hh, gates=True)


def dw_contraction(ys: torch.Tensor, dxp: torch.Tensor, dhp_n: torch.Tensor) -> torch.Tensor:
    """``hh_grads_plain``'s dW_hh, the persistent backward's contraction,
    callable alone (``csrc/gru_scan_bwd.cu``): bfloat16 on
    ``gru_bwd_dw_sm90`` (TMA + wgmma) where H % 256 == 0 and B divides or is
    divided by 64, else on the step body's FMA contraction
    ``gru_bwd_dw_kernel``; float32 on ``gemm_f32.cuh``'s pipelined FMA tile
    (``gru_bwd_dw_f32``). CUDA tensors of one of the two dtypes, H % 8 == 0
    -> float32 ``[D, H, 3H]``. (The persistent body sums db_hh in its
    recurrence.)"""
    length, d, b, hdim = ys.shape
    if (ys.dtype not in (torch.bfloat16, torch.float32) or dxp.dtype != ys.dtype
            or dhp_n.dtype != ys.dtype or tuple(dxp.shape) != (length, d, b, 3 * hdim)
            or tuple(dhp_n.shape) != tuple(ys.shape) or hdim % _UNIT_STEP):
        raise ValueError(f"dw_contraction: ys {tuple(ys.shape)} {ys.dtype}, dxp "
                         f"{tuple(dxp.shape)}, dhp_n {tuple(dhp_n.shape)}: needs bfloat16 "
                         "or float32 [L,D,B,H]/[L,D,B,3H]/[L,D,B,H], H % 8 == 0")
    ys, dxp, dhp_n = ys.contiguous(), dxp.contiguous(), dhp_n.contiguous()
    dw = torch.empty((d, hdim, 3 * hdim), dtype=torch.float32, device=ys.device)
    with torch.cuda.device(ys.device):
        rc = _entry("dw_contraction", "nsd_gru_dw", ys.dtype)(
            ys.data_ptr(), dxp.data_ptr(), dhp_n.data_ptr(), dw.data_ptr(), length, d, b,
            hdim, torch.cuda.current_stream().cuda_stream)
    check(rc, "dw_contraction")
    return dw


def scan_backward(gates: torch.Tensor, w_hh: torch.Tensor, ys: torch.Tensor,
                  dys: torch.Tensor, *, plan: ScanPlan | str | None = None):
    """Launch ``gru_sequence_bwd``'s kernels on the card: ``(dxp, dW_hh,
    db_hh)``. ``plan`` as in ``scan_forward``. Counts the launch."""
    length, d, b, four_h = gates.shape
    hdim = four_h // 4
    if (four_h % 4 or d not in (1, 2) or tuple(w_hh.shape) != (d, hdim, 3 * hdim)
            or tuple(ys.shape) != (length, d, b, hdim)
            or tuple(dys.shape) != tuple(ys.shape)):
        raise ValueError(
            f"gru_sequence_bwd: gates {tuple(gates.shape)}, w_hh "
            f"{tuple(w_hh.shape)}, ys {tuple(ys.shape)}, dys "
            f"{tuple(dys.shape)} do not fit [L,D,B,4H]/[D,H,3H]/[L,D,B,H]"
        )
    for name, t in (("w_hh", w_hh), ("ys", ys), ("dys", dys)):
        if t.device != gates.device:
            raise ValueError(
                f"gru_sequence_bwd: {name} on {t.device}, gates on {gates.device}")
    if plan is None:
        plan = plan_for(gates, hdim, b, d)
    dt = gates.dtype
    fn = _entry("gru_sequence_bwd", "nsd_gru_bwd" if plan == "step" else "nsd_gru_bwd_persistent",
                dt)
    gates = _aligned(gates)
    ys = _aligned(ys.to(dt))
    dys = _aligned(dys.to(dt))
    dxp = gates.new_empty((length, d, b, 3 * hdim))
    # dhp's n third; its r and z thirds are dxp's
    dhp_n = gates.new_empty((length, d, b, hdim))
    dw = torch.empty((d, hdim, 3 * hdim), dtype=torch.float32, device=gates.device)
    db = torch.empty((d, 3 * hdim), dtype=torch.float32, device=gates.device)
    if dxp.numel() == 0:
        return dxp, dw.zero_(), db.zero_()
    with torch.cuda.device(gates.device):
        stream = torch.cuda.current_stream().cuda_stream
        if plan == "step":
            # W^T once, so that the step product reads contiguous rows
            # (gru_scan.py:230)
            wt = w_hh.to(dt).transpose(1, 2).contiguous()
            dhz = torch.empty((d, b, hdim), dtype=torch.float32, device=gates.device)
            rc = fn(gates.data_ptr(), wt.data_ptr(), ys.data_ptr(), dys.data_ptr(),
                    dxp.data_ptr(), dhp_n.data_ptr(), dw.data_ptr(), db.data_ptr(),
                    dhz.data_ptr(), length, d, b, hdim, stream)
        else:
            w = w_hh.to(dt).contiguous()
            sync = torch.empty(2, dtype=torch.int32, device=gates.device)
            rc = fn(gates.data_ptr(), w.data_ptr(), ys.data_ptr(), dys.data_ptr(),
                    dxp.data_ptr(), dhp_n.data_ptr(), dw.data_ptr(), db.data_ptr(),
                    sync.data_ptr(), length, d, b, hdim, plan.units, plan.threads,
                    plan.smem_bwd, stream)
            _raise_if_too_large(rc, "gru_sequence_bwd", plan)
    check(rc, "gru_sequence_bwd")
    gru_sequence_bwd.launches += 1
    gru_sequence_bwd.launches_by_body["step" if plan == "step" else "persistent"] += 1
    return dxp, dw, db


def gru_sequence_bwd(
    gates: torch.Tensor, w_hh: torch.Tensor, ys: torch.Tensor, dys: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of the scan from the stored gates: ``gates [L, D, B,
    4H]``, ``w_hh [D, H, 3H]``, ``ys`` and ``dys [L, D, B, H]`` ->
    ``(dxp [L, D, B, 3H]`` in the gates' dtype, ``dW_hh [D, H, 3H]`` and
    ``db_hh [D, 3H]`` in float32)."""
    if gates.device.type == "cpu":
        return gru_sequence_bwd_plain(gates, w_hh, ys, dys)
    if gates.device.type != "cuda":
        raise ValueError(f"gru_sequence_bwd: unsupported device {gates.device}")
    return scan_backward(gates, w_hh, ys, dys)


for _wrapper in (gru_sequence, gru_sequence_gates, gru_sequence_bwd):
    _wrapper.launches = 0
    _wrapper.launches_by_body = {"persistent": 0, "step": 0}


class GRUScan(torch.autograd.Function):
    """``gru_sequence`` with the custom VJP of ``gru_scan.py:151-273``: the
    forward stores the gates (``gru_sequence_gates``), the backward runs
    ``gru_sequence_bwd`` and casts dW_hh and db_hh to the parameters'
    dtypes. ``plain`` runs both as their plain versions."""

    @staticmethod
    def forward(ctx, xp, w_hh, b_hh, plain):
        fwd = gru_sequence_gates_plain if plain else gru_sequence_gates
        ys, gates = fwd(xp, w_hh, b_hh)
        ctx.save_for_backward(gates, w_hh, ys)
        ctx.plain = plain
        ctx.b_dtype = b_hh.dtype
        return ys

    @staticmethod
    def backward(ctx, dys):
        gates, w_hh, ys = ctx.saved_tensors
        bwd = gru_sequence_bwd_plain if ctx.plain else gru_sequence_bwd
        dxp, dw, db = bwd(gates, w_hh, ys, dys.to(ys.dtype))
        return dxp, dw.to(w_hh.dtype), db.to(ctx.b_dtype), None


def gru_scan(
    xp: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor, *,
    plain: bool = False,
) -> torch.Tensor:
    """A GRU layer's scan as the model runs it: with grad enabled and an
    input that requires it, ``GRUScan`` (training forward, then the backward
    kernel); otherwise the inference forward, the operator
    ``torch.ops.nsd_torch.gru_sequence`` (``library.py``; what
    ``torch.export`` records). ``plain`` takes the kernels' plain versions."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xp, w_hh, b_hh)):
        return GRUScan.apply(xp, w_hh, b_hh, plain)
    if plain:
        return gru_sequence_plain(xp, w_hh, b_hh)
    return torch.ops.nsd_torch.gru_sequence(xp, w_hh, b_hh)
