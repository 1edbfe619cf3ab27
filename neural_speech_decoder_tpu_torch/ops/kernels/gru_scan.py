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
kernel (one call scans a whole layer). ``gru_scan`` is what the model
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

import torch

from ._build import check, load_library


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


def gru_sequence_bwd_plain(
    gates: torch.Tensor, w_hh: torch.Tensor, ys: torch.Tensor, dys: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``gru_sequence_bwd`` in plain PyTorch, step by step as
    ``_bwd_kernel``: ``(dxp [L, D, B, 3H]`` in the gates' dtype,
    ``dW_hh [D, H, 3H]`` float32, ``db_hh [D, 3H]`` float32)."""
    length, d, b, four_h = gates.shape
    hdim = four_h // 4
    dt = gates.dtype
    dirs = torch.arange(d, device=gates.device)
    t_idx = _scan_times(length, d, gates.device)
    wt = w_hh.to(dt).transpose(1, 2).float()  # [D, 3H, H]
    dh = torch.zeros((d, b, hdim), dtype=torch.float32, device=gates.device)
    dw = torch.zeros((d, hdim, 3 * hdim), dtype=torch.float32, device=gates.device)
    db = torch.zeros((d, 3 * hdim), dtype=torch.float32, device=gates.device)
    dxp = gates.new_empty((length, d, b, 3 * hdim))
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
        dhp_n = da_n * r
        dhp = torch.cat([da_r, da_z, dhp_n], dim=-1).to(dt).float()
        dxp[t, dirs] = torch.cat([da_r, da_z, da_n], dim=-1).to(dt)
        dw += torch.bmm(hprev.to(dt).float().transpose(1, 2), dhp)
        db += dhp.sum(dim=1)
        dh = dh_tot * z + torch.bmm(dhp, wt)
    return dxp, dw, db


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


def _run_scan(what, base, xp, w_hh, b_hh, with_gates):
    """Launch the forward scan kernel; ``(ys, gates or None)``."""
    _check_scan_args(what, xp, w_hh, b_hh)
    fn = _entry(what, base, xp.dtype)
    length, d, b, three_h = xp.shape
    hdim = three_h // 3
    xp = xp.contiguous()
    w = w_hh.to(xp.dtype).contiguous()
    bias = b_hh.float().contiguous()
    ys = xp.new_empty((length, d, b, hdim))
    gates = xp.new_empty((length, d, b, 4 * hdim)) if with_gates else None
    if ys.numel() == 0:
        return ys, gates
    carry = torch.empty((2, d, b, hdim), dtype=torch.float32, device=xp.device)
    ptrs = [xp.data_ptr(), w.data_ptr(), bias.data_ptr(), ys.data_ptr()]
    if with_gates:
        ptrs.append(gates.data_ptr())
    with torch.cuda.device(xp.device):
        rc = fn(*ptrs, carry.data_ptr(), length, d, b, hdim,
                torch.cuda.current_stream().cuda_stream)
    check(rc, what)
    return ys, gates


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
    ys, _ = _run_scan("gru_sequence", "nsd_gru_scan", xp, w_hh, b_hh, False)
    gru_sequence.launches += 1
    return ys


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
    out = _run_scan("gru_sequence_gates", "nsd_gru_scan_gates", xp, w_hh,
                    b_hh, True)
    gru_sequence_gates.launches += 1
    return out


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
    fn = _entry("gru_sequence_bwd", "nsd_gru_bwd", gates.dtype)
    dt = gates.dtype
    gates = gates.contiguous()
    # W^T once, so that the step product reads contiguous rows (gru_scan.py:230)
    wt = w_hh.to(dt).transpose(1, 2).contiguous()
    ys = ys.to(dt).contiguous()
    dys = dys.to(dt).contiguous()
    dxp = gates.new_empty((length, d, b, 3 * hdim))
    # dhp's n third; its r and z thirds are dxp's
    dhp_n = gates.new_empty((length, d, b, hdim))
    dw = torch.empty((d, hdim, 3 * hdim), dtype=torch.float32, device=gates.device)
    db = torch.empty((d, 3 * hdim), dtype=torch.float32, device=gates.device)
    if dxp.numel() == 0:
        return dxp, dw.zero_(), db.zero_()
    dhz = torch.empty((d, b, hdim), dtype=torch.float32, device=gates.device)
    with torch.cuda.device(gates.device):
        rc = fn(gates.data_ptr(), wt.data_ptr(), ys.data_ptr(), dys.data_ptr(),
                dxp.data_ptr(), dhp_n.data_ptr(), dw.data_ptr(), db.data_ptr(),
                dhz.data_ptr(), length, d, b, hdim,
                torch.cuda.current_stream().cuda_stream)
    check(rc, "gru_sequence_bwd")
    gru_sequence_bwd.launches += 1
    return dxp, dw, db


gru_sequence.launches = 0
gru_sequence_gates.launches = 0
gru_sequence_bwd.launches = 0


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
    kernel); otherwise the inference forward. ``plain`` takes the kernels'
    plain versions."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xp, w_hh, b_hh)):
        return GRUScan.apply(xp, w_hh, b_hh, plain)
    return (gru_sequence_plain if plain else gru_sequence)(xp, w_hh, b_hh)
