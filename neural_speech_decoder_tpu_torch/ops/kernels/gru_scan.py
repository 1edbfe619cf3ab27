"""Kernel 2: the forward time scan of a (bi)directional GRU layer,
hand-written in CUDA (``csrc/gru_scan.cu``).

Replaces the inference forward of ``neural_speech_decoder_tpu/ops/pallas/
gru_scan.py::gru_sequence`` (``_fwd_kernel``). ``gru_sequence`` launches the
kernel for a CUDA tensor and runs ``gru_sequence_plain``, the same function
in plain PyTorch, for a CPU tensor; it raises for any other device.
``gru_sequence.launches`` counts its calls that launched the kernel (one
call scans a whole layer).

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


def gru_cell(
    x_t: torch.Tensor, h: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor
) -> torch.Tensor:
    """One step for every direction: ``x_t [D, B, 3H]`` (input projections
    with b_ih), carry ``h [D, B, H]`` in any dtype, ``w_hh [D, H, 3H]``,
    ``b_hh [D, 3H]`` -> the new state in float32.

    ``hp = h @ W_hh + b_hh`` with h and W_hh in x_t's dtype and float32
    accumulation; ``r, z = sigmoid(x + hp)``; ``n = tanh(x_n + r * hp_n)``
    (b_hh's n part inside the product with r); ``h' = (1-z) n + z h``.
    """
    hdim = h.shape[-1]
    w = w_hh.to(x_t.dtype).float()
    hp = torch.bmm(h.to(x_t.dtype).float(), w) + b_hh.float()[:, None, :]
    x = x_t.float()
    r = torch.sigmoid(x[..., :hdim] + hp[..., :hdim])
    z = torch.sigmoid(x[..., hdim : 2 * hdim] + hp[..., hdim : 2 * hdim])
    n = torch.tanh(x[..., 2 * hdim :] + r * hp[..., 2 * hdim :])
    return (1.0 - z) * n + z * h.float()


def gru_sequence_plain(
    xp: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``xp [L, D, B, 3H]`` in
    natural time order for both directions -> ``ys [L, D, B, H]`` in natural
    order, zero initial state, direction 1 walked in reverse."""
    length, d, b, three_h = xp.shape
    hdim = three_h // 3
    dirs = torch.arange(d, device=xp.device)
    steps = torch.arange(length, device=xp.device)
    # time index of scan position s: s for direction 0, L-1-s for direction 1
    t_idx = torch.stack([steps, length - 1 - steps], dim=1)[:, :d]
    h = torch.zeros((d, b, hdim), dtype=torch.float32, device=xp.device)
    ys = xp.new_empty((length, d, b, hdim))
    for s in range(length):
        h = gru_cell(xp[t_idx[s], dirs], h, w_hh, b_hh)
        ys[t_idx[s], dirs] = h.to(ys.dtype)
    return ys


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
    entry = {torch.float32: "nsd_gru_scan_f32",
             torch.bfloat16: "nsd_gru_scan_bf16"}.get(xp.dtype)
    if entry is None:
        raise TypeError(f"gru_sequence: unsupported dtype {xp.dtype}")
    length, d, b, three_h = xp.shape
    hdim = three_h // 3
    if (three_h % 3 or d not in (1, 2) or tuple(w_hh.shape) != (d, hdim, three_h)
            or tuple(b_hh.shape) != (d, three_h)):
        raise ValueError(
            f"gru_sequence: xp {tuple(xp.shape)}, w_hh {tuple(w_hh.shape)}, "
            f"b_hh {tuple(b_hh.shape)} do not fit [L,D,B,3H]/[D,H,3H]/[D,3H]"
        )
    for name, t in (("w_hh", w_hh), ("b_hh", b_hh)):
        if t.device != xp.device:
            raise ValueError(f"gru_sequence: {name} on {t.device}, xp on {xp.device}")
    xp = xp.contiguous()
    w = w_hh.to(xp.dtype).contiguous()
    bias = b_hh.float().contiguous()
    ys = xp.new_empty((length, d, b, hdim))
    if ys.numel() == 0:
        return ys
    carry = torch.empty((2, d, b, hdim), dtype=torch.float32, device=xp.device)
    fn = getattr(load_library(), entry)
    with torch.cuda.device(xp.device):
        rc = fn(
            xp.data_ptr(), w.data_ptr(), bias.data_ptr(), ys.data_ptr(),
            carry.data_ptr(), length, d, b, hdim,
            torch.cuda.current_stream().cuda_stream,
        )
    check(rc, "gru_sequence")
    gru_sequence.launches += 1
    return ys


gru_sequence.launches = 0
