"""The CTC loss's alpha and beta recursions, hand-written in CUDA
(``csrc/ctc.cu``), and the per-sequence loss around them.

Replaces ``neural_speech_decoder_tpu/ops/pallas/ctc_kernel.py::
ctc_loss_tpu``: ``ctc_alpha`` is its ``_alpha_kernel`` and ``ctc_beta`` its
``_beta_kernel``. Each launches its kernel for a CUDA tensor and runs its
``*_plain`` twin, the same recursion in plain PyTorch, for a CPU tensor; it
raises for any other device. ``<wrapper>.launches`` counts the kernel's
launches.

Each recursion has two bodies in ``csrc/ctc.cu``, which ``ctc_plan`` picks
from the number of extended states S before any launch: ``"prefetch"``
(one block a row, one state a thread in a register, one barrier a frame,
the lpz rows requested three frames ahead and beta's neighbour terms read
from shared memory, so no global load waits on the dependent path; S <=
``PREFETCH_MAX_STATES``) and ``"block"`` (PR 2's body: the states in shared
memory, the frame's lpz loaded after the barrier; any S). Both give the
same bits. ``ctc_alpha.launches_by_body`` and ``ctc_beta.launches_by_body``
count launches by body; ``body="block"`` forces the block body (an A/B),
and a body S cannot take raises.

The glue stays plain tensor code, as the JAX package leaves it to XLA:
``prepare`` (the extended-label arrays), ``loss_from_alpha`` and the
gradient assembly of ``CTCLoss.backward``. Everything is float32 whatever
the model computes in. The ``-1e30`` sentinel stands for log 0, so an
infeasible row's loss is the finite ``1e30`` with a finite gradient, which
the caller masks (``ops/ctc.py``, ``zero_infinity``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import check, load_library

NEG_INF = -1e30
PREFETCH_MAX_STATES = 256  # csrc/ctc.cu kPrefetchStates: one state a thread


def logsum3(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``log(e^a + e^b + e^c)`` with ``ctc_kernel.py::_logsum3``'s rules: the
    maximum is clamped at ``NEG_INF / 2`` inside the exponentials, and a
    maximum at or below ``NEG_INF`` gives ``NEG_INF``."""
    mx = torch.maximum(torch.maximum(a, b), c)
    mx_safe = mx.clamp_min(NEG_INF / 2)
    out = mx + torch.log(
        torch.exp(a - mx_safe) + torch.exp(b - mx_safe) + torch.exp(c - mx_safe)
    )
    return torch.where(mx <= NEG_INF, NEG_INF, out)


def _shift(x: torch.Tensor, n: int) -> torch.Tensor:
    """Lanes moved n places along the last dim (right for n > 0, left for
    n < 0), filled with ``NEG_INF``."""
    s = x.shape[-1]
    pad = x.new_full(x.shape[:-1] + (abs(n),), NEG_INF)
    if n > 0:
        return torch.cat([pad, x], dim=-1)[..., :s]
    return torch.cat([x, pad], dim=-1)[..., -n:]


def ctc_alpha_plain(
    lpz: torch.Tensor, skip: torch.Tensor, lens: torch.Tensor
) -> torch.Tensor:
    """``ctc_alpha`` in plain PyTorch, frame by frame as ``_alpha_kernel``."""
    t_max = lpz.shape[0]
    frozen = torch.arange(t_max, device=lpz.device)[:, None] >= lens.to(
        lpz.device)[None, :]  # [T, B]
    s_idx = torch.arange(lpz.shape[-1], device=lpz.device)
    a = torch.where(s_idx <= 1, lpz[0], NEG_INF)
    alpha = [a]
    for t in range(1, t_max):
        new = logsum3(a, _shift(a, 1), _shift(a, 2) + skip) + lpz[t]
        a = torch.where(frozen[t][:, None], a, new)
        alpha.append(a)
    return torch.stack(alpha)


def ctc_beta_plain(
    lpz: torch.Tensor, skip: torch.Tensor, lens: torch.Tensor, s_end: torch.Tensor
) -> torch.Tensor:
    """``ctc_beta`` in plain PyTorch, frame by frame (last first) as
    ``_beta_kernel``."""
    t_max = lpz.shape[0]
    lens = lens.to(lpz.device)[:, None]
    b = torch.full_like(lpz[0], NEG_INF)
    beta = [None] * t_max
    for t in reversed(range(t_max)):
        term = b + lpz[min(t + 1, t_max - 1)]
        new = logsum3(term, _shift(term, -1), _shift(term + skip, -2))
        b = torch.where(t == lens - 1, s_end, torch.where(t >= lens, b, new))
        beta[t] = b
    return torch.stack(beta)


def _check(what, lpz, **others):
    if lpz.dim() != 3 or lpz.dtype != torch.float32:
        raise ValueError(f"{what}: lpz must be float32 [T, B, S], got "
                         f"{lpz.dtype} {tuple(lpz.shape)}")
    t, b, s = lpz.shape
    for name, (x, shape, dtype) in others.items():
        if tuple(x.shape) != shape or x.dtype != dtype or x.device != lpz.device:
            raise ValueError(
                f"{what}: {name} must be {dtype} {shape} on {lpz.device}, got "
                f"{x.dtype} {tuple(x.shape)} on {x.device}")


def ctc_plan(n_states: int) -> str:
    """The body a recursion over ``n_states`` extended states runs on:
    ``"prefetch"`` for 1 <= S <= ``PREFETCH_MAX_STATES`` (a block of one
    thread a state), else ``"block"``."""
    return "prefetch" if 1 <= n_states <= PREFETCH_MAX_STATES else "block"


def _body(what: str, n_states: int, body: str | None) -> str:
    plan = ctc_plan(n_states)
    if body is None:
        return plan
    if body in (plan, "block"):
        return body
    raise ValueError(f"{what}: body {body!r} does not take S={n_states} (the prefetch "
                     f"body takes 1 <= S <= {PREFETCH_MAX_STATES})")


def ctc_alpha(
    lpz: torch.Tensor, skip: torch.Tensor, lens: torch.Tensor, *, body: str | None = None
) -> torch.Tensor:
    """The alpha recursion: ``lpz [T, B, S]``, ``skip [B, S]`` (0 or
    ``NEG_INF``), ``lens [B]`` int32 -> ``alpha [T, B, S]``, all float32.
    ``body`` (``"prefetch"`` or ``"block"``) overrides ``ctc_plan`` on the
    card."""
    if lpz.device.type == "cpu":
        return ctc_alpha_plain(lpz, skip, lens)
    if lpz.device.type != "cuda":
        raise ValueError(f"ctc_alpha: unsupported device {lpz.device}")
    t, b, s = lpz.shape
    _check("ctc_alpha", lpz, skip=(skip, (b, s), torch.float32),
           lens=(lens, (b,), torch.int32))
    body = _body("ctc_alpha", s, body)
    lpz, skip, lens = lpz.contiguous(), skip.contiguous(), lens.contiguous()
    alpha = torch.empty_like(lpz)
    if alpha.numel() == 0:
        return alpha
    entry = "nsd_ctc_alpha_prefetch" if body == "prefetch" else "nsd_ctc_alpha"
    with torch.cuda.device(lpz.device):
        rc = getattr(load_library(), entry)(
            lpz.data_ptr(), skip.data_ptr(), lens.data_ptr(), alpha.data_ptr(),
            t, b, s, torch.cuda.current_stream().cuda_stream)
    check(rc, f"ctc_alpha ({body})")
    ctc_alpha.launches += 1
    ctc_alpha.launches_by_body[body] += 1
    return alpha


def ctc_beta(
    lpz: torch.Tensor, skip: torch.Tensor, lens: torch.Tensor, s_end: torch.Tensor, *,
    body: str | None = None
) -> torch.Tensor:
    """The beta recursion: ``ctc_alpha``'s inputs and ``s_end [B, S]`` (0 at
    the two final states) -> ``beta [T, B, S]``, all float32. ``body`` as
    ``ctc_alpha``'s."""
    if lpz.device.type == "cpu":
        return ctc_beta_plain(lpz, skip, lens, s_end)
    if lpz.device.type != "cuda":
        raise ValueError(f"ctc_beta: unsupported device {lpz.device}")
    t, b, s = lpz.shape
    _check("ctc_beta", lpz, skip=(skip, (b, s), torch.float32),
           lens=(lens, (b,), torch.int32), s_end=(s_end, (b, s), torch.float32))
    body = _body("ctc_beta", s, body)
    lpz, skip, lens, s_end = (x.contiguous() for x in (lpz, skip, lens, s_end))
    beta = torch.empty_like(lpz)
    if beta.numel() == 0:
        return beta
    entry = "nsd_ctc_beta_prefetch" if body == "prefetch" else "nsd_ctc_beta"
    with torch.cuda.device(lpz.device):
        rc = getattr(load_library(), entry)(
            lpz.data_ptr(), skip.data_ptr(), lens.data_ptr(), s_end.data_ptr(),
            beta.data_ptr(), t, b, s, torch.cuda.current_stream().cuda_stream)
    check(rc, f"ctc_beta ({body})")
    ctc_beta.launches += 1
    ctc_beta.launches_by_body[body] += 1
    return beta


ctc_alpha.launches = 0
ctc_beta.launches = 0
ctc_alpha.launches_by_body = {"prefetch": 0, "block": 0}
ctc_beta.launches_by_body = {"prefetch": 0, "block": 0}


def prepare(log_probs, labels, label_lens, input_lens):
    """The extended-label arrays of ``ctc_kernel.py::_prepare``, unpadded
    (S = 2U+1): ``(lp [B, T, K], lpz [T, B, S], z [B, S], skip [B, S],
    s_end [B, S], lens [B] int32)``."""
    b, t_max, _ = log_probs.shape
    u = labels.shape[1]
    s = 2 * u + 1
    dev = log_probs.device
    lp = torch.log_softmax(log_probs.float(), dim=-1)
    label_lens = label_lens.to(dev).long()
    z = torch.zeros((b, s), dtype=torch.long, device=dev)
    z[:, 1::2] = labels.to(dev).long()
    s_idx = torch.arange(s, device=dev)[None, :]
    valid = s_idx < 2 * label_lens[:, None] + 1
    lpz = torch.gather(lp, 2, z[:, None, :].expand(b, t_max, s))
    lpz = torch.where(valid[:, None, :], lpz, NEG_INF)
    lpz = lpz.transpose(0, 1).contiguous()  # [T, B, S]
    # skip transition into state s allowed iff z_s != blank and z_s != z_{s-2}
    z_m2 = F.pad(z, (2, 0))[:, :s]
    skip_ok = (z != 0) & (z != z_m2) & (s_idx >= 2)
    skip = torch.where(skip_ok & valid, 0.0, NEG_INF)
    # beta's start: 0 at s in {2u, 2u-1}, else NEG_INF
    end_hi = 2 * label_lens[:, None]
    s_end = torch.where((s_idx == end_hi) | (s_idx == (end_hi - 1).clamp_min(0)),
                        0.0, NEG_INF)
    lens = input_lens.to(dev).to(torch.int32)
    return lp, lpz, z, skip, s_end, lens


def loss_from_alpha(alpha, input_lens, label_lens):
    """Per-sequence NLL from the alpha rows at each row's last frame
    (``ctc_kernel.py::_loss_from_alpha``); ``1e30`` where no path exists."""
    t_max, b, _ = alpha.shape
    dev = alpha.device
    t_idx = (input_lens.to(dev).long() - 1).clamp(0, t_max - 1)
    last = alpha[t_idx, torch.arange(b, device=dev)]  # [B, S]
    hi = 2 * label_lens.to(dev).long()
    lo = (hi - 1).clamp_min(0)
    a_hi = torch.gather(last, 1, hi[:, None])[:, 0]
    a_lo = torch.gather(last, 1, lo[:, None])[:, 0]
    # empty target: one final state (hi == lo == 0), not counted twice
    a_lo = torch.where(hi == 0, NEG_INF, a_lo)
    mx = torch.maximum(a_hi, a_lo)
    mx_safe = mx.clamp_min(NEG_INF / 2)
    logp = mx + torch.log(torch.exp(a_hi - mx_safe) + torch.exp(a_lo - mx_safe))
    return -torch.where(mx <= NEG_INF, NEG_INF, logp)


class CTCLoss(torch.autograd.Function):
    """``ctc_loss_tpu``'s custom VJP: alpha in the forward, beta in the
    backward, gradient ``softmax(u) - gamma`` with respect to the input
    (read as logits: log_softmax is idempotent)."""

    @staticmethod
    def forward(ctx, log_probs, input_lens, labels, label_lens, plain):
        lp, lpz, z, skip, s_end, lens = prepare(
            log_probs, labels, label_lens, input_lens)
        alpha = (ctc_alpha_plain if plain else ctc_alpha)(lpz, skip, lens)
        loss = loss_from_alpha(alpha, input_lens, label_lens)
        ctx.save_for_backward(lp, lpz, z, skip, s_end, lens, alpha, loss)
        ctx.plain = plain
        ctx.in_dtype = log_probs.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        lp, lpz, z, skip, s_end, lens, alpha, loss = ctx.saved_tensors
        t_max = lpz.shape[0]
        beta = (ctc_beta_plain if ctx.plain else ctc_beta)(lpz, skip, lens, s_end)
        log_gamma = alpha + beta + loss[None, :, None]  # -(-log P)
        gamma = torch.exp(log_gamma.clamp_max(0.0))
        t_valid = (torch.arange(t_max, device=lp.device)[:, None]
                   < lens.long()[None, :])  # [T, B]
        gamma = torch.where(t_valid[:, :, None], gamma, 0.0)
        # extended states back to classes through a one-hot product (as the
        # JAX package): a fixed summation order, where a scatter-add on the
        # card would add in whatever order its atomics land
        onehot = F.one_hot(z, lp.shape[-1]).float()  # [B, S, K]
        gamma_k = torch.bmm(gamma.transpose(0, 1), onehot)  # [B, T, K]
        du = torch.exp(lp) * t_valid.T[:, :, None] - gamma_k
        du = du * g.float()[:, None, None]
        return du.to(ctx.in_dtype), None, None, None, None


def ctc_loss_kernel(
    log_probs: torch.Tensor,
    input_lens: torch.Tensor,
    labels: torch.Tensor,
    label_lens: torch.Tensor,
    *,
    plain: bool = False,
) -> torch.Tensor:
    """Per-sequence CTC NLL, blank id 0: ``log_probs [B, T, K]`` (log-probs
    or logits), ``input_lens [B]``, ``labels [B, U]``, ``label_lens [B]`` ->
    ``[B]`` float32, ``1e30`` for infeasible rows. ``plain`` runs the
    recursions' plain versions."""
    return CTCLoss.apply(log_probs, input_lens, labels, label_lens, plain)
