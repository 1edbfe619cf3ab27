"""Batched CTC prefix beam search (no LM) on the tensors' device.

Port of ``neural_speech_decoder_tpu/decoding/ondevice_beam.py``: standard
prefix beam search (Hannun et al.), exact up to the pruning width. Per
frame, the top ``top_k_tokens`` tokens extend each of the ``W`` beams; an
extension that recreates an existing beam's prefix folds its mass into that
beam's stay candidate (a content comparison of the prefixes), and the best
``W`` of the ``W`` stays and ``W * top_k_tokens`` extensions survive. Blank
id 0.

Two surfaces, as in the JAX package:

- ``prefix_beam_search(log_probs, input_lens)``: whole utterances at once;
- ``beam_init`` / ``beam_extend`` / ``beam_finalize``: carried state for
  streaming, exactly chunk-boundary-invariant
  (``beam_extend(beam_extend(s, a), b) == beam_extend(s, cat(a, b))``).

JAX ``vmap``s one stream's step over the batch; here the step is written
over ``[B, W, ...]`` directly, and the time scan is a Python loop over
frames. Ties keep JAX's order: ``lax.top_k`` puts the lower index first
among equal values, and at ``beam_init`` W-1 beams are dead at ``NEG_INF``,
so ties are everywhere; ``torch.topk``'s order among ties is unspecified,
so every selection is a stable descending sort, sliced
(``_top``), and ``beam_finalize``'s ordering a stable sort too.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

NEG_INF = -1e30


class BeamState(NamedTuple):
    """Carried beam-search state. Leaves lead with ``[B, W, ...]``."""

    prefixes: torch.Tensor  # [B, W, L_cap] int32, zero-padded
    lens: torch.Tensor  # [B, W] int32
    last: torch.Tensor  # [B, W] int32, -1 = empty prefix
    p_b: torch.Tensor  # [B, W] float32 log-mass ending in blank
    p_nb: torch.Tensor  # [B, W] float32 log-mass ending in non-blank


def _logsum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    mx = torch.maximum(a, b)
    mn = torch.minimum(a, b)
    safe = torch.where(mx <= NEG_INF, NEG_INF, mx + torch.log1p(torch.exp(mn - mx)))
    return torch.where(mn <= NEG_INF, mx, safe)


def _top(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: the k largest, lower index first
    among equal values."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _beam_step(state: BeamState, frame: torch.Tensor, top_k_tokens: int,
               blank_id: int) -> BeamState:
    """One frame's update of every stream's beams; ``frame [B, K]``."""
    prefixes, lens, last, p_b, p_nb = state
    b, w, l_cap = prefixes.shape
    tot = _logsum(p_b, p_nb)
    top_lp, top_ids = _top(frame, top_k_tokens)  # [B, K']

    # stay candidates (same prefix)
    stay_pb = tot + frame[:, blank_id, None]
    rep = frame.gather(1, last.clamp(min=0).long())
    stay_pnb = p_nb + torch.where(last >= 0, rep, NEG_INF)

    # extension candidates [B, W, K']
    is_rep = top_ids[:, None, :] == last[:, :, None]
    src = torch.where(is_rep, p_b[:, :, None], tot[:, :, None])
    ext_valid = (top_ids != blank_id)[:, None, :]
    ext_pnb = torch.where(ext_valid, src + top_lp[:, None, :], NEG_INF)

    # merge extensions that recreate an existing beam: pm[b, i, j] says
    # prefix_j == prefix_i + one token, content-equal over lens_i positions
    eq = prefixes[:, :, None, :] == prefixes[:, None, :, :]  # [B, W, W, L]
    pos = torch.arange(l_cap, device=prefixes.device)
    ignored = pos[None, None, None, :] >= lens[:, :, None, None]
    pm = (eq | ignored).all(dim=-1) & (lens[:, None, :] == lens[:, :, None] + 1)
    # match[b, i, kk, j]
    match = (pm[:, :, None, :]
             & (top_ids[:, None, :, None] == last[:, None, None, :])
             & ext_valid[:, :, :, None])
    contrib = torch.where(match, ext_pnb[:, :, :, None], NEG_INF)
    mx = contrib.amax(dim=(1, 2))  # [B, W]
    total = torch.where(match, torch.exp(contrib - mx[:, None, None, :]), 0.0).sum(dim=(1, 2))
    merged = torch.where(mx <= NEG_INF, NEG_INF, mx + torch.log(total + 1e-37))
    stay_pnb = _logsum(stay_pnb, merged)
    ext_pnb = torch.where(match.any(dim=-1), NEG_INF, ext_pnb)

    # the top W among W stays + W*K' extensions
    stay_tot = _logsum(stay_pb, stay_pnb)
    cand = torch.cat([stay_tot, ext_pnb.reshape(b, -1)], dim=1)
    sel_scores, sel_idx = _top(cand, w)
    is_stay = sel_idx < w
    parent = torch.where(is_stay, sel_idx, (sel_idx - w) // top_k_tokens)
    tok_pos = torch.where(is_stay, 0, (sel_idx - w) % top_k_tokens)
    token = top_ids.gather(1, tok_pos).to(torch.int32)

    new_prefixes = prefixes.gather(1, parent[:, :, None].expand(b, w, l_cap))
    new_lens = lens.gather(1, parent)
    new_last = last.gather(1, parent)
    # the extension token at position len (extensions only); at capacity the
    # stored prefix stays and the length is clamped (over-cap beams carry a
    # truncated tail, as JAX)
    at = new_lens.clamp(max=l_cap - 1).long()[:, :, None]
    wrote = new_prefixes.scatter(2, at, token[:, :, None])
    at_cap = new_lens >= l_cap
    new_prefixes = torch.where((is_stay | at_cap)[:, :, None], new_prefixes, wrote)
    new_lens = torch.where(is_stay, new_lens, (new_lens + 1).clamp(max=l_cap))
    new_last = torch.where(is_stay, new_last, token)
    new_pb = torch.where(is_stay, stay_pb.gather(1, parent), NEG_INF)
    new_pnb = torch.where(is_stay, stay_pnb.gather(1, parent), sel_scores)
    return BeamState(new_prefixes, new_lens, new_last, new_pb, new_pnb)


def beam_init(batch: int, beam_width: int, max_len: int, dtype=torch.float32,
              device: torch.device | str = "cuda") -> BeamState:
    """Fresh state: one live beam (the empty prefix) per stream.
    ``max_len`` caps the decodable label-sequence length."""
    w = beam_width
    p_b = torch.full((batch, w), NEG_INF, dtype=dtype, device=device)
    p_b[:, 0] = 0.0
    return BeamState(
        prefixes=torch.zeros((batch, w, max_len), dtype=torch.int32, device=device),
        lens=torch.zeros((batch, w), dtype=torch.int32, device=device),
        last=torch.full((batch, w), -1, dtype=torch.int32, device=device),
        p_b=p_b,
        p_nb=torch.full((batch, w), NEG_INF, dtype=dtype, device=device),
    )


def beam_extend(state: BeamState, log_probs: torch.Tensor, *, top_k_tokens: int = 8,
                blank_id: int = 0) -> BeamState:
    """Advance every stream's beams by ``log_probs [B, T_chunk, K]`` (every
    frame is consumed: mask or slice invalid frames on the caller's side)."""
    top_k_tokens = min(top_k_tokens, log_probs.shape[-1])
    for t in range(log_probs.shape[1]):
        state = _beam_step(state, log_probs[:, t], top_k_tokens, blank_id)
    return state


def _sorted(prefixes, lens, p_b, p_nb):
    scores = _logsum(p_b, p_nb)
    order = torch.sort(-scores, dim=1, stable=True).indices
    l_cap = prefixes.shape[2]
    return (prefixes.gather(1, order[:, :, None].expand(-1, -1, l_cap)),
            lens.gather(1, order), scores.gather(1, order))


def beam_finalize(state: BeamState):
    """Beams best-first: ``(prefixes [B, W, L], lens [B, W], scores [B, W])``."""
    return _sorted(state.prefixes, state.lens, state.p_b, state.p_nb)


def prefix_beam_search(log_probs: torch.Tensor, input_lens: torch.Tensor, *,
                       beam_width: int = 8, top_k_tokens: int = 8,
                       blank_id: int = 0):
    """Batched prefix beam search over whole utterances.

    ``log_probs [B, T, K]`` per-frame log-probs, ``input_lens [B]`` valid
    frame counts (frames past them leave a stream's state untouched) ->
    ``(prefixes [B, W, T], lens [B, W], scores [B, W])``, the n-best label
    sequences (zero-padded) best-first per row.
    """
    b, t_max, k = log_probs.shape
    top_k_tokens = min(top_k_tokens, k)
    state = beam_init(b, beam_width, t_max, device=log_probs.device)
    valid = input_lens.to(log_probs.device)
    for t in range(t_max):
        new = _beam_step(state, log_probs[:, t], top_k_tokens, blank_id)
        keep = t < valid  # [B]
        state = BeamState(*(torch.where(keep.view(-1, *(1,) * (n.dim() - 1)), n, o)
                            for n, o in zip(new, state)))
    return _sorted(state.prefixes, state.lens, state.p_b, state.p_nb)
