"""Greedy CTC decoding and phoneme error rate.

Port of ``neural_speech_decoder_tpu/ops/decode.py`` (whose module imports
jax): the batched greedy decode runs on the tensors' device; the edit
distance and PER run on the host.
"""

from __future__ import annotations

import numpy as np
import torch


def greedy_decode(
    log_probs: torch.Tensor, input_lens: torch.Tensor, *, blank_id: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched greedy CTC decode: argmax per frame over the valid frames,
    collapse repeats, drop blanks.

    ``log_probs [B, T, K]`` (any monotone score), ``input_lens [B]``.
    Returns ``(tokens [B, T], lens [B])``: the label ids left-packed and
    zero-padded.
    """
    b, t, _ = log_probs.shape
    ids = log_probs.argmax(dim=-1)  # [B, T]
    frames = torch.arange(t, device=ids.device)
    valid = frames[None, :] < input_lens.to(ids.device)[:, None]
    prev = torch.cat([ids.new_full((b, 1), -1), ids[:, :-1]], dim=1)
    keep = valid & (ids != prev) & (ids != blank_id)
    pos = keep.long().cumsum(dim=1) - 1
    rows = torch.arange(b, device=ids.device)[:, None].expand(b, t)
    tokens = torch.zeros_like(ids)
    tokens[rows[keep], pos[keep]] = ids[keep]
    return tokens, keep.sum(dim=1)


def edit_distance(a, b) -> int:
    """Levenshtein distance between two sequences of comparable items."""
    a = list(a)
    b = list(b)
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i] + [0] * len(b)
        for j, cb in enumerate(b, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb))
        prev = cur
    return prev[len(b)]


def batch_per(
    decoded: np.ndarray,
    decoded_lens: np.ndarray,
    targets: np.ndarray,
    target_lens: np.ndarray,
) -> tuple[int, int]:
    """Summed edit distance and summed target length over a batch; the PER
    is their ratio."""
    total_dist = 0
    total_len = 0
    for i in range(len(decoded_lens)):
        hyp = decoded[i, : decoded_lens[i]]
        ref = targets[i, : target_lens[i]]
        total_dist += edit_distance(ref, hyp)
        total_len += int(target_lens[i])
    return total_dist, total_len
