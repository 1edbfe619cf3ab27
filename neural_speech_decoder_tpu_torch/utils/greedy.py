"""Incremental CTC greedy collapse for the streamers (numpy, no model code).

The port's own copy of ``neural_speech_decoder_tpu/utils/greedy.py``:
argmax per frame -> collapse consecutive repeats -> drop blanks (id 0).
``prev`` carries the last argmax id per stream across calls, so chunked
decoding equals one offline pass; seed it with -1 (no previous frame).
"""

from __future__ import annotations

import numpy as np


def incremental_greedy(
    logits: np.ndarray, prev: np.ndarray
) -> list[list[int]]:
    """``logits [B, m, K]`` (any monotone score: raw logits or log-probs),
    ``prev [B]`` int64 carried collapse state (mutated in place). Returns
    the newly emitted label ids per stream."""
    b = logits.shape[0]
    out: list[list[int]] = [[] for _ in range(b)]
    if logits.shape[1] == 0:
        return out
    ids = np.argmax(np.asarray(logits), axis=-1)  # [B, m]
    for bi in range(b):
        p = prev[bi]
        for tok in ids[bi]:
            if tok != p and tok != 0:
                out[bi].append(int(tok))
            p = tok
        prev[bi] = p
    return out
