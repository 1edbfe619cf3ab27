"""Seeds derived from a run's ``--seed``.

Every random draw of a run (traffic, weights, each train step's noise and
dropout) takes its own seed from ``derive(seed, tag, ...)``, so that the
same ``--seed`` gives the same inputs and the draws do not overlap. The
seed may be any whole number, larger than 32 bits included.
"""

from __future__ import annotations

import numpy as np

TAGS = {"traffic": 1, "weights": 2, "step": 3, "sample": 4}


def derive(seed: int, tag: str, *index: int) -> int:
    """A 63-bit seed for the draw ``tag`` (and ``index``) of run ``seed``."""
    if seed < 0:
        raise ValueError(f"--seed must not be negative, got {seed}")
    words = [int(seed) & 0xFFFFFFFF, int(seed) >> 32, TAGS[tag], *map(int, index)]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return int((int(state[0]) << 31) ^ int(state[1])) & ((1 << 63) - 1)


def rng(seed: int, tag: str, *index: int) -> np.random.Generator:
    """A numpy generator for the draw ``tag`` of run ``seed``."""
    return np.random.default_rng(derive(seed, tag, *index))
