"""Synthetic dataset generation in the reference pickle schema.

The port's own copy of ``neural_speech_decoder_tpu/data/synthetic.py``
(numpy only; the port imports nothing of the JAX package).

Produces structurally faithful data (per-day trial lists with
``sentenceDat`` / ``phonemes`` / ``phoneLens`` / ``transcriptions``) for
tests and benchmarks; features carry a weak class-dependent signal so tiny
training runs can demonstrably reduce loss/PER.
"""

from __future__ import annotations

import numpy as np

from .phonemes import MAX_SEQ_LEN, N_PHONES


def synthetic_day(
    rng: np.random.Generator,
    n_trials: int,
    n_channels: int = 256,
    min_t: int = 60,
    max_t: int = 200,
    min_u: int = 3,
    max_u: int = 12,
    signal_scale: float = 1.0,
    templates: np.ndarray | None = None,
) -> dict:
    """One synthetic recording day in reference schema (notebook cell 3).

    ``templates`` are the per-class feature signatures; pass the same array
    for train/test days of one synthetic "subject" so the test split is
    actually learnable from the train split.
    """
    if templates is None:
        templates = rng.standard_normal((N_PHONES + 1, n_channels)).astype(
            np.float32
        )
    sentence_dat, phonemes, phone_lens, transcriptions = [], [], [], []
    for _ in range(n_trials):
        t = int(rng.integers(min_t, max_t + 1))
        u = int(rng.integers(min_u, min(max_u, max(t // 8, min_u)) + 1))
        labels = rng.integers(1, N_PHONES + 1, size=u).astype(np.int32)
        # Lay each label's template over an equal slice of time + noise.
        x = rng.standard_normal((t, n_channels)).astype(np.float32)
        bounds = np.linspace(0, t, u + 1).astype(int)
        for k in range(u):
            x[bounds[k] : bounds[k + 1]] += signal_scale * templates[labels[k]]
        buf = np.zeros(MAX_SEQ_LEN, dtype=np.int32)
        buf[:u] = labels
        sentence_dat.append(x)
        phonemes.append(buf)
        phone_lens.append(u)
        transcriptions.append("synthetic trial")
    return {
        "sentenceDat": sentence_dat,
        "phonemes": phonemes,
        "phoneLens": np.asarray(phone_lens),
        "transcriptions": transcriptions,
        "timeSeriesLens": np.asarray([x.shape[0] for x in sentence_dat]),
    }


def synthetic_dataset(
    seed: int = 0,
    n_days: int = 3,
    trials_per_day: int = 16,
    n_channels: int = 256,
    **kwargs,
) -> dict:
    """Full {train, test, competition} synthetic dataset pickle-equivalent."""
    rng = np.random.default_rng(seed)
    templates = rng.standard_normal((N_PHONES + 1, n_channels)).astype(np.float32)
    out = {"train": [], "test": [], "competition": []}
    for _ in range(n_days):
        out["train"].append(
            synthetic_day(rng, trials_per_day, n_channels,
                          templates=templates, **kwargs)
        )
        out["test"].append(
            synthetic_day(rng, max(trials_per_day // 4, 2), n_channels,
                          templates=templates, **kwargs)
        )
        out["competition"].append(
            synthetic_day(rng, max(trials_per_day // 8, 1), n_channels,
                          templates=templates, **kwargs)
        )
    return out
