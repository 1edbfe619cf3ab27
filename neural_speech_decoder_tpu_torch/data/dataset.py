"""In-memory speech-BCI dataset with a packed representation.

The port's own copy of ``neural_speech_decoder_tpu/data/dataset.py``
(numpy only; the port imports nothing of the JAX package).

Consumes the reference's formatted-pickle schema (``{"train","test",
"competition"} -> list-per-day of {"sentenceDat", "phonemes", "phoneLens",
"transcriptions", ...}`` — notebook cell 6 / reference ``dataset.py:5-40``)
but stores trials packed into one contiguous ``[ΣT, C]`` float32 array plus
offsets, instead of a Python list of per-trial tensors: O(1) slicing, no
per-trial object overhead, and memory-mappable.
"""

from __future__ import annotations

import dataclasses
import pickle
from typing import Any, Sequence

import numpy as np

from .phonemes import MAX_SEQ_LEN


@dataclasses.dataclass
class PackedDataset:
    """Flattened trials across days.

    Attributes:
      features: ``[sum(T_i), C]`` float32, all trials concatenated.
      offsets: ``[N+1]`` int64 — trial i occupies ``features[offsets[i]:offsets[i+1]]``.
      labels: ``[N, U_max]`` int32 phone IDs (+1 offset, 0 pad).
      label_lens: ``[N]`` int32.
      days: ``[N]`` int32 day index per trial.
      transcriptions: optional per-trial sentence strings.
    """

    features: np.ndarray
    offsets: np.ndarray
    labels: np.ndarray
    label_lens: np.ndarray
    days: np.ndarray
    transcriptions: list[str] | None = None

    @property
    def n_trials(self) -> int:
        return len(self.days)

    @property
    def n_days(self) -> int:
        return int(self.days.max()) + 1 if self.n_trials else 0

    @property
    def n_channels(self) -> int:
        return self.features.shape[1]

    @property
    def lengths(self) -> np.ndarray:
        return (self.offsets[1:] - self.offsets[:-1]).astype(np.int32)

    @property
    def max_len(self) -> int:
        return int(self.lengths.max())

    def trial(self, i: int) -> np.ndarray:
        return self.features[self.offsets[i] : self.offsets[i + 1]]


def pack_days(day_list: Sequence[dict[str, Any]]) -> PackedDataset:
    """Flatten the reference's per-day trial lists into a PackedDataset.

    Mirrors the flattening in the reference ``SpeechDataset.__init__``
    (``dataset.py:17-23``): day order preserved, trial order within day
    preserved, day index = position in the list.
    """
    feats, labels, label_lens, days, transcripts = [], [], [], [], []
    for day_idx, day in enumerate(day_list):
        n = len(day["sentenceDat"])
        for t in range(n):
            feats.append(np.asarray(day["sentenceDat"][t], dtype=np.float32))
            lab = np.asarray(day["phonemes"][t], dtype=np.int32)
            if lab.shape[0] < MAX_SEQ_LEN:
                lab = np.pad(lab, (0, MAX_SEQ_LEN - lab.shape[0]))
            labels.append(lab[:MAX_SEQ_LEN])
            label_lens.append(int(day["phoneLens"][t]))
            days.append(day_idx)
            # keep transcripts positionally aligned with trials even when
            # only some days carry the key (e.g. competition holdout days)
            transcripts.append(
                str(day["transcriptions"][t])
                if "transcriptions" in day else None
            )
    lengths = np.array([f.shape[0] for f in feats], dtype=np.int64)
    offsets = np.zeros(len(feats) + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    features = (
        np.concatenate(feats, axis=0)
        if feats
        else np.zeros((0, 0), dtype=np.float32)
    )
    u_max = max((int(l) for l in label_lens), default=0)
    return PackedDataset(
        features=features,
        offsets=offsets,
        labels=np.stack(labels)[:, : max(u_max, 1)] if labels else np.zeros((0, 1), np.int32),
        label_lens=np.asarray(label_lens, dtype=np.int32),
        days=np.asarray(days, dtype=np.int32),
        transcriptions=transcripts or None,
    )


def load_pickle_dataset(path: str) -> dict[str, Any]:
    """Load the reference-format dataset pickle (notebook cell 6)."""
    with open(path, "rb") as f:
        return pickle.load(f)


def load_splits(path: str) -> tuple[PackedDataset, PackedDataset, dict[str, Any]]:
    """Load (train, test, raw) — the shape ``getDatasetLoaders`` returns
    (``neural_decoder_trainer.py:19-59``), with packed datasets instead of
    torch DataLoaders."""
    raw = load_pickle_dataset(path)
    return pack_days(raw["train"]), pack_days(raw["test"]), raw
