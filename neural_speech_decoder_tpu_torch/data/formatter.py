"""Offline data formatter: raw ``.mat`` sessions -> formatted dataset.

The port's own copy of ``neural_speech_decoder_tpu/data/formatter.py``
(``nsd-format``; numpy and scipy on the host, as there: no device), a
scriptable replacement for the reference notebook
``notebooks/formatCompetitionData.ipynb`` (cells 0-6), reproducing exactly:
  * feature assembly: ``tx1[:, :128]`` ++ ``spikePow[:, :128]`` -> 256
    channels (area 6v only) per 20 ms bin (cell 2),
  * block-wise z-scoring per ``blockIdx`` over the contiguous span of each
    block, with ``std + 1e-8`` (cell 2),
  * G2P phonemization with stress stripping, inter-word + trailing SIL,
    +1 ID offset (0 = CTC blank), fixed 500-slot int32 label buffer,
    truncated to 499 with a warning (cell 3),
  * the {train, test, competition} pickle layout, ``competition`` only for
    the sessions with a ``competitionHoldOut/<name>.mat`` (cells 4-6).

G2P: ``make_g2p`` needs ``g2p_en`` (raises ``ImportError`` without it);
callers without it pass their own ``g2p``: text -> tokens as ``g2p_en.G2p``
gives them (ARPABET phones with stress digits, ``" "`` between words).

Usage (also installed as ``nsd-format-torch``):
    python -m neural_speech_decoder_tpu_torch.data.formatter \\
        --data-dir /path/competitionData --out /path/ptDecoder_ctc
"""

from __future__ import annotations

import argparse
import os
import pickle
import re
import warnings
from typing import Callable, Sequence

import numpy as np

from .phonemes import MAX_SEQ_LEN, phone_to_id

SESSION_NAMES = sorted(
    [
        "t12.2022.04.28", "t12.2022.05.26", "t12.2022.06.21", "t12.2022.07.21",
        "t12.2022.08.13", "t12.2022.05.05", "t12.2022.06.02", "t12.2022.06.23",
        "t12.2022.07.27", "t12.2022.08.18", "t12.2022.05.17", "t12.2022.06.07",
        "t12.2022.06.28", "t12.2022.07.29", "t12.2022.08.23", "t12.2022.05.19",
        "t12.2022.06.14", "t12.2022.07.05", "t12.2022.08.02", "t12.2022.08.25",
        "t12.2022.05.24", "t12.2022.06.16", "t12.2022.07.14", "t12.2022.08.11",
    ]
)


def clean_transcription(text: str) -> str:
    """Reference text normalization (notebook cell 3 / eval_competition.py:76-78)."""
    text = str(text).strip()
    text = re.sub(r"[^a-zA-Z\- \']", "", text)
    return text.replace("--", "").lower()


def make_g2p() -> Callable[[str], list[str]]:
    """Return a grapheme->token function; prefers g2p_en, else raises."""
    from g2p_en import G2p  # gated optional dependency

    return G2p()


def phonemize(
    text: str,
    g2p: Callable[[str], Sequence[str]],
    *,
    add_inter_word_symbol: bool = True,
) -> list[str]:
    """Sentence -> phone sequence with the reference SIL policy (cell 3):
    spaces become SIL, stress digits stripped, trailing SIL appended."""
    phonemes: list[str] = []
    for p in g2p(text):
        if add_inter_word_symbol and p == " ":
            phonemes.append("SIL")
        p = re.sub(r"[0-9]", "", p)
        if re.match(r"[A-Z]+", p):
            phonemes.append(p)
    if add_inter_word_symbol:
        phonemes.append("SIL")
    return phonemes


def labels_from_phonemes(phonemes: Sequence[str]) -> np.ndarray:
    """Phones -> fixed 500-slot int32 ID buffer with +1 offset (cell 3).

    Sequences at/over the buffer size truncate to MAX_SEQ_LEN - 1 (with a
    warning) so a terminating 0 always exists — the reference notebook
    would crash downstream on such sentences (its argwhere(ids==0) length
    probe finds no zero)."""
    if len(phonemes) >= MAX_SEQ_LEN:
        warnings.warn(
            f"phoneme sequence of length {len(phonemes)} truncated to "
            f"{MAX_SEQ_LEN - 1}"
        )
        phonemes = list(phonemes)[: MAX_SEQ_LEN - 1]
    ids = np.zeros(MAX_SEQ_LEN, dtype=np.int32)
    ids[: len(phonemes)] = [phone_to_id(p) + 1 for p in phonemes]
    return ids


def load_features_and_normalize(session_path: str) -> dict:
    """Load one ``.mat`` session and block-z-score (notebook cell 2)."""
    import scipy.io

    dat = scipy.io.loadmat(session_path)
    n_trials = dat["sentenceText"].shape[0]
    input_features, transcriptions, frame_lens = [], [], []
    for i in range(n_trials):
        feats = np.concatenate(
            [dat["tx1"][0, i][:, 0:128], dat["spikePow"][0, i][:, 0:128]], axis=1
        )
        input_features.append(feats)
        transcriptions.append(dat["sentenceText"][i].strip())
        frame_lens.append(feats.shape[0])

    block_nums = np.squeeze(dat["blockIdx"])
    for b in np.unique(block_nums):
        sent_idx = np.argwhere(block_nums == b)[:, 0].astype(np.int32)
        # Reference normalizes over the contiguous span [first..last] of the
        # block (cell 2), which equals the block when blocks are contiguous.
        span = np.concatenate(
            input_features[sent_idx[0] : sent_idx[-1] + 1], axis=0
        )
        mean = span.mean(axis=0, keepdims=True)
        std = span.std(axis=0, keepdims=True)
        for i in sent_idx:
            input_features[i] = (input_features[i] - mean) / (std + 1e-8)

    return {
        "inputFeatures": input_features,
        "transcriptions": transcriptions,
        "frameLens": frame_lens,
    }


def format_session(session_path: str, g2p) -> dict:
    """One session -> reference day-dict schema (notebook cell 3)."""
    session = load_features_and_normalize(session_path)
    sentence_dat, true_sentences, seq_elements = [], [], []
    for i in range(len(session["inputFeatures"])):
        sentence_dat.append(session["inputFeatures"][i].astype(np.float32))
        true_sentences.append(session["transcriptions"][i])
        phones = phonemize(clean_transcription(session["transcriptions"][i]), g2p)
        seq_elements.append(labels_from_phonemes(phones))

    time_lens = np.asarray([x.shape[0] for x in sentence_dat])
    phone_lens = np.asarray(
        [int(np.argwhere(ids == 0)[0, 0]) for ids in seq_elements]
    )
    return {
        "sentenceDat": sentence_dat,
        "transcriptions": true_sentences,
        "phonemes": seq_elements,
        "timeSeriesLens": time_lens,
        "phoneLens": phone_lens,
        "phonePerTime": phone_lens.astype(np.float32) / time_lens.astype(np.float32),
    }


def format_competition_data(
    data_dir: str,
    out_path: str,
    session_names: Sequence[str] = SESSION_NAMES,
    g2p=None,
) -> dict:
    """Format all sessions into the {train,test,competition} pickle."""
    g2p = g2p or make_g2p()
    out = {"train": [], "test": [], "competition": []}
    for name in session_names:
        out["train"].append(format_session(f"{data_dir}/train/{name}.mat", g2p))
        out["test"].append(format_session(f"{data_dir}/test/{name}.mat", g2p))
        holdout = f"{data_dir}/competitionHoldOut/{name}.mat"
        if os.path.exists(holdout):
            out["competition"].append(format_session(holdout, g2p))
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--data-dir", required=True)
    parser.add_argument("--out", required=True)
    args = parser.parse_args()
    format_competition_data(args.data_dir, args.out)


if __name__ == "__main__":
    main()
