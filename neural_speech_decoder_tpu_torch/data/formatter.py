"""Transcription normalization of the offline data formatter.

The port's copy of ``clean_transcription`` from
``neural_speech_decoder_tpu/data/formatter.py`` (the competition pipeline's
one normalization of reference transcriptions); the rest of the formatter
(``.mat`` sessions -> formatted pickle) is not ported yet.
"""

from __future__ import annotations

import re


def clean_transcription(text: str) -> str:
    """Reference text normalization (notebook cell 3 / eval_competition.py:76-78)."""
    text = str(text).strip()
    text = re.sub(r"[^a-zA-Z\- \']", "", text)
    return text.replace("--", "").lower()
