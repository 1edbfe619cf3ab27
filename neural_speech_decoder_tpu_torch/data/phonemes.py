"""Phoneme inventory: 39 ARPABET phones + SIL, CTC blank at ID 0.

The port's own copy of ``neural_speech_decoder_tpu/data/phonemes.py``
(numpy only; the port imports nothing of the JAX package).

Matches the reference label convention (notebook ``formatCompetitionData.ipynb``
cell 1): class IDs are ``index(phone) + 1`` so that 0 is the CTC blank / pad.
"""

PHONE_DEF = [
    "AA", "AE", "AH", "AO", "AW",
    "AY", "B", "CH", "D", "DH",
    "EH", "ER", "EY", "F", "G",
    "HH", "IH", "IY", "JH", "K",
    "L", "M", "N", "NG", "OW",
    "OY", "P", "R", "S", "SH",
    "T", "TH", "UH", "UW", "V",
    "W", "Y", "Z", "ZH",
]
PHONE_DEF_SIL = PHONE_DEF + ["SIL"]

N_PHONES = len(PHONE_DEF_SIL)  # 40 classes (+1 blank = 41 CTC outputs)

MAX_SEQ_LEN = 500  # fixed label buffer size (notebook cell 3)


def phone_to_id(p: str) -> int:
    """0-based phone index (SIL = 39). Label IDs are this + 1."""
    return PHONE_DEF_SIL.index(p)


def id_to_phone(i: int) -> str:
    """Inverse of the +1-offset label convention (ID 0 = blank)."""
    if i == 0:
        return "<blank>"
    return PHONE_DEF_SIL[i - 1]
