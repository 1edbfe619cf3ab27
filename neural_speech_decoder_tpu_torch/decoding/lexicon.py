"""Pronunciation lexicon (word -> phone sequences) and backoff n-gram LM.

The port's copy of ``neural_speech_decoder_tpu/decoding/lexicon.py`` (plain
Python; the port imports nothing of the JAX package).

Together these replace the Kaldi/OpenFST ``lang_test`` directory the
reference's external C++ decoder consumes (``eval_competition.py:88-91``):
the lexicon constrains CTC beam expansions to valid pronunciations and the
ARPA LM scores word sequences at word (SIL) boundaries.

Formats:
  * lexicon: text lines ``word<TAB or space>PH1 PH2 ...`` (CMUdict style,
    stress digits stripped); multiple pronunciations per word allowed.
  * LM: standard ARPA text (``\\1-grams:`` sections with log10
    probabilities and optional backoff weights).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field

from ..data.phonemes import PHONE_DEF_SIL, phone_to_id

LOG10 = math.log(10.0)


@dataclass
class TrieNode:
    children: dict[int, "TrieNode"] = field(default_factory=dict)
    words: list[int] = field(default_factory=list)  # word ids ending here


class Lexicon:
    """Phoneme-trie lexicon. Phone IDs use the framework convention
    (phone_to_id + 1, 0 reserved for blank; SIL = 40)."""

    def __init__(self):
        self.root = TrieNode()
        self.words: list[str] = []
        self.word_ids: dict[str, int] = {}

    def add(self, word: str, phones: list[str]) -> None:
        wid = self.word_ids.get(word)
        if wid is None:
            wid = len(self.words)
            self.words.append(word)
            self.word_ids[word] = wid
        node = self.root
        for p in phones:
            pid = phone_to_id(p) + 1
            node = node.children.setdefault(pid, TrieNode())
        if wid not in node.words:
            node.words.append(wid)

    @classmethod
    def from_file(cls, path: str) -> "Lexicon":
        lex = cls()
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith(";;;"):
                    continue
                parts = line.replace("\t", " ").split()
                word, phones = parts[0].lower(), parts[1:]
                # strip CMUdict alternative markers word(2) and stress digits
                word = re.sub(r"\(\d+\)$", "", word)
                phones = [re.sub(r"[0-9]", "", p).upper() for p in phones]
                # skip entries containing phones outside the 39+SIL set —
                # a silently truncated pronunciation would commit the word
                # on the wrong phone sequence (e.g. AX-style dictionaries)
                if phones and all(p in PHONE_DEF_SIL for p in phones):
                    lex.add(word, phones)
        return lex


class ArpaLM:
    """Backoff n-gram LM loaded from ARPA text. Scores in natural log."""

    UNK = "<unk>"

    def __init__(self):
        self.order = 0
        self.vocab: dict[str, int] = {}
        # key: tuple of word ids -> (logprob_e, backoff_e)
        self.grams: dict[tuple[int, ...], tuple[float, float]] = {}

    def word_id(self, w: str) -> int:
        return self.vocab.get(w, self.vocab.get(self.UNK, -1))

    @classmethod
    def from_file(cls, path: str) -> "ArpaLM":
        lm = cls()
        section = 0
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                m = re.match(r"\\(\d+)-grams:", line)
                if m:
                    section = int(m.group(1))
                    lm.order = max(lm.order, section)
                    continue
                if line.startswith("\\") or line.startswith("ngram "):
                    continue
                if section == 0:
                    continue
                parts = line.split("\t") if "\t" in line else line.split()
                if "\t" in line:
                    logp = float(parts[0])
                    words = parts[1].split()
                    backoff = float(parts[2]) if len(parts) > 2 else 0.0
                else:
                    logp = float(parts[0])
                    words = parts[1 : 1 + section]
                    backoff = (
                        float(parts[1 + section])
                        if len(parts) > 1 + section
                        else 0.0
                    )
                ids = []
                for w in words:
                    if w not in lm.vocab:
                        lm.vocab[w] = len(lm.vocab)
                    ids.append(lm.vocab[w])
                lm.grams[tuple(ids)] = (logp * LOG10, backoff * LOG10)
        return lm

    def score(self, history: tuple[int, ...], word: int) -> float:
        """log P(word | history) with standard backoff, natural log."""
        if word < 0:
            return math.log(1e-10)
        hist = tuple(history[-(self.order - 1):]) if self.order > 1 else ()
        return self._score(hist, word)

    def _score(self, hist: tuple[int, ...], word: int) -> float:
        g = self.grams.get(hist + (word,))
        if g is not None:
            return g[0]
        if not hist:
            return math.log(1e-10)  # OOV with no <unk> unigram
        bo = self.grams.get(hist)
        backoff = bo[1] if bo is not None else 0.0
        return backoff + self._score(hist[1:], word)


def sentence_logprob(lm: ArpaLM, words: list[str], *, bos: str = "<s>",
                     eos: str = "</s>") -> float:
    """Σ log P(w_i | context), natural log, with BOS/EOS if in vocab."""
    ids = []
    if bos in lm.vocab:
        ids.append(lm.vocab[bos])
    total = 0.0
    for w in words:
        wid = lm.word_id(w)
        total += lm.score(tuple(ids), wid)
        ids.append(wid)
    if eos in lm.vocab:
        total += lm.score(tuple(ids), lm.vocab[eos])
    return total
