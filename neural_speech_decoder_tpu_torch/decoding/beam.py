"""Lexicon-constrained CTC prefix beam search with n-gram LM (Python).

The port's copy of ``neural_speech_decoder_tpu/decoding/beam.py``: host
code in both packages, and the oracle of the port's native engine
(``neural_speech_decoder_tpu_torch/csrc/ctc_beam.cpp``).

This is the reference ("oracle") implementation of the decode semantics the
native C++ engine (``ctc_beam.cpp``) accelerates; both replace the
upstream Kaldi/OpenFST ``LanguageModelDecoder`` used by the reference at
``eval_competition.py:88-116``.

Semantics:
  * input: per-frame log-probabilities ``[T, K]`` with blank at index 0 and
    SIL at index 40 (the framework's label convention);
  * acoustic scores are scaled by ``acoustic_scale`` and the blank log-prob
    is reduced by ``blank_penalty`` (matching the reference's
    ``acoustic_scale=0.5``, ``blankPenalty=log 7`` hyperparameters);
  * beam expansions are constrained to pronunciations in the lexicon trie;
    SIL is the word delimiter: expanding SIL at a trie node that completes
    one or more words commits each candidate word (branching over
    homophones) and applies the LM increment ``log P(w | history)``;
  * n-best output is ranked by ``acoustic + lm_weight * lm`` with an
    optional per-word insertion penalty.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..data.phonemes import phone_to_id
from .lexicon import ArpaLM, Lexicon, TrieNode

SIL_ID = phone_to_id("SIL") + 1  # 40
NEG_INF = -1e30

# Sentinel trie position: inside an out-of-lexicon word (OOV free-phone
# track). Matches kTrieFree in csrc/ctc_beam.cpp.
FREE_NODE = TrieNode()


def _logsum(a: float, b: float) -> float:
    if a < b:
        a, b = b, a
    if b <= NEG_INF:
        return a
    return a + math.log1p(math.exp(b - a))


@dataclass
class _State:
    phones: tuple[int, ...] = ()
    words: tuple[int, ...] = ()
    node: TrieNode | None = None  # current trie position (None = no lexicon)
    lm: float = 0.0
    pen: float = 0.0  # lm_weight-independent penalties (OOV per-phone cost)
    p_b: float = NEG_INF  # ends in blank
    p_nb: float = NEG_INF  # ends in non-blank

    def total(self) -> float:
        return _logsum(self.p_b, self.p_nb)


@dataclass
class Hypothesis:
    phones: list[int]
    words: list[str]
    score: float  # combined
    ac_score: float
    lm_score: float


def beam_search(
    log_probs: np.ndarray,
    *,
    lexicon: Lexicon | None = None,
    lm: ArpaLM | None = None,
    acoustic_scale: float = 0.5,
    blank_penalty: float = 0.0,
    lm_weight: float = 1.0,
    word_insertion_penalty: float = 0.0,
    beam: float = 18.0,
    max_active: int = 200,
    nbest: int = 10,
    top_k_tokens: int = 12,
    oov_cost: float | None = None,
    boundary_free: bool = False,
) -> list[Hypothesis]:
    """Decode one utterance. ``log_probs``: [T, K], blank at 0.

    ``oov_cost``: when set (typically negative), enables the OOV fallback
    track — out-of-lexicon words may be hypothesized phone-by-phone from a
    word boundary at ``oov_cost`` score per phone, committing ``<unk>``.

    ``boundary_free``: words may also commit eagerly at any word-end trie
    node when the next phone starts a new word — decoding for models or
    lexicons without SIL word delimiters.
    """
    lp = np.asarray(log_probs, np.float64) * acoustic_scale
    lp[:, 0] -= blank_penalty
    t_max, k = lp.shape
    root = lexicon.root if lexicon is not None else None
    oov_on = oov_cost is not None and root is not None
    unk_wid = -1
    if oov_on:
        # Resolve <unk> without mutating the caller's Lexicon (the C++
        # engine only mutates its own privately-loaded copy): when the
        # lexicon has no <unk> entry, use a virtual id one past the end
        # and resolve it locally via word_name().
        unk_wid = lexicon.word_ids.get("<unk>")
        if unk_wid is None:
            unk_wid = len(lexicon.words)

    def word_name(w: int) -> str:
        if lexicon is not None and w < len(lexicon.words):
            return lexicon.words[w]
        return "<unk>"

    init = _State(node=root, p_b=0.0)
    states: dict[tuple, _State] = {_key(init): init}

    bos = (lm.vocab["<s>"],) if lm is not None and "<s>" in lm.vocab else ()

    def unk_lm_inc(words: tuple[int, ...]) -> float:
        if lm is None:
            return 0.0
        hist = bos + tuple(lm.word_id(word_name(w)) for w in words)
        return lm.score(hist, lm.vocab.get("<unk>", -1))

    for t in range(t_max):
        frame = lp[t]
        # candidate tokens this frame (pruning)
        order = np.argsort(frame)[::-1][:top_k_tokens]
        nxt: dict[tuple, _State] = {}

        def upd(key_state: _State, *, pb=NEG_INF, pnb=NEG_INF):
            kk = _key(key_state)
            cur = nxt.get(kk)
            if cur is None:
                nxt[kk] = key_state
                key_state.p_b = pb
                key_state.p_nb = pnb
            else:
                cur.p_b = _logsum(cur.p_b, pb)
                cur.p_nb = _logsum(cur.p_nb, pnb)

        for s in states.values():
            tot = s.total()
            last = s.phones[-1] if s.phones else -1
            # 1. blank
            upd(
                _State(s.phones, s.words, s.node, s.lm, s.pen),
                pb=tot + frame[0],
            )
            for c in order:
                c = int(c)
                if c == 0:
                    continue
                # 2. repeat of last phone (stays same prefix)
                if c == last:
                    upd(
                        _State(s.phones, s.words, s.node, s.lm, s.pen),
                        pnb=s.p_nb + frame[c],
                    )
                    src = s.p_b  # extension only from blank-ended mass
                else:
                    src = tot
                if src <= NEG_INF:
                    continue
                # 3. extension with phone c
                if root is None:
                    upd(
                        _State(s.phones + (c,), s.words, None, s.lm, s.pen),
                        pnb=src + frame[c],
                    )
                    continue
                if c == SIL_ID:
                    if s.node is root:
                        # inter/leading silence, no word commit
                        upd(
                            _State(s.phones + (c,), s.words, root, s.lm,
                                   s.pen),
                            pnb=src + frame[c],
                        )
                    elif s.node is FREE_NODE:
                        # OOV word ends: commit <unk>
                        upd(
                            _State(
                                s.phones + (c,),
                                s.words + (unk_wid,),
                                root,
                                s.lm + unk_lm_inc(s.words),
                                s.pen,
                            ),
                            pnb=src + frame[c],
                        )
                    elif s.node.words:
                        for wid in s.node.words:
                            lm_inc = 0.0
                            if lm is not None:
                                hist = bos + tuple(
                                    lm.word_id(word_name(w))
                                    for w in s.words
                                )
                                lm_inc = lm.score(
                                    hist, lm.word_id(word_name(wid))
                                )
                            upd(
                                _State(
                                    s.phones + (c,),
                                    s.words + (wid,),
                                    root,
                                    s.lm + lm_inc,
                                    s.pen,
                                ),
                                pnb=src + frame[c],
                            )
                    # mid-word SIL with no completed word: disallowed
                elif s.node is FREE_NODE:
                    # continue the OOV word with any phone
                    upd(
                        _State(s.phones + (c,), s.words, FREE_NODE, s.lm,
                               s.pen + oov_cost),
                        pnb=src + frame[c],
                    )
                else:
                    child = s.node.children.get(c)
                    if child is not None:
                        upd(
                            _State(s.phones + (c,), s.words, child, s.lm,
                                   s.pen),
                            pnb=src + frame[c],
                        )
                    if (boundary_free and s.node is not root
                            and s.node.words):
                        # eager commit: end the current word, start a new
                        # one with phone c (no SIL delimiter)
                        root_child = root.children.get(c)
                        if root_child is not None:
                            for wid in s.node.words:
                                lm_inc = 0.0
                                if lm is not None:
                                    hist = bos + tuple(
                                        lm.word_id(word_name(w))
                                        for w in s.words
                                    )
                                    lm_inc = lm.score(
                                        hist, lm.word_id(word_name(wid))
                                    )
                                upd(
                                    _State(
                                        s.phones + (c,),
                                        s.words + (wid,),
                                        root_child,
                                        s.lm + lm_inc,
                                        s.pen,
                                    ),
                                    pnb=src + frame[c],
                                )
                    if oov_on and s.node is root:
                        # start an OOV word from the word boundary
                        upd(
                            _State(s.phones + (c,), s.words, FREE_NODE, s.lm,
                                   s.pen + oov_cost),
                            pnb=src + frame[c],
                        )
        # prune: score beam + max_active
        def rank(s: _State) -> float:
            return (
                s.total() + lm_weight * s.lm
                + word_insertion_penalty * len(s.words) + s.pen
            )

        scored = sorted(nxt.values(), key=rank, reverse=True)
        if scored:
            best = rank(scored[0])
            scored = [s for s in scored if rank(s) > best - beam]
        states = {_key(s): s for s in scored[:max_active]}

    # finalize: commit trailing complete words without SIL; add </s>.
    finals: list[Hypothesis] = []
    for s in states.values():
        if root is None or s.node is root:
            cands = [s]
        elif s.node is FREE_NODE:  # trailing OOV word: commit <unk>
            cands = [
                _State(s.phones, s.words + (unk_wid,), root,
                       s.lm + unk_lm_inc(s.words), s.pen,
                       p_b=s.p_b, p_nb=s.p_nb)
            ]
        elif s.node.words:  # mid-trie but at a word end: commit each reading
            cands = []
            for wid in s.node.words:
                lm_inc = 0.0
                if lm is not None:
                    hist = bos + tuple(
                        lm.word_id(word_name(w)) for w in s.words
                    )
                    lm_inc = lm.score(hist, lm.word_id(word_name(wid)))
                cands.append(
                    _State(s.phones, s.words + (wid,), root, s.lm + lm_inc,
                           s.pen, p_b=s.p_b, p_nb=s.p_nb)
                )
        else:  # incomplete word: not a valid final
            continue
        for c in cands:
            lm_total = c.lm
            if lm is not None and "</s>" in lm.vocab:
                hist = bos + tuple(
                    lm.word_id(word_name(w)) for w in c.words
                )
                lm_total += lm.score(hist, lm.vocab["</s>"])
            ac = c.total()
            score = (
                ac
                + lm_weight * lm_total
                + word_insertion_penalty * len(c.words)
                + c.pen
            )
            finals.append(
                Hypothesis(
                    phones=list(c.phones),
                    words=[word_name(w) for w in c.words]
                    if lexicon is not None
                    else [],
                    score=score,
                    ac_score=ac,
                    lm_score=lm_total,
                )
            )
    # Deterministic tie-break: equal-scored hypotheses (e.g. homophone
    # orderings under a unigram LM) rank by phones then word strings, so
    # the n-best order is reproducible and engine-independent.
    finals.sort(key=lambda h: (-h.score, h.phones, h.words))
    # dedup identical word sequences (keep best-scoring)
    seen = set()
    out = []
    for h in finals:
        key = (tuple(h.phones), tuple(h.words))
        if key in seen:
            continue
        seen.add(key)
        out.append(h)
        if len(out) >= nbest:
            break
    return out


def _key(s: _State) -> tuple:
    return (s.phones, s.words, id(s.node))
