"""N-best rescoring with an external language model + WER/CER metrics.

Replaces the upstream ``cer_with_gpt2_decoder`` pass the reference runs after
WFST decoding (``eval_competition.py:125-137``): each n-best hypothesis is
re-scored as ``acoustic + alpha * llm_logprob + length_penalty * n_words``
and the corpus WER/CER of the best rescored hypotheses is reported (with
optional bootstrap confidence intervals, as upstream's ``returnCI``).

The LLM is pluggable: any ``callable(list[str]) -> list[float]`` returning
per-sentence log-probs. Adapters provided for HuggingFace causal LMs (from a
local checkpoint — this environment has no model-download egress) and for
the ARPA n-gram LM (cheap fallback).

The port's counterpart of ``neural_speech_decoder_tpu/decoding/rescore.py``;
``decoding/torch_lm.py`` and ``decoding/llm_engine.py`` hold the scorers
that run the LLM on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np

from ..ops.decode import edit_distance
from .beam import Hypothesis
from .lexicon import ArpaLM, sentence_logprob


def ngram_scorer(lm: ArpaLM) -> Callable[[Sequence[str]], list[float]]:
    def score(sentences: Sequence[str]) -> list[float]:
        return [sentence_logprob(lm, s.split()) for s in sentences]

    return score


def hf_causal_scorer(model_path: str, device: str = "cuda", batch_size: int = 8):
    """Causal-LM sentence log-prob scorer from a local HF checkpoint
    (the upstream uses OPT-6.7B in 8-bit — ``eval_competition.py:84-86``),
    run by ``transformers`` (imported here, at call time) on ``device``."""
    import torch
    from transformers import AutoModelForCausalLM, AutoTokenizer

    tok = AutoTokenizer.from_pretrained(model_path)
    if tok.pad_token is None:  # GPT-2-family ships without one; padding
        tok.pad_token = tok.eos_token  # batches would raise otherwise
    model = AutoModelForCausalLM.from_pretrained(model_path).to(device).eval()

    def score(sentences: Sequence[str]) -> list[float]:
        out = []
        for i in range(0, len(sentences), batch_size):
            chunk = [s if s else " " for s in sentences[i : i + batch_size]]
            enc = tok(chunk, return_tensors="pt", padding=True).to(device)
            with torch.no_grad():
                logits = model(**enc).logits
            logp = torch.log_softmax(logits[:, :-1], dim=-1)
            tgt = enc["input_ids"][:, 1:]
            mask = enc["attention_mask"][:, 1:]
            tok_lp = logp.gather(-1, tgt.unsqueeze(-1)).squeeze(-1) * mask
            out.extend(tok_lp.sum(-1).cpu().tolist())
        return out

    return score


@dataclass
class RescoreResult:
    decoded_transcripts: list[str]
    cer: float
    wer: float
    cer_ci: tuple[float, float] | None = None
    wer_ci: tuple[float, float] | None = None


def rescore_nbest(
    nbest_lists: Sequence[Sequence[Hypothesis]],
    llm_scorer: Callable[[Sequence[str]], list[float]] | None,
    *,
    acoustic_scale: float = 1.0,
    alpha: float = 0.5,
    length_penalty: float = 0.0,
) -> list[str]:
    """Pick the best hypothesis per utterance under the blended score
    (reference hyperparameters: ``alpha=0.5``, ``lengthPenalty=0``).

    Hypothesis word strings repeat heavily across an n-best list (distinct
    phone segmentations of the same words survive the beam's
    (phones, words) dedup), so the LLM — the expensive leg at OPT-6.7B
    scale — scores each UNIQUE sentence once and the blend looks scores up
    by text."""
    texts = [" ".join(h.words) for nb in nbest_lists for h in nb]
    if llm_scorer is not None and texts:
        unique = list(dict.fromkeys(texts))  # insertion-ordered dedup
        by_text = dict(zip(unique, llm_scorer(unique)))
        llm_scores = [by_text[t] for t in texts]
    else:
        llm_scores = [0.0] * len(texts)
    out = []
    pos = 0
    for nb in nbest_lists:
        best_text, best_score = "", -np.inf
        for h in nb:
            s = (
                acoustic_scale * h.ac_score
                + alpha * llm_scores[pos]
                + length_penalty * len(h.words)
            )
            if s > best_score:
                best_score = s
                best_text = " ".join(h.words)
            pos += 1
        out.append(best_text)
    return out


def _rates(refs: list[str], hyps: list[str]) -> tuple[float, float]:
    # zip would silently truncate a mismatched pairing and report a
    # plausible-looking WER over the wrong pairs — make it loud instead
    if len(refs) != len(hyps):
        raise ValueError(
            f"{len(refs)} references vs {len(hyps)} hypotheses"
        )
    wd = wl = cd = cl = 0
    for r, h in zip(refs, hyps):
        rw, hw = r.split(), h.split()
        # edit_distance only needs `!=` on elements — compare the word
        # strings directly (a hashed-int mapping would admit collisions)
        wd += edit_distance(rw, hw)
        wl += len(rw)
        cd += edit_distance(
            np.frombuffer(r.encode(), np.uint8),
            np.frombuffer(h.encode(), np.uint8),
        )
        cl += len(r)
    return cd / max(cl, 1), wd / max(wl, 1)


def evaluate_transcripts(
    references: list[str],
    hypotheses: list[str],
    *,
    return_ci: bool = False,
    n_boot: int = 200,
    seed: int = 0,
) -> RescoreResult:
    cer, wer = _rates(references, hypotheses)
    cer_ci = wer_ci = None
    if return_ci:
        rng = np.random.default_rng(seed)
        n = len(references)
        cs, ws = [], []
        for _ in range(n_boot):
            idx = rng.integers(0, n, n)
            c, w = _rates(
                [references[i] for i in idx], [hypotheses[i] for i in idx]
            )
            cs.append(c)
            ws.append(w)
        cer_ci = (float(np.percentile(cs, 2.5)), float(np.percentile(cs, 97.5)))
        wer_ci = (float(np.percentile(ws, 2.5)), float(np.percentile(ws, 97.5)))
    return RescoreResult(
        decoded_transcripts=list(hypotheses),
        cer=cer,
        wer=wer,
        cer_ci=cer_ci,
        wer_ci=wer_ci,
    )
