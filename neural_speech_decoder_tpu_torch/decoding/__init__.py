"""The port's decoding stack: the lexicon + n-gram CTC beam (the Python
oracle and the native engine), n-best rescoring with an LLM, the
competition pipeline (``eval_competition``) and the on-device beam
(``ondevice_beam``). See the package docstring of
neural_speech_decoder_tpu_torch."""

from .beam import Hypothesis, beam_search
from .lexicon import ArpaLM, Lexicon, sentence_logprob
from .lm_decoder import (
    build_lm_decoder,
    lm_decode,
    native_available,
    rearrange_speech_logits,
)
from .rescore import (
    evaluate_transcripts,
    hf_causal_scorer,
    ngram_scorer,
    rescore_nbest,
)

__all__ = [
    "Hypothesis",
    "beam_search",
    "ArpaLM",
    "Lexicon",
    "sentence_logprob",
    "build_lm_decoder",
    "lm_decode",
    "native_available",
    "rearrange_speech_logits",
    "evaluate_transcripts",
    "hf_causal_scorer",
    "ngram_scorer",
    "rescore_nbest",
]
