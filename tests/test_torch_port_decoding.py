"""The port's host decoding stack against the JAX package's, on the CPU.

``neural_speech_decoder_tpu_torch/decoding/{lexicon,beam,lm_decoder,rescore}.py``
and ``data/formatter.py::clean_transcription``: the port's Python beam
against JAX's ``beam_search`` (same n-best, scores exact: the same Python
arithmetic), the port's native engine (its own copy of ``ctc_beam.cpp``,
built into the package's ``_build/``) against its own ``force_python=True``
oracle (phones and words equal, scores within 1e-3, as
``tests/test_native_beam.py``), ``LMStream`` against the batch decode, two
processes building the library at once, and the rescoring metrics against
JAX's. JAX's native path is never called here: it builds into the repo's
``csrc/``.
"""

import math
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from neural_speech_decoder_tpu.data import formatter as jax_formatter
from neural_speech_decoder_tpu.decoding import beam as jax_beam
from neural_speech_decoder_tpu.decoding import lexicon as jax_lexicon
from neural_speech_decoder_tpu.decoding import rescore as jax_rescore
from neural_speech_decoder_tpu_torch.data.formatter import clean_transcription
from neural_speech_decoder_tpu_torch.data.phonemes import phone_to_id
from neural_speech_decoder_tpu_torch.decoding import lm_decoder, rescore
from neural_speech_decoder_tpu_torch.decoding.beam import SIL_ID, Hypothesis, beam_search
from neural_speech_decoder_tpu_torch.decoding.lexicon import ArpaLM, Lexicon, sentence_logprob

REPO = Path(__file__).resolve().parents[1]
SCORE_TOL = 1e-3  # native float32 sums vs the oracle's float64 (test_native_beam.py)

# tests/test_native_beam.py's lexicon (homophones two/too) and ARPA
LEXICON = """bat B AE T
bad B AE D
cat K AE T
at AE T
two T UW
too T UW
"""

ARPA = """\\data\\
ngram 1=8
ngram 2=3

\\1-grams:
-0.5\t<s>\t-0.3
-0.9\t</s>
-0.7\tbat\t-0.2
-1.5\tbad\t-0.2
-0.8\tcat\t-0.2
-1.0\tat\t-0.2
-1.2\ttwo\t-0.2
-1.4\ttoo\t-0.2

\\2-grams:
-0.1\t<s> cat
-0.2\tcat bat
-0.3\tbat </s>

\\end\\
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's parallel workers would otherwise
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("lang")
    (d / "lexicon.txt").write_text(LEXICON)
    (d / "lm.arpa").write_text(ARPA)
    return str(d / "lexicon.txt"), str(d / "lm.arpa")


def pid(p):
    return phone_to_id(p) + 1


def random_logprobs(rng, t=25, k=41, bias_ids=None, bias=2.0):
    x = rng.standard_normal((t, k)).astype(np.float32)
    if bias_ids is not None:
        for j, c in enumerate(bias_ids):
            x[j * t // len(bias_ids):(j + 1) * t // len(bias_ids), c] += bias
    return x - np.log(np.exp(x).sum(-1, keepdims=True))


# "cat SIL bat SIL", "two too", and a word outside the lexicon ("D IH G")
UTTERANCES = (
    ["K", "AE", "T", "SIL", "B", "AE", "T", "SIL"],
    ["T", "UW", "SIL", "T", "UW", "SIL"],
    ["K", "AE", "T", "SIL", "D", "IH", "G", "SIL"],
)
MODES = {
    "strict": {},
    "oov": {"oov_cost": -4.0},
    "boundary_free": {"boundary_free": True},
}


def _logprobs(seed, utt):
    rng = np.random.default_rng(seed)
    return random_logprobs(rng, t=32, bias_ids=[pid(p) for p in utt], bias=3.0)


def _same(h_a, h_b, exact):
    assert len(h_a) == len(h_b) > 0
    for a, b in zip(h_a, h_b):
        assert [int(p) for p in a.phones] == [int(p) for p in b.phones]
        assert a.words == b.words
        for x, y in ((a.score, b.score), (a.ac_score, b.ac_score), (a.lm_score, b.lm_score)):
            assert (x == y) if exact else abs(x - y) < SCORE_TOL


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("utt", range(len(UTTERANCES)))
def test_python_beam_matches_jax(paths, mode, utt):
    """The port's copy of the oracle gives JAX's n-best bit for bit."""
    lp = _logprobs(utt, UTTERANCES[utt])
    kw = dict(acoustic_scale=0.5, blank_penalty=math.log(7), lm_weight=1.5, beam=30.0,
              nbest=8, **MODES[mode])
    got = beam_search(lp, lexicon=Lexicon.from_file(paths[0]),
                      lm=ArpaLM.from_file(paths[1]), **kw)
    want = jax_beam.beam_search(lp, lexicon=jax_lexicon.Lexicon.from_file(paths[0]),
                                lm=jax_lexicon.ArpaLM.from_file(paths[1]), **kw)
    _same(got, want, exact=True)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("seed", range(4))
def test_native_matches_python_oracle(paths, mode, seed):
    """Native engine vs its ``force_python`` oracle, each decoding mode."""
    utt = UTTERANCES[seed % len(UTTERANCES)]
    lp = _logprobs(seed, utt)
    kw = dict(acoustic_scale=0.5, nbest=8, beam=30.0, lm_weight=1.5, **MODES[mode])
    native = lm_decoder.build_lm_decoder(*paths, **kw)
    python = lm_decoder.build_lm_decoder(*paths, force_python=True, **kw)
    assert native.handle is not None and python.handle is None
    bp = math.log(7)
    _same(lm_decoder.lm_decode(native, lp, blank_penalty=bp),
          lm_decoder.lm_decode(python, lp, blank_penalty=bp), exact=False)


def test_native_unconstrained_mode():
    lp = random_logprobs(np.random.default_rng(5), t=15)
    native = lm_decoder.build_lm_decoder(None, None, nbest=5, beam=20.0)
    python = lm_decoder.build_lm_decoder(None, None, nbest=5, beam=20.0, force_python=True)
    _same(lm_decoder.lm_decode(native, lp), lm_decoder.lm_decode(python, lp), exact=False)


def test_batch_and_stream_match_single_decode(paths):
    """``lm_decode_batch`` (OpenMP over utterances, ragged lengths) and an
    ``LMStream`` fed in uneven chunks give ``lm_decode``'s n-best."""
    dec = lm_decoder.build_lm_decoder(*paths, nbest=6, beam=30.0, lm_weight=1.5)
    lps = [_logprobs(s, UTTERANCES[s % 3])[: 24 + 3 * s] for s in range(4)]
    padded = np.zeros((4, 32, 41), np.float32)
    for i, lp in enumerate(lps):
        padded[i, : len(lp)] = lp
    batch = lm_decoder.lm_decode_batch(dec, padded, [len(lp) for lp in lps],
                                       blank_penalty=1.0, n_threads=2)
    for lp, got in zip(lps, batch):
        want = lm_decoder.lm_decode(dec, lp, blank_penalty=1.0)
        _same(got, want, exact=True)
        with lm_decoder.open_stream(dec) as st:
            for a, b in ((0, 5), (5, 6), (6, 17), (17, len(lp))):
                st.feed(lp[a:b], blank_penalty=1.0)
            _same(st.nbest(), want, exact=True)
    python = lm_decoder.build_lm_decoder(*paths, nbest=6, force_python=True)
    with pytest.raises(RuntimeError, match="native engine"):
        lm_decoder.open_stream(python)


_BUILD = """
import sys
from pathlib import Path
from neural_speech_decoder_tpu_torch.decoding import lm_decoder
lm_decoder.BUILD_DIR = Path(sys.argv[1])
print(lm_decoder.build())
"""


def test_concurrent_builds_share_one_library(tmp_path):
    """Two processes that start the build at once: both succeed and load
    one library (the file lock serializes them; the second finds it)."""
    build = tmp_path / "build"
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(build)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [o[1] for o in outs]
    libs = {o[0].strip() for o in outs}
    assert len(libs) == 1 and sorted(build.glob("*.so")) == [Path(libs.pop())]
    code = "import ctypes, sys; print(ctypes.CDLL(sys.argv[1]).ctcb_abi_version())"
    out = subprocess.run([sys.executable, "-c", code, str(next(build.glob("*.so")))],
                         capture_output=True, text=True, check=True).stdout
    assert out.strip() == str(lm_decoder._ABI_VERSION)


def test_no_silent_fallback(monkeypatch, tmp_path, paths):
    """A library that no compiler builds raises from ``build_lm_decoder``
    (``$CXX`` is tried first); the Python engine serves only
    ``force_python``."""
    monkeypatch.setenv("CXX", "false")
    assert lm_decoder.compilers()[0] == shutil.which("false")
    monkeypatch.setattr(lm_decoder, "compilers", lambda: [shutil.which("false")])
    monkeypatch.setattr(lm_decoder, "_LIB", None)
    monkeypatch.setattr(lm_decoder, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="building the native decoder failed"):
        lm_decoder.build_lm_decoder(*paths)
    assert lm_decoder.native_available() is False
    assert lm_decoder.build_lm_decoder(*paths, force_python=True).handle is None


def test_rearrange_speech_logits_roundtrip():
    x = np.random.default_rng(0).standard_normal((3, 5, 41)).astype(np.float32)
    y = lm_decoder.rearrange_speech_logits(x, blank_last=True)
    np.testing.assert_array_equal(y[..., -1], x[..., 0])
    np.testing.assert_array_equal(lm_decoder.rearrange_speech_logits(y, blank_last=False), x)


def test_lexicon_and_lm_match_jax(paths):
    """The trie, the word ids and every LM score equal JAX's."""
    lex, jlex = Lexicon.from_file(paths[0]), jax_lexicon.Lexicon.from_file(paths[0])
    assert lex.words == jlex.words and lex.word_ids == jlex.word_ids

    def walk(a, b):
        assert a.words == b.words and sorted(a.children) == sorted(b.children)
        for c in a.children:
            walk(a.children[c], b.children[c])

    walk(lex.root, jlex.root)
    lm, jlm = ArpaLM.from_file(paths[1]), jax_lexicon.ArpaLM.from_file(paths[1])
    assert lm.grams == jlm.grams and lm.order == jlm.order
    for words in (["cat", "bat"], ["two", "too", "at"], ["dig"], []):
        assert sentence_logprob(lm, words) == jax_lexicon.sentence_logprob(jlm, words)


def _nbest(rng, words):
    return [Hypothesis(phones=[], words=list(rng.choice(words, size=rng.integers(1, 4))),
                       score=0.0, ac_score=float(rng.normal()), lm_score=0.0)
            for _ in range(5)]


def test_rescoring_and_metrics_match_jax(paths):
    """``rescore_nbest`` (the n-gram scorer), ``evaluate_transcripts`` with
    its seeded bootstrap CI, and ``clean_transcription`` equal JAX's."""
    rng = np.random.default_rng(3)
    words = ["cat", "bat", "two", "too", "at"]
    lists = [_nbest(rng, words) for _ in range(6)]
    jlists = [[jax_beam.Hypothesis(**vars(h)) for h in nb] for nb in lists]
    lm, jlm = ArpaLM.from_file(paths[1]), jax_lexicon.ArpaLM.from_file(paths[1])
    calls = []

    def counting(scorer):
        def score(sentences):
            calls.append(len(sentences))
            return scorer(sentences)
        return score

    got = rescore.rescore_nbest(lists, counting(rescore.ngram_scorer(lm)), alpha=0.7)
    want = jax_rescore.rescore_nbest(jlists, jax_rescore.ngram_scorer(jlm), alpha=0.7)
    assert got == want
    assert calls == [len({" ".join(h.words) for nb in lists for h in nb})]
    refs = [" ".join(rng.choice(words, size=3)) for _ in range(6)]
    r = rescore.evaluate_transcripts(refs, got, return_ci=True, n_boot=50, seed=4)
    j = jax_rescore.evaluate_transcripts(refs, want, return_ci=True, n_boot=50, seed=4)
    assert (r.cer, r.wer, r.cer_ci, r.wer_ci) == (j.cer, j.wer, j.cer_ci, j.wer_ci)
    with pytest.raises(ValueError, match="references vs"):
        rescore.evaluate_transcripts(refs, got[:-1])
    for text in ("  Hello, World -- it's   TWO-fold! ", "a--b", "Ünïcode 42"):
        assert clean_transcription(text) == jax_formatter.clean_transcription(text)


def test_hf_causal_scorer_defaults_to_the_card():
    import inspect

    assert inspect.signature(rescore.hf_causal_scorer).parameters["device"].default == "cuda"
    assert SIL_ID == pid("SIL") == 40
