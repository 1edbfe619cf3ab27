"""The port's competition pipeline against the JAX package's, on the CPU.

``neural_speech_decoder_tpu_torch/decoding/eval_competition.py``: a tiny
GRU and a tiny Conformer, each initialized once in JAX and converted
(``models/convert.py``), through both packages' ``collect_model_outputs``
with ``model_bundle`` (log-probs within ``tests/test_torch_port_slice.py``'s
1e-4 for the GRU and ``tests/test_torch_port_conformer.py``'s 1e-5 of the
largest entry for the Conformer; ``logitLengths``, ``trueSeqs`` and the
cleaned transcriptions equal; the competition day-mapping warning on both);
``run_pipeline`` on word-structured log-probs, JAX serving from its Python
engine (its native library switched off, so nothing builds into the repo's
``csrc/``) and the port from its native engine: n-best words and phones
equal, scores within 1e-3, PER, WER, CER and their bootstrap CIs equal;
and ``nsd-eval-competition-torch`` (``main``) on the CPU with a bigram
OPT rescorer, writing ``llm_out`` and the submission file.
"""

import math
import pickle
import sys
import warnings

import numpy as np
import pytest
import torch

import jax

from neural_speech_decoder_tpu.decoding import eval_competition as jax_ec
from neural_speech_decoder_tpu.decoding import lm_decoder as jax_lm_decoder
from neural_speech_decoder_tpu.decoding.lexicon import ArpaLM as JaxArpaLM
from neural_speech_decoder_tpu.decoding.rescore import ngram_scorer as jax_ngram_scorer
from neural_speech_decoder_tpu.training.trainer import build_model as jax_build_model
from neural_speech_decoder_tpu_torch.data.phonemes import MAX_SEQ_LEN, phone_to_id
from neural_speech_decoder_tpu_torch.decoding import bigram_opt, eval_competition, llm_engine
from neural_speech_decoder_tpu_torch.decoding.lexicon import ArpaLM
from neural_speech_decoder_tpu_torch.decoding.rescore import ngram_scorer
from neural_speech_decoder_tpu_torch.models.api import build_model
from neural_speech_decoder_tpu_torch.models.convert import params_from_jax
from neural_speech_decoder_tpu_torch.training import checkpoints

N_DAYS = 6  # > COMPETITION_DAY_IDXS[1]: the reference mapping applies to 2 days
C = 16
WORDS = {"bat": ["B", "AE", "T"], "cat": ["K", "AE", "T"], "two": ["T", "UW"]}
LEXICON = "\n".join(f"{w} {' '.join(ps)}" for w, ps in WORDS.items()) + "\n"
ARPA = """\\data\\
ngram 1=5

\\1-grams:
-0.5\t<s>
-0.9\t</s>
-0.6\tbat
-0.6\tcat
-0.6\ttwo

\\end\\
"""
BASE = {"nInputFeatures": C, "nClasses": 40, "seed": 0, "time_multiple": 16}
GRU_ARGS = dict(BASE, gaussianSmoothWidth=2.0, nUnits=16, nLayers=2, dropout=0.0,
                strideLen=2, kernelLen=4, bidirectional=True)
CONF_ARGS = dict(
    BASE, model_type="transformer_ctc", temporal_kernel=4, temporal_stride=2,
    gaussian_smooth_width=2.0, frontend_dim=16, latent_dim=16, autoencoder_hidden_dim=12,
    transformer_num_layers=2, transformer_n_heads=2, transformer_dim_ff=24,
    transformer_dropout=0.0, conformer_conv_kernel=5, drop_path_prob=0.0)
SCORE_TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pid(p):
    return phone_to_id(p) + 1


def word_dataset(seed, n_days=N_DAYS, trials=3, comp_days=2, comp_trials=5):
    """Word-structured trials (lexicon words + SIL) in the reference pickle
    layout, with a competition partition."""
    rng = np.random.default_rng(seed)
    templates = rng.standard_normal((41, C)).astype(np.float32)
    words = list(WORDS)

    def day(n):
        sd, ph, pl, tr = [], [], [], []
        for _ in range(n):
            ws = [words[i] for i in rng.integers(len(words), size=2)]
            ids = [i for w in ws for i in [pid(p) for p in WORDS[w]] + [pid("SIL")]]
            x = 0.4 * rng.standard_normal((6 * len(ids), C)).astype(np.float32)
            for j, c in enumerate(ids):
                x[6 * j: 6 * j + 6] += 4.0 * templates[c]
            buf = np.zeros(MAX_SEQ_LEN, np.int32)
            buf[: len(ids)] = ids
            sd.append(x)
            ph.append(buf)
            pl.append(len(ids))
            tr.append(" " + " ".join(ws).upper() + "!")  # cleaned by the pipeline
        return {"sentenceDat": sd, "phonemes": ph, "phoneLens": np.asarray(pl),
                "transcriptions": tr, "timeSeriesLens": np.asarray([len(x) for x in sd])}

    return {"train": [day(trials) for _ in range(n_days)],
            "test": [day(2) for _ in range(n_days)],
            "competition": [day(comp_trials) for _ in range(comp_days)]}


@pytest.fixture(scope="module")
def dataset():
    return word_dataset(0)


def _models(args):
    """One JAX init, converted: ``(jax_params, jax_model, port_model)``."""
    jax_model = jax_build_model(args, N_DAYS)
    params = jax_model.init(jax.random.key(0))
    model = build_model(args, N_DAYS, "cpu")
    model.load_params(params_from_jax(jax.tree.map(np.asarray, params)))
    return params, jax_model, model


@pytest.mark.parametrize("args, tol, relative", [(GRU_ARGS, 1e-4, False),
                                                  (CONF_ARGS, 1e-5, True)],
                         ids=["gru", "conformer"])
def test_collect_model_outputs_matches_jax(dataset, args, tol, relative):
    params, jax_model, model = _models(args)
    with pytest.warns(UserWarning, match="competition day mapping"):
        want = jax_ec.collect_model_outputs(None, dataset=dataset,
                                            model_bundle=(params, jax_model))
    with pytest.warns(UserWarning, match=r"competition day mapping \[4, 5\]"):
        got = eval_competition.collect_model_outputs(None, dataset=dataset,
                                                     model_bundle=model)
    n = sum(len(d["sentenceDat"]) for d in dataset["competition"])
    assert len(got["logits"]) == len(want["logits"]) == n
    assert got["logitLengths"] == want["logitLengths"]
    assert got["transcriptions"] == want["transcriptions"]
    assert got["transcriptions"][0] == got["transcriptions"][0].strip().lower()
    for a, b in zip(got["trueSeqs"], want["trueSeqs"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got["logits"], want["logits"]):
        assert a.dtype == np.float32 and a.shape == b.shape
        err = np.abs(a - b).max()
        assert err <= tol * (np.abs(b).max() if relative else 1.0), err
    # an explicit mapping and a partition outside the heuristic: no warning
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        eval_competition.collect_model_outputs(None, dataset=dataset, model_bundle=model,
                                               day_indices=[0, 1])
        eval_competition.collect_model_outputs(None, dataset=dataset, model_bundle=model,
                                               partition="test")
    with pytest.raises(ValueError, match="day_indices has 1"):
        eval_competition.collect_model_outputs(None, dataset=dataset, model_bundle=model,
                                               day_indices=[0])


def _word_outputs(dataset, seed):
    """Log-probs from each competition trial's true phones plus noise (3
    frames a phone), in ``collect_model_outputs``' structure."""
    rng = np.random.default_rng(seed)
    out = {"logits": [], "logitLengths": [], "trueSeqs": [], "transcriptions": []}
    for d in dataset["competition"]:
        for ph, n, tr in zip(d["phonemes"], d["phoneLens"], d["transcriptions"]):
            ids = ph[:n]
            x = rng.standard_normal((3 * n, 41)).astype(np.float32)
            x[np.arange(3 * n), np.repeat(ids, 3)] += 3.0
            x -= np.log(np.exp(x).sum(-1, keepdims=True))
            out["logits"].append(x)
            out["logitLengths"].append(3 * n)
            out["trueSeqs"].append(ids)
            out["transcriptions"].append(eval_competition.clean_transcription(tr))
    return out


def test_run_pipeline_matches_jax(dataset, tmp_path, monkeypatch):
    lex, arpa = tmp_path / "lexicon.txt", tmp_path / "lm.arpa"
    lex.write_text(LEXICON)
    arpa.write_text(ARPA)
    # JAX serves from its Python engine; nothing builds into csrc/
    monkeypatch.setattr(jax_lm_decoder, "_LIB_TRIED", True)
    monkeypatch.setattr(jax_lm_decoder, "_LIB", None)
    outputs = _word_outputs(dataset, 1)
    kw = dict(lexicon_path=str(lex), arpa_path=str(arpa), nbest=10, beam=20.0,
              alpha=0.5, return_ci=True, verbose=False)
    want = jax_ec.run_pipeline(outputs, llm_scorer=jax_ngram_scorer(JaxArpaLM.from_file(
        str(arpa))), **kw)
    got = eval_competition.run_pipeline(outputs, llm_scorer=ngram_scorer(ArpaLM.from_file(
        str(arpa))), **kw)
    assert len(got["nbest"]) == len(want["nbest"]) == len(outputs["logits"])
    for nb_g, nb_w in zip(got["nbest"], want["nbest"]):
        assert len(nb_g) == len(nb_w) > 0
        for a, b in zip(nb_g, nb_w):
            assert [int(p) for p in a.phones] == list(b.phones) and a.words == b.words
            assert abs(a.score - b.score) < SCORE_TOL
            assert abs(a.ac_score - b.ac_score) < SCORE_TOL
    for key in ("per", "wer", "cer", "wer_top1", "cer_top1", "wer_ci", "cer_ci",
                "decoded_transcripts"):
        assert got[key] == want[key], key
    assert got["wer"] < 0.5 and got["beam_seconds"] > 0


def test_main_writes_the_submission(dataset, tmp_path, monkeypatch):
    """``nsd-eval-competition-torch`` on the CPU: a run directory of the
    port, the lexicon and ARPA, and a bigram OPT checkpoint (``.bin`` +
    WordLevel tokenizer) scored by the engine backend, with
    ``transformers`` blocked (the card's machine has none)."""
    monkeypatch.setitem(sys.modules, "transformers", None)
    run = tmp_path / "run"
    model = build_model(GRU_ARGS, N_DAYS, "cpu")
    checkpoints.save_args(str(run), {**GRU_ARGS, "nDays": N_DAYS, "device": "cpu"})
    checkpoints.CheckpointManager(str(run)).save("modelState", {"params": model.params})
    data = tmp_path / "data.pkl"
    data.write_bytes(pickle.dumps(dataset))
    (tmp_path / "lexicon.txt").write_text(LEXICON)
    (tmp_path / "lm.arpa").write_text(ARPA)
    spec = llm_engine.EngineSpec(n_layer=2, d_model=32, ffn_dim=64, n_head=2, vocab=16,
                                 n_positions=32)
    k = len(WORDS)
    logp = np.log(np.full((k + 1, k), 1.0 / k))
    builder = bigram_opt.BigramOptBuilder(spec, logp, np.arange(k) + bigram_opt.FIRST_WORD_ID)
    llm = tmp_path / "opt"
    bigram_opt.write_checkpoint(spec, str(llm), builder.tensor_fn)
    bigram_opt.build_wordlevel_tokenizer(list(WORDS), str(llm))
    eval_competition.main([
        "--modelPath", str(run), "--datasetPath", str(data), "--lexicon",
        str(tmp_path / "lexicon.txt"), "--lm", str(tmp_path / "lm.arpa"), "--llmPath",
        str(llm), "--device", "cpu", "--nbest", "5", "--dayIndices", "0,1"])
    lines = (run / "5gramLLMCompetitionSubmission.txt").read_text().splitlines()
    assert len(lines) == sum(len(d["sentenceDat"]) for d in dataset["competition"])
    with open(run / "llm_out", "rb") as f:
        out = pickle.load(f)
    assert "nbest" not in out and out["decoded_transcripts"] == lines
    assert math.isfinite(out["wer"]) and out["rescore_seconds"] >= 0


def test_llm_backend_routing(tmp_path):
    """The engine backend takes every OPT checkpoint and raises for one it
    cannot take, naming ``--llmBackend hf``; int8 applies above ~1B."""
    import json

    cfg = {"model_type": "opt", "hidden_size": 4096, "ffn_dim": 16384,
           "num_hidden_layers": 32, "num_attention_heads": 32, "vocab_size": 50272,
           "max_position_embeddings": 2048, "do_layer_norm_before": False}
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    assert eval_competition._is_large_opt(str(tmp_path))
    with pytest.raises(NotImplementedError, match="--llmBackend hf"):
        eval_competition.make_llm_scorer(str(tmp_path), "engine", device="cpu")
    (tmp_path / "config.json").write_text(json.dumps({**cfg, "num_hidden_layers": 2}))
    assert not eval_competition._is_large_opt(str(tmp_path))
    assert not eval_competition._is_large_opt(str(tmp_path / "missing"))
