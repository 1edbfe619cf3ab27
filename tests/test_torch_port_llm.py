"""The port's LLM rescorers against the JAX package's, on the CPU.

``neural_speech_decoder_tpu_torch/decoding/{torch_lm,llm_engine,bigram_opt}.py``
on tiny OPT and GPT-2 checkpoints written with ``transformers``
(``tests/test_llm_engine.py``'s): the streamed loader's leaves bit-equal to
JAX's (safetensors, ``.bin``, sharded, the ``decoder.`` prefix,
``quantize=True`` in the stream), ``quantize_int8`` bit-equal, the port's
safetensors reader bit-equal to ``safe_open``, the plain WordLevel
tokenizer reader giving the ids of ``tokenizers``, both forwards against
JAX's, the bigram construction against its analytic oracle, and a mesh
raising ``NotImplementedError``.

Tolerances on per-sentence log-probs against JAX's (3 layers, d=32):
float32 within 1e-5 relative + 1e-4 absolute (the same float32 function,
sums in other orders; ``tests/test_llm_engine.py``'s own pairing; measured
at most 7.6e-6 on |log-probs| up to 88); bfloat16 within 1e-4 relative +
1e-2 absolute (the same bf16 rounding points, so the two differ only where
a float32 sum in another order rounds a stored bf16 value the other way;
measured at most 1.1e-3, GPT-2). The bigram construction at d=64: within
0.05 (float32 leaves) of the analytic oracle.
"""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

import jax
import jax.numpy as jnp

from neural_speech_decoder_tpu.decoding import bigram_opt as jax_bigram_opt
from neural_speech_decoder_tpu.decoding import jax_lm, llm_engine as jax_engine
from neural_speech_decoder_tpu_torch.decoding import bigram_opt, llm_engine, torch_lm

F32_TOL = dict(rtol=1e-5, atol=1e-4)
BF16_TOL = dict(rtol=1e-4, atol=1e-2)
SENTENCES = ["the cat sat", "a", "hello world again and again", "dog ran", ""]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_tokenizer(d):
    from transformers import GPT2TokenizerFast

    vocab = {chr(c): i for i, c in enumerate(range(ord("a"), ord("z") + 1))}
    vocab.update({" ": 26, "<|endoftext|>": 27, "Ġ": 28})
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version: 0.2\n")
    return GPT2TokenizerFast(
        vocab_file=str(d / "vocab.json"), merges_file=str(d / "merges.txt"),
        unk_token="<|endoftext|>", pad_token="<|endoftext|>",
        bos_token="<|endoftext|>", eos_token="<|endoftext|>"), len(vocab)


def _make_opt(d, *, word_embed_proj_dim=None, safetensors=True, shard=None):
    from transformers import OPTConfig, OPTForCausalLM

    d.mkdir(parents=True, exist_ok=True)
    tok, vocab_size = _tiny_tokenizer(d)
    torch.manual_seed(3)
    model = OPTForCausalLM(OPTConfig(
        vocab_size=vocab_size, hidden_size=32, num_hidden_layers=3, num_attention_heads=2,
        ffn_dim=64, max_position_embeddings=64,
        word_embed_proj_dim=word_embed_proj_dim or 32, do_layer_norm_before=True,
        pad_token_id=27, bos_token_id=27, eos_token_id=27))
    kw = {"max_shard_size": shard} if shard else {}
    model.save_pretrained(str(d), safe_serialization=safetensors, **kw)
    tok.save_pretrained(str(d))
    return str(d)


def _make_gpt2(d):
    from transformers import GPT2Config, GPT2LMHeadModel

    d.mkdir(parents=True, exist_ok=True)
    tok, vocab_size = _tiny_tokenizer(d)
    torch.manual_seed(4)
    GPT2LMHeadModel(GPT2Config(vocab_size=vocab_size, n_positions=64, n_embd=32, n_layer=2,
                               n_head=2)).save_pretrained(str(d))
    tok.save_pretrained(str(d))
    return str(d)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("llm")
    return {
        "safetensors": _make_opt(root / "st"),
        "bin": _make_opt(root / "bin", safetensors=False),
        "sharded": _make_opt(root / "sharded", shard="20KB"),
        "proj": _make_opt(root / "proj", word_embed_proj_dim=16),
        "gpt2": _make_gpt2(root / "gpt2"),
    }


def _tokenize(path, sentences):
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(path)
    if tok.pad_token is None:
        tok.pad_token = tok.eos_token
    enc = tok([s if s else " " for s in sentences], padding=True)
    return (np.asarray(enc["input_ids"], np.int32),
            np.asarray(enc["attention_mask"], np.int32))


def _bits(a):
    """A leaf's bits as numpy (bfloat16 through int16)."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


def _assert_tree_bits(got, want):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        gb, wb = _bits(g[k]), _bits(w[k])
        assert gb.shape == wb.shape and gb.dtype == wb.dtype, k
        np.testing.assert_array_equal(gb, wb, err_msg=k)


@pytest.mark.parametrize("kind", ["safetensors", "bin", "sharded", "proj"])
@pytest.mark.parametrize("dtype, quantize", [("float32", False), ("bfloat16", False),
                                             ("bfloat16", True)])
def test_stream_load_bit_equal_to_jax(ckpts, kind, dtype, quantize):
    if kind == "sharded":
        assert os.path.exists(os.path.join(ckpts[kind], "model.safetensors.index.json"))
    got, spec = llm_engine.stream_load_hf(ckpts[kind], dtype, quantize=quantize)
    want, jspec = jax_engine.stream_load_hf(ckpts[kind], dtype, quantize=quantize)
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    _assert_tree_bits(got, want)


def test_stream_load_prefix_variant_and_bogus_names(ckpts, tmp_path):
    """``decoder.*``-prefixed checkpoints load bit-equal; unknown names raise."""
    from safetensors import safe_open
    from safetensors.numpy import save_file

    ref, _ = llm_engine.stream_load_hf(ckpts["safetensors"], "float32")
    d = tmp_path / "prefix"
    d.mkdir()
    shutil.copy(f"{ckpts['safetensors']}/config.json", d / "config.json")
    with safe_open(f"{ckpts['safetensors']}/model.safetensors", framework="np") as f:
        save_file({n.removeprefix("model."): f.get_tensor(n) for n in f.keys()},
                  str(d / "model.safetensors"))
    got, _ = llm_engine.stream_load_hf(str(d), "float32")
    _assert_tree_bits(got, ref)
    d2 = tmp_path / "bogus"
    d2.mkdir()
    shutil.copy(f"{ckpts['safetensors']}/config.json", d2 / "config.json")
    save_file({"something.weird": np.zeros((2, 2), np.float32)}, str(d2 / "model.safetensors"))
    with pytest.raises(ValueError, match="filled"):
        llm_engine.stream_load_hf(str(d2), "float32")


def test_quantize_int8_bit_equal_and_pure(ckpts):
    """``quantize_int8`` of the same tree gives JAX's int8 and scales bit
    for bit, equals the in-stream quantization, and leaves its input as
    it was."""
    for dtype in ("float32", "bfloat16"):
        tree, _ = llm_engine.stream_load_hf(ckpts["safetensors"], dtype)
        before = {k: v.clone() for k, v in _flat(tree).items()}
        got = llm_engine.quantize_int8(tree)
        _assert_tree_bits(tree, before)
        want = jax_engine.quantize_int8(jax_engine.stream_load_hf(ckpts["safetensors"],
                                                                  dtype)[0])
        _assert_tree_bits(got, want)
        _assert_tree_bits(got, llm_engine.stream_load_hf(ckpts["safetensors"], dtype,
                                                         quantize=True)[0])


def test_safetensors_reader_bit_equal(tmp_path):
    """The port's reader against ``safe_open`` on every dtype it maps,
    bfloat16 included."""
    from safetensors import safe_open
    from safetensors.torch import save_file

    g = torch.Generator().manual_seed(0)
    tensors = {
        "bf16": torch.randn(3, 5, generator=g).to(torch.bfloat16),
        "f16": torch.randn(7, generator=g).to(torch.float16),
        "f32": torch.randn(2, 3, 4, generator=g),
        "i8": torch.randint(-127, 128, (4, 4), generator=g, dtype=torch.int8),
        "i64": torch.arange(6).reshape(2, 3),
        "scalar": torch.tensor(2.5),
    }
    path = str(tmp_path / "t.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    got = dict(llm_engine.read_safetensors(path))
    assert sorted(got) == sorted(tensors)
    with safe_open(path, framework="pt") as f:
        for name in f.keys():
            want = f.get_tensor(name)
            assert got[name].dtype == want.dtype and got[name].shape == want.shape
            assert torch.equal(got[name].view(torch.uint8) if want.dim() else got[name],
                               want.view(torch.uint8) if want.dim() else want), name


def test_wordlevel_tokenizer_matches_tokenizers(tmp_path):
    """``build_wordlevel_tokenizer`` writes JAX's files (as parsed JSON);
    the plain reader gives ``transformers``' ids and masks on them; any
    other tokenizer kind raises, naming transformers."""
    from transformers import AutoTokenizer

    words = ["word00", "word01", "it's", "ok"]
    port, jaxd = tmp_path / "port", tmp_path / "jax"
    bigram_opt.build_wordlevel_tokenizer(words, str(port))
    jax_bigram_opt.build_wordlevel_tokenizer(words, str(jaxd))
    for name in ("tokenizer.json", "tokenizer_config.json"):
        assert (json.loads((port / name).read_text())
                == json.loads((jaxd / name).read_text())), name
    plain = llm_engine.WordLevelTokenizer(str(port))
    hf = AutoTokenizer.from_pretrained(str(port))
    batch = ["word00 word01", "word01", " ", "ok, it's word00!", "unknown word01"]
    assert plain(batch, padding=True) == {k: list(map(list, v)) for k, v in
                                          hf(batch, padding=True).items()
                                          if k in ("input_ids", "attention_mask")}
    assert plain(["word01"])["input_ids"] == [[bigram_opt.BOS_ID, bigram_opt.FIRST_WORD_ID + 1]]
    gpt2 = tmp_path / "gpt2"
    gpt2.mkdir()
    _tiny_tokenizer(gpt2)[0].save_pretrained(str(gpt2))
    with pytest.raises(NotImplementedError, match="transformers"):
        llm_engine.WordLevelTokenizer(str(gpt2))


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("kind", ["safetensors", "proj", "gpt2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_lm_matches_jax_lm(ckpts, kind, dtype):
    """``torch_lm.sentence_logprobs`` against ``jax_lm``'s on the same
    weights and ids (GPT-2's gelu_new, OPT's relu and word/hidden split)."""
    params, spec, _ = torch_lm.load_causal_lm(ckpts[kind])
    jparams, jspec, _ = jax_lm.load_causal_lm(ckpts[kind])
    assert spec.__dict__ == jspec.__dict__
    _assert_tree_bits(params, jparams)
    ids, mask = _tokenize(ckpts[kind], SENTENCES)
    got = torch_lm.sentence_logprobs(torch_lm.to_device(params, "cpu"), spec,
                                     torch.from_numpy(ids), torch.from_numpy(mask),
                                     torch_lm.DTYPES[dtype]).numpy()
    want = np.asarray(jax_lm.sentence_logprobs(_jax_tree(jparams), jspec, ids, mask,
                                               compute_dtype=jnp.dtype(dtype)))
    np.testing.assert_allclose(got, want, **(F32_TOL if dtype == "float32" else BF16_TOL))
    assert np.all(np.isfinite(got))


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_engine_matches_jax_engine(ckpts, dtype, quantize):
    """``engine_sentence_logprobs`` against JAX's on the same streamed (and
    int8) leaves, in the compute dtype of the leaves."""
    params, spec = llm_engine.stream_load_hf(ckpts["safetensors"], dtype, quantize=quantize)
    jparams, jspec = jax_engine.stream_load_hf(ckpts["safetensors"], dtype,
                                               quantize=quantize)
    ids, mask = _tokenize(ckpts["safetensors"], SENTENCES)
    got = llm_engine.engine_sentence_logprobs(params, spec, torch.from_numpy(ids),
                                              torch.from_numpy(mask),
                                              torch_lm.DTYPES[dtype]).numpy()
    want = np.asarray(jax_engine.engine_sentence_logprobs(_jax_tree(jparams), jspec, ids,
                                                          mask, jnp.dtype(dtype)))
    np.testing.assert_allclose(got, want, **(F32_TOL if dtype == "float32" else BF16_TOL))


def test_engine_and_torch_lm_scorers_agree(ckpts):
    """The two scorers of the port on one checkpoint (float32), through
    ``make_batched_scorer``'s padding, against JAX's engine scorer; the
    ``from_lm`` bridge gives the streamed leaves."""
    eng = llm_engine.engine_scorer(ckpts["safetensors"], batch_size=2,
                                   compute_dtype="float32", param_dtype="float32",
                                   device="cpu")
    lm = torch_lm.torch_causal_scorer(ckpts["safetensors"], batch_size=3,
                                      compute_dtype="float32", device="cpu")
    want = jax_engine.engine_scorer(ckpts["safetensors"], compute_dtype="float32",
                                    param_dtype="float32")(SENTENCES)
    np.testing.assert_allclose(eng(SENTENCES), want, **F32_TOL)
    np.testing.assert_allclose(lm(SENTENCES), want, **F32_TOL)
    params, spec, _ = torch_lm.load_causal_lm(ckpts["safetensors"])
    bridged, bspec = llm_engine.from_lm(params, spec)
    streamed, sspec = llm_engine.stream_load_hf(ckpts["safetensors"], "float32")
    assert bspec == sspec
    _assert_tree_bits(bridged, streamed)


def test_int8_close_and_rank_preserving(ckpts):
    params, spec = llm_engine.stream_load_hf(ckpts["safetensors"], "float32")
    ids, mask = (torch.from_numpy(a) for a in _tokenize(ckpts["safetensors"], SENTENCES))
    fp = llm_engine.engine_sentence_logprobs(params, spec, ids, mask, torch.float32).numpy()
    q = llm_engine.engine_sentence_logprobs(llm_engine.quantize_int8(params), spec, ids, mask,
                                            torch.float32).numpy()
    np.testing.assert_allclose(q, fp, rtol=0.05, atol=0.5)
    assert list(np.argsort(q)) == list(np.argsort(fp))


K = 16
TINY = llm_engine.EngineSpec(n_layer=3, d_model=64, ffn_dim=128, n_head=4, vocab=48,
                             n_positions=32)


def _bigram():
    rng = np.random.default_rng(11)
    p = rng.dirichlet(np.full(K, 0.25), size=K + 1)
    p = 0.98 * p + 0.02 / K
    return np.log(p / p.sum(axis=1, keepdims=True))


def test_bigram_builder_realizes_its_oracle(tmp_path):
    """The construction through the engine reproduces ``oracle_logp``
    (in memory and from ``write_checkpoint``'s ``.bin`` + WordLevel
    tokenizer, bit-equal to each other), equals JAX's builder, and ranks
    like the true bigram."""
    bigram = _bigram()
    ids_k = np.arange(K) + bigram_opt.FIRST_WORD_ID
    builder = bigram_opt.BigramOptBuilder(TINY, bigram, ids_k)
    jbuilder = jax_bigram_opt.BigramOptBuilder(jax_engine.EngineSpec(**TINY.__dict__),
                                               bigram, ids_k)
    np.testing.assert_array_equal(builder.oracle_logp(), jbuilder.oracle_logp())
    params = bigram_opt.engine_params(builder, "float32")
    out = str(tmp_path / "ckpt")
    bigram_opt.write_checkpoint(TINY, out, builder.tensor_fn)
    words = [f"word{i:02d}" for i in range(K)]
    bigram_opt.build_wordlevel_tokenizer(words, out)
    loaded, spec = llm_engine.stream_load_hf(out, "float32")
    assert spec == TINY
    _assert_tree_bits(loaded, params)
    oracle = builder.oracle_logp()
    rng = np.random.default_rng(5)
    sents = [rng.integers(0, K, size=int(rng.integers(2, 7))).tolist() for _ in range(10)]
    want = [oracle[0, s[0]] + sum(oracle[1 + a, b] for a, b in zip(s, s[1:]))
            for s in sents]
    score = llm_engine.engine_scorer(out, batch_size=4, compute_dtype="float32",
                                     param_dtype="float32", device="cpu")
    got = score([" ".join(words[i] for i in s) for s in sents])
    np.testing.assert_allclose(got, want, atol=0.05)
    for r in range(K + 1):
        assert list(np.argsort(bigram[r])[::-1][:6]) == list(np.argsort(oracle[r])[::-1][:6])


def test_synth_params_shapes_and_no_mesh():
    """``synth_params_on_device`` has ``_synth_shapes``' shapes and dtypes
    (bf16 and int8), scores finitely; a mesh raises."""
    for quantize in (False, True):
        got = llm_engine.synth_params_on_device(TINY, seed=1, dtype=torch.bfloat16,
                                                quantize=quantize, device="cpu")
        want = jax_engine._synth_shapes(jax_engine.EngineSpec(**TINY.__dict__),
                                        jnp.bfloat16, quantize=quantize)
        g, w = _flat(got), _flat(jax.tree.map(lambda s: s, want, is_leaf=lambda x: hasattr(
            x, "shape")))
        assert sorted(g) == sorted(w)
        for k in w:
            assert tuple(g[k].shape) == tuple(w[k].shape), k
            assert str(g[k].dtype).removeprefix("torch.") == str(w[k].dtype), k
        assert bool((got["lnf_g"] == 1).all()) and bool((got["blocks"]["ln1_g"] == 1).all())
        ids = torch.randint(0, TINY.vocab, (2, 8), generator=torch.Generator().manual_seed(0))
        lp = llm_engine.engine_sentence_logprobs(got, TINY, ids, torch.ones_like(ids),
                                                 torch.bfloat16)
        assert bool(torch.isfinite(lp).all())
        if quantize:
            q = got["blocks"]["wfc_q"]
            assert int(q.min()) >= -127 and int(q.max()) <= 127
    with pytest.raises(NotImplementedError):
        llm_engine.engine_scorer("unused", mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError):
        llm_engine.llm_shardings(TINY, mesh=object())
    with pytest.raises(NotImplementedError):
        llm_engine.synth_params_on_device(TINY, shardings={}, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_host_synth_params_bit_equal(dtype):
    """``synth_params`` draws the JAX package's numpy values and rounds them
    as ``ml_dtypes`` does (to nearest even)."""
    got = llm_engine.synth_params(TINY, seed=3, dtype=dtype)
    want = jax_engine.synth_params(jax_engine.EngineSpec(**TINY.__dict__), seed=3,
                                   dtype=dtype)
    _assert_tree_bits(got, want)


def test_truncation_warns_past_the_position_table():
    """``make_batched_scorer`` pads T up to 16 from max(t, 2), pads rows to
    the batch, and truncates over-long batches to the table with a warning."""
    seen = []

    def tok(sentences, padding=True):
        ids = [[int(w) for w in s.split()] or [0] for s in sentences]
        t = max(map(len, ids))
        return {"input_ids": [r + [0] * (t - len(r)) for r in ids],
                "attention_mask": [[1] * len(r) + [0] * (t - len(r)) for r in ids]}

    def score_batch(ids, mask):
        seen.append(ids.shape)
        return torch.from_numpy(mask.sum(1).astype(np.float32))

    score = torch_lm.make_batched_scorer(tok, 24, score_batch, batch_size=4)
    assert score(["1 2 3", "4", ""]) == [3.0, 1.0, 1.0]
    with pytest.warns(UserWarning, match="position table"):
        assert score([" ".join(["7"] * 30)]) == [24.0]
    assert seen == [(4, 16), (4, 24)]
