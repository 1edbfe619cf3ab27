"""Tensor-parallel LLM rescoring and the multichip dryrun on the port,
against the JAX package, on the CPU over gloo.

Rank processes (``spawn``, one torch thread each, ``transformers`` blocked
so the plain WordLevel reader serves) join a gloo group on ``localhost``:
a module-scoped pool of two ranks is the 1x2 ``(data, model)`` grid, one of
four the 2x2 grid (``parallel/mesh.py``). The tiny OPT checkpoints are
``tests/test_torch_port_llm.py``'s (3 layers, d=32, 2 heads, written with
``transformers``); JAX's reference runs on a ``jax.sharding.Mesh`` of the
same shape over the conftest's virtual CPU devices.

Held: ``llm_shardings`` against JAX's PartitionSpecs (float and int8
trees), the "divisible" ``ValueError``, each model rank's ``shard_params``
leaves bit-equal to JAX's addressable shards (quantized, then sharded),
the streamed rank-local load bit-equal to them, tensor-parallel log-probs
(float32 and int8) within rtol 1e-5 / atol 1e-4 of JAX's tensor-parallel
log-probs and of the port on one rank (``tests/test_llm_engine.py``'s own
pairing), ``engine_scorer(mesh=)`` against JAX's, sharded
``synth_params_on_device`` bit-equal to its slice of the one-rank draw
(int8 leaves and scales bit-equal to JAX's draw; float leaves within 3e-8
absolute, or one bfloat16 rounding step, of it: XLA's and torch's
``log1p``/``cos`` round differently in the last bit), and
``dryrun_multichip(2)`` / ``(4)`` with every stage's OK line. A job that
does not answer within 120 s fails its test.
"""

import multiprocessing as mp
import os
import shutil
import sys
import traceback
from contextlib import contextmanager

import numpy as np
import pytest
import torch
import torch.distributed as dist

# The rank processes import this module for its jobs, which run the port
# alone: JAX and transformers are imported in the test process only.
RANK_ENV = "NSD_TEST_RANK_PROCESS"
if not os.environ.get(RANK_ENV):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JaxMesh

    from neural_speech_decoder_tpu.decoding import llm_engine as jax_engine
    from test_torch_port_llm import SENTENCES, TINY, _bits, _flat, _make_opt, _tokenize
from neural_speech_decoder_tpu_torch.decoding import bigram_opt, llm_engine
from neural_speech_decoder_tpu_torch.parallel import data_parallel as dp
from neural_speech_decoder_tpu_torch.parallel import multihost
from neural_speech_decoder_tpu_torch.parallel.dryrun import dryrun_multichip
from neural_speech_decoder_tpu_torch.parallel.mesh import make_mesh
from neural_speech_decoder_tpu_torch.parallel.tensor_parallel import ModelShard

JOB_TIMEOUT = 120.0
TOL = dict(rtol=1e-5, atol=1e-4)
GRIDS = {"1x2": (1, 2), "2x2": (2, 2)}
WORDS = [f"w{i}" for i in range(20)]  # the WordLevel vocabulary: ids 4-23 of 29
WORD_SENTENCES = ["w1 w2 w3", "w4", "w5 w6 w7 w8 w9 w10 w11", "", "w12 w3 w3",
                  "w19 w0", "w7"]
FLOAT_SYNTH_ATOL = 3e-8  # 4 float32 ulps at 0.0625-0.125


# ------------------------------------------------------- the rank processes


def _rank_loop(rank: int, world: int, address: str, conn) -> None:
    """A pool rank: join the gloo group, then run the jobs the test sends
    (``(name, kwargs)``, None to stop) and send back their results."""
    torch.set_num_threads(1)
    sys.modules["transformers"] = None  # the port's plain tokenizer reader serves
    multihost.initialize(address, world, rank, backend="gloo", device="cpu", timeout_s=60)
    try:
        while (msg := conn.recv()) is not None:
            name, kwargs = msg
            try:
                conn.send(("ok", globals()[name](rank=rank, **kwargs)))
            except BaseException:
                conn.send(("error", traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class _Ranks:
    """``world`` rank processes in one gloo group; ``run`` sends a job to
    every rank and returns their results by rank."""

    def __init__(self, world: int):
        ctx = mp.get_context("spawn")
        address = f"tcp://127.0.0.1:{dp._free_port()}"
        self.procs, self.conns = [], []
        with _one_thread_env(**{RANK_ENV: "1"}):
            for r in range(world):
                mine, theirs = ctx.Pipe()
                p = ctx.Process(target=_rank_loop, args=(r, world, address, theirs))
                p.start()
                theirs.close()
                self.procs.append(p)
                self.conns.append(mine)

    def run(self, name: str, **kwargs) -> list:
        for c in self.conns:
            c.send((name, kwargs))
        out = []
        for r, c in enumerate(self.conns):
            if not c.poll(JOB_TIMEOUT):
                self.close(kill=True)
                pytest.fail(f"rank {r} did not answer {name} within {JOB_TIMEOUT} s")
            status, value = c.recv()
            if status != "ok":
                pytest.fail(f"rank {r}, {name}:\n{value}")
            out.append(value)
        return out

    def close(self, kill: bool = False) -> None:
        for c in self.conns:
            if not kill:
                try:
                    c.send(None)
                except (BrokenPipeError, OSError):
                    pass
        for p in self.procs:
            p.join(None if not kill else 0)
            if p.is_alive():
                p.kill()
                p.join()


@contextmanager
def _one_thread_env(**env):
    """``OMP_NUM_THREADS=1`` (and ``env``) for spawned ranks (read at their
    torch import) and one torch thread here."""
    env = {"OMP_NUM_THREADS": "1", **env}
    old_env, old_n = {k: os.environ.get(k) for k in env}, torch.get_num_threads()
    os.environ.update(env)
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(old_n)
        for k, v in old_env.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


@pytest.fixture(autouse=True)
def _one_thread():
    with _one_thread_env():
        yield


@pytest.fixture(scope="module")
def ranks2():
    pool = _Ranks(2)
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def ranks4():
    pool = _Ranks(4)
    yield pool
    pool.close()


def _id_tok(sentences, padding=True):
    """Sentences of ids after OPT's ``</s>`` (2); pad 1."""
    ids = [[2] + [int(w) for w in s.split()] for s in sentences]
    t = max(map(len, ids))
    return {"input_ids": [r + [1] * (t - len(r)) for r in ids],
            "attention_mask": [[1] * len(r) + [0] * (t - len(r)) for r in ids]}


# ------------------------------------------------------------ rank-side jobs


def _leaves(tree, prefix=""):
    """A tree's leaves as ``{dotted path: numpy}`` (bfloat16 as int16 bits)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, prefix + k + "."))
        else:
            out[prefix + k] = (v.view(torch.int16) if v.dtype == torch.bfloat16 else v).numpy()
    return out


def job_tp_logprobs(rank, path, n_model, dtype, quantize, ids, mask):
    """This rank's shards (``shard_params`` of the whole tree, quantized
    first) and the streamed rank-local load of the same; the tensor-parallel
    log-probs of ``ids``."""
    mesh = make_mesh(n_model=n_model, device="cpu")
    whole, spec = llm_engine.stream_load_hf(path, dtype)
    if quantize:
        whole = llm_engine.quantize_int8(whole)
    shards, dims = llm_engine.shard_params(whole, spec, mesh)
    streamed, _ = llm_engine.stream_load_hf(path, dtype, quantize=quantize, mesh=mesh)
    lp = llm_engine.engine_sentence_logprobs(shards, spec, torch.from_numpy(ids),
                                             torch.from_numpy(mask),
                                             llm_engine.DTYPES[dtype], tp=mesh)
    return {"m": mesh.m, "d": mesh.d, "shards": _leaves(shards),
            "streamed": _leaves(streamed), "lp": lp.numpy()}


def job_engine_scorer(rank, path, n_model, batch_size, quantize, sentences):
    """``engine_scorer(path, mesh=)`` on this rank's cell of the grid, and
    its scores of ``sentences`` (or the ``ValueError`` it raised)."""
    mesh = make_mesh(n_model=n_model, device="cpu")
    try:
        score = llm_engine.engine_scorer(path, batch_size=batch_size, compute_dtype="float32",
                                         param_dtype="float32", quantize=quantize, mesh=mesh,
                                         device="cpu")
    except ValueError as e:
        return str(e)
    return score(sentences)


def job_synth_scores(rank, n_model, quantize, sentences):
    """This rank's shards drawn by ``synth_params_on_device(shardings=,
    mesh=)`` (on the mesh's device) and ``params_scorer(mesh=)``'s scores."""
    mesh = make_mesh(n_model=n_model, device="cpu")
    shards = llm_engine.synth_params_on_device(
        TINY_RANK, seed=11, dtype=torch.float32, quantize=quantize,
        shardings=llm_engine.llm_shardings(TINY_RANK, mesh), mesh=mesh)
    score = llm_engine.params_scorer(shards, TINY_RANK, _id_tok, batch_size=4,
                                     compute_dtype="float32", mesh=mesh)
    return score(sentences)


# TINY (tests/test_torch_port_llm.py's spec), importable by the ranks
TINY_RANK = llm_engine.EngineSpec(n_layer=3, d_model=64, ffn_dim=128, n_head=4, vocab=48,
                                  n_positions=32)


# --------------------------------------------------------------- fixtures


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """A tiny OPT checkpoint with its GPT-2 tokenizer, and the same weights
    with a WordLevel tokenizer (which the ranks read without transformers)."""
    root = tmp_path_factory.mktemp("llm_tp")
    opt = _make_opt(root / "opt")
    words = root / "words"
    words.mkdir()
    for name in ("config.json", "model.safetensors"):
        shutil.copy(os.path.join(opt, name), words / name)
    bigram_opt.build_wordlevel_tokenizer(WORDS, str(words))
    return {"opt": opt, "words": str(words)}


def _jax_mesh(n_data, n_model):
    return JaxMesh(np.array(jax.devices()[: n_data * n_model]).reshape(n_data, n_model),
                   ("data", "model"))


def _shard_on(arr, device):
    """The addressable shard of a sharded JAX array on ``device``."""
    return next(s.data for s in arr.addressable_shards if s.device == device)


def _dim(p):
    """A JAX PartitionSpec as the sharded dimension (None: replicated)."""
    dims = [i for i, a in enumerate(p) if a == "model"]
    return dims[0] if dims else None


def _jax_tp_logprobs(path, grid, dtype, quantize, ids, mask):
    jparams, jspec = jax_engine.stream_load_hf(path, dtype)
    if quantize:
        jparams = jax_engine.quantize_int8(jparams)
    sharded, _ = jax_engine.shard_params(jparams, jspec, _jax_mesh(*GRIDS[grid]))
    fn = jax.jit(lambda p, i, m: jax_engine.engine_sentence_logprobs(
        p, jspec, i, m, compute_dtype=jnp.dtype(dtype)))
    return np.asarray(fn(sharded, ids, mask))


# -------------------------------------------------------------- the table


@pytest.mark.parametrize("quantize", [False, True])
def test_llm_shardings_match_jax_partition_specs(ckpts, quantize):
    """Every leaf's sharded dimension is JAX's PartitionSpec's 'model' axis,
    on the float tree and on the int8 tree (``_prune_to``'s leaves), for a
    ``Mesh`` and a ``ModelShard`` alike."""
    params, spec = llm_engine.stream_load_hf(ckpts["opt"], "float32", quantize=quantize)
    jspec = jax_engine.EngineSpec(**spec.__dict__)
    want = _flat(jax_engine.llm_shardings(jspec, _jax_mesh(1, 2)))
    table = _flat(llm_engine.llm_shardings(spec, ModelShard(0, 2)))
    assert sorted(table) == sorted(want)
    assert {k: _dim(p) for k, p in want.items()} == table
    _, dims = llm_engine.shard_params(params, spec, ModelShard(1, 2))
    assert sorted(_flat(dims)) == sorted(_flat(params))
    assert all(table[k] == v for k, v in _flat(dims).items())
    if quantize:
        assert _flat(dims)["blocks.wo_s"] is None and _flat(dims)["blocks.wqkv_s"] == 3


def test_indivisible_heads_raise(ckpts):
    """Heads that do not divide over the model ranks raise ``ValueError``
    ("divisible"), as JAX's ``llm_shardings``; so does ``shard_params``."""
    params, spec = llm_engine.stream_load_hf(ckpts["opt"], "float32")
    assert spec.n_head == 2
    with pytest.raises(ValueError, match="divisible"):
        jax_engine.llm_shardings(jax_engine.EngineSpec(**spec.__dict__), _jax_mesh(1, 3))
    with pytest.raises(ValueError, match="divisible"):
        llm_engine.llm_shardings(spec, ModelShard(0, 3))
    with pytest.raises(ValueError, match="divisible"):
        llm_engine.shard_params(params, spec, ModelShard(2, 3))
    with pytest.raises(ValueError, match="'model' axis"):
        llm_engine.llm_shardings(spec, ModelShard(0, 2), axis="data")


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shard_params_bit_equal_to_jax_shards(ckpts, dtype, quantize):
    """Each model rank's leaves (quantized whole, then sharded) are bit for
    bit the JAX array's addressable shard on that rank's device of a 1x2
    mesh."""
    params, spec = llm_engine.stream_load_hf(ckpts["opt"], dtype, quantize=quantize)
    jparams, jspec = jax_engine.stream_load_hf(ckpts["opt"], dtype, quantize=quantize)
    mesh = _jax_mesh(1, 2)
    jsharded = _flat(jax_engine.shard_params(jparams, jspec, mesh)[0])
    for m in range(2):
        got = _flat(llm_engine.shard_params(params, spec, ModelShard(m, 2))[0])
        assert sorted(got) == sorted(jsharded)
        for k, arr in jsharded.items():
            want = _bits(np.asarray(_shard_on(arr, mesh.devices[0, m])))
            np.testing.assert_array_equal(_bits(got[k]), want, err_msg=f"{k}, rank {m}")


# ------------------------------------------------------ the sharded forward


def _ranks_for(grid, ranks2, ranks4):
    return ranks2 if grid == "1x2" else ranks4


@pytest.mark.parametrize("grid", ["1x2", "2x2"])
@pytest.mark.parametrize("quantize", [False, True])
def test_tp_logprobs_match_jax_tp_and_one_rank(ckpts, ranks2, ranks4, grid, quantize):
    """Float32 (and int8 weights quantized then sharded, float32 compute):
    every rank's tensor-parallel log-probs within rtol 1e-5 / atol 1e-4 of
    JAX's ``shard_params`` + ``engine_sentence_logprobs`` on the same grid
    and of the port on one rank; each rank's ``shard_params`` leaves and
    its streamed rank-local load bit-equal to its slice of the whole tree."""
    ids, mask = _tokenize(ckpts["opt"], SENTENCES)
    res = _ranks_for(grid, ranks2, ranks4).run(
        "job_tp_logprobs", path=ckpts["opt"], n_model=2, dtype="float32", quantize=quantize,
        ids=ids, mask=mask)
    whole, spec = llm_engine.stream_load_hf(ckpts["opt"], "float32", quantize=quantize)
    one = llm_engine.engine_sentence_logprobs(whole, spec, torch.from_numpy(ids),
                                              torch.from_numpy(mask), torch.float32).numpy()
    want = _jax_tp_logprobs(ckpts["opt"], grid, "float32", quantize, ids, mask)
    np.testing.assert_allclose(one, want, **TOL)
    assert sorted((r["d"], r["m"]) for r in res) == sorted(
        (d, m) for d in range(GRIDS[grid][0]) for m in range(2))
    for r in res:
        np.testing.assert_allclose(r["lp"], want, **TOL)
        np.testing.assert_allclose(r["lp"], one, **TOL)
        ref = {k: _bits(v) for k, v in _flat(
            llm_engine.shard_params(whole, spec, ModelShard(r["m"], 2))[0]).items()}
        assert sorted(r["shards"]) == sorted(r["streamed"]) == sorted(ref)
        for k, v in ref.items():
            np.testing.assert_array_equal(r["shards"][k], v, err_msg=k)
            np.testing.assert_array_equal(r["streamed"][k], v, err_msg=k)
    assert np.all(np.isfinite(res[0]["lp"]))


@pytest.mark.parametrize("grid", ["1x2", "2x2"])
def test_engine_scorer_mesh_matches_jax(ckpts, ranks2, ranks4, grid):
    """``engine_scorer(path, mesh=)`` (the ranks stream only their slices;
    on the 2x2 grid each data coordinate scores its half of every batch of
    4) gives every rank JAX's ``engine_scorer(mesh=)`` scores, float32 and
    int8; a batch the data axis does not divide raises ``ValueError``."""
    for quantize in (False, True):
        res = _ranks_for(grid, ranks2, ranks4).run(
            "job_engine_scorer", path=ckpts["words"], n_model=2, batch_size=4,
            quantize=quantize, sentences=WORD_SENTENCES)
        want = jax_engine.engine_scorer(ckpts["words"], batch_size=4, compute_dtype="float32",
                                        param_dtype="float32", quantize=quantize,
                                        mesh=_jax_mesh(*GRIDS[grid]))(WORD_SENTENCES)
        one = llm_engine.engine_scorer(ckpts["words"], batch_size=3, compute_dtype="float32",
                                       param_dtype="float32", quantize=quantize,
                                       device="cpu")(WORD_SENTENCES)
        np.testing.assert_allclose(one, want, **TOL)
        for r in res:
            assert len(r) == len(WORD_SENTENCES)
            np.testing.assert_allclose(r, want, **TOL)
            assert r == res[0]
    if grid == "2x2":
        res = ranks4.run("job_engine_scorer", path=ckpts["words"], n_model=2, batch_size=3,
                         quantize=False, sentences=WORD_SENTENCES)
        assert all("does not split over" in r for r in res)


# ---------------------------------------------------------- the draws


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sharded_synth_is_the_slice_and_matches_jax(dtype, quantize):
    """``synth_params_on_device(shardings=, mesh=)`` on each of 2 and 4
    model ranks is bit for bit its slice of the one-rank draw; the one-rank
    draw's int8 leaves and scales are JAX's bits, its float leaves within
    ``FLOAT_SYNTH_ATOL`` (bfloat16: one rounding step) of JAX's."""
    tdt, jdt = llm_engine.DTYPES[dtype], jnp.dtype(dtype)
    whole = llm_engine.synth_params_on_device(TINY, seed=7, dtype=tdt, quantize=quantize,
                                              device="cpu")
    want = _flat(jax_engine.synth_params_on_device(jax_engine.EngineSpec(**TINY.__dict__),
                                                   seed=7, dtype=jdt, quantize=quantize))
    got = _flat(whole)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), k
        if g.dtype in (torch.int8,) or k.endswith("_s"):
            np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=k)
        else:
            w32 = np.asarray(w).astype(np.float32)
            tol = FLOAT_SYNTH_ATOL + (2.0**-8 * np.abs(w32) if dtype == "bfloat16" else 0)
            assert (np.abs(g.float().numpy() - w32) <= tol).all(), k
    for n in (2, 4):
        for m in range(n):
            tp = ModelShard(m, n)
            part = llm_engine.synth_params_on_device(
                TINY, seed=7, dtype=tdt, quantize=quantize,
                shardings=llm_engine.llm_shardings(TINY, tp), mesh=tp, device="cpu")
            ref = _flat(llm_engine.shard_params(whole, TINY, tp)[0])
            part = _flat(part)
            assert sorted(part) == sorted(ref)
            for k, v in ref.items():
                assert part[k].shape == v.shape and torch.equal(part[k], v), (k, n, m)
    with pytest.raises(ValueError, match="mesh"):
        llm_engine.synth_params_on_device(TINY, shardings={}, device="cpu")


@pytest.mark.parametrize("grid", ["1x2", "2x2"])
def test_synth_shards_score_as_one_rank(ranks2, ranks4, grid):
    """Each rank draws its shards (``shardings=``, on the mesh's device) and
    ``params_scorer(mesh=)`` scores with them: every rank returns the
    one-rank scores of the whole draw, float32 and int8, within rtol 1e-5
    / atol 1e-4."""
    rng = np.random.default_rng(3)
    sentences = [" ".join(map(str, rng.integers(4, TINY.vocab, size=int(n))))
                 for n in rng.integers(1, 12, size=10)]
    for quantize in (False, True):
        res = _ranks_for(grid, ranks2, ranks4).run(
            "job_synth_scores", n_model=2, quantize=quantize, sentences=sentences)
        whole = llm_engine.synth_params_on_device(TINY, seed=11, dtype=torch.float32,
                                                  quantize=quantize, device="cpu")
        want = llm_engine.params_scorer(whole, TINY, _id_tok, batch_size=4,
                                        compute_dtype="float32", device="cpu")(sentences)
        for r in res:
            np.testing.assert_allclose(r, want, **TOL)


# ------------------------------------------------------------ the dryrun


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_cpu(n, capsys):
    """``dryrun_multichip(n, "cpu")``: every stage's OK line (the
    Conformer's ``+pallas`` stage since n is even), each stage's grid, the
    bucketed stage's 8 per-step losses within rtol 1e-5 of one rank's, the
    same on every rank."""
    res = dryrun_multichip(n, "cpu", timeout_s=60)
    out = capsys.readouterr().out
    grid = f"({n // 2}x2)"
    for line in (f"[gru_baseline]: mesh={grid} devices={n}",
                 f"[transformer_ctc]: mesh={grid} devices={n}",
                 f"[gru_baseline+pallas]: mesh=({n}x1) devices={n}",
                 f"[transformer_ctc+pallas]: mesh={grid} devices={n}",
                 f"[gru_baseline+bucketed+device-data]: mesh=({n}x1) shapes="):
        assert f"dryrun_multichip OK {line}" in out, line
    assert sorted(r["rank"] for r in res) == list(range(n))
    for r in res:
        assert [s["mesh"] for s in r["stages"]] == [(n // 2, 2), (n // 2, 2), (n, 1),
                                                     (n // 2, 2), (n, 1)]
        bucketed = r["stages"][-1]
        assert len(bucketed["losses"]) == 8
        np.testing.assert_allclose(bucketed["losses"], bucketed["one_rank_losses"], rtol=1e-5)
        assert bucketed["losses"] == res[0]["stages"][-1]["losses"]
        assert all(np.isfinite(s["loss"]) for s in r["stages"])
