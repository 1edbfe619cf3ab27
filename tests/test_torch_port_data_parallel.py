"""Data-parallel training on the port against the JAX package and against
the port on one device, on the CPU over gloo.

Rank processes (``spawn``, one torch thread each) join a gloo group on
``localhost``; a module-scoped pool of two ranks runs the step-level jobs
below, so that the group is made once. Each job runs in every rank with the
same numpy inputs: the rank keeps its rows of the global batch
(``parallel/mesh.py::shard_batch``), and, where the job compares with one
device, also runs the single-device step itself on the whole batch.
Tolerances: the loss 1e-5 relative; gradients 2e-5 of each leaf's largest
entry and the parameters after Adam 1e-6 absolute, as
``test_torch_port_train.py::test_train_step_f32_matches_jax`` (the ranks'
sums of the CTC and scan terms are taken in another order, and averaged);
the random draws (noise, dropout and DropPath masks, SpecAugment's masks)
bit for bit. A job that does not answer within 120 s fails its test.
"""

import json
import multiprocessing as mp
import os
import signal
import traceback
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

# The rank processes import this module for its jobs, which run the port
# alone: the JAX reference is imported in the test process only (the ranks
# are started with RANK_ENV set).
RANK_ENV = "NSD_TEST_RANK_PROCESS"
if not os.environ.get(RANK_ENV):
    import jax
    import jax.numpy as jnp

    from neural_speech_decoder_tpu.parallel import mesh as jax_mesh
    from neural_speech_decoder_tpu.parallel import multihost as jax_multihost
    from neural_speech_decoder_tpu.training import trainer as jax_trainer
    from neural_speech_decoder_tpu.training.optim import make_optimizer as jax_make_optimizer
from neural_speech_decoder_tpu_torch.data.synthetic import synthetic_dataset
from neural_speech_decoder_tpu_torch.models import conformer, gru
from neural_speech_decoder_tpu_torch.models.api import build_model, config_from_args
from neural_speech_decoder_tpu_torch.models.convert import gru_params_from_jax
from neural_speech_decoder_tpu_torch.models.gru import GRUDecoder
from neural_speech_decoder_tpu_torch.ops.hashrng import fold_seed
from neural_speech_decoder_tpu_torch.ops.kernels.attention import dropout_masks
from neural_speech_decoder_tpu_torch.parallel import data_parallel as dp
from neural_speech_decoder_tpu_torch.parallel import multihost
from neural_speech_decoder_tpu_torch.parallel.mesh import Mesh, batch_sharding, make_mesh, shard_batch
from neural_speech_decoder_tpu_torch.training import trainer
from neural_speech_decoder_tpu_torch.training.checkpoints import CheckpointManager
from neural_speech_decoder_tpu_torch.training.optim import make_optimizer
from neural_speech_decoder_tpu_torch.training.trainer import (
    make_train_step,
    step_generator,
    train_model,
)

JOB_TIMEOUT = 120.0
N_DAYS = 3


def _gru_args(**kw):
    args = dict(nInputFeatures=32, nClasses=40, nUnits=32, nLayers=2,
                dropout=0.0, strideLen=4, kernelLen=8, gaussianSmoothWidth=2.0,
                bidirectional=True, whiteNoiseSD=0.0, constantOffsetSD=0.0,
                lrStart=0.02, lrEnd=0.01, l2_decay=1e-5, nBatch=10, seed=0,
                watch_log_freq=0, batchSize=4)
    args.update(kw)
    return args


def _conformer_args(**kw):
    args = dict(model_type="transformer_ctc", nInputFeatures=32, nClasses=40,
                frontend_dim=64, latent_dim=128, autoencoder_hidden_dim=64,
                transformer_num_layers=2, transformer_n_heads=2,
                transformer_dim_ff=128, conformer_conv_kernel=7,
                transformer_dropout=0.0, drop_path_prob=0.3,
                use_spec_augment=True, spec_augment_freq_mask=40,
                spec_augment_time_mask=8, whiteNoiseSD=0.2, constantOffsetSD=0.1,
                optimizer="adamw", lrStart=4e-4, lrEnd=4e-4, l2_decay=1e-3,
                warmup_steps=2, nBatch=10, label_smoothing=0.1, seed=0,
                watch_log_freq=0, batchSize=4)
    args.update(kw)
    return args


def _batch(b=4, t=120, c=32, u=6, seed=0):
    rng = np.random.default_rng(seed)
    lens = np.array([120, 97, 64, 20, 111, 88, 73, 120][:b], np.int32)
    return (rng.standard_normal((b, t, c)).astype(np.float32),
            rng.integers(1, 41, size=(b, u)).astype(np.int32),
            lens,  # 20 < kernel: 0 frames
            np.array([6, 4, 3, 2, 5, 6, 4, 3][:b], np.int32),
            (np.arange(b) % N_DAYS).astype(np.int32))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k in tree for k2, v2 in _flat(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().numpy()
    return {prefix: np.asarray(tree, np.float32)}


# ------------------------------------------------------- the rank processes


def _rank_loop(rank: int, world: int, address: str, conn) -> None:
    """A pool rank: join the gloo group, then run the jobs the test sends
    (``(name, kwargs)``, None to stop) and send back their results."""
    torch.set_num_threads(1)
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


@pytest.fixture(scope="module")
def ranks2():
    pool = _Ranks(2)
    yield pool
    pool.close()


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


@contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


# ------------------------------------------------------------ rank-side jobs


def _port_step(args, model, batch, mesh, step=0):
    """One train step of ``model`` on ``batch`` (numpy; this rank's rows of
    it with a mesh in a group): (loss, gradients, updated parameters)."""
    opt, sched = make_optimizer(args, model.parameters())
    train_step = make_train_step(args, model, opt, sched, mesh)
    local = (shard_batch(mesh, batch) if mesh is not None and mesh.distributed
             else tuple(torch.from_numpy(a) for a in batch))
    metrics = train_step(local, step_generator(torch.device("cpu"), int(args["seed"]), step))
    grads = _flat(_grads(model.params))
    return float(metrics["train/loss"]), grads, _flat(model.params)


def _grads(tree):
    if isinstance(tree, dict):
        return {k: _grads(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_grads(v) for v in tree]
    return tree.grad.float()


def job_gru_step_from_jax(rank, args, params, batch):
    """The port's data-parallel step on JAX's initial weights."""
    model = GRUDecoder(config_from_args(args, N_DAYS), gru_params_from_jax(params))
    return _port_step(args, model, batch, make_mesh(device="cpu"))


def job_local_rows(rank, n_rows):
    try:
        return multihost.local_rows(n_rows), multihost.is_primary()
    except ValueError as e:
        return str(e), multihost.is_primary()


class _Recorder:
    """The outputs of the random draws of a forward, by kind, in call
    order: the noisy input, and where the GRU's dropout, DropPath, the
    hash dropout and SpecAugment zeroed entries; the kernels' seeds."""

    def __init__(self):
        self.seen: dict[str, list] = {}

    def wrap(self, kind, fn, record=lambda out, a, k: out == 0):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            self.seen.setdefault(kind, []).append(record(out, a, k))
            return out
        return wrapped

    @contextmanager
    def active(self):
        def seed_of(out, a, k):  # the seed, the frame count, the heads
            return a[2].clone(), a[0].shape[1], k["num_heads"]

        with _patched(trainer, "apply_noise", self.wrap("noise", trainer.apply_noise,
                                                        lambda out, a, k: out.clone())), \
                _patched(gru, "dropout", self.wrap("gru_dropout", gru.dropout)), \
                _patched(conformer, "_drop_path", self.wrap("drop_path", conformer._drop_path)), \
                _patched(conformer, "hash_dropout", self.wrap("hash", conformer.hash_dropout)), \
                _patched(conformer, "spec_augment", self.wrap("spec", conformer.spec_augment)), \
                _patched(conformer, "mhsa", self.wrap("attn_seed", conformer.mhsa, seed_of)):
            yield self


def job_draws_against_one_device(rank, args, batch, step=3):
    """The single-device step on the whole batch and the data-parallel step
    on this rank's rows, from one initial model, each with its draws
    recorded: the draws compared (the rank's rows of the single-device
    draws), the losses and the gradients returned."""
    mesh = make_mesh(device="cpu")
    rows = batch_sharding(mesh, batch[0].shape[0])
    runs = {}
    for name, m in (("one", None), ("dp", mesh)):
        model = build_model(args, N_DAYS, "cpu", int(args["seed"]))
        with _Recorder().active() as rec:
            loss, grads, _ = _port_step(args, model, batch, m, step)
        runs[name] = (loss, grads, rec.seen)
    (loss1, g1, one), (loss_dp, g_dp, mine) = runs["one"], runs["dp"]
    same, counts = {}, {}
    for kind in one:
        if kind == "attn_seed":
            continue
        assert len(one[kind]) == len(mine.get(kind, ())), kind
        counts[kind] = len(one[kind])
        same[kind] = all(torch.equal(a[rows], b) for a, b in zip(one[kind], mine[kind]))
    seeds = None
    if "attn_seed" in one:
        rate = float(args["transformer_dropout"])
        seeds = []
        for (s1, _, _), (s_dp, t, heads) in zip(one["attn_seed"], mine["attn_seed"]):
            bh = (rows.stop - rows.start) * heads
            seeds.append((int(fold_seed(s1, rank)), int(s_dp),
                          torch.equal(dropout_masks(bh, t, fold_seed(s1, rank), rate),
                                      dropout_masks(bh, t, s_dp, rate))))
    return {"loss_one": loss1, "loss_dp": loss_dp, "grads_one": g1, "grads_dp": g_dp,
            "same": same, "counts": counts, "seeds": seeds}


def job_train(rank, args, preempt_rank=None, preempt_call=None):
    """``train_model`` in this rank of the caller's group (way (a)), with the
    writes of every rank recorded; ``preempt_rank`` sends itself SIGTERM in
    its ``preempt_call``-th batch draw."""
    writes = []

    def rec(name, fn):
        def wrapped(*a, **k):
            writes.append(name)
            return fn(*a, **k)
        return wrapped

    real_sample = trainer.sample_batch
    calls = []

    def sample(*a, **k):
        calls.append(1)
        if rank == preempt_rank and len(calls) == preempt_call:
            os.kill(os.getpid(), signal.SIGTERM)
        return real_sample(*a, **k)

    with _patched(trainer, "save_args", rec("args", trainer.save_args)), \
            _patched(trainer, "save_training_stats",
                     rec("trainingStats", trainer.save_training_stats)), \
            _patched(CheckpointManager, "save", rec("save", CheckpointManager.save)), \
            _patched(CheckpointManager, "save_sidecar",
                     rec("trainerState", CheckpointManager.save_sidecar)), \
            _patched(trainer, "sample_batch", sample):
        summary = train_model(args)
    return summary, writes


# ------------------------------------------------------------------ helpers


def test_local_rows_and_batch_sharding_match_jax(ranks2, monkeypatch):
    """``local_rows`` gives JAX's slices (and its error for rows that do not
    divide) at every world size and rank; in the pool's two ranks it reads
    the group, and only rank 0 is primary."""
    for world in (1, 2, 4):
        for rank in range(world):
            monkeypatch.setattr(jax, "process_count", lambda w=world: w)
            monkeypatch.setattr(jax, "process_index", lambda r=rank: r)
            for n in (4, 8, 12, 6):
                mine = Mesh(world, rank, torch.device("cpu"))
                if n % world:
                    with pytest.raises(ValueError) as theirs:
                        jax_multihost.local_rows(n)
                    with pytest.raises(ValueError, match=str(theirs.value)):
                        batch_sharding(mine, n)
                else:
                    assert batch_sharding(mine, n) == jax_multihost.local_rows(n)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    for n in (8, 6, 5):
        got = ranks2.run("job_local_rows", n_rows=n)
        for rank, (rows, primary) in enumerate(got):
            assert primary == (rank == 0)
            monkeypatch.setattr(jax, "process_index", lambda r=rank: r)
            try:
                want = jax_multihost.local_rows(n)
            except ValueError as e:
                want = str(e)
            assert rows == want


class _Resolved(Exception):
    pass


@pytest.mark.parametrize("case", [
    dict(devices=8, kw={}),
    dict(devices=8, kw={"batchSize": 12}),
    dict(devices=8, kw={"batchSize": 12, "n_data_devices": 5}),
    dict(devices=4, kw={"batchSize": 6}),
    dict(devices=8, kw={"batchSize": 7, "n_data_devices": 3}),
    dict(devices=8, kw={"tokensPerBatch": 200, "batchMultiple": 6, "lengthBuckets": 2}),
    dict(devices=2, kw={"n_data_devices": 8}),
])
def test_n_data_resolves_as_jax(case, tmp_path, monkeypatch):
    """``resolve_n_data`` on ``cuda`` with N visible cards against the size
    of the 'data' axis that JAX's trainer gives its mesh over N devices
    (``training/trainer.py:537-555``, captured at its ``make_mesh``)."""
    args = {"outputDir": str(tmp_path), "wandb_mode": "disabled", "nBatch": 1,
            "dataset": synthetic_dataset(seed=3, n_days=1, trials_per_day=8, n_channels=8,
                                         min_t=24, max_t=40, min_u=2, max_u=4),
            **_gru_args(nInputFeatures=8, nUnits=8, nLayers=1, batchSize=8), **case["kw"]}
    devices = jax.devices()[:case["devices"]]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: devices)

    def capture(n_data=None, n_model=1, *, devices=None):
        raise _Resolved(n_data)

    monkeypatch.setattr(jax_trainer, "make_mesh", capture)
    with pytest.raises(_Resolved) as theirs:
        jax_trainer.train_model(args)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: case["devices"])
    assert dp.resolve_n_data(args, torch.device("cuda")) == theirs.value.args[0]
    # an explicit card is one device; the CPU runs as many gloo ranks as
    # asked (by default one), cut by the same rule
    assert dp.resolve_n_data(args, torch.device("cuda", 0)) == 1
    asked = args.get("n_data_devices")
    cpu = dp.resolve_n_data(args, torch.device("cpu"))
    if not asked:
        assert cpu == 1
    elif asked <= case["devices"]:
        assert cpu == theirs.value.args[0]


def test_tensor_parallelism_still_raises(tmp_path):
    """What tensor parallelism still refuses, before anything is written: a
    head count the 'model' axis does not divide (JAX's ``shard_params``
    message), the fused FF kernel (it needs the whole FF weights), and a
    grid that one process cannot hold."""
    conf = {"outputDir": str(tmp_path), "device": "cpu", **_conformer_args(),
            "n_model_devices": 2}
    with pytest.raises(ValueError, match="num_heads=3 not divisible by the 'model'"):
        train_model({**conf, "transformer_n_heads": 3, "latent_dim": 96})
    with pytest.raises(ValueError, match="fused_ffn under tensor parallelism"):
        train_model({**conf, "fused_ffn": True})
    with pytest.raises(ValueError, match="does not divide"):
        make_mesh(n_model=2, device="cpu")
    assert not (tmp_path / "args").exists()


# --------------------------------------------------- the step against JAX DP


def _jax_dp_step(args, params, batch, world):
    """JAX's loss, gradients and updated parameters with the batch sharded
    over a ``world``-device CPU mesh and the state replicated (GSPMD)."""
    mesh = jax_mesh.make_mesh(n_data=world, devices=jax.devices()[:world])
    rep, sh = jax_mesh.replicated_sharding(mesh), jax_mesh.batch_sharding(mesh)
    params = jax.device_put(jax.tree.map(jnp.asarray, params), rep)
    batch = tuple(jax.device_put(a, sh) for a in batch)
    model = jax_trainer.build_model(args, N_DAYS)
    key = jax.random.key(0)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jax_trainer._loss_and_metrics(args, model, p, b, key), has_aux=True
    ))(params, batch)
    tx, schedule = jax_make_optimizer(args)
    state = jax.device_put({"params": params, "opt_state": tx.init(params),
                            "step": jnp.array(0)}, rep)
    state, _ = jax_trainer.make_train_step(args, model, tx, schedule)(state, *batch, key)
    return float(loss), _flat(jax.device_get(grads)), _flat(jax.device_get(state["params"]))


def _check_against_jax(results, ref):
    ref_loss, ref_grads, ref_params = ref
    for loss, grads, params in results:
        assert loss == pytest.approx(ref_loss, rel=1e-5)
        assert grads.keys() == ref_grads.keys() and len(grads) == 12
        for k, want in ref_grads.items():
            np.testing.assert_allclose(grads[k], want, atol=2e-5 * np.abs(want).max(),
                                       err_msg=k)
        for k, want in ref_params.items():
            np.testing.assert_allclose(params[k], want, atol=1e-6, err_msg=k)
    # every rank holds the same update, bit for bit
    for _, grads, params in results[1:]:
        assert all(np.array_equal(params[k], results[0][2][k]) for k in params)


def test_gru_step_two_ranks_matches_jax_dp(ranks2):
    args = _gru_args()
    params = jax.tree.map(np.asarray, jax_trainer.build_model(args, N_DAYS)
                          .init(jax.random.key(1)))
    batch = _batch()
    ref = _jax_dp_step(args, params, batch, 2)
    _check_against_jax(ranks2.run("job_gru_step_from_jax", args=args, params=params,
                                  batch=batch), ref)


def test_gru_step_four_ranks_matches_jax_dp():
    args = _gru_args(batchSize=8)
    params = jax.tree.map(np.asarray, jax_trainer.build_model(args, N_DAYS)
                          .init(jax.random.key(2)))
    batch = _batch(b=8, seed=1)
    ref = _jax_dp_step(args, params, batch, 4)
    pool = _Ranks(4)
    try:
        got = pool.run("job_gru_step_from_jax", args=args, params=params, batch=batch)
    finally:
        pool.close()
    _check_against_jax(got, ref)


# ----------------------------------- DP against one device, randomness on


def _check_draws(results, kinds, grads_too=False):
    for rank, res in enumerate(results):
        assert set(res["same"]) == set(kinds), res["same"]
        assert all(res["same"].values()), (rank, res["same"])
        assert all(n > 0 for n in res["counts"].values()), res["counts"]
        assert res["loss_dp"] == pytest.approx(res["loss_one"], rel=1e-5)
        if grads_too:
            for k, want in res["grads_one"].items():
                np.testing.assert_allclose(res["grads_dp"][k], want,
                                           atol=2e-5 * np.abs(want).max(), err_msg=k)


def test_gru_noise_and_dropout_are_the_ranks_rows_of_one_device(ranks2):
    """White noise, the constant offset and the GRU's inter-layer dropout:
    each rank's are bit-equal to its rows of the single-device draws."""
    args = _gru_args(whiteNoiseSD=0.3, constantOffsetSD=0.2, dropout=0.4, nLayers=3)
    res = ranks2.run("job_draws_against_one_device", args=args, batch=_batch())
    _check_draws(res, {"noise", "gru_dropout"}, grads_too=True)
    assert res[0]["counts"]["gru_dropout"] == 2


def test_conformer_hash_dropout_droppath_specaugment_rows(ranks2):
    """The Conformer with its head's hash dropout, DropPath, SpecAugment and
    noise on, the kernels' rate 0 (``transformer_dropout`` 0): the same."""
    args = _conformer_args()
    res = ranks2.run("job_draws_against_one_device", args=args, batch=_batch())
    _check_draws(res, {"noise", "drop_path", "hash", "spec"}, grads_too=True)
    assert res[0]["counts"] == {"noise": 1, "drop_path": 6, "hash": 1, "spec": 1}


def test_conformer_kernel_dropout_folds_the_rank(ranks2):
    """With the kernels dropping (``transformer_dropout`` 0.2: the attention
    kernel's rate, and the hash dropout of the FFs, conv modules and
    frontend): every hash mask is the rank's rows of the single-device
    mask, and rank r's attention seed and mask are the single-device ones
    under ``fold_seed(seed, r)``."""
    args = _conformer_args(transformer_dropout=0.2)
    res = ranks2.run("job_draws_against_one_device", args=args, batch=_batch())
    for rank, r in enumerate(res):
        assert all(r["same"].values()) and r["counts"]["hash"] > 1, r["same"]
        assert len(r["seeds"]) == 2
        for folded, mine, masks_equal in r["seeds"]:
            assert folded == mine and masks_equal
    assert res[0]["seeds"][0][1] != res[1]["seeds"][0][1]


@pytest.mark.parametrize("kw", [
    {"label_smoothing": 0.1},
    {"tokensPerBatch": 500, "batchSize": 8},
    {"label_smoothing": 0.1, "tokensPerBatch": 500, "batchSize": 8},
], ids=["kl", "tokens", "both"])
def test_kl_and_tokens_scale_give_the_single_device_gradient(ranks2, kw):
    """The label-smoothing KL (a sum over rows) and the ``tokensPerBatch``
    scale (the global row count over batchSize): the averaged gradients
    equal the single-device ones at the float32 tolerances."""
    res = ranks2.run("job_draws_against_one_device", args=_gru_args(**kw), batch=_batch())
    _check_draws(res, {"noise"}, grads_too=True)


# -------------------------------------------------------- train_model


def _run_args(out, n_batch, **kw):
    args = {
        "outputDir": str(out), "device": "cpu",
        "dataset": synthetic_dataset(seed=3, n_days=2, trials_per_day=10, n_channels=8,
                                     min_t=24, max_t=40, min_u=2, max_u=4),
        "batchSize": 4, "lrStart": 0.005, "lrEnd": 0.001, "l2_decay": 1e-5,
        "nBatch": n_batch, "evalEvery": 10, "whiteNoiseSD": 0.2,
        "constantOffsetSD": 0.1, "gaussianSmoothWidth": 2.0, "nUnits": 16,
        "nLayers": 2, "nInputFeatures": 8, "nClasses": 40, "dropout": 0.3,
        "strideLen": 2, "kernelLen": 4, "bidirectional": True, "seed": 0,
        "wandb_mode": "offline", "time_multiple": 16, "checkpointEvery": 0,
        "dist_timeout_s": 60,
    }
    args.update(kw)
    return args


def _records(run_dir):
    return [json.loads(line) for line in (Path(run_dir) / "metrics.jsonl").read_text()
            .splitlines()]


def _losses(run_dir):
    return [r["train/loss"] for r in _records(run_dir) if "train/loss" in r]


def _evals(run_dir):
    return [(r["step"], r["eval/cer"], r["eval/loss"]) for r in _records(run_dir)
            if "eval/cer" in r]


def _same_run(dp_dir, one_dir, n_steps):
    a, b = _losses(dp_dir), _losses(one_dir)
    assert len(a) == len(b) == n_steps
    for x, y in zip(a, b):
        assert x == pytest.approx(y, rel=1e-5)
    (ea, eb) = _evals(dp_dir), _evals(one_dir)
    assert [e[:2] for e in ea] == [e[:2] for e in eb]  # PER equal
    for x, y in zip(ea, eb):
        assert x[2] == pytest.approx(y[2], rel=1e-5)
    assert sorted(os.listdir(dp_dir)) == sorted(os.listdir(one_dir))


@pytest.fixture(scope="module")
def one_device_run(tmp_path_factory):
    """The single-device run the data-parallel ones are held against."""
    out = tmp_path_factory.mktemp("one") / "run"
    with _one_thread_env():
        summary = train_model(_run_args(out, 30))
    return out, summary


def test_train_model_spawns_ranks(tmp_path, one_device_run):
    """Way (b): no group and ``n_data_devices: 2`` on the CPU: train_model
    starts two gloo ranks and returns rank 0's summary; per-step losses and
    the eval equal the single-device run's, the files are its set, and the
    last record holds each rank's launches and span."""
    one_dir, one_summary = one_device_run
    out = tmp_path / "dp"
    summary = train_model(_run_args(out, 30, n_data_devices=2))
    assert summary.keys() == one_summary.keys()
    assert summary["summary/best_cer"] == one_summary["summary/best_cer"]
    _same_run(out, one_dir, 30)
    last = _records(out)[-1]
    for r in (0, 1):
        assert last[f"summary/rank{r}/launches/gru_scan_gates"] == 0  # CPU tensors
        assert last[f"summary/rank{r}/steps_wall_start"] <= last[f"summary/rank{r}/steps_wall_end"]
    assert not dist.is_initialized()


def test_train_model_in_the_callers_group_writes_on_rank_0_only(ranks2, tmp_path,
                                                                one_device_run):
    """Way (a): each rank of the caller's group calls train_model; only
    rank 0 writes, the run equals the single-device run."""
    one_dir, one_summary = one_device_run
    out = tmp_path / "dp"
    res = ranks2.run("job_train", args=_run_args(out, 30))
    (s0, w0), (s1, w1) = res
    assert s0 == s1 and s0["summary/best_cer"] == one_summary["summary/best_cer"]
    assert w1 == [] and {"args", "trainingStats", "save", "trainerState"} <= set(w0)
    _same_run(out, one_dir, 30)


def test_sigterm_to_one_rank_stops_both_then_resume_at_world_1(ranks2, tmp_path,
                                                               one_device_run):
    """SIGTERM to rank 1 alone during its 12th batch draw: both ranks agree
    on the stop (one step later: the flag is read with the next step's
    metrics), return the same step, and rank 0 writes one checkpoint;
    ``resume: true`` on one device then gives the uninterrupted run's
    losses and eval history."""
    one_dir, one_summary = one_device_run
    out = tmp_path / "dp"
    res = ranks2.run("job_train", args=_run_args(out, 30), preempt_rank=1, preempt_call=12)
    (s0, w0), (s1, w1) = res
    assert s0 == s1 and s0["summary/preempted_at"] == 13
    assert w1 == [] and w0.count("trainerState") == 1
    state = CheckpointManager(str(out)).restore("lastState")
    assert state["step"] == 13
    second = train_model(_run_args(out, 30, resume=True))
    assert second == pytest.approx(one_summary, rel=1e-5)
    _same_run(out, one_dir, 30)
    stats = CheckpointManager(str(out)).load_sidecar()
    want = CheckpointManager(str(one_dir)).load_sidecar()
    assert stats["testCER"] == want["testCER"] and stats["step"] == want["step"] == 30
    np.testing.assert_allclose(stats["testLoss"], want["testLoss"], rtol=1e-5)


def test_a_failed_rank_fails_the_launch_without_a_hang(tmp_path):
    """A rank that raises: ``launch`` kills the other (waiting in a
    collective) and raises with the rank's traceback."""
    with _one_thread_env(**{RANK_ENV: "1"}), \
            pytest.raises(RuntimeError, match=r"rank 1:(.|\n)*FileNotFoundError"):
        dp.launch(_fail_on_rank_1, [(str(tmp_path / "missing.pkl"),)] * 2,
                  devices=["cpu", "cpu"], backend="gloo", timeout_s=60, grace_s=2)


def _fail_on_rank_1(path):
    if dist.get_rank() == 1:
        open(path, "rb")
    dist.barrier()
    return dist.get_rank()


def test_stdin_main_is_refused(monkeypatch):
    class Main:
        __file__ = "<stdin>"

    monkeypatch.setitem(__import__("sys").modules, "__main__", Main)
    with pytest.raises(RuntimeError, match="stdin"):
        dp.launch(_fail_on_rank_1, [("x",)] * 2, devices=["cpu", "cpu"], backend="gloo")
