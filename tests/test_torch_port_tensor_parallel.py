"""Tensor-parallel training on the port against the JAX package and against
the port on one rank, on the CPU over gloo.

Rank processes (``spawn``, one torch thread each) join a gloo group on
``localhost`` as the cells of an ``(n_data, n_model)`` grid
(``parallel/mesh.py``): a module-scoped pool of two ranks is the 1x2 grid,
one of four the 2x2 grid. The runs start from the JAX package's initial
weights (its ``build_model(...).init``), so that they are held against
JAX's own 2x2 run with the tolerances of JAX's ``tests/
test_tensor_parallel.py``: best_loss within 1e-3, best_cer equal, every
parameter within 1e-4 (after de-interleaving the Conformer's qkv). The
step-level jobs hold each rank's gradient shards against its slice of the
one-rank gradient within 2e-5 of the leaf's largest entry, and the clip's
norm within 1e-5 relative. A job that does not answer within 120 s fails
its test.
"""

import dataclasses
import multiprocessing as mp
import os
import signal
import traceback
from contextlib import contextmanager

import numpy as np
import pytest
import torch
import torch.distributed as dist

# The rank processes import this module for its jobs, which run the port
# alone: the JAX reference is imported in the test process only.
RANK_ENV = "NSD_TEST_RANK_PROCESS"
if not os.environ.get(RANK_ENV):
    import jax
    import jax.numpy as jnp

    from neural_speech_decoder_tpu.models import conformer as jax_conformer
    from neural_speech_decoder_tpu.parallel import shardings as jax_shardings
    from neural_speech_decoder_tpu.training import trainer as jax_trainer

    @dataclasses.dataclass(frozen=True)
    class _JaxConfigNoHeadDropout(jax_conformer.ConformerConfig):
        head_dropout: float = 0.0
from neural_speech_decoder_tpu_torch.data.synthetic import synthetic_dataset
from neural_speech_decoder_tpu_torch.models import api, conformer
from neural_speech_decoder_tpu_torch.models.api import (
    build_model,
    config_from_args,
    forward,
    shard_model,
)
from neural_speech_decoder_tpu_torch.models.conformer import ConformerConfig, ConformerDecoder
from neural_speech_decoder_tpu_torch.models.convert import params_from_jax
from neural_speech_decoder_tpu_torch.parallel import data_parallel as dp
from neural_speech_decoder_tpu_torch.parallel import multihost
from neural_speech_decoder_tpu_torch.parallel.mesh import make_mesh, shard_batch
from neural_speech_decoder_tpu_torch.parallel.shardings import (
    deinterleave_attention_params,
    interleave_attention_params,
    leaf_dim,
    named_leaves,
    relayout_attention,
)
from neural_speech_decoder_tpu_torch.training import trainer
from neural_speech_decoder_tpu_torch.training.checkpoints import CheckpointManager
from neural_speech_decoder_tpu_torch.training.optim import make_optimizer
from neural_speech_decoder_tpu_torch.training.trainer import (
    load_model,
    make_run_mesh,
    make_train_step,
    step_generator,
    train_model,
)

JOB_TIMEOUT = 120.0
N_DAYS = 2


def _run_args(out, **over):
    """JAX's ``tests/test_tensor_parallel.py::run`` args, on the CPU."""
    args = {
        "outputDir": str(out), "device": "cpu",
        "dataset": synthetic_dataset(seed=0, n_days=N_DAYS, trials_per_day=10,
                                     n_channels=16, min_t=40, max_t=60, min_u=2,
                                     max_u=4, signal_scale=3.0),
        "batchSize": 4, "lrStart": 0.01, "lrEnd": 0.01, "l2_decay": 0.0, "nBatch": 8,
        "evalEvery": 4, "whiteNoiseSD": 0.0, "constantOffsetSD": 0.0,
        "gaussianSmoothWidth": 2.0, "nUnits": 32, "nLayers": 2, "nInputFeatures": 16,
        "nClasses": 40, "dropout": 0.0, "strideLen": 4, "kernelLen": 8,
        "bidirectional": True, "seed": 0, "wandb_mode": "disabled", "time_multiple": 16,
        "dist_timeout_s": 60,
    }
    args.update(over)
    return args


# JAX's CONF_OVER
CONF_OVER = dict(
    model_type="transformer_ctc", temporal_kernel=8, temporal_stride=4,
    gaussian_smooth_width=2.0, frontend_dim=16, latent_dim=16, autoencoder_hidden_dim=12,
    transformer_num_layers=2, transformer_n_heads=2, transformer_dim_ff=16,
    transformer_dropout=0.0, conformer_conv_kernel=5, drop_path_prob=0.0,
    optimizer="adamw", lrStart=1e-3, weight_decay=0.0, warmup_steps=2,
    label_smoothing=0.1, use_spec_augment=False,
)
FAMILY = {"gru": {}, "conformer": CONF_OVER}


def _flat(tree) -> dict:
    return {"/".join(p): np.asarray(t.detach().float().cpu().numpy() if torch.is_tensor(t)
                                    else t, np.float32)
            for p, t in named_leaves(tree)}


def _close(got, want, atol) -> None:
    """Two parameter trees with the same leaves, each within ``atol`` (a
    number, or one a leaf path)."""
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, atol=atol[k] if isinstance(atol, dict) else atol,
                                   err_msg=k)


def _batch(b=4, t=60, c=16, u=4, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, c)).astype(np.float32),
            rng.integers(1, 41, size=(b, u)).astype(np.int32),
            np.array([60, 47, 53, 40, 58, 44, 60, 51][:b], np.int32),
            np.array([4, 3, 2, 4, 3, 2, 4, 3][:b], np.int32),
            (np.arange(b) % N_DAYS).astype(np.int32))


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
    """``world`` rank processes in one gloo group; ``submit`` sends a job to
    every rank, ``collect`` returns their results by rank."""

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

    def submit(self, name: str, **kwargs) -> str:
        for c in self.conns:
            c.send((name, kwargs))
        return name

    def collect(self, name: str) -> list:
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

    def run(self, name: str, **kwargs) -> list:
        return self.collect(self.submit(name, **kwargs))

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


@contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@dataclasses.dataclass(frozen=True)
class _ConfigNoHeadDropout(ConformerConfig):
    head_dropout: float = 0.0


@contextmanager
def _no_head_dropout():
    """The Conformer's head dropout at 0 in the configs both packages build
    from args (JAX's ``build_model`` does not expose it, and the two draw
    its masks from different generators)."""
    with _patched(api, "ConformerConfig", _ConfigNoHeadDropout):
        if os.environ.get(RANK_ENV):
            yield
            return
        with _patched(jax_conformer, "ConformerConfig", _JaxConfigNoHeadDropout):
            yield


@contextmanager
def _initial_weights(init):
    """``trainer.build_model`` drawing nothing: the model starts from
    ``init`` (numpy, the JAX package's tree), as JAX's trainer does."""
    if init is None:
        yield
        return
    real = trainer.build_model

    def build(args, n_days, device, seed=0):
        model = real(args, n_days, device, seed)
        model.load_params(params_from_jax(init))
        return model

    with _patched(trainer, "build_model", build):
        yield


# ------------------------------------------------------------ rank-side jobs


def job_train(rank, args, init=None, preempt_call=None):
    """``train_model`` in this rank of the caller's group; with
    ``preempt_call``, rank 1 sends itself SIGTERM in that batch draw."""
    real_sample = trainer.sample_batch
    calls = []

    def sample(*a, **k):
        calls.append(1)
        if rank == 1 and len(calls) == preempt_call:
            os.kill(os.getpid(), signal.SIGTERM)
        return real_sample(*a, **k)

    with _initial_weights(init), _no_head_dropout(), \
            _patched(trainer, "sample_batch", sample):
        return train_model(args)


def _step(args, model, batch, mesh, steps=1):
    """``steps`` train steps of ``model`` on ``batch`` (this rank's rows of
    it with a 'data' axis): the first step's metrics, the last gradients
    and the parameters after the update."""
    opt, sched = make_optimizer(args, model.parameters())
    train_step = make_train_step(args, model, opt, sched, mesh)
    local = (shard_batch(mesh, batch) if mesh is not None and mesh.n_data > 1
             else tuple(torch.from_numpy(a) for a in batch))
    first = None
    for step in range(steps):
        metrics = train_step(local, step_generator(torch.device("cpu"),
                                                   int(args["seed"]), step))
        first = first or {k: float(v) for k, v in metrics.items()}
    grads = {"/".join(p): t.grad.float().numpy().copy() for p, t in named_leaves(model.params)}
    return first, grads, _flat(model.params)


def job_step_against_one_rank(rank, args, batch, steps=1, record=False):
    """One model, whole on this rank (the single-device step on the whole
    batch) and sharded over the group's grid (``n_model_devices``; its rows
    with a 'data' axis): both steps' metrics, gradients and parameters,
    the one-rank ones in the sharded model's qkv layout. ``record``: the FF
    hidden's dropout masks of both runs (calls at width F and F/n)."""
    mesh = make_run_mesh(args, torch.device("cpu"))
    one_args = {k: v for k, v in args.items() if k != "n_model_devices"}
    seed = int(args["seed"])
    masks = {"one": [], "tp": []}
    runs = {}
    for name, a, m in (("one", one_args, None), ("tp", args, mesh)):
        model = build_model(a, N_DAYS, "cpu", seed)
        if m is not None:
            model = shard_model(model, m.model_shard)
        real = conformer.hash_dropout

        def rec(seed_, x, rate, row0=0, col0=0, _name=name):
            out = real(seed_, x, rate, row0, col0)
            if x.shape[-1] in (int(a.get("transformer_dim_ff", 0)),
                               int(a.get("transformer_dim_ff", 0)) // 2):
                masks[_name].append((col0, (out == 0).numpy()))
            return out

        with _patched(conformer, "hash_dropout", rec if record else real):
            runs[name] = _step(a, model, batch, m, steps)
    if "transformer_n_heads" in args:
        heads = int(args["transformer_n_heads"])
        for d in (runs["one"][1], runs["one"][2]):
            d.update({k: v for k, v in _flat(relayout_attention(
                _unflat(d), heads, True)).items()})
    return {"one": runs["one"], "tp": runs["tp"], "d": mesh.d, "m": mesh.m,
            "n_model": mesh.n_model, "masks": masks}


def _unflat(flat: dict):
    """A flat ``{'a/0/b': array}`` as the nested tree (lists for digit keys)
    of torch tensors."""
    tree: dict = {}
    for key, v in flat.items():
        node, parts = tree, key.split("/")
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = torch.from_numpy(v)

    def lists(n):
        if not isinstance(n, dict):
            return n
        if n and all(k.isdigit() for k in n):
            return [lists(n[str(i)]) for i in range(len(n))]
        return {k: lists(v) for k, v in n.items()}

    return lists(tree)


# --------------------------------------------------------------- fixtures


@pytest.fixture(scope="module")
def ranks2():
    pool = _Ranks(2)
    yield pool
    pool.close()


def _jax_init(args):
    """The JAX trainer's initial weights for ``args`` (numpy)."""
    model = jax_trainer.build_model(args, N_DAYS)
    params = model.init(jax.random.key(int(args["seed"]),
                                       impl=args.get("rng_impl", "rbg")))
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def ranks4():
    pool = _Ranks(4)
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def grid_runs(tmp_path_factory, ranks2, ranks4):
    """Every family's run on one rank, on the 1x2 and 2x2 grids (the port,
    from JAX's initial weights), and JAX's own 2x2 and one-device runs.
    The grids' runs go to the rank pools first and run while JAX and the
    one-rank runs run here."""
    root = tmp_path_factory.mktemp("grids")
    runs = {}
    for fam, over in FAMILY.items():
        init = _jax_init(_run_args(root, **over))
        ranks4.submit("job_train", args=_run_args(root / f"{fam}_2x2", n_data_devices=2,
                                                  n_model_devices=2, **over), init=init)
        ranks2.submit("job_train", args=_run_args(root / f"{fam}_1x2", n_model_devices=2,
                                                  **over), init=init)
        out = {}
        with _no_head_dropout():
            with _initial_weights(init):
                out["one"] = train_model(_run_args(root / f"{fam}_one", **over))
            for name, n in (("jax", 2), ("jax1", 1)):
                out[name] = jax_trainer.train_model(_run_args(
                    root / f"{fam}_{name}", n_data_devices=n, n_model_devices=n, **over))
        out["2x2"] = ranks4.collect("job_train")[0]
        out["1x2"] = ranks2.collect("job_train")[0]
        runs[fam] = out
    return root, runs


# ---------------------------------------------------------- the qkv repair


def _conformer_forward_args(**kw):
    return dict(model_type="transformer_ctc", nInputFeatures=16, nClasses=40,
                frontend_dim=16, latent_dim=32, autoencoder_hidden_dim=12,
                transformer_num_layers=2, transformer_n_heads=4, transformer_dim_ff=32,
                transformer_dropout=0.0, conformer_conv_kernel=5, temporal_kernel=8,
                temporal_stride=4, drop_path_prob=0.0, use_spec_augment=False, **kw)


@pytest.mark.parametrize("n_model", [None, 1, 2])
def test_qkv_interleaved_default_matches_jax(n_model):
    """``config_from_args`` defaults ``qkv_interleaved`` as JAX's
    ``build_model`` does (True iff ``n_model_devices`` > 1), so a JAX run
    saved with ``n_model_devices: 2`` (weights interleaved by
    ``interleave_attention_params``) gives the same logits in both
    packages; the canonical reading of those weights (the old default)
    does not."""
    args = _conformer_forward_args(**({} if n_model is None else {"n_model_devices": n_model}))
    jmodel = jax_trainer.build_model(args, N_DAYS)
    cfg = config_from_args(args, N_DAYS)
    want_inter = bool(n_model and n_model > 1)
    assert jmodel.config.qkv_interleaved == cfg.qkv_interleaved == want_inter
    jcfg = dataclasses.replace(jmodel.config, head_dropout=0.0)
    params = jax_trainer.build_model(args, N_DAYS).init(jax.random.key(3))
    if want_inter:
        params = jax_shardings.interleave_attention_params(params, cfg.num_heads)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 48, 16)).astype(np.float32)
    days, lens = np.array([0, 1], np.int32), np.array([48, 40], np.int32)
    from neural_speech_decoder_tpu.models.conformer import conformer_forward as jax_fwd

    want = np.asarray(jax.jit(lambda p, *a: jax_fwd(p, jcfg, *a, train=False, key=None)[0])(
        params, jnp.asarray(x), jnp.asarray(days), jnp.asarray(lens)))
    model = ConformerDecoder(dataclasses.replace(cfg, head_dropout=0.0),
                             params_from_jax(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = forward(model, torch.from_numpy(x), torch.from_numpy(days),
                      torch.from_numpy(lens))[0].numpy()
    np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max())
    if want_inter:  # the fault: the old default reads the columns as canonical
        model.cfg = dataclasses.replace(model.cfg, qkv_interleaved=False)
        with torch.no_grad():
            wrong = forward(model, torch.from_numpy(x), torch.from_numpy(days),
                            torch.from_numpy(lens))[0].numpy()
        assert np.abs(wrong - want).max() > 1e-3


def test_interleave_roundtrip_and_bit_equal_logits():
    """The port's interleave is JAX's, bit for bit; de-interleave restores
    the canonical tree; the interleaved eval forward on interleaved weights
    gives the canonical forward's logits bit for bit."""
    args = _conformer_forward_args()
    cfg = dataclasses.replace(config_from_args(args, N_DAYS), head_dropout=0.0)
    params = jax.tree.map(np.asarray, jax_trainer.build_model(args, N_DAYS)
                          .init(jax.random.key(1)))
    canon = params_from_jax(params)
    inter = interleave_attention_params(canon, cfg.num_heads)
    want = jax.tree.map(np.asarray, jax_shardings.interleave_attention_params(
        params, cfg.num_heads))
    for (pa, a), (pb, b) in zip(named_leaves(inter), named_leaves(params_from_jax(want))):
        assert pa == pb and torch.equal(a, b), pa
    back = deinterleave_attention_params(inter, cfg.num_heads)
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(named_leaves(back),
                                                          named_leaves(canon)))
    assert not torch.equal(inter["blocks"][0]["attn"]["in_proj_w"],
                           canon["blocks"][0]["attn"]["in_proj_w"])
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 48, 16)).astype(np.float32))
    days, lens = torch.tensor([0, 1]), torch.tensor([48, 36])
    with torch.no_grad():
        ref = forward(ConformerDecoder(cfg, canon), x, days, lens)
        got = forward(ConformerDecoder(dataclasses.replace(cfg, qkv_interleaved=True),
                                       inter), x, days, lens)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


# ----------------------------------------------- the grids against JAX


@pytest.mark.parametrize("grid", ["1x2", "2x2"])
@pytest.mark.parametrize("family", ["gru", "conformer"])
def test_grid_matches_one_rank_and_jax_2x2(grid_runs, family, grid):
    """``train_model`` with ``n_model_devices: 2`` (``n_data_devices: 2`` on
    the 2x2 grid) from JAX's initial weights, with JAX's test's tolerances:
    best_loss within 1e-3 and best_cer equal to the port's one-rank run and
    to JAX's one-device run, every final parameter (the Conformer's
    de-interleaved) within 1e-4 of the port's one-rank run and the best-CER
    weights within 1e-4 of JAX's. Against JAX's own 2x2 run best_cer is
    equal, and best_loss and the weights are within those tolerances plus
    JAX's 2x2 run's own distance from its one-device run (for the Conformer
    with its head dropout at 0, AdamW's eps of 1e-6 turns JAX's other
    summation order into a best_loss 1.24e-3 away from its one-device
    run's). The checkpoints hold whole interleaved params, which
    ``load_model`` serves on one device."""
    root, runs = grid_runs
    got = runs[family][grid]
    jax_gap = abs(runs[family]["jax"]["summary/best_loss"]
                  - runs[family]["jax1"]["summary/best_loss"])
    for ref, tol in (("one", 1e-3), ("jax1", 1e-3), ("jax", 1e-3 + jax_gap)):
        want = runs[family][ref]
        assert abs(got["summary/best_loss"] - want["summary/best_loss"]) < tol, ref
        assert got["summary/best_cer"] == want["summary/best_cer"], ref
    tp_dir = root / f"{family}_{grid}"
    mine = CheckpointManager(str(tp_dir)).restore("lastState")["params"]
    one = CheckpointManager(str(root / f"{family}_one")).restore("lastState")["params"]
    jax_best = {}  # JAX's best-CER weights (modelState), canonical
    for ref in ("jax", "jax1"):
        jax_params = jax.tree.map(np.asarray, jax_trainer.load_model(
            str(root / f"{family}_{ref}"))[0])
        if family == "conformer" and ref == "jax":
            jax_params = jax_shardings.deinterleave_attention_params(jax_params, 2)
        jax_best[ref] = params_from_jax(jax_params)
    if family == "conformer":
        mine = deinterleave_attention_params(mine, 2)
    _close(mine, one, 1e-4)
    served, args = load_model(str(tp_dir), device="cpu")
    assert args["n_model_devices"] == 2
    assert getattr(served.cfg, "qkv_interleaved", True)
    best = served.params
    if family == "conformer":
        best = deinterleave_attention_params(best, 2)
    _close(best, jax_best["jax1"], 1e-4)
    gap = {k: np.abs(v - _flat(jax_best["jax1"])[k]).max()
           for k, v in _flat(jax_best["jax"]).items()}
    _close(best, jax_best["jax"], {k: 1e-4 + g for k, g in gap.items()})
    x, _, lens, _, days = _batch()
    with torch.no_grad():
        logp, out_lens, _ = forward(served, torch.from_numpy(x), torch.from_numpy(days),
                                    torch.from_numpy(lens))
    assert torch.isfinite(logp).all() and logp.shape[0] == 4


# ---------------------------------------------- step-level checks on ranks


@pytest.mark.parametrize("family", ["gru", "conformer"])
def test_gradient_shards_are_slices_of_the_one_rank_gradient(ranks2, family):
    """One step on the 1x2 grid: every leaf's gradient on each rank is its
    slice of the one-rank gradient (a replicated leaf whole), which a
    doubled ``dW_hh`` or a missing join of the input's gradient (the day
    affine's) would break; the loss too, and the GRU's updated shards
    (AdamW's eps 1e-6 turns a rounding difference in a near-zero gradient
    entry into a visible step, so the Conformer's update is not held to
    1e-6)."""
    over = dict(FAMILY[family], transformer_dropout=0.0, label_smoothing=0.1) \
        if family == "conformer" else {}
    args = _run_args("unused", n_model_devices=2, nLayers=3, **over)
    mt = "transformer_ctc" if family == "conformer" else "gru_baseline"
    res = ranks2.run("job_step_against_one_rank", args=args, batch=_batch())
    for r in res:
        (m1, g1, p1), (mt_, gt, pt) = r["one"], r["tp"]
        assert mt_["train/loss"] == pytest.approx(m1["train/loss"], rel=1e-5)
        for key, want in g1.items():
            dim = leaf_dim(tuple(key.split("/")), mt)
            if dim is not None:
                per = want.shape[dim] // r["n_model"]
                want = np.take(want, range(r["m"] * per, (r["m"] + 1) * per), axis=dim)
                p_want = np.take(p1[key], range(r["m"] * per, (r["m"] + 1) * per), axis=dim)
            else:
                p_want = p1[key]
            assert gt[key].shape == want.shape, key
            np.testing.assert_allclose(gt[key], want, atol=2e-5 * np.abs(want).max(),
                                       err_msg=key)
            if family == "gru":  # Adam's eps 0.1 keeps the update smooth
                np.testing.assert_allclose(pt[key], p_want, atol=1e-6, err_msg=key)


def test_clip_and_watch_norms_under_tp_equal_one_rank(ranks2):
    """The Conformer (clipped to norm 1.0) with the watch norms on: the
    clip's global norm and every leaf's gradient and parameter norm on the
    1x2 grid equal the one-rank ones (sharded leaves summed over the model
    group, replicated ones counted once)."""
    args = _run_args("unused", n_model_devices=2, watch_log_freq=1, **CONF_OVER)
    res = ranks2.run("job_step_against_one_rank", args=args, batch=_batch())
    for r in res:
        one, tp = r["one"][0], r["tp"][0]
        norms = [k for k in one if k.startswith(("train/grad_norm", "train/param_norm"))]
        assert "train/grad_norm" in norms and len(norms) > 50
        assert one["train/grad_norm"] > 1.0  # the clip scales this step
        for k in norms:
            assert tp[k] == pytest.approx(one[k], rel=1e-5), k


def test_dropout_keeps_replicas_equal_and_splits_the_ff_mask(ranks2):
    """Dropout, DropPath and SpecAugment on, the fused conv module's kernel
    dropping: after 3 steps every replicated parameter is bit-equal on the
    two model ranks (the same draws on each), the FF hidden's masks of the
    two ranks differ, and each is its columns of the one-rank mask."""
    args = _run_args("unused", n_model_devices=2, **{
        **CONF_OVER, "latent_dim": 48, "transformer_dim_ff": 64,
        "transformer_dropout": 0.3, "drop_path_prob": 0.2, "use_spec_augment": True,
        "spec_augment_freq_mask": 8, "spec_augment_time_mask": 4, "fused_conv": True,
        "whiteNoiseSD": 0.2})
    res = ranks2.run("job_step_against_one_rank", args=args, batch=_batch(), steps=3,
                     record=True)
    (_, _, p0), (_, _, p1) = res[0]["tp"], res[1]["tp"]
    replicated = [k for k in p0 if leaf_dim(tuple(k.split("/")), "transformer_ctc") is None]
    assert len(replicated) > 40
    for k in replicated:
        assert np.array_equal(p0[k], p1[k]), k
    m0, m1, one = res[0]["masks"]["tp"], res[1]["masks"]["tp"], res[0]["masks"]["one"]
    assert len(m0) == len(m1) == len(one) == 3 * 2 * 2  # steps x blocks x FFs
    assert any(not np.array_equal(a[1], b[1]) for a, b in zip(m0, m1))
    for (c0, a), (c1, b), (_, w) in zip(m0, m1, one):
        assert (c0, c1) == (0, 32)
        assert np.array_equal(np.concatenate([a, b], -1), w)


def test_gru_dropout_keeps_replicas_equal(ranks2):
    """The GRU's inter-layer dropout and noise on: after 3 steps the
    replicated leaves are bit-equal on the two model ranks."""
    args = _run_args("unused", n_model_devices=2, dropout=0.4, nLayers=3,
                     whiteNoiseSD=0.3, constantOffsetSD=0.2)
    res = ranks2.run("job_step_against_one_rank", args=args, batch=_batch(), steps=3)
    (_, _, p0), (_, _, p1) = res[0]["tp"], res[1]["tp"]
    for k in ("day/weight", "day/bias", "fc/bias", "gru/layers/2/b_ih", "gru/layers/0/b_hh"):
        assert np.array_equal(p0[k], p1[k]), k
    assert not np.array_equal(p0["fc/weight"], p1["fc/weight"])  # its two shards


def test_2x2_grid_step_matches_one_rank(ranks4):
    """One GRU step on the 2x2 grid (the data group averages, the model
    group sums): each rank's gradient shard is its slice of the one-rank
    gradient."""
    res = ranks4.run("job_step_against_one_rank",
                     args=_run_args("unused", n_model_devices=2, n_data_devices=2),
                     batch=_batch())
    assert sorted((r["d"], r["m"]) for r in res) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in res:
        (m1, g1, _), (mt, gt, _) = r["one"], r["tp"]
        assert mt["train/loss"] == pytest.approx(m1["train/loss"], rel=1e-5)
        for key, want in g1.items():
            dim = leaf_dim(tuple(key.split("/")), "gru_baseline")
            if dim is not None:
                per = want.shape[dim] // 2
                want = np.take(want, range(r["m"] * per, (r["m"] + 1) * per), axis=dim)
            np.testing.assert_allclose(gt[key], want, atol=2e-5 * np.abs(want).max(),
                                       err_msg=key)


# ------------------------------------------------- refusals and resume


@pytest.mark.parametrize("over, match", [
    ({**CONF_OVER, "fused_ffn": True}, "fused_ffn"),
    ({**CONF_OVER, "transformer_n_heads": 3, "latent_dim": 15}, "num_heads"),
    ({"nUnits": 33}, "nUnits"),
])
def test_unshardable_configs_raise_before_writing(tmp_path, over, match):
    with pytest.raises(ValueError, match=match):
        train_model(_run_args(tmp_path, n_model_devices=2, **over))
    assert not (tmp_path / "args").exists()


def test_make_mesh_grid_needs_the_ranks():
    """One process cannot hold two model ranks; ``local_rows`` reads the
    data coordinate."""
    with pytest.raises(ValueError, match="does not divide"):
        make_mesh(n_model=2, device="cpu")
    assert multihost.local_rows(8, n_model=1) == slice(0, 8)


def test_resume_under_tp(ranks2, tmp_path):
    """SIGTERM to rank 1 of the 1x2 grid in its 4th batch draw: both ranks
    stop and rank 0 writes the whole state; ``resume`` on the same grid
    gives the uninterrupted TP run's parameters and Adam moments bit for
    bit (JAX's ``test_tp_resume_preserves_training``). Resumed on one
    model rank instead, the Conformer's interleaved checkpoint is relaid
    out to the canonical layout and the run ends where the TP run does,
    within the 1e-4 that JAX's test holds a grid to one device."""
    for fam in ("gru", "conformer"):
        over = FAMILY[fam]
        full = tmp_path / f"{fam}_full"
        ranks2.run("job_train", args=_run_args(full, n_model_devices=2, checkpointEvery=1,
                                               **over))
        split = tmp_path / f"{fam}_split"
        first = ranks2.run("job_train", args=_run_args(split, n_model_devices=2, **over),
                           preempt_call=4)
        assert first[0] == first[1] and first[0]["summary/preempted_at"] == 5
        if fam == "conformer":
            with _no_head_dropout():  # as job_train
                train_model(_run_args(split, resume=True, **over))  # one rank, canonical
        else:
            ranks2.run("job_train", args=_run_args(split, n_model_devices=2, resume=True,
                                                   **over))
        a = CheckpointManager(str(full)).restore("lastState")
        b = CheckpointManager(str(split)).restore("lastState")
        assert a["step"] == b["step"] == 8
        if fam == "gru":
            for (p, x), (_, y) in zip(named_leaves(a["params"]), named_leaves(b["params"])):
                assert torch.equal(x, y), p
            for i, st in a["optimizer"]["state"].items():
                for k in ("exp_avg", "exp_avg_sq"):
                    assert torch.equal(st[k], b["optimizer"]["state"][i][k])
        else:
            assert a["qkv_interleaved"] and not b["qkv_interleaved"]
            _close(b["params"], deinterleave_attention_params(a["params"], 2), 1e-4)
