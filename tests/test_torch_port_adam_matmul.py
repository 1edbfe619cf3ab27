"""The GRU's opt-in kernel paths in the port, against the JAX package, on the
CPU: the fused Adam (``ops/kernels/adam.py``, ``training/optim.py::
FusedAdam``), the projection matmul (``ops/kernels/matmul.py``), a train
step with ``fused_optimizer`` and ``use_pallas_matmul``, the device-resident
data, the config reader and the training CLI.

The same inputs, made with numpy from a seed, go through the JAX function
(its Pallas kernel in interpret mode, where it has one) and the port's plain
version, which is what a kernel wrapper runs for a CPU tensor. Tolerances:

- Adam, 4 steps: p within 1e-6, m and v within 1e-7 (the same float32
  operations; |p| < 5, so 1e-6 is a few float32 ulps).
- Matmul, relative to the output's largest entry: float32 1e-5 (the same
  float32 products summed in another order over K, N <= 384 or M <= 200);
  bfloat16 2**-7, one bf16 step of the largest entry (both round the same
  float32 sums once, so an entry may round the other way).
- The flagged train step: ``test_torch_port_train.py``'s tolerances.
"""

import copy
import functools
import math
import os
import pickle
import signal
from pathlib import Path

import numpy as np
import pytest
import yaml

import jax
import jax.numpy as jnp
import torch

from neural_speech_decoder_tpu.data.device_data import _assemble_x as jax_assemble_x
from neural_speech_decoder_tpu.ops.pallas import matmul as jax_mm
from neural_speech_decoder_tpu.ops.pallas.adam_kernel import fused_adam_update
from neural_speech_decoder_tpu.training.optim import make_optimizer as jax_make_optimizer
from neural_speech_decoder_tpu.training.trainer import (
    _loss_and_metrics as jax_loss_and_metrics,
)
from neural_speech_decoder_tpu.training.trainer import build_model as jax_build_model
from neural_speech_decoder_tpu.training.trainer import make_train_step as jax_make_train_step
from neural_speech_decoder_tpu.utils import config as jax_config
from neural_speech_decoder_tpu_torch.data.batching import eval_batches, sample_batch
from neural_speech_decoder_tpu_torch.data.dataset import pack_days
from neural_speech_decoder_tpu_torch.data.device_data import DeviceData
from neural_speech_decoder_tpu_torch.data.synthetic import synthetic_dataset
from neural_speech_decoder_tpu_torch.models import gru as port_gru
from neural_speech_decoder_tpu_torch.models.api import config_from_args
from neural_speech_decoder_tpu_torch.models.convert import (
    gru_params_from_jax,
    gru_params_to_numpy,
)
from neural_speech_decoder_tpu_torch.models.gru import GRUConfig, GRUDecoder, init_gru_params
from neural_speech_decoder_tpu_torch.ops.kernels import matmul as port_mm
from neural_speech_decoder_tpu_torch.ops.kernels.adam import adam_scalars, adam_update
from neural_speech_decoder_tpu_torch.parallel import data_parallel as port_dp
from neural_speech_decoder_tpu_torch.training import cli
from neural_speech_decoder_tpu_torch.training import trainer as port_trainer
from neural_speech_decoder_tpu_torch.training.checkpoints import CheckpointManager
from neural_speech_decoder_tpu_torch.training.optim import FusedAdam, make_optimizer
from neural_speech_decoder_tpu_torch.training.trainer import (
    batch_tensors,
    make_train_step,
    step_generator,
    train_model,
)
from neural_speech_decoder_tpu_torch.utils import config as port_config

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted((REPO / "neural_speech_decoder_tpu" / "configs").glob("*.yaml"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's parallel workers would otherwise
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------- Adam

SHAPES = [(16, 128), (8, 384), (3, 128), (7,), (41,), (2, 5, 128)]  # test_fused_adam.py


def _tree(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in SHAPES]


ADAM = dict(b1=0.9, b2=0.999, eps=0.1)


def _lr(step: int) -> float:
    return 0.02 + (0.005 - 0.02) * step / 10.0


@functools.cache
def _jax_adam(l2: float):
    """``fused_adam_update`` with the Pallas kernel in interpret mode over 4
    steps from ``_tree(0)``: the final (p, m, v) leaves."""
    update = jax.jit(functools.partial(fused_adam_update, use_pallas=True, interpret=True,
                                       l2=l2, **ADAM))
    p = [jnp.asarray(a) for a in _tree(0)]
    m, v = [jnp.zeros_like(a) for a in p], [jnp.zeros_like(a) for a in p]
    for step in range(4):
        g = [jnp.asarray(a) for a in _tree(100 + step)]
        p, m, v = update(g, p, m, v, jnp.int32(step), jnp.float32(_lr(step)))
    return [[np.asarray(a) for a in leaves] for leaves in (p, m, v)]


@pytest.mark.parametrize("arm", ["adam_update", "FusedAdam"])
@pytest.mark.parametrize("l2", [0.0, 1e-3])
def test_adam_matches_jax_kernel(arm, l2):
    """4 steps of the port's update against ``fused_adam_update`` with the
    Pallas kernel in interpret mode (leaves of sizes 7 and 41 included)."""
    ours = [torch.nn.Parameter(torch.from_numpy(a)) for a in _tree(0)]
    m = [torch.zeros_like(p) for p in ours]
    v = [torch.zeros_like(p) for p in ours]
    opt = FusedAdam(ours, lr=0.02, eps=0.1, weight_decay=l2)
    for step in range(4):
        grads = [torch.from_numpy(g) for g in _tree(100 + step)]
        lr = float(np.float32(_lr(step)))
        if arm == "adam_update":
            c1, c2 = adam_scalars(step, 0.9, 0.999)
            with torch.no_grad():
                adam_update(grads, ours, m, v, lr=lr, c1=c1, c2=c2, l2=l2, **ADAM)
        else:
            for p, g in zip(ours, grads):
                p.grad = g
            opt.param_groups[0]["lr"] = lr
            opt.step()
    if arm == "FusedAdam":
        m = [opt.state[p]["exp_avg"] for p in ours]
        v = [opt.state[p]["exp_avg_sq"] for p in ours]
        assert all(int(opt.state[p]["step"]) == 4 for p in ours)
    ref_p, ref_m, ref_v = _jax_adam(l2)
    for i, p in enumerate(ours):
        np.testing.assert_allclose(p.detach().numpy(), ref_p[i], rtol=0, atol=1e-6)
        np.testing.assert_allclose(m[i].numpy(), ref_m[i], rtol=0, atol=1e-7)
        np.testing.assert_allclose(v[i].numpy(), ref_v[i], rtol=0, atol=1e-7)


def test_fused_adam_with_linear_lr_matches_torch_adam():
    """``FusedAdam`` and ``torch.optim.Adam``, each driven by the linear schedule,
    over 5 steps agree to rounding: the same update written in other forms
    (torch's ``lerp`` moments and ``addcdiv``): p within 8 float32 ulps of
    |p| < 4, each moment within 1e-6 of its largest entry (8 ulps)."""
    params = _tree(1)
    a = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in params]
    b = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in params]
    args = dict(lrStart=0.02, lrEnd=0.005, l2_decay=1e-3, nBatch=10)
    oa, sa = make_optimizer({**args, "fused_optimizer": True}, a)
    ob, sb = make_optimizer(args, b)
    assert type(oa) is FusedAdam and type(ob) is torch.optim.Adam
    for step in range(5):
        for pa, pb, g in zip(a, b, _tree(200 + step)):
            pa.grad, pb.grad = torch.from_numpy(g), torch.from_numpy(g.copy())
        oa.step(), ob.step(), sa.step(), sb.step()
        assert oa.param_groups[0]["lr"] == ob.param_groups[0]["lr"]
    for pa, pb in zip(a, b):
        np.testing.assert_allclose(pa.detach().numpy(), pb.detach().numpy(), rtol=0,
                                   atol=4e-6)
        for k in ("exp_avg", "exp_avg_sq"):
            ref = ob.state[pb][k].numpy()
            np.testing.assert_allclose(oa.state[pa][k].numpy(), ref, rtol=0,
                                       atol=1e-6 * np.abs(ref).max())
        assert float(oa.state[pa]["step"]) == float(ob.state[pb]["step"]) == 5


def _run_args(out, n_batch, **kw):
    args = {
        "outputDir": str(out), "device": "cpu",
        "dataset": synthetic_dataset(seed=3, n_days=1, trials_per_day=8, n_channels=8,
                                     min_t=24, max_t=40, min_u=2, max_u=4),
        "batchSize": 4, "lrStart": 0.005, "lrEnd": 0.001, "l2_decay": 1e-5,
        "nBatch": n_batch, "evalEvery": 3, "whiteNoiseSD": 0.2,
        "constantOffsetSD": 0.1, "gaussianSmoothWidth": 2.0, "nUnits": 64,
        "nLayers": 2, "nInputFeatures": 8, "nClasses": 40, "dropout": 0.3,
        "strideLen": 2, "kernelLen": 4, "bidirectional": True, "seed": 0,
        "wandb_mode": "disabled", "time_multiple": 16, "checkpointEvery": 2,
        "use_pallas_matmul": True,
    }
    args.update(kw)
    return args


@pytest.mark.parametrize("saved_on, resumed_on", [(True, True), (True, False),
                                                  (False, True)])
def test_last_state_resumes_with_the_flag_on_or_off(tmp_path, monkeypatch, saved_on,
                                                    resumed_on):
    """A run preempted after 2 of 4 steps writes ``lastState`` with
    ``fused_optimizer`` on or off; a resumed run loads it with the flag on
    or off: the loaded optimizer holds the saved step and moments bit for
    bit, and the run ends where an uninterrupted run with the saving flag
    ends (bit for bit with the same flag, to the optimizers' rounding, 1e-6,
    across them)."""
    full = tmp_path / "full"
    train_model(_run_args(full, 4, fused_optimizer=saved_on))
    real = port_trainer.sample_batch
    calls = []

    def preempt_on_second(*a, **k):
        calls.append(1)
        if len(calls) == 2:  # steps 0-1 finish, then stop
            os.kill(os.getpid(), signal.SIGTERM)
        return real(*a, **k)

    monkeypatch.setattr(port_trainer, "sample_batch", preempt_on_second)
    out = tmp_path / "split"
    assert train_model(_run_args(out, 4, fused_optimizer=saved_on))[
        "summary/preempted_at"] == 2
    monkeypatch.setattr(port_trainer, "sample_batch", real)
    saved = CheckpointManager(str(out)).restore("lastState")
    args = _run_args(out, 4, fused_optimizer=resumed_on, resume=True)
    module = port_trainer.build_model(args, 1, "cpu")
    opt, _ = make_optimizer(args, module.parameters())
    assert type(opt) is (FusedAdam if resumed_on else torch.optim.Adam)
    opt.load_state_dict(saved["optimizer"])
    loaded = opt.state_dict()["state"]
    for i, st in saved["optimizer"]["state"].items():
        assert float(loaded[i]["step"]) == float(st["step"]) == 2
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(loaded[i][k], st[k])
    train_model(args)
    a = CheckpointManager(str(full)).restore("lastState")
    b = CheckpointManager(str(out)).restore("lastState")
    assert a["step"] == b["step"] == 4
    for x, y in zip(jax.tree.leaves(a["params"]), jax.tree.leaves(b["params"])):
        if saved_on == resumed_on:
            assert torch.equal(x, y)
        else:
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0, atol=1e-6)


# ----------------------------------------------------------------- matmul

DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
MM_TOL = {"float32": 1e-5, "bfloat16": 2.0**-7}
# (M, K, N): M ragged (not a multiple of 128), K and N multiples of 128
MM_SHAPES = [(56, 128, 384), (200, 256, 128), (56, 384, 256), (200, 128, 256),
             (56, 256, 384), (200, 384, 128)]


def _mm_operands(kind, m, k, n, dtype, rng):
    shapes = {"nn": ((m, k), (k, n)), "nt": ((m, n), (k, n)), "tn": ((m, k), (m, n))}[kind]
    return [rng.standard_normal(s).astype(np.float32).astype(DT[dtype][0]) for s in shapes]


def _close(got: torch.Tensor, ref, tol: float, what: str):
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    err = np.abs(got.float().numpy() - ref).max()
    assert err <= tol * np.abs(ref).max(), (what, err, np.abs(ref).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind, bias", [("nn", False), ("nn", True), ("nt", False),
                                        ("tn", False)])
def test_tiled_matmul_plain_matches_jax(dtype, kind, bias):
    rng = np.random.default_rng(5)
    for m, k, n in MM_SHAPES:
        a, b = _mm_operands(kind, m, k, n, dtype, rng)
        cols = {"nn": n, "nt": k, "tn": n}[kind]
        bb = rng.standard_normal(cols).astype(np.float32) if bias else None
        ref = jax_mm.tiled_matmul(jnp.asarray(a), jnp.asarray(b), kind=kind,
                                  bias=None if bb is None else jnp.asarray(bb),
                                  interpret=True)
        to_t = lambda z: torch.from_numpy(np.array(jnp.asarray(z, jnp.float32))).to(
            DT[dtype][1])
        got = port_mm.tiled_matmul(to_t(a), to_t(b), kind=kind,
                                   bias=None if bb is None else torch.from_numpy(bb))
        assert got.dtype == DT[dtype][1] and tuple(got.shape) == tuple(ref.shape)
        _close(got, ref, MM_TOL[dtype], (kind, m, k, n))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_projection_matmul_grads_match_jax_vjp(dtype):
    """The forward and the three gradients of ``ProjectionMatmul`` against
    ``jax.vjp`` of ``projection_matmul(..., interpret=True)``: dX and dW in
    the operands' dtype, db float32."""
    rng = np.random.default_rng(6)
    jdt, tdt = DT[dtype]
    x = rng.standard_normal((200, 256)).astype(np.float32)
    w = (0.1 * rng.standard_normal((256, 384))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(384)).astype(np.float32)
    cot = rng.standard_normal((200, 384)).astype(np.float32)
    jx, jw, jc = (jnp.asarray(a).astype(jdt) for a in (x, w, cot))
    y_ref, vjp = jax.vjp(lambda a, b, c: jax_mm.projection_matmul(a, b, c, True), jx, jw,
                         jnp.asarray(bias))
    refs = vjp(jc)
    tx, tw = (torch.from_numpy(np.array(z.astype(jnp.float32))).to(tdt).requires_grad_()
              for z in (jx, jw))
    tb = torch.from_numpy(bias).requires_grad_()
    y = port_mm.projection_matmul(tx, tw, tb)
    y.backward(torch.from_numpy(np.array(jc.astype(jnp.float32))).to(tdt))
    assert y.dtype == tdt and tx.grad.dtype == tdt and tw.grad.dtype == tdt
    assert tb.grad.dtype == torch.float32 and refs[2].dtype == jnp.float32
    _close(y.detach(), y_ref, MM_TOL[dtype], "y")
    for got, ref, what in zip((tx.grad, tw.grad), refs[:2], ("dx", "dw")):
        assert ref.dtype == jdt
        _close(got, ref, MM_TOL[dtype], what)
    _close(tb.grad, refs[2], 1e-5, "db")


def test_tiled_matmul_raises_on_what_it_does_not_take():
    a, b = torch.zeros(8, 16), torch.zeros(12, 24)
    for kind in ("nn", "nt", "tn"):
        with pytest.raises(ValueError, match="contracted dims disagree"):
            port_mm.tiled_matmul(a, b, kind=kind)
    with pytest.raises(ValueError, match="a bias only with kind 'nn'"):
        port_mm.tiled_matmul(torch.zeros(8, 16), torch.zeros(12, 16), kind="nt",
                             bias=torch.zeros(12))
    with pytest.raises(ValueError, match="share one dtype"):
        port_mm.tiled_matmul(torch.zeros(8, 16), torch.zeros(16, 4, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="unknown kind"):
        port_mm.tiled_matmul(a, b, kind="tt")


# ------------------------------------------------------------- the slice


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k in tree for k2, v2 in _flat(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: np.asarray(tree, np.float32)}


def _step_args(**kw):
    args = dict(nInputFeatures=32, nClasses=40, nUnits=64, nLayers=2, dropout=0.0,
                strideLen=4, kernelLen=8, gaussianSmoothWidth=2.0, bidirectional=True,
                whiteNoiseSD=0.0, constantOffsetSD=0.0, lrStart=0.02, lrEnd=0.01,
                l2_decay=1e-5, nBatch=10, seed=0, watch_log_freq=0, batchSize=4,
                fused_optimizer=True, use_pallas_matmul=True, use_pallas=True,
                ctc_use_kernel=True)
    args.update(kw)
    return args


def _step_batch(b=4, t=120, c=32, u=6, n_days=3, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, c)).astype(np.float32),
            rng.integers(1, 41, size=(b, u)).astype(np.int32),
            np.array([120, 97, 64, 20], np.int32), np.array([6, 4, 3, 2], np.int32),
            (np.arange(b) % n_days).astype(np.int32))


def _jax_flagged_step(args, batch, params):
    params = jax.tree.map(jnp.asarray, params)
    model = jax_build_model(args, 3)
    key = jax.random.key(0)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_and_metrics(args, model, p, batch, key), has_aux=True))(params)
    tx, schedule = jax_make_optimizer(args)
    state = {"params": params, "opt_state": tx.init(params), "step": jnp.array(0)}
    state, _ = jax_make_train_step(args, model, tx, schedule)(state, *batch, key)
    return float(loss), _flat(grads), _flat(state["params"])


def _port_flagged_step(args, batch, params):
    module = GRUDecoder(config_from_args(args, 3), gru_params_from_jax(params))
    assert module.cfg.use_pallas_matmul
    opt, sched = make_optimizer(args, module.parameters())
    assert type(opt) is FusedAdam
    metrics = make_train_step(args, module, opt, sched)(
        tuple(torch.from_numpy(a) for a in batch), step_generator(torch.device("cpu"), 0, 0))
    grads = _flat(jax.tree.map(lambda p: p.grad.float().numpy(), module.params,
                               is_leaf=lambda x: isinstance(x, torch.Tensor)))
    return float(metrics["train/loss"]), grads, _flat(gru_params_to_numpy(module))


def test_flagged_gru_train_step_matches_jax(monkeypatch):
    """One train step with ``fused_optimizer`` and ``use_pallas_matmul`` at
    nUnits=64 (K=128, N=384 tile) against JAX's flagged step (its scan, CTC
    and projection kernels in interpret mode; one device, so that the
    kernel call sites take them), in float32 and bfloat16. Float32 as
    ``test_torch_port_train.py``: loss 1e-5 relative, each gradient leaf
    2e-5 of its largest entry, each parameter after the update 1e-6. In
    bfloat16 each quantity lies within twice the JAX bf16 path's distance
    from its own float32 path (the parameters also within their float32
    rounding, 1e-6). Both sides are counted through the projection."""
    monkeypatch.setattr(jax, "device_count", lambda *a, **k: 1)
    jax_calls, port_calls = [], []
    real_jax, real_port = jax_mm.projection_matmul, port_mm.tiled_matmul
    monkeypatch.setattr(jax_mm, "projection_matmul",
                        lambda *a, **k: jax_calls.append(1) or real_jax(*a, **k))
    monkeypatch.setattr(port_mm, "tiled_matmul",
                        lambda *a, **k: port_calls.append(k["kind"]) or real_port(*a, **k))
    params = jax.tree.map(np.asarray,
                          jax_build_model(_step_args(), 3).init(jax.random.key(1)))
    batch = _step_batch()
    out = {}
    for dt in ("float32", "bfloat16"):
        args = _step_args(compute_dtype=dt)
        out[dt] = (_jax_flagged_step(args, batch, params),
                   _port_flagged_step(args, batch, params))
    assert jax_calls and port_calls == ["nn", "nt", "tn"] * 2
    (ref32, ours32), (ref16, ours16) = out["float32"], out["bfloat16"]
    assert ours32[0] == pytest.approx(ref32[0], rel=1e-5)
    assert ours32[1].keys() == ref32[1].keys() and len(ref32[1]) == 12
    for k, ref in ref32[1].items():
        np.testing.assert_allclose(ours32[1][k], ref, atol=2e-5 * np.abs(ref).max(),
                                   err_msg=k)
    for k, ref in ref32[2].items():
        np.testing.assert_allclose(ours32[2][k], ref, atol=1e-6, err_msg=k)
    dist = abs(ref16[0] - ref32[0])
    assert dist > 0 and abs(ours16[0] - ref16[0]) <= 2 * dist
    for i in (1, 2):
        for k, ref in ref16[i].items():
            dist = np.abs(ref - ref32[i][k]).max()
            slack = 1e-6 if i == 2 else 0.0
            assert np.abs(ours16[i][k] - ref).max() <= 2 * dist + slack, (i, k)


def test_untileable_dims_warn_and_take_linear():
    """nUnits=96 bidirectional gives K=192: the call site warns once and
    takes ``linear``, as the JAX package's does; the output equals the
    unflagged model's."""
    cfg = GRUConfig(neural_dim=32, n_classes=12, hidden_dim=96, num_layers=2, n_days=2,
                    use_pallas_matmul=True)
    params = init_gru_params(cfg, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((4, 68, 32))
                         .astype(np.float32))
    day = torch.tensor([0, 1, 0, 1])
    port_gru._warned_matmul_fallback = False
    with pytest.warns(UserWarning, match="not.*multiples of 128"):
        y = port_gru.gru_forward(params, cfg, x, day)
    plain_cfg = GRUConfig(**{**cfg.__dict__, "use_pallas_matmul": False})
    assert torch.equal(y, port_gru.gru_forward(params, plain_cfg, x, day))


# ------------------------------------------------ device data, config, CLI


def test_device_data_assemble_is_bit_equal_to_the_host_batch():
    """``DeviceData.assemble`` against ``batch_tensors`` of the host batch
    drawn from the same RNG state, and its x against JAX ``_assemble_x``:
    train batches (whole envelope and a bucket), eval batches with padded
    rows."""
    raw = synthetic_dataset(seed=3, n_days=2, trials_per_day=9, n_channels=8, min_t=30,
                            max_t=70, min_u=2, max_u=5)
    ds = pack_days(raw["train"])
    dd = DeviceData(ds, "cpu")
    pairs = []
    for kw in ({}, {"buckets": [48, 80]}):
        r1, r2 = np.random.default_rng(2), np.random.default_rng(2)
        pairs.append((sample_batch(ds, r1, 5, 80, 6, **kw),
                      sample_batch(ds, r2, 5, 80, 6, materialize_x=False, **kw)))
    pairs += zip(eval_batches(ds, 4, 80, 6), eval_batches(ds, 4, 80, 6, materialize_x=False))
    assert pairs[1][1].t_env == 48 and any(b.weight.min() == 0 for b, _ in pairs)
    for host, idx_only in pairs:
        assert idx_only.x is None
        want, got = batch_tensors(host, torch.device("cpu")), dd.assemble(idx_only)
        for a, b in zip(want, got):
            assert a.dtype == b.dtype and torch.equal(a, b)
        ref = jax_assemble_x(jnp.asarray(ds.features),
                             jnp.asarray(ds.offsets[idx_only.idx].astype(np.int32)),
                             jnp.asarray(idx_only.x_lens), t_env=idx_only.t_env)
        assert np.array_equal(np.asarray(ref), got[0].numpy())


def _same(a, b):
    """Equal, with NaN equal to NaN."""
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_config_reader_matches_yaml(path):
    assert len(CONFIGS) == 3
    ours, ref = port_config.load_yaml_config(str(path)), yaml.safe_load(path.read_text())
    assert ours.keys() == ref.keys() and all(_same(ours[k], ref[k]) for k in ref)


SCALARS = ["5", "-3", "0", "+7", "1_000", "1.5", "-2.", "1.0e-3", "3.0E+2", ".5", "1e-3",
           "1E5", ".inf", "-.Inf", ".nan", "true", "False", "YES", "no", "On", "off", "~",
           "null", "NULL", "", "abc", "/tmp/run dir", "-foo", "a:b", "[12,14]", "[a, 1.5]",
           "[]", "'quoted: #x'", "'it''s'", '"dq"', "bfloat16", "http://x.y/z"]


def test_scalar_reader_matches_yaml():
    for s in SCALARS:
        assert _same(port_config.parse_scalar(s), yaml.safe_load(s)), s


@pytest.mark.parametrize("text", ["{a: 1}", "&x 5", "*x", "!!int 3", "0x10", "010",
                                  "0b11", "1:30", "2001-12-14", "a: b", "x #c", "[[1]]",
                                  '"a\\tb"', "|", "- x", "<<", "="])
def test_scalar_reader_raises_outside_its_subset(text):
    with pytest.raises(ValueError):
        port_config.parse_scalar(text)


def test_config_reader_raises_on_nesting(tmp_path):
    for body in ("model:\n  depth: 3\n", "- a\n", "a: 1\na: 2\n", " a: 1\n", "a:1\n"):
        p = tmp_path / "c.yaml"
        p.write_text(body)
        with pytest.raises(ValueError):
            port_config.load_yaml_config(str(p))


OVERRIDES = ["lrStart=0.01", "nBatch=500", "l2_decay=1e-3", "lrEnd=1.0e-4",
             "fused_optimizer=true", "deviceResidentData=yes", "outputDir=/tmp/run",
             "datasetPath=data/ptDecoder_ctc", "profile_steps=[12,14]", "seed=-1",
             "wandb_mode=disabled", "model.depth=3", "note=", "maxTimeSeriesLen=null"]


def test_overrides_match_jax():
    base = port_config.load_yaml_config(str(CONFIGS[1]))
    ours = port_config.apply_overrides(copy.deepcopy(base), OVERRIDES)
    ref = jax_config.apply_overrides(copy.deepcopy(base), OVERRIDES)
    assert ours.keys() == ref.keys() and all(_same(ours[k], ref[k]) for k in ref)
    sweep = ["lrStart=0.01,0.02", "nUnits=512, 1024", "x=[1,2]", "outputDir=/o", "q='a,b'"]
    assert port_config.expand_multirun(sweep) == jax_config.expand_multirun(sweep)
    for ovs in jax_config.expand_multirun(sweep) + [OVERRIDES]:
        assert port_config.override_dirname(ovs) == jax_config.override_dirname(ovs)


def _cli_args(tmp_path, *extra):
    ds = synthetic_dataset(seed=3, n_days=2, trials_per_day=8, n_channels=8, min_t=24,
                           max_t=40, min_u=2, max_u=4)
    data = tmp_path / "data.pkl"
    data.write_bytes(pickle.dumps(ds))
    return ["--config", str(REPO / "neural_speech_decoder_tpu/configs/gru_baseline.yaml"),
            f"outputDir={tmp_path / 'run'}", f"datasetPath={data}", "device=cpu",
            "nUnits=64", "nLayers=2", "nInputFeatures=8", "kernelLen=4", "strideLen=2",
            "nBatch=4", "evalEvery=2", "checkpointEvery=2", "batchSize=4",
            "compute_dtype=float32", "wandb_mode=disabled", "time_multiple=16", *extra]


def test_cli_trains_with_the_three_flags(tmp_path, monkeypatch):
    """``cli.main`` on the recipe's config at a small width, on the CPU,
    with ``fused_optimizer``, ``use_pallas_matmul`` and
    ``deviceResidentData``: it trains, evaluates, writes the artifacts and
    the profile window's trace, and its optimizer state is Adam's."""
    assembled = []
    real = DeviceData.assemble
    monkeypatch.setattr(DeviceData, "assemble",
                        lambda self, b: assembled.append(1) or real(self, b))
    summary = cli.main(_cli_args(tmp_path, "fused_optimizer=true", "use_pallas_matmul=true",
                                 "deviceResidentData=true", "profile_steps=[1,2]"))
    run = tmp_path / "run"
    assert math.isfinite(summary["summary/best_cer"])
    for name in ("args", "modelState", "lastState", "trainingStats"):
        assert (run / name).is_file(), name
    assert list((run / "profile").glob("trace_steps_1-2.json"))
    assert len(assembled) >= 4 + 2  # 4 train batches and at least one per eval
    state = CheckpointManager(str(run)).restore("lastState")
    assert state["step"] == 4 and {"step", "exp_avg", "exp_avg_sq"} <= set(
        state["optimizer"]["state"][0])


def test_cli_multirun_raises(tmp_path):
    """``-m`` runs sweeps now (``tests/test_torch_port_sweep.py``); it raises
    ``SystemExit`` when every job fails, and comma-swept values without it
    raise ``SystemExit``."""
    with pytest.raises(SystemExit, match="all 2 multirun jobs failed"):
        cli.main(["-m", *_cli_args(tmp_path, "lrStart=0.01,0.02",
                                   f"datasetPath={tmp_path / 'missing.pkl'}")])
    with pytest.raises(SystemExit):
        cli.main(_cli_args(tmp_path, "lrStart=0.01,0.02"))


@pytest.mark.parametrize("arg, ranks", [({"n_data_devices": 2, "n_model_devices": 2}, 4),
                                        ({"n_model_devices": 4}, 4),
                                        ({"multihost_staging": True, "n_model_devices": 2}, 2)])
def test_unported_multi_device_args_raise(tmp_path, monkeypatch, arg, ranks):
    """The multi-device args are all ported since tensor parallelism
    (``tests/test_torch_port_tensor_parallel.py``): on the CPU the run goes
    to ``n_data x n_model`` gloo rank processes, and nothing is written
    before they start. On ``cuda`` with fewer cards than model ranks the
    size of the 'data' axis raises ``ValueError`` as JAX's trainer does
    (``training/trainer.py:538-542``), before the run writes anything."""
    started = []
    monkeypatch.setattr(port_trainer, "_train_ranks",
                        lambda args, device, n: started.append((str(device), n)) or {})
    args = _run_args(tmp_path, 2, **arg)
    train_model(args)
    assert started == [("cpu", ranks)]
    assert not (tmp_path / "args").exists()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="exceeds the 1 available device"):
        port_dp.resolve_n_data(args, torch.device("cuda"))
