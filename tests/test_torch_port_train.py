"""The port's train step, trainer and data copies against the JAX package,
on the CPU.

The same weights (``init_gru_params`` in JAX, converted with
``models/convert.py``) and the same numpy batch go through the JAX
package's train step and the port's, with noise and dropout at 0 (their
random streams differ by design). Tolerances in float32: the loss 1e-5
relative; each gradient leaf 2e-5 of its largest entry (two layers of
28-step recurrences and a 29-frame CTC recursion summed in other orders);
the parameters after Adam 1e-6 absolute (an update is at most lr = 0.02,
and its float32 rounding is ~1e-9). In bfloat16 the bound on each quantity
is twice the JAX bf16 Pallas path's distance from its own float32 path:
both round the same float32 function to bf16 in different places.
"""

import os
import signal

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neural_speech_decoder_tpu.data import batching as jax_batching
from neural_speech_decoder_tpu.data.dataset import pack_days as jax_pack_days
from neural_speech_decoder_tpu.data.synthetic import synthetic_dataset as jax_synthetic
from neural_speech_decoder_tpu.models.gru import gru_forward as jax_gru_forward
from neural_speech_decoder_tpu.training.optim import make_optimizer as jax_make_optimizer
from neural_speech_decoder_tpu.training.trainer import (
    _loss_and_metrics as jax_loss_and_metrics,
)
from neural_speech_decoder_tpu.training.trainer import build_model as jax_build_model
from neural_speech_decoder_tpu.training.trainer import make_train_step as jax_make_train_step
from neural_speech_decoder_tpu_torch.data import batching
from neural_speech_decoder_tpu_torch.data.dataset import pack_days
from neural_speech_decoder_tpu_torch.data.synthetic import synthetic_dataset
from neural_speech_decoder_tpu_torch.models.api import config_from_args
from neural_speech_decoder_tpu_torch.models.convert import (
    gru_params_from_jax,
    gru_params_to_numpy,
)
from neural_speech_decoder_tpu_torch.models.gru import GRUDecoder, gru_head
from neural_speech_decoder_tpu_torch.training import trainer as port_trainer
from neural_speech_decoder_tpu_torch.training.checkpoints import CheckpointManager
from neural_speech_decoder_tpu_torch.training.optim import make_optimizer
from neural_speech_decoder_tpu_torch.training.trainer import (
    load_model,
    make_train_step,
    step_generator,
    train_model,
)


def _args(**kw):
    args = dict(nInputFeatures=32, nClasses=40, nUnits=32, nLayers=2,
                dropout=0.0, strideLen=4, kernelLen=8, gaussianSmoothWidth=2.0,
                bidirectional=True, whiteNoiseSD=0.0, constantOffsetSD=0.0,
                lrStart=0.02, lrEnd=0.01, l2_decay=1e-5, nBatch=10, seed=0,
                watch_log_freq=0, batchSize=4)
    args.update(kw)
    return args


def _batch(b=4, t=120, c=32, u=6, n_days=3, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, c)).astype(np.float32),
            rng.integers(1, 41, size=(b, u)).astype(np.int32),
            np.array([120, 97, 64, 20][:b], np.int32),  # 20 < kernel: 0 frames
            np.array([6, 4, 3, 2][:b], np.int32),
            (np.arange(b) % n_days).astype(np.int32))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k in tree for k2, v2 in _flat(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: np.asarray(tree, np.float32)}


def _jax_step(args, n_days, batch, params):
    """JAX loss, gradients and post-Adam parameters from a numpy tree (the
    train step donates its state, so it gets fresh arrays)."""
    params = jax.tree.map(jnp.asarray, params)
    model = jax_build_model(args, n_days)
    key = jax.random.key(0)
    (loss, _), grads = jax.value_and_grad(
        lambda p: jax_loss_and_metrics(args, model, p, batch, key), has_aux=True
    )(params)
    tx, schedule = jax_make_optimizer(args)
    state = {"params": params, "opt_state": tx.init(params), "step": jnp.array(0)}
    state, _ = jax_make_train_step(args, model, tx, schedule)(state, *batch, key)
    return float(loss), _flat(grads), _flat(state["params"])


def _port_step(args, n_days, batch, params):
    module = GRUDecoder(config_from_args(args, n_days),
                        gru_params_from_jax(params))
    opt, sched = make_optimizer(args, module.parameters())
    step = make_train_step(args, module, opt, sched)
    metrics = step(tuple(torch.from_numpy(a) for a in batch),
                   step_generator(torch.device("cpu"), 0, 0))
    grads = _flat(jax.tree.map(lambda p: p.grad.float().numpy(), module.params,
                               is_leaf=lambda x: isinstance(x, torch.Tensor)))
    return float(metrics["train/loss"]), grads, _flat(gru_params_to_numpy(module))


def test_train_step_f32_matches_jax():
    args = _args()
    params = jax.tree.map(np.asarray, jax_build_model(args, 3).init(jax.random.key(1)))
    batch = _batch()
    ref_loss, ref_grads, ref_params = _jax_step(args, 3, batch, params)
    loss, grads, new_params = _port_step(args, 3, batch, params)
    assert loss == pytest.approx(ref_loss, rel=1e-5)
    assert grads.keys() == ref_grads.keys() and len(grads) == 12
    for k, ref in ref_grads.items():
        np.testing.assert_allclose(grads[k], ref, atol=2e-5 * np.abs(ref).max(),
                                   err_msg=k)
    for k, ref in ref_params.items():
        np.testing.assert_allclose(new_params[k], ref, atol=1e-6, err_msg=k)


def test_train_step_bf16_within_twice_jax_pallas_distance(monkeypatch):
    """bf16 against the JAX package's Pallas path (scan and CTC kernels in
    interpret mode; one device, so that the kernel call sites take them)."""
    monkeypatch.setattr(jax, "device_count", lambda *a, **k: 1)
    params = jax.tree.map(np.asarray,
                          jax_build_model(_args(), 3).init(jax.random.key(1)))
    batch = _batch()
    out = {}
    for dt in ("float32", "bfloat16"):
        args = _args(compute_dtype=dt, use_pallas=True, ctc_use_kernel=True)
        out[dt] = (_jax_step(args, 3, batch, params), _port_step(args, 3, batch, params))
    (ref32, ours32), (ref16, ours16) = out["float32"], out["bfloat16"]
    # float32: the Pallas path and the port agree as in the f32 test
    assert ours32[0] == pytest.approx(ref32[0], rel=1e-5)
    dist = abs(ref16[0] - ref32[0])
    assert dist > 0 and abs(ours16[0] - ours32[0]) > 0  # both really round
    assert abs(ours16[0] - ref16[0]) <= 2 * dist
    for k, ref in ref16[1].items():
        dist = np.abs(ref - ref32[1][k]).max()
        assert np.abs(ours16[1][k] - ref).max() <= 2 * dist, k


def test_gru_head_keeps_float32_accumulation():
    """The head multiplies bf16 encoder states and bf16-rounded weights with
    float32 accumulation and output, as the JAX package's einsum with
    preferred_element_type=float32: against a float64 product of the same
    bf16 operands it agrees to float32 rounding of a 256-term sum (under
    1e-5 of the largest logit), where a bf16 output is off by up to 2**-9
    of it."""
    rng = np.random.default_rng(0)
    enc = torch.from_numpy(rng.standard_normal((3, 50, 256)).astype(np.float32)
                           ).to(torch.bfloat16)
    w = torch.from_numpy((rng.standard_normal((256, 41)) * 0.06).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal(41) * 0.06).astype(np.float32))
    logits = gru_head({"fc": {"weight": w, "bias": b}}, enc)
    assert logits.dtype == torch.float32
    ref = enc.double() @ w.to(torch.bfloat16).double() + b.double()
    err = (logits.double() - ref).abs().max().item()
    assert err <= 1e-5 * ref.abs().max().item(), err


def test_gru_bf16_projection_rounds_once(monkeypatch):
    """Layers 1+ of the bf16 GRU take their input projection through the
    single-rounding ``linear`` (float32 product and bias, one bf16
    rounding), as the JAX package: at C=128/H=64 the port's eval logits
    agree with the JAX Pallas path's (kernels in interpret mode) within
    1e-6, where a bf16 product rounded again after the float32 bias put
    them 9.156e-4 apart (logits up to ~0.4)."""
    monkeypatch.setattr(jax, "device_count", lambda *a, **k: 1)
    args = _args(nInputFeatures=128, nUnits=64, kernelLen=32,
                 compute_dtype="bfloat16", use_pallas=True)
    model = jax_build_model(args, 3)
    params = model.init(jax.random.key(0))
    x, _, _, _, day = _batch(b=3, t=100, c=128)
    ref = jax_gru_forward(params, model.config, jnp.asarray(x), jnp.asarray(day))
    module = GRUDecoder(config_from_args(args, 3),
                        gru_params_from_jax(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        ours = module(torch.from_numpy(x), torch.from_numpy(day))
    assert ours.dtype == torch.float32
    err = np.abs(ours.numpy() - np.asarray(ref, np.float32)).max()
    assert err <= 1e-6, err


# ------------------------------------------------------------ data copies


def _datasets():
    kw = dict(seed=3, n_days=2, trials_per_day=9, n_channels=8, min_t=30,
              max_t=70, min_u=2, max_u=5)
    return synthetic_dataset(**kw), jax_synthetic(**kw)


def _same_batch(a, b):
    for f in ("x", "y", "x_lens", "y_lens", "days", "weight", "idx"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert a.t_env == b.t_env


def test_data_copies_match_jax():
    ours_raw, ref_raw = _datasets()
    ours, ref = pack_days(ours_raw["train"]), jax_pack_days(ref_raw["train"])
    for f in ("features", "offsets", "labels", "label_lens", "days"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f), err_msg=f)
    test = pack_days(ours_raw["test"])
    env = batching.choose_envelope(ours, test, time_multiple=16)
    assert env == jax_batching.choose_envelope(
        ref, jax_pack_days(ref_raw["test"]), time_multiple=16)
    t_max, u_max = env
    buckets = batching.length_buckets(ours, 3, t_max, time_multiple=16)
    assert buckets == jax_batching.length_buckets(ref, 3, t_max, time_multiple=16)
    sizes = batching.bucket_batch_sizes(buckets, 256, t_max, max_batch=16, multiple=2)
    assert sizes == jax_batching.bucket_batch_sizes(buckets, 256, t_max,
                                                    max_batch=16, multiple=2)
    r1, r2 = np.random.default_rng(7), np.random.default_rng(7)
    for kw in ({}, {"buckets": buckets}, {"buckets": buckets, "bucket_sizes": sizes}):
        _same_batch(batching.sample_batch(ours, r1, 5, t_max, u_max, **kw),
                    jax_batching.sample_batch(ref, r2, 5, t_max, u_max, **kw))
    for kw in ({}, {"buckets": buckets}):
        got = list(batching.eval_batches(ours, 4, t_max, u_max, **kw))
        want = list(jax_batching.eval_batches(ref, 4, t_max, u_max, **kw))
        assert len(got) == len(want) == 5
        for a, b in zip(got, want):
            _same_batch(a, b)


# ---------------------------------------------------------------- trainer


def _run_args(out, n_batch, **kw):
    args = {
        "outputDir": str(out), "device": "cpu",
        "dataset": synthetic_dataset(seed=3, n_days=1, trials_per_day=8,
                                     n_channels=8, min_t=24, max_t=40,
                                     min_u=2, max_u=4),
        "batchSize": 4, "lrStart": 0.005, "lrEnd": 0.001, "l2_decay": 1e-5,
        "nBatch": n_batch, "evalEvery": 3, "whiteNoiseSD": 0.2,
        "constantOffsetSD": 0.1, "gaussianSmoothWidth": 2.0, "nUnits": 16,
        "nLayers": 2, "nInputFeatures": 8, "nClasses": 40, "dropout": 0.3,
        "strideLen": 2, "kernelLen": 4, "bidirectional": True, "seed": 0,
        "wandb_mode": "disabled", "time_multiple": 16, "checkpointEvery": 2,
    }
    args.update(kw)
    return args


def test_resume_after_preemption_is_exact(tmp_path, monkeypatch):
    """8 steps in one run equal 4 steps, a SIGTERM, and a resumed run of the
    other 4: the same parameters, optimizer state and eval history, bit for
    bit (noise and dropout on: the per-step generators are reseeded)."""
    full = train_model(_run_args(tmp_path / "full", 8))
    assert "summary/final_cer" in full

    real = port_trainer.sample_batch
    calls = []

    def preempt_on_fourth(*a, **k):
        calls.append(1)
        if len(calls) == 4:  # during step 3: steps 0-3 finish, then stop
            os.kill(os.getpid(), signal.SIGTERM)
        return real(*a, **k)

    monkeypatch.setattr(port_trainer, "sample_batch", preempt_on_fourth)
    out = tmp_path / "split"
    first = train_model(_run_args(out, 8))
    assert first["summary/preempted_at"] == 4
    monkeypatch.setattr(port_trainer, "sample_batch", real)
    second = train_model(_run_args(out, 8, resume=True))
    assert second == full
    a = CheckpointManager(str(tmp_path / "full")).restore("lastState")
    b = CheckpointManager(str(out)).restore("lastState")
    assert a["step"] == b["step"] == 8
    for x, y in zip(jax.tree.leaves(a["params"]), jax.tree.leaves(b["params"])):
        assert torch.equal(x, y)
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    for i in sa:
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[i][k], sb[i][k])


def test_train_model_lowers_per_and_reloads(tmp_path):
    """The verify skill's small drive, shortened: test PER falls from the
    step-0 eval, the artifacts appear, and load_model decodes as the best
    checkpoint scored."""
    ds = synthetic_dataset(seed=1, n_days=2, trials_per_day=32, n_channels=32,
                           min_t=60, max_t=100, min_u=3, max_u=5, signal_scale=4.0)
    args = {
        "outputDir": str(tmp_path), "device": "cpu", "dataset": ds,
        "batchSize": 8, "lrStart": 0.005, "lrEnd": 0.001, "l2_decay": 1e-5,
        "nBatch": 301, "evalEvery": 100, "whiteNoiseSD": 0.1,
        "constantOffsetSD": 0.0, "gaussianSmoothWidth": 2.0, "nUnits": 64,
        "nLayers": 2, "nInputFeatures": 32, "nClasses": 40, "dropout": 0.0,
        "strideLen": 4, "kernelLen": 8, "bidirectional": True, "seed": 0,
        "wandb_mode": "offline", "time_multiple": 32,
    }
    summary = train_model(args)
    stats = CheckpointManager(str(tmp_path)).load_sidecar()
    cer = stats["testCER"]
    assert len(cer) == 4 and summary["summary/best_cer"] < cer[0] - 0.1, cer
    for name in ("args", "trainingStats", "modelState", "lastState",
                 "trainerState", "metrics.jsonl"):
        assert (tmp_path / name).is_file(), name
    model, run_args = load_model(str(tmp_path))
    assert run_args["nDays"] == 2 and next(model.parameters()).device.type == "cpu"
    test_ds = pack_days(ds["test"])
    t_max, u_max = batching.choose_envelope(pack_days(ds["train"]), test_ds,
                                            time_multiple=32)
    _, per, _, _ = port_trainer.run_eval(
        port_trainer.make_eval_step(model), test_ds, 8, t_max, u_max,
        torch.device("cpu"))
    assert per == pytest.approx(summary["summary/best_cer"], abs=1e-12)


def test_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        train_model(_run_args(tmp_path, 2, device="cuda"))
