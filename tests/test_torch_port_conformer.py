"""The port's Conformer (``model_type: transformer_ctc``) against the JAX
package, on the CPU, and its trainer.

The same weights (``init_conformer_params`` in JAX, converted with
``models/convert.py``) and the same numpy inputs go through the JAX
package's ``conformer_forward`` and train step and the port's, at a small
width (C=32, latent 256 = 2 heads of 128, FF 256, 6 blocks so that the
InterCTC head exists). Dropout, DropPath, the head's dropout and
SpecAugment are off: their random streams differ by design. Every row has
an unmasked key (JAX's einsum path, which it takes on the CPU, gives a
fully masked row uniform attention where the kernel gives 0).

Tolerances, float32: log-probs within 1e-5 of their largest entry (6
blocks of 256-wide products and softmaxes summed in other orders); the
loss 1e-5 relative; each gradient leaf 1e-4 of its largest entry (the
same sums through the backward, the CTC recursions and label smoothing's
KL); the AdamW update, about lr * sign(g) on the first step, within 1e-6
where |g| is at least 1e-3 of its leaf's largest entry (elsewhere the
gradient is rounding noise and its sign is arbitrary on both sides).
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neural_speech_decoder_tpu.models import conformer as jax_conformer
from neural_speech_decoder_tpu.training.optim import make_optimizer as jax_make_optimizer
from neural_speech_decoder_tpu.training.trainer import (
    _loss_and_metrics as jax_loss_and_metrics,
)
from neural_speech_decoder_tpu.training.trainer import build_model as jax_build_model
from neural_speech_decoder_tpu.training.trainer import make_train_step as jax_make_train_step
from neural_speech_decoder_tpu_torch.data.synthetic import synthetic_dataset
from neural_speech_decoder_tpu_torch.data import batching
from neural_speech_decoder_tpu_torch.data.dataset import pack_days
from neural_speech_decoder_tpu_torch.models.api import config_from_args, forward
from neural_speech_decoder_tpu_torch.models.conformer import (
    ConformerDecoder,
    init_conformer_params,
)
from neural_speech_decoder_tpu_torch.models.convert import (
    conformer_params_from_jax,
    conformer_params_to_numpy,
)
from neural_speech_decoder_tpu_torch.training import trainer as port_trainer
from neural_speech_decoder_tpu_torch.training.checkpoints import CheckpointManager
from neural_speech_decoder_tpu_torch.training.optim import make_optimizer
from neural_speech_decoder_tpu_torch.training.trainer import (
    load_model,
    make_train_step,
    step_generator,
    train_model,
)

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small CPU ops gain nothing from more, and
    the suite's parallel workers would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGP_TOL = 1e-5
GRAD_TOL = 1e-4
N_DAYS = 3


def _args(**kw):
    args = dict(model_type="transformer_ctc", nInputFeatures=32, nClasses=40,
                frontend_dim=64, latent_dim=256, autoencoder_hidden_dim=64,
                transformer_num_layers=6, transformer_n_heads=2,
                transformer_dim_ff=256, conformer_conv_kernel=7,
                transformer_dropout=0.0, drop_path_prob=0.0,
                use_spec_augment=False, whiteNoiseSD=0.0, constantOffsetSD=0.0,
                optimizer="adamw", lrStart=4e-4, lrEnd=4e-4, l2_decay=1e-3,
                warmup_steps=2, nBatch=10, label_smoothing=0.1, seed=0,
                watch_log_freq=0, batchSize=3)
    args.update(kw)
    return args


def _both(args, seed=0):
    """The JAX model (head dropout off) with fresh params, and the port's
    module on the same weights."""
    model = jax_build_model(args, N_DAYS)
    cfg = dataclasses.replace(model.config, head_dropout=0.0)

    def fwd(params, x, day_idx, x_lens, *, train, key):
        return jax_conformer.conformer_forward(params, cfg, x, day_idx, x_lens,
                                               train=train, key=key)

    model = model._replace(config=cfg, forward=fwd)
    params = model.init(jax.random.key(seed))
    module = ConformerDecoder(
        dataclasses.replace(config_from_args(args, N_DAYS), head_dropout=0.0),
        conformer_params_from_jax(jax.tree.map(np.asarray, params)))
    return model, params, module


def _batch(b=3, t=120, c=32, u=6, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, c)).astype(np.float32),
            rng.integers(1, 41, size=(b, u)).astype(np.int32),
            np.array([120, 91, 44][:b], np.int32),  # 44 bins: 3 frames
            np.array([6, 4, 2][:b], np.int32),
            (np.arange(b) % N_DAYS).astype(np.int32))


@pytest.mark.parametrize("variant", [
    {},
    {"qkv_interleaved": True},
    {"causal": True, "attn_left_context": 8},
])
@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_jax(variant, train):
    args = _args(**variant)
    model, params, module = _both(args)
    x, _, lens, _, day = _batch()
    if variant.get("causal"):
        lens = np.full_like(lens, 120)  # no padded rows: see the module doc
    ref = model.forward(params, jnp.asarray(x), jnp.asarray(day), jnp.asarray(lens),
                        train=train, key=jax.random.key(1) if train else None)
    with torch.no_grad():
        lp, out_lens, inter = forward(
            module, torch.from_numpy(x), torch.from_numpy(day), torch.from_numpy(lens),
            train=train, generator=torch.Generator().manual_seed(0) if train else None)
    ref_lp = np.asarray(ref[0])
    assert lp.dtype == torch.float32 and lp.shape == ref_lp.shape
    np.testing.assert_allclose(lp.numpy(), ref_lp, atol=LOGP_TOL * np.abs(ref_lp).max())
    np.testing.assert_array_equal(out_lens.numpy(), np.asarray(ref[1]))
    if train:
        ref_inter = np.asarray(ref[2])
        np.testing.assert_allclose(inter.numpy(), ref_inter,
                                   atol=LOGP_TOL * np.abs(ref_inter).max())
    else:
        assert inter is None and ref[2] is None


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k in tree for k2, v2 in _flat(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: np.asarray(tree, np.float32)}


def test_train_step_matches_jax():
    """Label smoothing 0.1, InterCTC at layer 3 of 6 (weight 0.3), AdamW
    with warmup-cosine, gradients clipped to norm 1.0."""
    args = _args()
    model, params, module = _both(args, seed=2)
    batch = _batch()
    np_params = jax.tree.map(np.asarray, params)
    key = jax.random.key(0)
    (ref_loss, ref_metrics), ref_grads = jax.value_and_grad(
        lambda p: jax_loss_and_metrics(args, model, p, batch, key), has_aux=True
    )(jax.tree.map(jnp.asarray, np_params))
    tx, schedule = jax_make_optimizer(args)
    p0 = jax.tree.map(jnp.asarray, np_params)
    state = {"params": p0, "opt_state": tx.init(p0), "step": jnp.array(0)}
    state, jax_step_metrics = jax_make_train_step(args, model, tx, schedule)(
        state, *batch, key)

    opt, sched = make_optimizer(args, module.parameters())
    metrics = make_train_step(args, module, opt, sched)(
        tuple(torch.from_numpy(a) for a in batch),
        step_generator(torch.device("cpu"), 0, 0))
    assert float(metrics["train/loss"]) == pytest.approx(float(ref_loss), rel=1e-5)
    for k in ("train/ctc_loss", "train/kl_loss", "train/inter_ctc_loss",
              "train/main_loss"):
        assert float(metrics[k]) == pytest.approx(float(ref_metrics[k]), rel=1e-5), k
    assert float(metrics["train/grad_norm"]) == pytest.approx(
        float(jax_step_metrics["train/grad_norm"]), rel=1e-4)
    assert float(metrics["train/grad_norm"]) > 1.0  # the clip is active
    # the port's .grad holds the clipped gradient: JAX's times 1 / norm
    clip = 1.0 / float(jax_step_metrics["train/grad_norm"])
    grads = _flat(jax.tree.map(lambda p: p.grad.float().numpy(), module.params,
                               is_leaf=lambda x: isinstance(x, torch.Tensor)))
    ref_grads = _flat(ref_grads)
    assert grads.keys() == ref_grads.keys() and len(grads) > 100
    for k, ref in ref_grads.items():
        np.testing.assert_allclose(grads[k], ref * clip,
                                   atol=GRAD_TOL * np.abs(ref * clip).max(), err_msg=k)
    new = _flat(conformer_params_to_numpy(module))
    lr0 = 4e-4 / 2
    for k, ref in _flat(state["params"]).items():
        g = np.abs(ref_grads[k])
        sure = g >= 1e-3 * g.max()
        np.testing.assert_allclose(new[k][sure], ref[sure], atol=1e-6, err_msg=k)
        assert np.abs(new[k] - ref).max() <= 2.1 * lr0, k


def test_config_from_args_matches_jax_build_model():
    args = _args(compute_dtype="bfloat16", causal=True, attn_left_context=17)
    jcfg = jax_build_model(args, 5).config
    cfg = config_from_args(args, 5)
    for f in dataclasses.fields(jcfg):
        if f.name in ("dtype", "compute_dtype"):
            continue
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.compute_dtype == torch.bfloat16 and jcfg.compute_dtype == jnp.bfloat16
    assert (cfg.n_out, cfg.use_interctc, cfg.interctc_layer) == (
        jcfg.n_out, jcfg.use_interctc, jcfg.interctc_layer)


def test_init_params_tree_matches_jax():
    args = _args(transformer_num_layers=2)  # no InterCTC head
    jtree = jax.tree.map(np.asarray, jax_build_model(args, N_DAYS).init(jax.random.key(0)))
    cfg = config_from_args(args, N_DAYS)
    ours = conformer_params_to_numpy(init_conformer_params(cfg, torch.Generator().manual_seed(0)))
    a, b = _flat(ours), _flat(jtree)
    assert a.keys() == b.keys() and "/inter_out/w" not in a
    for k in a:
        assert a[k].shape == b[k].shape, k
        # same family: the same bound (uniform) or the same constant
        assert np.abs(a[k]).max() <= np.abs(b[k]).max() * 1.05 + 1e-7, k
        if np.ptp(b[k]) == 0:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    full = _flat(conformer_params_to_numpy(
        init_conformer_params(config_from_args(_args(), N_DAYS), torch.Generator())))
    assert "/inter_out/w" in full


def test_module_params_round_trip():
    cfg = config_from_args(_args(transformer_num_layers=2), N_DAYS)
    tree = init_conformer_params(cfg, torch.Generator().manual_seed(1))
    module = ConformerDecoder(cfg, tree)
    assert sum(p.numel() for p in module.parameters()) == sum(
        v.size for v in _flat(conformer_params_to_numpy(tree)).values())
    assert isinstance(module.params["blocks"], list) and len(module.params["blocks"]) == 2
    other = ConformerDecoder(cfg, init_conformer_params(cfg, torch.Generator().manual_seed(2)))
    other.load_params(module.params)
    for x, y in zip(module.parameters(), other.parameters()):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        other.load_params({"day": module.params["day"]})


# ---------------------------------------------------------------- trainer


def _run_args(out, n_batch, **kw):
    args = {
        "outputDir": str(out), "device": "cpu", "model_type": "transformer_ctc",
        "dataset": synthetic_dataset(seed=3, n_days=1, trials_per_day=8,
                                     n_channels=8, min_t=40, max_t=64,
                                     min_u=2, max_u=4),
        "batchSize": 4, "nBatch": n_batch, "evalEvery": 3, "checkpointEvery": 2,
        "nInputFeatures": 8, "nClasses": 40, "frontend_dim": 32, "latent_dim": 32,
        "autoencoder_hidden_dim": 16, "transformer_num_layers": 2,
        "transformer_n_heads": 2, "transformer_dim_ff": 64,
        "conformer_conv_kernel": 5, "temporal_kernel": 8, "temporal_stride": 2,
        "spec_augment_freq_mask": 8, "spec_augment_time_mask": 4,
        "whiteNoiseSD": 0.2, "constantOffsetSD": 0.1, "optimizer": "adamw",
        "lrStart": 1e-3, "lrEnd": 1e-3, "warmup_steps": 2, "label_smoothing": 0.1,
        "seed": 0, "wandb_mode": "disabled", "time_multiple": 16,
    }
    args.update(kw)
    return args


def test_resume_after_preemption_is_exact(tmp_path, monkeypatch):
    """8 steps in one run equal 4 steps, a SIGTERM, and a resumed run of the
    other 4, bit for bit, with dropout, DropPath, SpecAugment and noise on."""
    full = train_model(_run_args(tmp_path / "full", 8))
    real = port_trainer.sample_batch
    calls = []

    def preempt_on_fourth(*a, **k):
        calls.append(1)
        if len(calls) == 4:
            os.kill(os.getpid(), signal.SIGTERM)
        return real(*a, **k)

    monkeypatch.setattr(port_trainer, "sample_batch", preempt_on_fourth)
    out = tmp_path / "split"
    assert train_model(_run_args(out, 8))["summary/preempted_at"] == 4
    monkeypatch.setattr(port_trainer, "sample_batch", real)
    assert train_model(_run_args(out, 8, resume=True)) == full
    a = CheckpointManager(str(tmp_path / "full")).restore("lastState")
    b = CheckpointManager(str(out)).restore("lastState")
    assert a["step"] == b["step"] == 8
    for x, y in zip(jax.tree.leaves(a["params"]), jax.tree.leaves(b["params"])):
        assert torch.equal(x, y)


def test_train_model_lowers_per_and_reloads(tmp_path):
    """A small Conformer learns the synthetic task on the CPU: test PER falls
    from the step-0 eval; load_model re-scores the best checkpoint's PER
    exactly."""
    ds = synthetic_dataset(seed=1, n_days=2, trials_per_day=32, n_channels=32,
                           min_t=60, max_t=100, min_u=3, max_u=5, signal_scale=4.0)
    args = {
        "outputDir": str(tmp_path), "device": "cpu", "dataset": ds,
        "model_type": "transformer_ctc", "batchSize": 8, "nBatch": 301,
        "evalEvery": 100, "whiteNoiseSD": 0.1, "constantOffsetSD": 0.0,
        "nInputFeatures": 32, "nClasses": 40, "frontend_dim": 64, "latent_dim": 64,
        "autoencoder_hidden_dim": 32, "transformer_num_layers": 2,
        "transformer_n_heads": 2, "transformer_dim_ff": 128,
        "conformer_conv_kernel": 7, "temporal_kernel": 8, "temporal_stride": 4,
        "transformer_dropout": 0.0, "drop_path_prob": 0.0, "use_spec_augment": False,
        "optimizer": "adamw", "lrStart": 3e-3, "lrEnd": 3e-3, "warmup_steps": 20,
        "label_smoothing": 0.1, "seed": 0, "wandb_mode": "offline",
        "time_multiple": 32,
    }
    summary = train_model(args)
    cer = CheckpointManager(str(tmp_path)).load_sidecar()["testCER"]
    assert len(cer) == 4 and summary["summary/best_cer"] < cer[0] - 0.3, cer
    model, run_args = load_model(str(tmp_path))
    assert isinstance(model, ConformerDecoder) and run_args["nDays"] == 2
    test_ds = pack_days(ds["test"])
    t_max, u_max = batching.choose_envelope(pack_days(ds["train"]), test_ds,
                                            time_multiple=32)
    _, per, _, _ = port_trainer.run_eval(
        port_trainer.make_eval_step(model), test_ds, 8, t_max, u_max,
        torch.device("cpu"), torch_mean_semantics=False)
    assert per == pytest.approx(summary["summary/best_cer"], abs=1e-12)


_NO_JAX = """
import json, sys, tempfile
import torch
from neural_speech_decoder_tpu_torch.data.synthetic import synthetic_dataset
from neural_speech_decoder_tpu_torch.models.api import forward
from neural_speech_decoder_tpu_torch.training.trainer import load_model, train_model
with tempfile.TemporaryDirectory() as run:
    summary = train_model(json.loads(sys.argv[1]) | {"outputDir": run, "dataset":
        synthetic_dataset(seed=0, n_days=1, trials_per_day=4, n_channels=8,
                          min_t=40, max_t=64, min_u=2, max_u=3)})
    model, args = load_model(run)
    with torch.no_grad():
        lp, lens, _ = forward(model, torch.ones((1, 64, 8)), torch.zeros(1, dtype=torch.int32),
                              torch.tensor([64]))
mods = [m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "neural_speech_decoder_tpu")]
print(json.dumps({"mods": mods, "finite": bool(torch.isfinite(lp).all()),
                  "trained": "summary/final_cer" in summary,
                  "conformer": type(model).__name__}))
"""


def test_conformer_train_and_load_never_import_jax():
    args = {k: v for k, v in _run_args("", 2).items() if k not in ("dataset", "outputDir")}
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", _NO_JAX, json.dumps(args)], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res == {"mods": [], "finite": True, "trained": True,
                   "conformer": "ConformerDecoder"}
