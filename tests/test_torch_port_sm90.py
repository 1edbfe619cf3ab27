"""The run args that pick the plain paths (``use_pallas``, ``ctc_use_kernel``,
``rng_impl``) and the projection matmul's choice of kernel body, in the
port, on the CPU.

- ``use_pallas: false`` runs the plain versions of the GRU time scan and
  the serving frontend and keeps every other kernel (the JAX package's
  ``cfg.use_pallas``); the call sites are watched through monkeypatched
  functions that record their ``plain`` choice, and the forward is held
  against JAX's ``use_pallas=False`` forward (log-probs within 1e-4, as
  ``test_torch_port_slice.py``: float32 recurrences and products summed in
  other orders).
- ``ctc_use_kernel: false`` runs ``ctc_loss(plain=True)`` at both call
  sites, the train loss and the eval loss (the JAX trainer takes optax's
  CTC at both).
- ``rng_impl`` warns once that it changes nothing in the port.
- ``ops/kernels/matmul.py::matmul_body``: aligned bfloat16 to the sm90 body
  (TMA + wgmma), aligned float32 with contiguous extents that are multiples
  of 4 to the pipelined float32 body, everything else to the tile body.
"""

import warnings

import numpy as np
import pytest

import jax
import torch

from neural_speech_decoder_tpu.training.trainer import build_model as jax_build_model
from neural_speech_decoder_tpu_torch.data.synthetic import synthetic_dataset
from neural_speech_decoder_tpu_torch.models import gru as port_gru
from neural_speech_decoder_tpu_torch.models.api import build_model, config_from_args, forward
from neural_speech_decoder_tpu_torch.models.convert import gru_params_from_jax
from neural_speech_decoder_tpu_torch.models.gru import GRUDecoder
from neural_speech_decoder_tpu_torch.ops.kernels import matmul as port_mm
from neural_speech_decoder_tpu_torch.training import trainer as port_trainer

LOGP_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's parallel workers would otherwise
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _args(**kw):
    args = dict(nInputFeatures=32, nClasses=40, nUnits=64, nLayers=2, dropout=0.0,
                strideLen=4, kernelLen=8, gaussianSmoothWidth=2.0, bidirectional=True,
                whiteNoiseSD=0.0, constantOffsetSD=0.0, lrStart=0.02, lrEnd=0.01,
                l2_decay=1e-5, nBatch=10, seed=0, watch_log_freq=0, batchSize=4)
    args.update(kw)
    return args


def _batch(b=4, t=120, c=32, u=6, n_days=3, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(a) for a in (
        rng.standard_normal((b, t, c)).astype(np.float32),
        rng.integers(1, 41, size=(b, u)).astype(np.int32),
        np.array([120, 97, 64, 40][:b], np.int32),
        np.array([6, 4, 3, 2][:b], np.int32),
        (np.arange(b) % n_days).astype(np.int32)))


def _record(monkeypatch, module, name, calls):
    """Replace ``module.name`` by a wrapper that appends ``(name, plain)``
    to ``calls`` and runs the original."""
    original = getattr(module, name)

    def wrapper(*args, **kw):
        calls.append((name, bool(kw.get("plain", False))))
        return original(*args, **kw)

    monkeypatch.setattr(module, name, wrapper)


def _frontend_calls(monkeypatch, calls):
    for name in ("fused_frontend", "fused_frontend_plain"):
        original = getattr(port_gru, name)
        monkeypatch.setattr(port_gru, name,
                            lambda *a, _n=name, _f=original, **k: calls.append((_n, None))
                            or _f(*a, **k))


# ------------------------------------------------------------- use_pallas


def test_use_pallas_reaches_the_gru_config():
    assert config_from_args(_args(), 3).use_pallas is None
    assert config_from_args(_args(use_pallas=True), 3).use_pallas is True
    assert config_from_args(_args(use_pallas=False), 3).use_pallas is False


@pytest.mark.parametrize("use_pallas, plain_scan", [(None, False), (True, False),
                                                    (False, True)])
@pytest.mark.parametrize("train", [False, True])
def test_use_pallas_false_takes_the_plain_scan_and_frontend(monkeypatch, use_pallas,
                                                            plain_scan, train):
    """``use_pallas: false`` sends the time scan (every layer, train and
    eval) and the serving frontend to their plain versions; the projection
    kernel (``use_pallas_matmul``) and the CTC kernels stay."""
    args = _args(use_pallas=use_pallas, use_pallas_matmul=True)
    model = build_model(args, 3, "cpu")
    calls = []
    _record(monkeypatch, port_gru, "gru_scan", calls)
    _record(monkeypatch, port_gru, "projection_matmul", calls)
    _record(monkeypatch, port_trainer, "ctc_loss", calls)
    _frontend_calls(monkeypatch, calls)
    batch = _batch()
    if train:
        loss, _ = port_trainer._loss_and_metrics(
            args, model, batch, port_trainer.step_generator(torch.device("cpu"), 0, 0))
        loss.backward()
    else:
        port_trainer.make_eval_step(model, args)(*batch)
    scans = [p for n, p in calls if n == "gru_scan"]
    assert scans == [plain_scan] * args["nLayers"]
    assert [p for n, p in calls if n == "projection_matmul"] == [False]
    assert [p for n, p in calls if n == "ctc_loss"] == [False]
    fronts = [n for n, _ in calls if n.startswith("fused_frontend")]
    # training takes the unfused chain whatever use_pallas says
    want = [] if train else ["fused_frontend_plain" if plain_scan else "fused_frontend"]
    assert fronts == want


def test_use_pallas_false_forward_matches_jax():
    """The eval forward with ``use_pallas: false`` against JAX's forward with
    the same flag (its lax.scan twin and unfused frontend)."""
    args = dict(nInputFeatures=128, nClasses=40, nUnits=64, nLayers=2, dropout=0.4,
                strideLen=4, kernelLen=32, gaussianSmoothWidth=2.0, bidirectional=True,
                use_pallas=False)
    model = jax_build_model(args, 3)
    params = model.init(jax.random.key(0))
    module = GRUDecoder(config_from_args(args, 3),
                        gru_params_from_jax(jax.tree.map(np.asarray, params)))
    assert module.cfg.use_pallas is False
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 100, 128)).astype(np.float32)
    day = np.arange(3, dtype=np.int32)
    lens = np.array([100, 77, 20], np.int32)
    ref_lp, ref_len, _ = model.forward(params, x, day, lens, train=False, key=None)
    with torch.no_grad():
        lp, out_len, _ = forward(module, *(torch.from_numpy(a) for a in (x, day, lens)))
    np.testing.assert_allclose(lp.numpy(), np.asarray(ref_lp), atol=LOGP_TOL)
    np.testing.assert_array_equal(out_len.numpy(), np.asarray(ref_len))


# --------------------------------------------------------- ctc_use_kernel


@pytest.mark.parametrize("ctc_use_kernel, plain", [(None, False), (True, False),
                                                   (False, True)])
def test_ctc_use_kernel_picks_the_ctc_at_both_call_sites(monkeypatch, ctc_use_kernel, plain):
    args = _args(ctc_use_kernel=ctc_use_kernel)
    model = build_model(args, 3, "cpu")
    calls = []
    _record(monkeypatch, port_trainer, "ctc_loss", calls)
    batch = _batch()
    port_trainer._loss_and_metrics(
        args, model, batch, port_trainer.step_generator(torch.device("cpu"), 0, 0))
    port_trainer.make_eval_step(model, args)(*batch)
    assert calls == [("ctc_loss", plain), ("ctc_loss", plain)]


def test_ctc_use_kernel_false_loss_equals_the_kernel_path():
    """On the CPU both CTC paths are plain PyTorch; the flag changes which
    one runs, not the number."""
    batch = _batch()
    losses = []
    for flag in (True, False):
        args = _args(ctc_use_kernel=flag)
        model = build_model(args, 3, "cpu")
        loss, _ = port_trainer._loss_and_metrics(
            args, model, batch, port_trainer.step_generator(torch.device("cpu"), 0, 0))
        losses.append(loss.item())
    assert losses[0] == pytest.approx(losses[1], rel=1e-6)


def _run_args(out, **kw):
    args = {
        "outputDir": str(out), "device": "cpu",
        "dataset": synthetic_dataset(seed=3, n_days=1, trials_per_day=8, n_channels=8,
                                     min_t=24, max_t=40, min_u=2, max_u=4),
        "batchSize": 4, "lrStart": 0.005, "lrEnd": 0.001, "l2_decay": 1e-5, "nBatch": 2,
        "evalEvery": 1, "whiteNoiseSD": 0.0, "constantOffsetSD": 0.0,
        "gaussianSmoothWidth": 2.0, "nUnits": 16, "nLayers": 2, "nInputFeatures": 8,
        "nClasses": 40, "dropout": 0.0, "strideLen": 2, "kernelLen": 4,
        "bidirectional": True, "seed": 0, "wandb_mode": "disabled", "time_multiple": 16,
    }
    args.update(kw)
    return args


def test_train_model_honours_ctc_use_kernel_and_warns_rng_impl(tmp_path, monkeypatch):
    """``train_model`` with ``ctc_use_kernel: false`` takes the plain CTC in
    its train steps and its evals, and warns once about ``rng_impl``."""
    monkeypatch.setattr(port_trainer, "_warned_rng_impl", False)
    calls = []
    _record(monkeypatch, port_trainer, "ctc_loss", calls)
    with pytest.warns(UserWarning, match="rng_impl='threefry2x32' has no effect") as rec:
        port_trainer.train_model(_run_args(tmp_path, ctc_use_kernel=False,
                                           rng_impl="threefry2x32"))
    assert sum("rng_impl" in str(w.message) for w in rec) == 1
    # 2 train steps and 2 evals of the 2 test trials (one batch each)
    assert len(calls) == 4 and all(plain for _, plain in calls)


# ---------------------------------------------------------------- rng_impl


def test_rng_impl_warns_once_and_says_why(monkeypatch):
    monkeypatch.setattr(port_trainer, "_warned_rng_impl", False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        port_trainer.warn_unused_args(_args())  # no rng_impl: silent
    with pytest.warns(UserWarning) as rec:
        port_trainer.warn_unused_args(_args(rng_impl="rbg"))
        port_trainer.warn_unused_args(_args(rng_impl="threefry2x32"))
    assert len(rec) == 1
    msg = str(rec[0].message)
    assert "rng_impl='rbg'" in msg and "torch.Generator" in msg and "bit-reproducible" in msg


# ------------------------------------------------------ the matmul's body


@pytest.mark.parametrize("dtype, kind, rows, cols, red, aligned, body", [
    # the GRU's projections at the recipe's shapes: every one on sm90
    (torch.bfloat16, "nn", 20032, 6144, 2048, True, "sm90"),
    (torch.bfloat16, "nt", 20032, 2048, 6144, True, "sm90"),
    (torch.bfloat16, "tn", 2048, 6144, 20032, True, "sm90"),
    # ragged rows and a ragged long axis are TMA's zero fill, not a stride
    (torch.bfloat16, "nn", 1001, 6144, 2048, True, "sm90"),
    (torch.bfloat16, "tn", 2048, 6144, 1001, True, "sm90"),
    (torch.bfloat16, "nn", 40, 264, 72, True, "sm90"),
    # a contiguous extent not a multiple of 8: TMA cannot take the stride
    (torch.bfloat16, "nn", 1001, 6144, 2044, True, "tile"),
    (torch.bfloat16, "nn", 1001, 6142, 2048, True, "tile"),
    (torch.bfloat16, "nt", 100, 130, 72, True, "tile"),
    (torch.bfloat16, "tn", 100, 72, 40, True, "tile"),
    # a pointer off the 16-byte grid
    (torch.bfloat16, "nn", 20032, 6144, 2048, False, "tile"),
    # float32 never takes wgmma (TF32): aligned, with contiguous extents
    # that are multiples of 4, the pipelined float32 body, at the recipe's
    # shapes and at a ragged M (rows, or the long axis of tn)
    (torch.float32, "nn", 20032, 6144, 2048, True, "f32"),
    (torch.float32, "nt", 20032, 2048, 6144, True, "f32"),
    (torch.float32, "tn", 2048, 6144, 20032, True, "f32"),
    (torch.float32, "nn", 1001, 6144, 2048, True, "f32"),
    (torch.float32, "nt", 1001, 2048, 6144, True, "f32"),
    (torch.float32, "tn", 2048, 6144, 1001, True, "f32"),
    # float32 with a contiguous extent not a multiple of 4, or off the
    # 16-byte grid: the tile body
    (torch.float32, "nn", 1001, 6144, 2046, True, "tile"),
    (torch.float32, "nt", 1001, 2046, 6144, True, "tile"),
    (torch.float32, "tn", 2046, 6144, 1001, True, "tile"),
    (torch.float32, "tn", 2048, 6142, 20032, True, "tile"),
    (torch.float32, "nn", 20032, 6144, 2048, False, "tile"),
    (torch.float32, "tn", 2048, 6144, 1001, False, "tile"),
])
def test_matmul_body_dispatch(dtype, kind, rows, cols, red, aligned, body):
    assert port_mm.matmul_body(dtype, kind, rows, cols, red, aligned=aligned) == body


def test_matmul_on_the_cpu_counts_no_launch():
    a, b = torch.ones((16, 8), dtype=torch.bfloat16), torch.ones((8, 24), dtype=torch.bfloat16)
    before = dict(port_mm.tiled_matmul.launches_by_body)
    out = port_mm.tiled_matmul(a, b, kind="nn")
    assert torch.equal(out, torch.full((16, 24), 8.0, dtype=torch.bfloat16))
    assert port_mm.tiled_matmul.launches_by_body == before == {
        "sm90": before["sm90"], "f32": before["f32"], "tile": before["tile"]}
