"""The port's serving forward as a whole against the JAX package's, on the
CPU in float32 (and once in the recipe's bfloat16), and the port's
independence from jax.

The same weights (``init_gru_params`` in JAX, converted) and the same
numpy inputs go through ``build_model(...).forward(train=False)`` and the
port's ``forward``. Tolerance on the log-probs: 1e-4 (five layers of
float32 recurrences and 6144-wide products summed in other orders);
lengths and greedy decodes must be equal.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neural_speech_decoder_tpu.ops.decode import greedy_decode as jax_greedy_decode
from neural_speech_decoder_tpu.training.trainer import build_model
from neural_speech_decoder_tpu_torch.models.api import config_from_args, forward
from neural_speech_decoder_tpu_torch.models.convert import gru_params_from_jax
from neural_speech_decoder_tpu_torch.models.gru import GRUDecoder
from neural_speech_decoder_tpu_torch.ops.decode import greedy_decode
from neural_speech_decoder_tpu_torch.serving.model import InferenceModel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGP_TOL = 1e-4


def _args(**kw):
    args = dict(nInputFeatures=128, nClasses=40, nUnits=64, nLayers=2,
                dropout=0.4, strideLen=4, kernelLen=32, gaussianSmoothWidth=2.0,
                bidirectional=True)
    args.update(kw)
    return args


def _both(args, n_days, seed=0):
    """The JAX model with fresh params, and the port's module on them."""
    model = build_model(args, n_days)
    params = model.init(jax.random.key(seed))
    module = GRUDecoder(config_from_args(args, n_days),
                        gru_params_from_jax(jax.tree.map(np.asarray, params)))
    return model, params, module


def _inputs(b, t, c, n_days, seed=0, lens=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    day = (np.arange(b) % n_days).astype(np.int32)
    if lens is None:
        lens = rng.integers(t // 2, t + 1, size=b)
    return x, day, np.asarray(lens, np.int32)


def _compare(args, n_days, b, t, lens=None):
    model, params, module = _both(args, n_days)
    x, day, lens = _inputs(b, t, args["nInputFeatures"], n_days, lens=lens)
    ref_lp, ref_len, _ = model.forward(params, x, day, lens, train=False, key=None)
    with torch.no_grad():  # the module's parameters are trainable
        lp, out_len, _ = forward(module, *(torch.from_numpy(a) for a in (x, day, lens)))
    assert lp.shape == ref_lp.shape and lp.dtype == torch.float32
    np.testing.assert_allclose(lp.numpy(), np.asarray(ref_lp), atol=LOGP_TOL)
    np.testing.assert_array_equal(out_len.numpy(), np.asarray(ref_len))
    ref_tok, ref_n = jax_greedy_decode(ref_lp, ref_len)
    tok, n = greedy_decode(lp, out_len)
    np.testing.assert_array_equal(n.numpy(), np.asarray(ref_n))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))


@pytest.mark.parametrize("variant", [
    {},
    {"bidirectional": False},
    {"gaussianSmoothWidth": 0.0},  # no smoothing: the unfused frontend chain
])
def test_slice_matches_jax_small(variant):
    # lens 20 is shorter than the 32-bin kernel: 0 frames, empty decode
    _compare(_args(**variant), n_days=3, b=3, t=100, lens=[100, 77, 20])


def test_slice_matches_jax_full_width():
    """The GRU baseline's widths (C=256, H=1024, 5 layers, 24 days) at a
    short length."""
    args = _args(nInputFeatures=256, nUnits=1024, nLayers=5)
    _compare(args, n_days=24, b=2, t=160, lens=[160, 131])


def test_slice_bf16_matches_jax_pallas_path(monkeypatch):
    """The recipe's bfloat16 compute against the JAX package's Pallas path
    (``use_pallas=True``, its kernels in interpret mode), which keeps a
    float32 scan carry as the port does. Both round to bf16 at the same
    places (layers 1+ take their projection rounded once), so their
    log-probs differ by float32 summation order only: within 1e-5, where
    the JAX bf16 path is ~2e-3 from its float32 path."""
    # one device, so that the JAX kernel call sites take the Pallas kernels
    monkeypatch.setattr(jax, "device_count", lambda *a, **k: 1)
    x, day, lens = _inputs(3, 100, 128, 3, lens=[100, 77, 20])
    out = {}
    for dt in ("float32", "bfloat16"):
        model, params, module = _both(_args(compute_dtype=dt, use_pallas=True), 3)
        ref_lp, ref_len, _ = model.forward(params, x, day, lens, train=False, key=None)
        with torch.no_grad():  # the module's parameters are trainable
            lp, out_len, _ = forward(module, *(torch.from_numpy(a) for a in (x, day, lens)))
        np.testing.assert_array_equal(out_len.numpy(), np.asarray(ref_len))
        out[dt] = np.asarray(ref_lp, np.float32), lp.numpy()
    (ref32, ours32), (ref16, ours16) = out["float32"], out["bfloat16"]
    np.testing.assert_allclose(ours32, ref32, atol=LOGP_TOL)
    dist = np.abs(ref16 - ref32).max()
    assert dist > 1e-4 and np.abs(ours16 - ours32).max() > 1e-4  # both really round
    np.testing.assert_allclose(ours16, ref16, atol=LOGP_TOL / 10)


def test_inference_model_serves_padded_requests_like_jax():
    args = _args()
    model, params, _ = _both(args, 3, seed=1)
    cfg = config_from_args(args, 3)
    server = InferenceModel(gru_params_from_jax(jax.tree.map(np.asarray, params)),
                            cfg, "cpu", batch_size=4, t_max=96)
    rng = np.random.default_rng(2)
    trials = [rng.standard_normal((n, 128)).astype(np.float32) for n in (96, 50)]
    x, day, lens = server.pad_batch(trials, days=[2, 1])
    assert x.shape == (4, 96, 128) and lens.tolist() == [96, 50, 0, 0]
    assert day.tolist() == [2, 1, 0, 0] and float(x[1, 50:].abs().sum()) == 0
    lp, out_lens = server(x, day, lens)
    assert out_lens.tolist()[2:] == [0, 0]
    ref_lp, ref_len, _ = model.forward(params, x.numpy(), day.numpy(),
                                       lens.numpy(), train=False, key=None)
    np.testing.assert_allclose(lp.numpy(), np.asarray(ref_lp), atol=LOGP_TOL)
    decoded = server.decode(lp, out_lens)
    assert decoded[2] == [] and decoded[3] == []
    tok, n = jax_greedy_decode(ref_lp, ref_len)
    assert decoded == [np.asarray(tok)[i, : int(n[i])].tolist() for i in range(4)]
    with pytest.raises(ValueError):
        server.pad_batch([np.zeros((97, 128), np.float32)])
    with pytest.raises(ValueError):
        server.pad_batch([np.zeros((10, 128), np.float32)] * 5)
    with pytest.raises(ValueError):
        server(x[:, :90], day, lens)


def test_config_from_args_matches_build_model():
    args = _args(compute_dtype="bfloat16")
    jcfg = build_model(args, 5).config
    cfg = config_from_args(args, 5)
    for f in ("neural_dim", "n_classes", "hidden_dim", "num_layers", "n_days",
              "dropout", "stride_len", "kernel_len", "gaussian_smooth_width",
              "gaussian_kernel_size", "bidirectional", "n_out", "input_dim"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.compute_dtype == torch.bfloat16 and jcfg.compute_dtype == jnp.bfloat16


_NO_JAX = """
import json, sys, tempfile
import numpy as np, torch
from neural_speech_decoder_tpu_torch.data.synthetic import synthetic_dataset
from neural_speech_decoder_tpu_torch.models.gru import GRUConfig, init_gru_params
from neural_speech_decoder_tpu_torch.serving.model import InferenceModel
from neural_speech_decoder_tpu_torch.training.trainer import load_model, train_model
from neural_speech_decoder_tpu_torch.training import cli
from neural_speech_decoder_tpu_torch.utils import config
from neural_speech_decoder_tpu_torch.data import device_data
from neural_speech_decoder_tpu_torch.ops.kernels import adam, library, matmul
from neural_speech_decoder_tpu_torch.serving import cli as serve_cli
from neural_speech_decoder_tpu_torch.serving import (
    export_inference, export_streaming_params, load_exported, load_exported_streamer)
cfg = GRUConfig(neural_dim=32, hidden_dim=16, num_layers=2, n_days=2, kernel_len=8)
server = InferenceModel(init_gru_params(cfg, torch.Generator().manual_seed(0)),
                        cfg, "cpu", batch_size=2, t_max=40)
x, d, n = server.pad_batch([np.ones((40, 32), np.float32)], days=[1])
lp, lens = server(x, d, n)
out = server.decode(lp, lens)
with tempfile.TemporaryDirectory() as run:
    summary = train_model({
        "outputDir": run, "device": "cpu", "batchSize": 2, "nBatch": 2,
        "dataset": synthetic_dataset(seed=0, n_days=1, trials_per_day=4,
                                     n_channels=8, min_t=24, max_t=40,
                                     min_u=2, max_u=3),
        "lrStart": 0.01, "lrEnd": 0.01, "l2_decay": 0.0, "evalEvery": 1,
        "whiteNoiseSD": 0.1, "constantOffsetSD": 0.1, "gaussianSmoothWidth": 2.0,
        "nUnits": 8, "nLayers": 2, "nInputFeatures": 8, "nClasses": 40,
        "dropout": 0.2, "strideLen": 2, "kernelLen": 4, "bidirectional": True,
        "wandb_mode": "disabled", "time_multiple": 16, "fused_optimizer": True,
        "use_pallas_matmul": True, "deviceResidentData": True})
    model, args = load_model(run)
    exported = load_exported(export_inference(run, run + "/art", batch_size=2, t_max=32,
                                              device="cpu"))
    e_lp, e_lens = exported(*exported.pad_batch([np.ones((30, 8), np.float32)]))
from neural_speech_decoder_tpu_torch.models.conformer import (
    ConformerConfig, init_conformer_params)
from neural_speech_decoder_tpu_torch.streaming.conformer import ConformerStreamer
from neural_speech_decoder_tpu_torch.streaming.engine import GRUStreamer
scfg = GRUConfig(neural_dim=8, hidden_dim=16, num_layers=2, n_days=1, kernel_len=8,
                 bidirectional=False)
ccfg = ConformerConfig(n_channels=8, n_days=1, frontend_dim=16, latent_dim=16,
                       autoencoder_hidden_dim=8, num_layers=2, num_heads=2, ff_dim=16,
                       temporal_kernel=8, conv_kernel=3, causal=True, attn_left_context=4)
streamed = []
for st in (GRUStreamer(init_gru_params(scfg, torch.Generator().manual_seed(0)), scfg, 0,
                       batch=2, device="cpu"),
           ConformerStreamer(init_conformer_params(ccfg, torch.Generator().manual_seed(0)),
                             ccfg, 0, batch=2, device="cpu")):
    for i in range(12):
        nbest = st.decode_beam(st.process_async(np.ones((2, 4, 8), np.float32) * i),
                               beam_width=4, max_len=16)
    nbest = st.decode_beam(st.flush(), beam_width=4, max_len=16)
    streamed.append(st.emitted == (48 - 8) // 4 and st.fast_path_engaged is False
                    and bool(torch.isfinite(nbest[2][:, 0]).all()))
mods = [m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "neural_speech_decoder_tpu")]
print(json.dumps({"mods": mods, "finite": bool(torch.isfinite(lp).all()),
                  "empty": out[1], "trained": "summary/final_cer" in summary,
                  "reloaded": args["nDays"] == 1, "streamed": streamed,
                  "exported": bool(torch.isfinite(e_lp).all()) and e_lens.tolist() == [13, 0]}))
"""


def test_port_never_imports_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res == {"mods": [], "finite": True, "empty": [], "trained": True,
                   "reloaded": True, "streamed": [True, True], "exported": True}
