"""The port's reference-layout checkpoint interop against the JAX package's,
on the CPU: ``neural_speech_decoder_tpu_torch/models/torch_{export,import}.py``
against ``neural_speech_decoder_tpu/models/torch_{export,import}.py``.

The same weights (JAX's ``init_*_params`` from a seed, carried over with
``models/convert.py::params_from_jax``, the day affine randomized so the
export exercises it) go through both exporters: the same keys and
bit-equal arrays, the smoothing buffer and the dead ``inpLayer`` Linears
included. A reference state dict goes through both importers: bit-equal
leaves. Round trips both ways, and through ``torch.save`` and the export's
``main()`` on ``device=cpu``, are exact. Forward: the port's eval forward
on an imported state dict against JAX's ``gru_forward`` /
``conformer_forward`` on the same dict, float32, logits within 2e-5 (GRU:
two layers of 12-wide recurrences and products summed in other orders, as
``tests/test_torch_export.py``) and log-probs within 1e-5 of their largest
entry (Conformer, as ``tests/test_torch_port_conformer.py``). The smoke's
reference-layout ``nn.GRU`` module (``chip_smoke.py::ReferenceGRUDecoder``,
which the card's full-width check rests on) loads the exported GRU state
dict strictly and gives JAX's ``gru_forward`` logits within 2e-5.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neural_speech_decoder_tpu.models import conformer as jax_conformer
from neural_speech_decoder_tpu.models import gru as jax_gru
from neural_speech_decoder_tpu.models import torch_export as jax_export
from neural_speech_decoder_tpu.models import torch_import as jax_import
from neural_speech_decoder_tpu.training.trainer import build_model as jax_build_model
from neural_speech_decoder_tpu_torch.data.synthetic import synthetic_dataset
from neural_speech_decoder_tpu_torch.models import torch_export, torch_import
from neural_speech_decoder_tpu_torch.models.api import config_from_args, forward
from neural_speech_decoder_tpu_torch.models.conformer import ConformerDecoder
from neural_speech_decoder_tpu_torch.models.convert import params_from_jax
from neural_speech_decoder_tpu_torch.models.gru import GRUDecoder
from neural_speech_decoder_tpu_torch.training.trainer import load_model, train_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from chip_smoke import ReferenceConformerLayout, ReferenceGRUDecoder  # noqa: E402

GRU_LOGIT_TOL = 2e-5
CONF_LOGP_TOL = 1e-5
N_DAYS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small CPU ops gain nothing from more, and
    the suite's parallel workers would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gru_args(**kw):
    return dict(nInputFeatures=8, nClasses=5, nUnits=12, nLayers=2, dropout=0.0,
                strideLen=2, kernelLen=4, gaussianSmoothWidth=2.0, bidirectional=True) | kw


def _conf_args(**kw):
    return dict(model_type="transformer_ctc", nInputFeatures=8, nClasses=5, frontend_dim=16,
                latent_dim=16, autoencoder_hidden_dim=12, transformer_num_layers=2,
                transformer_n_heads=2, transformer_dim_ff=24, transformer_dropout=0.0,
                temporal_kernel=4, temporal_stride=2, conformer_conv_kernel=5,
                use_spec_augment=False, drop_path_prob=0.0) | kw


ARGS = {
    "gru": _gru_args(),
    "gru_unidirectional": _gru_args(bidirectional=False),
    "conformer": _conf_args(),
    "conformer_interctc": _conf_args(transformer_num_layers=6),
}


def _jax_params(args, seed=0):
    """JAX's config and a fresh tree (numpy leaves), its day affine
    randomized."""
    model = jax_build_model(args, N_DAYS)
    params = jax.tree.map(np.asarray, model.init(jax.random.key(seed)))
    rng = np.random.default_rng(seed + 1)
    day = params["day"]
    day["weight"] = (day["weight"] + 0.1 * rng.standard_normal(day["weight"].shape)
                     ).astype(np.float32)
    day["bias"] = (0.1 * rng.standard_normal(day["bias"].shape)).astype(np.float32)
    return model.config, params


def _jax_export(cfg, params):
    fn = (jax_export.export_conformer_state_dict
          if isinstance(cfg, jax_conformer.ConformerConfig) else jax_export.export_gru_state_dict)
    return fn(params, cfg)


def _jax_import(sd, cfg):
    fn = (jax_import.import_conformer_state_dict
          if isinstance(cfg, jax_conformer.ConformerConfig) else jax_import.import_gru_state_dict)
    return jax.tree.map(np.asarray, fn(sd, cfg))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(tree[key], f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, t in enumerate(tree) for k, v in _flat(t, f"{prefix}/{i}").items()}
    return {prefix: tree.detach().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)}


def _assert_trees_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype == np.float32, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.mark.parametrize("kind", list(ARGS))
def test_export_matches_jax(kind):
    """Same keys, bit-equal float32 arrays (smoothing buffer and inpLayers
    included); every value a contiguous float32 CPU tensor."""
    args = ARGS[kind]
    jcfg, jparams = _jax_params(args)
    want = _jax_export(jcfg, jparams)
    got = torch_export.export_state_dict(params_from_jax(jparams),
                                         config_from_args(args, N_DAYS))
    assert got.keys() == want.keys()
    for k, v in got.items():
        assert v.device.type == "cpu" and v.dtype == torch.float32 and v.is_contiguous(), k
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    if kind.startswith("gru"):
        assert "gaussianSmoother.weight" in got and f"inpLayer{N_DAYS - 1}.bias" in got
    assert ("inter_output.weight" in got) == (kind == "conformer_interctc")


@pytest.mark.parametrize("kind", list(ARGS))
def test_import_matches_jax(kind):
    """A reference state dict (numpy, and as CPU tensors) -> the port's tree,
    leaf for leaf bit-equal to JAX's import."""
    args = ARGS[kind]
    jcfg, jparams = _jax_params(args, seed=3)
    sd = _jax_export(jcfg, jparams)
    cfg = config_from_args(args, N_DAYS)
    want = _jax_import(sd, jcfg)
    _assert_trees_equal(torch_import.import_state_dict(sd, cfg), want)
    tensors = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    _assert_trees_equal(torch_import.import_state_dict(tensors, cfg), want)


@pytest.mark.parametrize("kind", list(ARGS))
def test_round_trips_are_exact(kind):
    """tree -> export -> import == tree, and state dict -> import -> export
    == state dict."""
    args = ARGS[kind]
    jcfg, jparams = _jax_params(args, seed=5)
    cfg = config_from_args(args, N_DAYS)
    tree = params_from_jax(jparams)
    _assert_trees_equal(torch_import.import_state_dict(
        torch_export.export_state_dict(tree, cfg), cfg), tree)
    sd = _jax_export(jcfg, jparams)
    back = torch_export.export_state_dict(torch_import.import_state_dict(sd, cfg), cfg)
    assert back.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)


def test_interleaved_qkv_layout_is_rejected():
    args = _conf_args(qkv_interleaved=True)
    cfg = config_from_args(args, N_DAYS)
    assert cfg.qkv_interleaved
    _, jparams = _jax_params(_conf_args())
    with pytest.raises(ValueError, match="canonical"):
        torch_export.export_conformer_state_dict(params_from_jax(jparams), cfg)


@pytest.mark.parametrize("kind", ["gru", "gru_unidirectional"])
def test_gru_forward_on_imported_state_dict_matches_jax(kind):
    args = ARGS[kind]
    jcfg, jparams = _jax_params(args, seed=7)
    sd = _jax_export(jcfg, jparams)
    cfg = config_from_args(args, N_DAYS)
    module = GRUDecoder(cfg, torch_import.import_gru_state_dict(sd, cfg))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 40, 8)).astype(np.float32)
    days = np.array([0, 2], np.int32)
    want = np.asarray(jax_gru.gru_forward(_jax_import(sd, jcfg), jcfg, jnp.asarray(x),
                                          jnp.asarray(days)))
    with torch.no_grad():
        got = module(torch.from_numpy(x), torch.from_numpy(days)).numpy()
    np.testing.assert_allclose(got, want, atol=GRU_LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("kind", ["conformer", "conformer_interctc"])
def test_conformer_forward_on_imported_state_dict_matches_jax(kind):
    args = ARGS[kind]
    jcfg, jparams = _jax_params(args, seed=9)
    sd = _jax_export(jcfg, jparams)
    cfg = config_from_args(args, N_DAYS)
    module = ConformerDecoder(cfg, torch_import.import_conformer_state_dict(sd, cfg))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 32, 8)).astype(np.float32)
    days, lens = np.array([0, 1], np.int32), np.array([32, 28], np.int32)
    want, want_lens, _ = jax_conformer.conformer_forward(
        _jax_import(sd, jcfg), dataclasses.replace(jcfg, head_dropout=0.0), jnp.asarray(x),
        jnp.asarray(days), jnp.asarray(lens))
    with torch.no_grad():
        got, got_lens, _ = forward(module, *(torch.from_numpy(a) for a in (x, days, lens)))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, atol=CONF_LOGP_TOL * np.abs(want).max(),
                               rtol=0)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))


@pytest.mark.parametrize("bidirectional", [True, False])
def test_reference_layout_gru_module_matches_jax(bidirectional):
    """The smoke's ``nn.GRU`` reference module: strict loading of the port's
    export, and its forward against JAX's ``gru_forward``."""
    args = _gru_args(bidirectional=bidirectional)
    jcfg, jparams = _jax_params(args, seed=11)
    cfg = config_from_args(args, N_DAYS)
    sd = torch_export.export_gru_state_dict(params_from_jax(jparams), cfg)
    ref = ReferenceGRUDecoder.from_config(cfg)
    ref.load_state_dict(sd, strict=True)
    ref.eval()
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 40, 8)).astype(np.float32)
    days = np.array([0, 2, 1], np.int32)
    want = np.asarray(jax_gru.gru_forward(jparams, jcfg, jnp.asarray(x), jnp.asarray(days)))
    with torch.no_grad():
        got = ref(torch.from_numpy(x), torch.from_numpy(days).long()).numpy()
    np.testing.assert_allclose(got, want, atol=GRU_LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("kind", ["conformer", "conformer_interctc"])
def test_reference_conformer_layout_matches_export(kind):
    """The smoke's Conformer layout has the export's keys and shapes."""
    args = ARGS[kind]
    _, jparams = _jax_params(args)
    cfg = config_from_args(args, N_DAYS)
    sd = torch_export.export_conformer_state_dict(params_from_jax(jparams), cfg)
    assert ReferenceConformerLayout(cfg).shapes() == {k: tuple(v.shape) for k, v in sd.items()}


@pytest.mark.parametrize("family", ["gru_baseline", "transformer_ctc"])
def test_export_main_and_load_checkpoint_on_cpu(tmp_path, family):
    """A trained run -> ``torch_export.main(--device cpu)`` -> a file of
    CPU tensors equal to the JAX exporter's output on the same weights ->
    ``load_checkpoint(device="cpu")``: a tree bit-equal to ``load_model``'s,
    and the same forward."""
    run = tmp_path / "run"
    args = {"outputDir": str(run), "device": "cpu", "batchSize": 2, "nBatch": 2,
            "dataset": synthetic_dataset(seed=0, n_days=2, trials_per_day=4, n_channels=8,
                                         min_t=24, max_t=40, min_u=2, max_u=3),
            "lrStart": 0.01, "lrEnd": 0.01, "l2_decay": 0.0, "evalEvery": 1,
            "whiteNoiseSD": 0.0, "constantOffsetSD": 0.0, "nClasses": 40, "seed": 0,
            "wandb_mode": "disabled", "time_multiple": 16}
    if family == "gru_baseline":
        args |= _gru_args(nInputFeatures=8, nClasses=40)
    else:
        args |= _conf_args(nInputFeatures=8, nClasses=40, optimizer="adamw", warmup_steps=1)
    train_model(args)
    out = tmp_path / "modelWeights"
    assert torch_export.main([str(run), str(out), "--device", "cpu"]) == str(out)
    sd = torch.load(out, map_location="cpu", weights_only=True)
    model, margs = load_model(str(run), device="cpu")
    jcfg = jax_build_model(margs, model.cfg.n_days).config
    want = _jax_export(jcfg, _numpy_tree(model))
    assert sd.keys() == want.keys()
    for k, v in sd.items():
        assert v.device.type == "cpu" and v.is_contiguous()
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    back = torch_import.load_checkpoint(str(out), margs, device="cpu")
    _assert_trees_equal(back.params, model.params)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 40, 8)).astype(np.float32))
    days, lens = torch.tensor([0, 1]), torch.tensor([40, 30])
    with torch.no_grad():
        a, b = forward(back, x, days, lens), forward(model, x, days, lens)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _numpy_tree(model):
    """A module's parameter tree as numpy arrays (JAX's exporter takes them)."""
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, list):
            return [conv(v) for v in t]
        return t.detach().numpy()
    return conv(model.params)


def test_load_checkpoint_on_cuda_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_import.load_checkpoint(str(tmp_path / "missing"), _gru_args())
