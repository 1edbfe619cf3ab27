"""The port's exported batch artifacts (``serving/export.py``) against the
port's eager forward and against the JAX package's artifacts, on the CPU,
and the serving kernels as operators (``ops/kernels/library.py``).

Sizes are ``tests/test_serving_export.py``'s (8 channels, 2 layers, widths
16). A CPU export runs the kernels' plain twins, as the eager forward on
the CPU does.

Tolerances: the port's artifact against the port's eager
``InferenceModel``, bit-equal (the program runs the same aten ops and
operators on the same inputs; measured 0.0 for both families, float32 and
bfloat16). Against the JAX package's ``export_inference`` artifact from the
same weights (``models/convert.py``) and the same numpy inputs: the GRU's
log-probs within 1e-4 (``tests/test_torch_port_slice.py``'s), the
Conformer's within 1e-5 of their largest entry
(``tests/test_torch_port_conformer.py``'s); ``out_lens`` and greedy
decodes equal.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax
import torch

from neural_speech_decoder_tpu.ops.decode import greedy_decode as jax_greedy_decode
from neural_speech_decoder_tpu.serving import export_inference as jax_export_inference
from neural_speech_decoder_tpu.serving import load_exported as jax_load_exported
from neural_speech_decoder_tpu.training import checkpoints as jax_checkpoints
from neural_speech_decoder_tpu.training.trainer import build_model as jax_build_model
from neural_speech_decoder_tpu_torch.models.api import build_model
from neural_speech_decoder_tpu_torch.models.convert import params_from_jax
from neural_speech_decoder_tpu_torch.ops.decode import greedy_decode
from neural_speech_decoder_tpu_torch.ops.kernels import (
    attention,
    conv_module,
    ffn,
    frontend,
    gru_scan,
    library,
    matmul,
)
from neural_speech_decoder_tpu_torch.serving import (
    export_inference,
    export_streaming,
    load_exported,
    load_exported_streamer,
)
from neural_speech_decoder_tpu_torch.serving.model import InferenceModel
from neural_speech_decoder_tpu_torch.serving.pad import Padder
from neural_speech_decoder_tpu_torch.training import checkpoints

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_DAYS = 2
BASE = {"batchSize": 4, "nBatch": 2, "seed": 0, "nInputFeatures": 8, "nClasses": 40,
        "time_multiple": 16, "maxTimeSeriesLen": 64, "nDays": N_DAYS}
GRU_ARGS = dict(BASE, gaussianSmoothWidth=2.0, nUnits=16, nLayers=2, dropout=0.0,
                strideLen=4, kernelLen=8, bidirectional=True)
CONF_ARGS = dict(
    BASE, model_type="transformer_ctc", temporal_kernel=8, temporal_stride=4,
    gaussian_smooth_width=2.0, frontend_dim=16, latent_dim=16, autoencoder_hidden_dim=12,
    transformer_num_layers=2, transformer_n_heads=2, transformer_dim_ff=24,
    transformer_dropout=0.1, conformer_conv_kernel=5, drop_path_prob=0.0)
# nUnits=64 bidirectional: K=128, N=384, so layer 1 takes the projection
# kernel's operator
GRU_MM_ARGS = dict(GRU_ARGS, nUnits=64, use_pallas_matmul=True)
GRU_TOL = 1e-4
CONF_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small CPU ops gain nothing from more, and
    the suite's parallel workers would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_run(path, args, seed=0):
    """A port run directory (``args`` and a best checkpoint) of fresh
    weights; returns the model."""
    model = build_model(args, N_DAYS, "cpu", seed)
    checkpoints.save_args(str(path), {**args, "device": "cpu"})
    checkpoints.CheckpointManager(str(path)).save("modelState", {"params": model.params})
    return model


def _trials(n, c=8, t_max=64, seed=0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(t_max // 2, t_max + 1, size=n)
    return ([rng.standard_normal((int(t), c)).astype(np.float32) for t in lens],
            [int(d) for d in rng.integers(0, N_DAYS, size=n)])


@pytest.mark.parametrize("args, dtype", [
    (GRU_ARGS, "float32"),
    (GRU_ARGS, "bfloat16"),
    (GRU_MM_ARGS, "bfloat16"),
    (CONF_ARGS, "float32"),
    ({**CONF_ARGS, "fused_ffn": True, "fused_conv": True}, "bfloat16"),
], ids=["gru", "gru-bf16", "gru-matmul-bf16", "conformer", "conformer-fused-bf16"])
def test_artifact_matches_eager_forward(tmp_path, args, dtype):
    """The artifact's requests against the eager ``InferenceModel`` of the
    same run: bit-equal, and so are the pads."""
    args = {**args, "compute_dtype": dtype}
    model = _port_run(tmp_path / "run", args)
    art = export_inference(str(tmp_path / "run"), str(tmp_path / "art"), batch_size=4,
                           t_max=64, device="cpu")
    exported = load_exported(art)
    meta = exported.meta
    assert (meta["batch_size"], meta["t_max"], meta["n_channels"]) == (4, 64, 8)
    assert meta["model_type"] == args.get("model_type", "gru_baseline")
    assert meta["device"] == "cpu" and meta["torch_version"] == torch.__version__
    assert len(meta["leaf_names"]) == meta["n_leaves"] == len(meta["leaf_dtypes"])
    eager = InferenceModel(model.params, model.cfg, "cpu", batch_size=4, t_max=64)
    for n in (4, 3, 1):  # shorter requests after longer: the pad's zeroing
        trials, days = _trials(n, seed=n)
        batch = exported.pad_batch(trials, days)
        ref_batch = eager.pad_batch(trials, days)
        for a, b in zip(batch, ref_batch):
            assert torch.equal(a, b)
        lp, out_lens = exported(*batch)
        ref_lp, ref_lens = eager(*ref_batch)
        assert lp.dtype == torch.float32 and torch.equal(lp, ref_lp)
        assert torch.equal(out_lens, ref_lens)
        assert exported.decode(lp, out_lens) == eager.decode(ref_lp, ref_lens)


def _jax_run(path, args, seed=0):
    """A JAX run directory of fresh weights; returns the JAX params."""
    params = jax_build_model(args, N_DAYS).init(jax.random.key(seed))
    jax_checkpoints.save_args(str(path), args)
    jax_checkpoints.CheckpointManager(str(path)).save("modelState", {"params": params})
    return params


@pytest.mark.parametrize("args, tol, relative", [(GRU_ARGS, GRU_TOL, False),
                                                  (CONF_ARGS, CONF_TOL, True)],
                         ids=["gru", "conformer"])
def test_artifact_matches_jax_artifact(tmp_path, args, tol, relative):
    """The same weights exported by both packages, the same numpy request:
    log-probs within the tolerance, lengths and greedy decodes equal."""
    params = _jax_run(tmp_path / "jax_run", args)
    port_params = params_from_jax(jax.tree.map(np.asarray, params))
    checkpoints.save_args(str(tmp_path / "run"), {**args, "device": "cpu"})
    checkpoints.CheckpointManager(str(tmp_path / "run")).save("modelState",
                                                              {"params": port_params})
    jax_model = jax_load_exported(jax_export_inference(
        str(tmp_path / "jax_run"), str(tmp_path / "jax_art"), batch_size=4, t_max=64))
    model = load_exported(export_inference(str(tmp_path / "run"), str(tmp_path / "art"),
                                           batch_size=4, t_max=64, device="cpu"))
    trials, days = _trials(4, seed=5)  # every row real: no row fully masked
    x, dd, lens = jax_model.pad_batch(trials, days)
    ref_lp, ref_lens = jax_model(x, dd, lens)
    lp, out_lens = model(x, dd, lens)
    ref_lp = np.asarray(ref_lp)
    np.testing.assert_allclose(lp.numpy(), ref_lp,
                               atol=tol * np.abs(ref_lp).max() if relative else tol)
    np.testing.assert_array_equal(out_lens.numpy(), np.asarray(ref_lens))
    ref_tok, ref_n = jax_greedy_decode(ref_lp, ref_lens)
    tok, n = greedy_decode(lp, out_lens)
    np.testing.assert_array_equal(n.numpy(), np.asarray(ref_n))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))


@pytest.fixture(scope="module")
def gru_artifact(tmp_path_factory):
    path = tmp_path_factory.mktemp("export")
    _port_run(path / "run", GRU_ARGS)
    return str(path / "run"), export_inference(str(path / "run"), str(path / "art"),
                                               batch_size=4, t_max=64, device="cpu")


def test_export_enforces_envelope(gru_artifact):
    model = load_exported(gru_artifact[1])
    x, days, lens = model.pad_batch(*_trials(4))
    with pytest.raises(ValueError, match="envelope"):
        model(x[:2], days[:2], lens[:2])  # wrong batch
    with pytest.raises(ValueError, match="envelope"):
        model(x[:, :48], days, lens)  # wrong length
    with pytest.raises(ValueError, match="envelope"):
        model.pad_batch([np.zeros((65, 8), np.float32)])  # a trial past t_max
    with pytest.raises(ValueError, match="batch_size"):
        model.pad_batch([np.zeros((10, 8), np.float32)] * 5)
    # the program checks its inputs too
    with pytest.raises(Exception):
        model._program(model._weights, x[:, :48], days, lens)


def test_loader_kind_errors(tmp_path, gru_artifact):
    """A batch artifact is not a streaming one, and the other way round: both
    fail loudly at load time."""
    with pytest.raises(ValueError, match="streaming"):
        load_exported_streamer(gru_artifact[1])
    _port_run(tmp_path / "uni", {**GRU_ARGS, "bidirectional": False})
    art = export_streaming(str(tmp_path / "uni"), str(tmp_path / "sart"), device="cpu")
    with pytest.raises(FileNotFoundError):
        load_exported(art)  # no meta.json / model.pt2


def test_cuda_artifact_without_a_card_raises(tmp_path, gru_artifact):
    """No CPU fallback: a CUDA export or a CUDA artifact on a machine without
    a card raises."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_inference(gru_artifact[0], str(tmp_path / "art"), device="cuda")
    art = tmp_path / "cuda_art"
    shutil.copytree(gru_artifact[1], art)
    meta = json.loads((art / "meta.json").read_text())
    (art / "meta.json").write_text(json.dumps({**meta, "device": "cuda"}))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_exported(str(art))


_LOADER = """
import json, sys
import numpy as np
from neural_speech_decoder_tpu_torch.serving import load_exported
m = load_exported({art!r})
x, days, lens = m.pad_batch([np.ones((64, 8), np.float32), np.ones((40, 8), np.float32)],
                            days=[1, 0])
lp, out_lens = m(x, days, lens)
banned = [k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "neural_speech_decoder_tpu")
          or k.startswith(("neural_speech_decoder_tpu_torch.models",
                           "neural_speech_decoder_tpu_torch.training",
                           "neural_speech_decoder_tpu_torch.streaming"))]
print(json.dumps({{"banned": banned, "finite": bool(np.isfinite(lp.numpy()).all()),
                  "lens": out_lens.tolist()}}))
"""


def test_loaded_artifact_imports_no_model_code(gru_artifact):
    """A serving process loads and runs an artifact with no jax, no JAX
    package and none of the port's model, training or streaming modules."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", _LOADER.format(art=gru_artifact[1])],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res == {"banned": [], "finite": True, "lens": [14, 8, 0, 0]}


def _fresh_pad(trials, days, b, t, c):
    """The JAX package's ``pad_batch``: fresh zeros, each trial copied in."""
    x = np.zeros((b, t, c), np.float32)
    lens = np.zeros((b,), np.int32)
    day_arr = np.zeros((b,), np.int32)
    for i, tr in enumerate(trials):
        x[i, : len(tr)] = tr
        lens[i] = len(tr)
        day_arr[i] = days[i] if days is not None else 0
    return x, day_arr, lens


def test_pinned_padding_matches_fresh_padding():
    """One buffer reused across requests of growing and shrinking trials and
    row counts gives the fresh arrays' values bit for bit, and the returned
    tensors are the caller's (a later request does not change them)."""
    pad = Padder(5, 40, 3, "cpu")
    rng = np.random.default_rng(0)
    kept = []
    for n in (5, 2, 5, 0, 3, 1, 4):
        trials = [rng.standard_normal((int(rng.integers(0, 41)), 3)).astype(np.float32)
                  for _ in range(n)]
        days = [int(d) for d in rng.integers(0, 9, size=n)] if n % 2 else None
        got = pad(trials, days)
        want = _fresh_pad(trials, days, 5, 40, 3)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b)
        kept.append((got, want))
    for got, want in kept:
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b)
    with pytest.raises(ValueError):
        pad([np.zeros((4, 2), np.float32)])  # wrong channel count


def _op_inputs(name):
    """Small CPU inputs of each operator, from a seed."""
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g)

    seed = torch.tensor([7], dtype=torch.int32)
    if name == "fused_frontend":
        return (r(2, 30, 8), r(3, 8, 8), r(3, 8), torch.tensor([2, 5], dtype=torch.int32),
                20, 2.0)
    if name == "gru_sequence":
        return (r(9, 2, 3, 48), r(2, 16, 48), r(2, 48))
    if name == "projection_matmul":
        return (r(6, 16), r(16, 24), r(24))
    if name == "mhsa_qkv":
        return (r(2, 11, 48), torch.tensor([11, 6], dtype=torch.int32), seed, 2, 0.3, 4, True)
    if name == "ffn":
        return (r(2, 7, 16), r(16), r(16), r(16, 24), r(24), r(24, 16), r(16), seed, 0.3)
    return (r(2, 7, 16), r(16), r(16), r(16, 32), r(32), r(5, 16), r(16), r(16), r(16),
            r(16, 16), r(16), seed, 0.3, True)


_PLAIN = {
    "fused_frontend": lambda x, w, b, d, k, s: frontend.fused_frontend_plain(
        x, w, b, d, kernel_size=k, sigma=s),
    "gru_sequence": gru_scan.gru_sequence_plain,
    "projection_matmul": lambda x, w, b: matmul.tiled_matmul_plain(x, w, kind="nn", bias=b),
    "mhsa_qkv": lambda q, n, s, h, r, left, inter: attention.mhsa_qkv_plain(
        q, n, s, num_heads=h, rate=r, left_context=left, interleaved=inter),
    "ffn": lambda *a: ffn.ffn_plain(*a[:8], rate=a[8]),
    "conv_module": lambda *a: conv_module.conv_module_plain(*a[:12], rate=a[12],
                                                            causal=a[13]),
}


@pytest.mark.parametrize("name", sorted(library.OPS))
def test_operator_on_the_cpu_is_the_plain_twin(name):
    """Each operator of ``torch.ops.nsd_torch`` runs its plain twin on the
    CPU, bit for bit, and its registrations pass ``opcheck``'s schema and
    fake-tensor checks (the shape and dtype ``torch.export`` traces)."""
    args = _op_inputs(name)
    op = getattr(torch.ops.nsd_torch, name)
    assert torch.equal(op(*args), _PLAIN[name](*args))
    torch.library.opcheck(op.default, args, test_utils=("test_schema", "test_faketensor"))


@pytest.mark.parametrize("args, want", [
    (GRU_ARGS, {"fused_frontend": 1, "gru_sequence": 2}),
    (GRU_MM_ARGS, {"fused_frontend": 1, "gru_sequence": 2, "projection_matmul": 1}),
    (CONF_ARGS, {"mhsa_qkv": 2}),
    ({**CONF_ARGS, "fused_ffn": True, "fused_conv": True},
     {"mhsa_qkv": 2, "ffn": 4, "conv_module": 2}),
], ids=["gru", "gru-matmul", "conformer", "conformer-fused"])
def test_exported_program_holds_the_kernel_operators(tmp_path, args, want):
    """The exported graph calls each serving kernel's operator as often as a
    request launches it on the card, and no other of the namespace."""
    _port_run(tmp_path / "run", args)
    art = export_inference(str(tmp_path / "run"), str(tmp_path / "art"), batch_size=2,
                           t_max=48, device="cpu")
    graph = torch.export.load(os.path.join(art, "model.pt2")).graph
    got = {}
    for node in graph.nodes:
        if node.op == "call_function" and getattr(node.target, "namespace", "") == "nsd_torch":
            name = node.target._opname
            got[name] = got.get(name, 0) + 1
    assert got == want
