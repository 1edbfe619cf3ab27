"""The port's exported streaming and beam artifacts (``serving/export.py``,
driven by ``serving/streaming.py::ExportedStreamer``) against the port's
offline forward, the live streamers and the JAX package's exported
streamer, on the CPU, and ``nsd-export-torch`` in both modes.

Sizes are ``tests/test_serving_export.py``'s streaming models (GRU: C=12,
H=16, 2 unidirectional layers, k=8, s=4; causal Conformer: C=16, latent
24, 2 blocks, a 6-frame left context). The same weights (``init_*_params``
in JAX, converted with ``models/convert.py``) go to both packages.

Tolerances: against the live streamer and the offline forward over the
reference CTC length ``(T - k) // s``, 1e-5 (GRU logits,
``tests/test_torch_port_streaming.py``) and atol 2e-5 + rtol 1e-5
(Conformer log-probs, ``tests/test_torch_port_stream_conformer.py``);
against JAX's exported streamer the same; beam scores within 1e-5,
prefixes and lengths equal. The program is traced from the live bodies
(``_admit``, ``_smooth``, ``_emit``), yet it is not bit-equal to the live
streamer: its prime smooths its whole window at once, where the live
streamer smooths what has arrived, and the CPU's convolution sums windows
of other lengths in other orders (measured 8.9e-08 on the GRU's logits fed
a bin at a time). The bf16 round trip and the beam, given the same
outputs, are bit-equal.
"""

import dataclasses

import numpy as np
import pytest

import jax
import torch

from neural_speech_decoder_tpu.models.conformer import ConformerConfig as JaxConformerConfig
from neural_speech_decoder_tpu.models.conformer import (
    init_conformer_params as jax_init_conformer_params,
)
from neural_speech_decoder_tpu.models.gru import GRUConfig as JaxGRUConfig
from neural_speech_decoder_tpu.models.gru import init_gru_params as jax_init_gru_params
from neural_speech_decoder_tpu.serving import export_beam as jax_export_beam
from neural_speech_decoder_tpu.serving import (
    export_streaming_conformer_params as jax_export_streaming_conformer_params,
)
from neural_speech_decoder_tpu.serving import (
    export_streaming_params as jax_export_streaming_params,
)
from neural_speech_decoder_tpu.serving import load_exported_streamer as jax_load_streamer
from neural_speech_decoder_tpu_torch.models.api import build_model
from neural_speech_decoder_tpu_torch.models.conformer import ConformerConfig, conformer_forward
from neural_speech_decoder_tpu_torch.models.convert import params_from_jax
from neural_speech_decoder_tpu_torch.models.gru import GRUConfig, gru_forward
from neural_speech_decoder_tpu_torch.serving import (
    export_beam,
    export_streaming_conformer_params,
    export_streaming_params,
    load_exported,
    load_exported_streamer,
)
from neural_speech_decoder_tpu_torch.serving.cli import main as cli
from neural_speech_decoder_tpu_torch.streaming.conformer import ConformerStreamer
from neural_speech_decoder_tpu_torch.streaming.engine import GRUStreamer
from neural_speech_decoder_tpu_torch.training import checkpoints

GRU_TOL = 1e-5
CONF_ATOL, CONF_RTOL = 2e-5, 1e-5
SCORE_TOL = 1e-5
GRU_WIDTHS = dict(neural_dim=12, n_classes=8, hidden_dim=16, num_layers=2, n_days=3,
                  dropout=0.0, stride_len=4, kernel_len=8, gaussian_smooth_width=2.0,
                  bidirectional=False)
CONF_WIDTHS = dict(n_channels=16, n_days=2, frontend_dim=24, latent_dim=24,
                   autoencoder_hidden_dim=16, num_layers=2, num_heads=2, ff_dim=32,
                   dropout=0.0, temporal_kernel=8, temporal_stride=4,
                   gaussian_smooth_width=2.0, conv_kernel=5, use_spec_augment=False,
                   drop_path_prob=0.0, head_dropout=0.0, causal=True, attn_left_context=6)
BEAM = dict(beam_width=4, top_k_tokens=4, max_len=32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small CPU ops gain nothing from more, and
    the suite's parallel workers would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gru_params(seed=0):
    """JAX's GRU parameters (day calibration randomised, as a trained
    model's) and the port's copy."""
    params = jax_init_gru_params(jax.random.key(seed), JaxGRUConfig(**GRU_WIDTHS))
    params["day"]["weight"] = params["day"]["weight"] + 0.1 * jax.random.normal(
        jax.random.key(seed + 1), params["day"]["weight"].shape)
    params["day"]["bias"] = 0.1 * jax.random.normal(jax.random.key(seed + 2),
                                                    params["day"]["bias"].shape)
    return params, params_from_jax(jax.tree.map(np.asarray, params))


def _conf_params(seed=0):
    params = jax_init_conformer_params(jax.random.key(seed), cfg=JaxConformerConfig(**CONF_WIDTHS))
    return params, params_from_jax(jax.tree.map(np.asarray, params))


def _x(b, t, c, seed):
    return np.random.default_rng(seed).standard_normal((b, t, c)).astype(np.float32)


def _feed(st, x, n):
    """Stream ``x`` in chunks of ``n`` bins and flush: the outputs."""
    outs = [np.asarray(st.feed(x[:, i: i + n])) for i in range(0, x.shape[1], n)]
    return np.concatenate(outs + [np.asarray(st.flush())], axis=1)


def _live(st, x, n):
    outs = [st.process(x[:, i: i + n]) for i in range(0, x.shape[1], n)]
    return np.concatenate(outs + [st.flush()], axis=1)


@pytest.fixture(scope="module")
def gru(tmp_path_factory):
    """The GRU streaming artifact (day 1, 2 streams, 2 frames a chunk) with
    its beam programs, from both packages."""
    path = tmp_path_factory.mktemp("gru")
    params, port_params = _gru_params()
    cfg = GRUConfig(**GRU_WIDTHS)
    art = export_streaming_params(port_params, cfg, str(path / "port"), day_idx=1, batch=2,
                                  frames_per_chunk=2, device="cpu")
    export_beam(art, batch=2, n_classes=cfg.n_out, device="cpu", **BEAM)
    jart = jax_export_streaming_params(params, JaxGRUConfig(**GRU_WIDTHS), str(path / "jax"),
                                       day_idx=1, batch=2, frames_per_chunk=2)
    jax_export_beam(jart, batch=2, n_classes=cfg.n_out, top_k_tokens=4, beam_width=4,
                    max_len=32)
    # loaded once (a program takes seconds to load on the CPU); each test
    # starts with reset()
    return port_params, cfg, load_exported_streamer(art), jax_load_streamer(jart)


@pytest.mark.parametrize("n", [1, 5, 37])
def test_gru_matches_offline_and_live(gru, n):
    port_params, cfg, st, _ = gru
    st.reset()
    assert st.meta["kind"] == "gru_stream" and st.meta["device"] == "cpu"
    t = 53
    x = _x(2, t, 12, 1)
    got = _feed(st, x, n)
    live = _live(GRUStreamer(port_params, cfg, 1, batch=2, frames_per_chunk=2, device="cpu"),
                 x, n)
    with torch.no_grad():
        offline = gru_forward(port_params, cfg, torch.from_numpy(x),
                              torch.tensor([1, 1])).numpy()
    ref_len = (t - 8) // 4
    assert got.shape == live.shape == (2, ref_len, cfg.n_out)
    np.testing.assert_allclose(got, live, atol=GRU_TOL, rtol=0)
    np.testing.assert_allclose(got, offline[:, :ref_len], atol=GRU_TOL, rtol=0)


def test_gru_matches_jax_exported_streamer(gru):
    """Same weights and chunks: logits, greedy and beam decodes against JAX's
    ``ExportedStreamer`` with its beam blobs."""
    _, cfg, st, jst = gru
    st.reset()
    x = _x(2, 49, 12, 13)
    outs, jouts, ids, jids = [], [], [[], []], [[], []]
    for i in range(0, 49, 8):
        a, b = st.feed(x[:, i: i + 8]), jst.feed(x[:, i: i + 8])
        outs.append(a)
        jouts.append(np.asarray(b))
        for k, (p, q) in enumerate(zip(st.decode_greedy(a), jst.decode_greedy(b))):
            ids[k] += p
            jids[k] += q
        res, jres = st.decode_beam(a), jst.decode_beam(b)
    a, b = st.flush(), jst.flush()
    outs.append(a)
    jouts.append(np.asarray(b))
    res, jres = st.decode_beam(a), jst.decode_beam(b)
    np.testing.assert_allclose(np.concatenate(outs, 1), np.concatenate(jouts, 1), atol=GRU_TOL,
                               rtol=0)
    assert ids == jids
    np.testing.assert_array_equal(res[1], np.asarray(jres[1]))
    for bi in range(2):
        for w in range(4):
            np.testing.assert_array_equal(res[0][bi, w, : res[1][bi, w]],
                                          np.asarray(jres[0])[bi, w, : res[1][bi, w]])
    np.testing.assert_allclose(res[2], np.asarray(jres[2]), atol=SCORE_TOL, rtol=0)


def test_gru_beam_matches_live_beam_extend(gru):
    """The exported beam programs against the live streamer's
    ``decode_beam`` (``beam_extend``) given the same outputs, chunk by
    chunk: bit-equal."""
    port_params, cfg, st, _ = gru
    st.reset()
    assert st.beam_meta["beam_width"] == 4 and st.beam_meta["device"] == "cpu"
    live = GRUStreamer(port_params, cfg, 1, batch=2, frames_per_chunk=2, device="cpu")
    x = _x(2, 41, 12, 14)
    for i in range(0, 42, 6):
        out = st.feed(x[:, i: i + 6]) if i < 41 else st.flush()
        res, ref = st.decode_beam(out), live.decode_beam(out, **BEAM)
        for a, b in zip(res, ref):
            np.testing.assert_array_equal(a, b.numpy())
    st.reset()
    assert st._beam_state is None


def test_gru_short_utterance(gru):
    """An utterance shorter than the prime window still flushes to exactly
    the reference CTC length."""
    port_params, cfg, st, _ = gru
    st.reset()
    t = 17  # the prime needs k + 2s + pad_r = 8 + 8 + 10 bins
    x = _x(2, t, 12, 3)
    got = np.concatenate([st.feed(x), st.flush()], axis=1)
    assert got.shape[1] == (t - 8) // 4
    with torch.no_grad():
        offline = gru_forward(port_params, cfg, torch.from_numpy(x), torch.tensor([1, 1]))
    np.testing.assert_allclose(got, offline.numpy()[:, : got.shape[1]], atol=GRU_TOL, rtol=0)
    with pytest.raises(RuntimeError):
        st.flush()  # already flushed
    st.reset()
    assert st.feed(x[:, :3]).shape == (2, 0, cfg.n_out)


def test_feed_async_equals_feed(gru):
    """``feed_async`` returns the dispatches' outputs as tensors without a
    host copy; their concatenation is ``feed``'s."""
    _, _, st, _ = gru
    st.reset()
    x = _x(2, 48, 12, 5)
    via_feed = [st.feed(x[:, i: i + 6]) for i in range(0, 48, 6)] + [st.flush()]
    st.reset()
    via_async = []
    for i in range(0, 48, 6):
        chunks = st.feed_async(x[:, i: i + 6])
        assert all(isinstance(c, torch.Tensor) for c in chunks)
        via_async += [c.numpy() for c in chunks]
    np.testing.assert_array_equal(np.concatenate(via_feed, axis=1),
                                  np.concatenate(via_async + [st.flush()], axis=1))


def test_gru_bf16_roundtrip(tmp_path):
    """bfloat16 leaves (the streamer's weights cast to bf16; its biases and
    day affine stay float32) are stored as float32 with their dtype
    recorded, and load back in it: the exported bf16 stream equals the live
    one."""
    _, port_params = _gru_params(11)
    port_params = jax.tree.map(lambda t: t.to(torch.bfloat16), port_params)
    cfg = dataclasses.replace(GRUConfig(**GRU_WIDTHS), compute_dtype=torch.bfloat16)
    art = export_streaming_params(port_params, cfg, str(tmp_path / "sart"), day_idx=0,
                                  batch=1, frames_per_chunk=1, device="cpu")
    st = load_exported_streamer(art)
    live = GRUStreamer(port_params, cfg, 0, batch=1, frames_per_chunk=1, device="cpu")
    want = [t for lt in live.weight_tree()["layers"] for t in lt]
    assert set(st.meta["leaf_dtypes"]) == {"bfloat16", "float32"}
    assert all(any(w.dtype == t.dtype and torch.equal(w, t) for w in st._weights)
               for t in want)
    x = _x(1, 36, 12, 6)
    got = np.concatenate([st.feed(x), st.flush()], axis=1)
    want = np.concatenate([live.process(x), live.flush()], axis=1)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def conformer(tmp_path_factory):
    """The causal Conformer's streaming artifacts, one frame a chunk (no
    tail program) and four (a tail), loaded, and JAX's (four frames)."""
    path = tmp_path_factory.mktemp("conformer")
    params, port_params = _conf_params()
    cfg = ConformerConfig(**CONF_WIDTHS)
    streamers = {n_f: load_exported_streamer(export_streaming_conformer_params(
        port_params, cfg, str(path / f"port{n_f}"), day_idx=1, batch=2, frames_per_chunk=n_f,
        device="cpu")) for n_f in (1, 4)}
    jart = jax_export_streaming_conformer_params(params, JaxConformerConfig(**CONF_WIDTHS),
                                                 str(path / "jax"), day_idx=1, batch=2,
                                                 frames_per_chunk=4)
    return port_params, cfg, streamers, jax_load_streamer(jart)


@pytest.mark.parametrize("n_f, n", [(1, 3), (1, 29), (4, 8), (4, 5)])
def test_conformer_matches_offline_and_live(conformer, n_f, n):
    """Tail on (four frames a chunk, 70 bins: 15 frames = 3 chunks + a
    3-frame tail) and off."""
    port_params, cfg, streamers, _ = conformer
    st = streamers[n_f]
    st.reset()
    assert st.meta["kind"] == "conformer_stream" and st.meta["has_tail"] == (n_f > 1)
    assert st.meta["pe_unbounded"] is True
    t = 70
    x = _x(2, t, 16, 7)
    got = _feed(st, x, n)
    live = _live(ConformerStreamer(port_params, cfg, 1, batch=2, frames_per_chunk=n_f,
                                   device="cpu"), x, n)
    with torch.no_grad():
        offline, _, _ = conformer_forward(port_params, cfg, torch.from_numpy(x),
                                          torch.tensor([1, 1]))
    ref_len = (t - 8) // 4
    assert got.shape == live.shape == (2, ref_len, cfg.n_out)
    np.testing.assert_allclose(got, live, atol=CONF_ATOL, rtol=CONF_RTOL)
    np.testing.assert_allclose(got, offline.numpy()[:, :ref_len], atol=CONF_ATOL,
                               rtol=CONF_RTOL)


def test_conformer_matches_jax_exported_streamer(conformer):
    """Same weights and chunks, four frames a chunk with the tail: against
    JAX's ``ExportedStreamer``."""
    _, _, streamers, jst = conformer
    st = streamers[4]
    st.reset()
    x = _x(2, 75, 16, 8)
    got = _feed(st, x, 11)
    ref = np.concatenate([np.asarray(jst.feed(x[:, i: i + 11])) for i in range(0, 75, 11)]
                         + [np.asarray(jst.flush())], axis=1)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=CONF_ATOL, rtol=CONF_RTOL)


def test_conformer_greedy_matches_live(conformer):
    """Incremental greedy decodes of the exported and the live streams, a
    frame a chunk, equal."""
    port_params, cfg, streamers, _ = conformer
    st = streamers[1]
    st.reset()
    live = ConformerStreamer(port_params, cfg, 1, batch=2, frames_per_chunk=1, device="cpu")
    x = _x(2, 60, 16, 9)
    ids, live_ids = [[], []], [[], []]
    for i in range(0, 61, 4):
        a = st.feed(x[:, i: i + 4]) if i < 60 else st.flush()
        b = live.process(x[:, i: i + 4]) if i < 60 else live.flush()
        for k, (p, q) in enumerate(zip(st.decode_greedy(a), live.decode_greedy(b))):
            ids[k] += p
            live_ids[k] += q
    assert ids == live_ids and sum(map(len, ids)) > 0


def test_decode_beam_requires_the_beam_programs(conformer):
    _, cfg, streamers, _ = conformer
    st = streamers[4]
    st.reset()
    assert st.beam_meta is None
    with pytest.raises(RuntimeError, match="beam"):
        st.decode_beam(np.zeros((2, 1, cfg.n_out), np.float32))


@pytest.mark.parametrize("model_type", ["gru_baseline", "transformer_ctc"])
def test_cli_both_modes(tmp_path, model_type):
    """``nsd-export-torch`` on a port run directory: the batch artifact, and
    the streaming one with its beam programs."""
    args = {"nInputFeatures": 8, "nClasses": 40, "nDays": 2, "seed": 0, "batchSize": 4,
            "time_multiple": 16, "maxTimeSeriesLen": 40, "device": "cpu"}
    if model_type == "gru_baseline":
        args.update(nUnits=16, nLayers=2, dropout=0.0, strideLen=4, kernelLen=8,
                    gaussianSmoothWidth=2.0, bidirectional=False)
    else:
        args.update(model_type=model_type, frontend_dim=16, latent_dim=16,
                    autoencoder_hidden_dim=12, transformer_num_layers=2,
                    transformer_n_heads=2, transformer_dim_ff=24, temporal_kernel=8,
                    conformer_conv_kernel=5, causal=True, attn_left_context=4)
    model = build_model(args, 2, "cpu", 0)
    checkpoints.save_args(str(tmp_path / "run"), args)
    checkpoints.CheckpointManager(str(tmp_path / "run")).save("modelState",
                                                              {"params": model.params})
    cli([str(tmp_path / "run"), str(tmp_path / "a1"), "--batch-size", "2", "--t-max", "40",
         "--device", "cpu"])
    m = load_exported(str(tmp_path / "a1"))
    assert (m.meta["batch_size"], m.meta["t_max"], m.meta["model_type"]) == (2, 48, model_type)
    # the GRU with two frames a chunk and the beam programs; the Conformer
    # with the defaults (a frame a chunk, no beam)
    gru = model_type == "gru_baseline"
    flags = ["--frames-per-chunk", "2", "--beam", "--beam-width", "3"] if gru else []
    cli([str(tmp_path / "run"), str(tmp_path / "a2"), "--streaming", "--day-idx", "1",
         "--device", "cpu", *flags])
    st = load_exported_streamer(str(tmp_path / "a2"))
    want = ("gru_stream", 2, 1) if gru else ("conformer_stream", 1, 1)
    assert (st.meta["kind"], st.meta["frames_per_chunk"], st.meta["day_idx"]) == want
    x = _x(1, 30, 8, 10)
    out = np.concatenate([st.feed(x), st.flush()], axis=1)
    assert out.shape == (1, (30 - 8) // 4, 41) and np.isfinite(out).all()
    if gru:
        assert st.beam_meta["beam_width"] == 3
        assert st.decode_beam(out)[0].shape == (1, 3, 512)
    else:
        assert st.beam_meta is None
