"""The port's causal-Conformer streamer and on-device prefix beam search
against the JAX package's, on the CPU.

The same weights (``init_conformer_params`` in JAX, converted with
``models/convert.py``; the day affine made non-trivial, weight x1.1 and
bias +0.7, so the smoother's edge padding in the affined domain is
exercised) and the same numpy inputs go through
``neural_speech_decoder_tpu.streaming.conformer.ConformerStreamer`` and the
port's ``ConformerStreamer(device="cpu")``, fed the same chunk patterns, at
C=16, latent 24 (2 heads), 2 blocks, k=8, s=4, conv kernel 5, left context
6 (the config of ``tests/test_conformer_streaming.py``). Tolerance, float32
log-probs: atol 2e-5, rtol 1e-5 (that file's), against JAX's streamer and
against the port's offline causal forward over ``(T - k) // s`` frames.

The beam (``decoding/ondevice_beam.py``) is held to JAX's exactly in
prefixes and lengths, on every beam including the dead ones, and within
1e-5 in scores, at W = 1, 4 and 8, offline with ``input_lens`` masking and
chained in chunks.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neural_speech_decoder_tpu.decoding import ondevice_beam as jax_beam
from neural_speech_decoder_tpu.models.conformer import ConformerConfig as JaxConformerConfig
from neural_speech_decoder_tpu.models.conformer import (
    init_conformer_params as jax_init_conformer_params,
)
from neural_speech_decoder_tpu.streaming.conformer import (
    ConformerStreamer as JaxConformerStreamer,
)
from neural_speech_decoder_tpu_torch.decoding import ondevice_beam
from neural_speech_decoder_tpu_torch.models.conformer import (
    ConformerConfig,
    conformer_forward,
    sinusoidal_pos_rows,
)
from neural_speech_decoder_tpu_torch.models.convert import params_from_jax
from neural_speech_decoder_tpu_torch.streaming.conformer import ConformerStreamer

ATOL, RTOL = 2e-5, 1e-5
SCORE_TOL = 1e-5
WIDTHS = dict(n_channels=16, n_days=2, frontend_dim=24, latent_dim=24,
              autoencoder_hidden_dim=16, num_layers=2, num_heads=2, ff_dim=32, dropout=0.0,
              temporal_kernel=8, temporal_stride=4, gaussian_smooth_width=2.0, conv_kernel=5,
              use_spec_augment=False, drop_path_prob=0.0, head_dropout=0.0, causal=True,
              attn_left_context=6)
K, S = WIDTHS["temporal_kernel"], WIDTHS["temporal_stride"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small CPU ops gain nothing from more, and
    the suite's parallel workers would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    params = jax_init_conformer_params(jax.random.key(0), cfg=JaxConformerConfig(**WIDTHS))
    params["day"] = {"weight": params["day"]["weight"] * 1.1,
                     "bias": params["day"]["bias"] + 0.7}
    return params, params_from_jax(jax.tree.map(np.asarray, params))


def _x(b, t, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, t, WIDTHS["n_channels"])).astype(np.float32)


def _stream(streamer, x, pattern, async_=False):
    outs, pos, engaged = [], 0, False
    for n in pattern:
        chunk = x[:, pos: pos + n]
        out = streamer.process_async(chunk) if async_ else streamer.process(chunk)
        outs.append(np.asarray(out))
        engaged = engaged or bool(getattr(streamer, "fast_path_engaged", False))
        pos += n
    assert pos == x.shape[1]
    outs.append(np.asarray(streamer.flush()))
    return np.concatenate(outs, axis=1), engaged


def _both(model, x, pattern, fpc, **widths):
    params, port_params = model
    jcfg = JaxConformerConfig(**{**WIDTHS, **widths})
    pcfg = ConformerConfig(**{**WIDTHS, **widths})
    b = x.shape[0]
    ref, _ = _stream(JaxConformerStreamer(params, jcfg, 0, batch=b, frames_per_chunk=fpc),
                     x, pattern)
    port = ConformerStreamer(port_params, pcfg, 0, batch=b, frames_per_chunk=fpc, device="cpu")
    got, engaged = _stream(port, x, pattern)
    # no key-padding mask: a live stream has none (a length would mask the
    # last realized frame)
    with torch.no_grad():
        off, _, _ = conformer_forward(port_params, pcfg, torch.from_numpy(x),
                                      torch.zeros(b, dtype=torch.int32))
    return ref, got, off.numpy()[:, : (x.shape[1] - K) // S], engaged, port


def _chunks(t, n):
    return [n] * (t // n) + ([t % n] if t % n else [])


@pytest.mark.parametrize("fpc,feed", [(1, 4), (2, 8), (4, 16), (2, 3), (2, 7), (2, 32)])
def test_streamer_matches_jax_and_offline(model, fpc, feed):
    x = _x(2, 96, seed=1)
    ref, got, off, engaged, port = _both(model, x, _chunks(96, feed), fpc)
    n = (96 - K) // S
    assert got.shape == ref.shape == off.shape == (2, n, 41) and port.emitted == n
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, off, atol=ATOL, rtol=RTOL)
    if feed == S * fpc:  # steady chunks: the fast path engages
        assert engaged


@pytest.mark.parametrize("seed", [0, 1])
def test_random_chunk_pattern_fuzz(model, seed):
    rng = np.random.default_rng(200 + seed)
    t = int(rng.integers(64, 128))
    x = rng.standard_normal((2, t, WIDTHS["n_channels"])).astype(np.float32)
    fpc = int(rng.integers(1, 4))
    pattern, left = [], t
    while left:
        pattern.append(min(left, int(rng.integers(1, 14))))
        left -= pattern[-1]
    ref, got, off, _, _ = _both(model, x, pattern, fpc)
    assert got.shape == ref.shape == off.shape
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, off, atol=ATOL, rtol=RTOL)


def test_zero_left_context_keeps_an_empty_cache(model):
    """``attn_left_context=0``: the K/V caches stay 0 frames wide (a
    negative-index roll would keep the whole buffer) and the stream still
    matches."""
    x = _x(2, 96, seed=3)
    ref, got, off, engaged, port = _both(model, x, _chunks(96, 8), 2, attn_left_context=0)
    assert engaged and port._caches[0].shape[3] == 0
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, off, atol=ATOL, rtol=RTOL)


def test_fast_path_survives_reset(model):
    """The steady step's buffers survive ``reset()`` (servers reset between
    utterances) and re-engage on the next utterance, which matches JAX
    again; the device offset and its host mirror agree."""
    params, port_params = model
    x = _x(2, 96, seed=4)
    pattern = _chunks(96, 8)
    ref, _ = _stream(JaxConformerStreamer(params, JaxConformerConfig(**WIDTHS), 0, batch=2,
                                          frames_per_chunk=2), x, pattern)
    st = ConformerStreamer(port_params, ConformerConfig(**WIDTHS), 0, batch=2,
                           frames_per_chunk=2, device="cpu")
    first, engaged = _stream(st, x, pattern, async_=True)
    steps = dict(st._fast._steps)
    st.reset()
    assert st.emitted == 0 and int(st._offset) == 0 and st._fast._steps == steps
    again, engaged2 = _stream(st, x, pattern, async_=True)
    assert engaged and engaged2 and int(st._offset) == st.emitted == ref.shape[1]
    np.testing.assert_array_equal(first, again)
    np.testing.assert_allclose(again, ref, atol=ATOL, rtol=RTOL)


def test_greedy_and_beam_decode_match_offline(model):
    """Chunked ``decode_greedy`` equals the offline greedy pass; chunked
    ``decode_beam`` equals ``prefix_beam_search`` over the streamed
    log-probs, the port's and JAX's."""
    _, port_params = model
    x = _x(2, 96, seed=5)
    st = ConformerStreamer(port_params, ConformerConfig(**WIDTHS), 0, batch=2,
                           frames_per_chunk=2, device="cpu")
    outs, toks = [], [[], []]
    for i in range(0, 96, 8):
        outs.append(st.process_async(x[:, i: i + 8]))
        for b, seq in enumerate(st.decode_greedy(outs[-1])):
            toks[b] += seq
        nbest = st.decode_beam(outs[-1], beam_width=4, max_len=64)
    outs.append(torch.from_numpy(st.flush()))
    for b, seq in enumerate(st.decode_greedy(outs[-1])):
        toks[b] += seq
    nbest = st.decode_beam(outs[-1], beam_width=4, max_len=64)
    logp = torch.cat(outs, dim=1)
    t = logp.shape[1]
    ids = logp.argmax(-1).numpy()
    want = [[int(c) for j, c in enumerate(row) if c != 0 and (j == 0 or c != row[j - 1])]
            for row in ids]
    assert toks == want
    lens = torch.full((2,), t, dtype=torch.int32)
    ref = ondevice_beam.prefix_beam_search(logp, lens, beam_width=4)
    jref = jax_beam.prefix_beam_search(jnp.asarray(logp.numpy()), jnp.asarray(lens.numpy()),
                                       beam_width=4)
    for r in (ref, [torch.from_numpy(np.array(a)) for a in jref]):
        np.testing.assert_array_equal(nbest[0][:, :, :t].numpy(), r[0].numpy())
        np.testing.assert_array_equal(nbest[1].numpy(), r[1].numpy())
        np.testing.assert_allclose(nbest[2].numpy(), r[2].numpy(), atol=SCORE_TOL, rtol=0)
    assert not nbest[0][:, :, t:].any()
    with pytest.raises(ValueError, match="changed mid-stream"):
        st.decode_beam(outs[-1], beam_width=8, max_len=64)
    st.reset()
    st.decode_beam(outs[-1], beam_width=8, max_len=64)  # a new search after reset


def _log_probs(b, t, k, seed):
    logits = np.random.default_rng(seed).standard_normal((b, t, k)).astype(np.float32) * 3
    return np.array(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))


@pytest.mark.parametrize("width", [1, 4, 8])
def test_prefix_beam_search_matches_jax(width):
    """Every beam, dead ones included; a row of full length, a shorter one
    and an empty one (``input_lens`` masking)."""
    lp = _log_probs(3, 30, 9, seed=width)
    lens = np.array([30, 17, 0], np.int32)
    ref = jax_beam.prefix_beam_search(jnp.asarray(lp), jnp.asarray(lens), beam_width=width,
                                      top_k_tokens=6)
    got = ondevice_beam.prefix_beam_search(torch.from_numpy(lp), torch.from_numpy(lens),
                                           beam_width=width, top_k_tokens=6)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), atol=SCORE_TOL, rtol=0)
    assert got[0].dtype == got[1].dtype == torch.int32


@pytest.mark.parametrize("width", [1, 4, 8])
def test_chained_beam_extend_matches_jax(width):
    """``beam_extend`` chained over chunks of 7 frames: the carried state
    leaf by leaf (prefixes, lens, last exactly), then ``beam_finalize``,
    and a prefix cap shorter than the decode (lens clamp at max_len)."""
    lp = _log_probs(2, 40, 9, seed=10 + width)
    for max_len in (48, 5):
        st = jax_beam.beam_init(2, width, max_len)
        ours = ondevice_beam.beam_init(2, width, max_len, device="cpu")
        for i in range(0, 40, 7):
            st = jax_beam.beam_extend(st, jnp.asarray(lp[:, i: i + 7]), top_k_tokens=8)
            ours = ondevice_beam.beam_extend(ours, torch.from_numpy(lp[:, i: i + 7]),
                                             top_k_tokens=8)
        for name, a, b in zip(ondevice_beam.BeamState._fields, ours, st):
            if name in ("prefixes", "lens", "last"):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
            else:
                np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=SCORE_TOL, rtol=0,
                                           err_msg=name)
        fin, jfin = ondevice_beam.beam_finalize(ours), jax_beam.beam_finalize(st)
        np.testing.assert_array_equal(fin[0].numpy(), np.asarray(jfin[0]))
        np.testing.assert_array_equal(fin[1].numpy(), np.asarray(jfin[1]))
        np.testing.assert_allclose(fin[2].numpy(), np.asarray(jfin[2]), atol=SCORE_TOL, rtol=0)


@pytest.mark.parametrize("change", [
    {"causal": False},
    {"gaussian_smooth_width": 0.25},  # int(4 * 0.25) + 1 = 2 taps
    {"qkv_interleaved": True},
])
def test_refusals(model, change):
    with pytest.raises(ValueError):
        ConformerStreamer(model[1], dataclasses.replace(ConformerConfig(**WIDTHS), **change),
                          0, device="cpu")


def test_pos_rows_from_a_tensor_offset_keep_their_bits():
    """``sinusoidal_pos_rows`` with a 0-dim tensor offset (what the steady
    step reads inside a CUDA graph) gives the int offset's bits."""
    for off in (0, 17, 4093):
        want = sinusoidal_pos_rows(off, 6, 24)
        got = sinusoidal_pos_rows(torch.tensor(off), 6, 24)
        assert torch.equal(got, want)
