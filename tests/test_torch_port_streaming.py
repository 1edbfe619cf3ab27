"""The port's GRU streamer and incremental greedy decode against the JAX
package's, on the CPU.

The same weights (``init_gru_params`` in JAX with randomised day weights
and biases, converted with ``models/convert.py``) and the same numpy inputs
go through ``neural_speech_decoder_tpu.streaming.engine.GRUStreamer`` and
the port's ``GRUStreamer(device="cpu")``, fed the same chunk patterns (the
patterns of ``tests/test_streaming.py``: fixed sizes, odd chunks that demote
the fast path, a seeded random-pattern fuzz, ``causal=True``, sigma 0), at
C=12, H=16, 2 layers, k=8, s=4.

Tolerances: float32 logits within 1e-5 of JAX's streamer (the same sums in
other orders), and within 1e-5 of the port's offline forward over the
reference CTC length ``(T - k) // s``. In bfloat16 the streamer is held to
JAX's bf16 streamer (the offline forward rounds layer 0 twice and keeps a
float32 carry), within 2x the distance between JAX's bf16 and float32
streamers on the same input.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neural_speech_decoder_tpu.models.gru import GRUConfig as JaxGRUConfig
from neural_speech_decoder_tpu.models.gru import init_gru_params as jax_init_gru_params
from neural_speech_decoder_tpu.streaming.engine import GRUStreamer as JaxGRUStreamer
from neural_speech_decoder_tpu.utils.greedy import incremental_greedy as jax_incremental_greedy
from neural_speech_decoder_tpu_torch.models.convert import params_from_jax
from neural_speech_decoder_tpu_torch.models.gru import GRUConfig, gru_forward
from neural_speech_decoder_tpu_torch.ops.decode import greedy_decode
from neural_speech_decoder_tpu_torch.streaming.engine import GRUStreamer
from neural_speech_decoder_tpu_torch.utils.greedy import incremental_greedy

TOL = 1e-5
WIDTHS = dict(neural_dim=12, n_classes=8, hidden_dim=16, num_layers=2, n_days=3,
              dropout=0.0, stride_len=4, kernel_len=8, gaussian_smooth_width=2.0,
              bidirectional=False)
K, S = WIDTHS["kernel_len"], WIDTHS["stride_len"]


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
    """JAX's parameters (day calibration randomised, as a trained model's)
    and the port's copy of them."""
    params = jax_init_gru_params(jax.random.key(0), JaxGRUConfig(**WIDTHS))
    params["day"]["weight"] = params["day"]["weight"] + 0.1 * jax.random.normal(
        jax.random.key(1), params["day"]["weight"].shape)
    params["day"]["bias"] = 0.1 * jax.random.normal(jax.random.key(2),
                                                    params["day"]["bias"].shape)
    return params, params_from_jax(jax.tree.map(np.asarray, params))


def _configs(**kw):
    return JaxGRUConfig(**{**WIDTHS, **kw}), GRUConfig(**{**WIDTHS, **kw})


def _stream(streamer, x, pattern):
    """Feed ``x`` in chunks of the sizes in ``pattern`` (the rest in the
    last), flush, and return the concatenated outputs and whether the fast
    path was ever engaged."""
    outs, pos, engaged = [], 0, False
    for n in pattern:
        outs.append(np.asarray(streamer.process(x[:, pos: pos + n])))
        engaged = engaged or bool(getattr(streamer, "fast_path_engaged", False))
        pos += n
    assert pos == x.shape[1]
    outs.append(np.asarray(streamer.flush()))
    return np.concatenate(outs, axis=1), engaged


def _both(model, x, pattern, day=1, fpc=1, jcfg=None, pcfg=None, **kw):
    params, port_params = model
    if jcfg is None:
        jcfg, pcfg = _configs()
    b = x.shape[0]
    ref, _ = _stream(JaxGRUStreamer(params, jcfg, day, batch=b, frames_per_chunk=fpc, **kw),
                     x, pattern)
    got, engaged = _stream(GRUStreamer(port_params, pcfg, day, batch=b, frames_per_chunk=fpc,
                                       device="cpu", **kw), x, pattern)
    return ref, got, engaged


def _offline(model, pcfg, x, day):
    _, port_params = model
    with torch.no_grad():
        logits = gru_forward(port_params, pcfg, torch.from_numpy(x),
                             torch.full((x.shape[0],), day, dtype=torch.int32))
    return logits.numpy()[:, : (x.shape[1] - K) // S]


def _x(b, t, seed):
    return np.random.default_rng(seed).standard_normal((b, t, WIDTHS["neural_dim"])).astype(
        np.float32)


def _chunks(t, n):
    return [n] * (t // n) + ([t % n] if t % n else [])


@pytest.mark.parametrize("case", [
    # fixed chunk sizes, two frames a steady chunk (tests/test_streaming.py)
    dict(t=40, pattern=_chunks(40, 1), fpc=2),
    dict(t=40, pattern=_chunks(40, 4), fpc=2),
    dict(t=40, pattern=_chunks(40, 7), fpc=2),
    dict(t=40, pattern=[40], fpc=2),
    # exactly s bins a chunk: the fast path engages
    dict(t=96, pattern=_chunks(96, 4), fpc=1, fast=True),
    # odd chunks demote the fast path mid-stream and it promotes again
    dict(t=80, pattern=[4, 4, 4, 4, 4, 7, 4, 4, 4, 4, 5, 4, 4, 4, 4, 4, 4, 4, 4], fpc=1,
         fast=True, day=2),
])
def test_streamer_matches_jax_and_offline(model, case):
    x = _x(1, case["t"], seed=case["t"])
    day = case.get("day", 1)
    ref, got, engaged = _both(model, x, case["pattern"], day=day, fpc=case["fpc"])
    n = (case["t"] - K) // S
    assert got.shape == ref.shape == (1, n, WIDTHS["n_classes"] + 1)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)
    np.testing.assert_allclose(got, _offline(model, _configs()[1], x, day), atol=TOL, rtol=0)
    assert engaged == case.get("fast", engaged)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_chunk_pattern_fuzz(model, seed):
    """Any chunk sizes (1..17 bins, through promotions and demotions), two
    streams, 1-3 frames a steady chunk."""
    rng = np.random.default_rng(100 + seed)
    t = int(rng.integers(60, 140))
    x = rng.standard_normal((2, t, WIDTHS["neural_dim"])).astype(np.float32)
    fpc = int(rng.integers(1, 4))
    pattern, left = [], t
    while left:
        pattern.append(min(left, int(rng.integers(1, 18))))
        left -= pattern[-1]
    ref, got, _ = _both(model, x, pattern, fpc=fpc)
    assert got.shape[1] == (t - K) // S
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)
    np.testing.assert_allclose(got, _offline(model, _configs()[1], x, 1), atol=TOL, rtol=0)


@pytest.mark.parametrize("variant", ["causal", "sigma0"])
def test_causal_and_unsmoothed_match_jax(model, variant):
    """``causal=True`` (renormalised past taps, no lookahead: no offline
    parity, held to JAX's streamer) and sigma 0 (one tap, no lookahead:
    also the offline forward)."""
    x = _x(1, 64, seed=7)
    if variant == "causal":
        ref, got, engaged = _both(model, x, _chunks(64, 4), causal=True)
    else:
        jcfg, pcfg = _configs(gaussian_smooth_width=0.0)
        ref, got, engaged = _both(model, x, _chunks(64, 4), jcfg=jcfg, pcfg=pcfg)
        np.testing.assert_allclose(got, _offline(model, pcfg, x, 1), atol=TOL, rtol=0)
    assert engaged and got.shape == ref.shape == (1, (64 - K) // S, 9)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


def test_bfloat16_within_twice_jax_bf16_distance(model):
    """In bf16 the port's streamer is held to JAX's bf16 streamer, within 2x
    the distance between JAX's bf16 and float32 streamers."""
    params, port_params = model
    x = _x(2, 96, seed=11)
    pattern = _chunks(96, 4)
    ref16, got16, engaged = _both(model, x, pattern,
                                  jcfg=JaxGRUConfig(**WIDTHS, compute_dtype=jnp.bfloat16),
                                  pcfg=GRUConfig(**WIDTHS, compute_dtype=torch.bfloat16))
    ref32, _ = _stream(JaxGRUStreamer(params, _configs()[0], 1, batch=2), x, pattern)
    dist = np.abs(ref16 - ref32).max()
    err = np.abs(got16 - ref16).max()
    assert engaged and got16.dtype == np.float32 and 0 < dist
    assert err <= 2 * dist, (err, dist)


def test_emits_incrementally_and_flush_length(model):
    """40 bins in 4-bin chunks: 5 frames before the flush (10 bins of
    lookahead, the one-frame holdback), (40 - 8) // 4 in all."""
    _, port_params = model
    s = GRUStreamer(port_params, _configs()[1], 0, device="cpu")
    x = _x(1, 40, seed=1)
    emitted = sum(s.process(x[:, i: i + 4]).shape[1] for i in range(0, 40, 4))
    assert emitted == s.emitted == 5
    assert emitted + s.flush().shape[1] == (40 - K) // S == s.emitted


def test_incremental_greedy_is_jax_copy():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((3, 25, 6)).astype(np.float32)
    logits[:, ::3, 0] += 3.0  # blanks between runs
    prev_a, prev_b = np.full((3,), -1, np.int64), np.full((3,), -1, np.int64)
    for lo, hi in ((0, 0), (0, 7), (7, 8), (8, 25)):
        assert (incremental_greedy(logits[:, lo:hi], prev_a)
                == jax_incremental_greedy(logits[:, lo:hi], prev_b))
        np.testing.assert_array_equal(prev_a, prev_b)


def test_decode_greedy_matches_offline_and_reset(model):
    """Chunked ``decode_greedy`` equals the offline greedy decode over the
    reference CTC length, and ``reset()`` reproduces the stream and its
    decode (the collapse state does not leak across utterances)."""
    _, port_params = model
    pcfg = _configs()[1]
    x = _x(1, 100, seed=5)
    s = GRUStreamer(port_params, pcfg, 0, device="cpu")

    def run():
        toks, outs = [], []
        for i in range(0, 100, 4):
            outs.append(s.process(x[:, i: i + 4]))
            toks += s.decode_greedy(outs[-1])[0]
        outs.append(s.flush())
        toks += s.decode_greedy(outs[-1])[0]
        return toks, np.concatenate(outs, axis=1)

    first, out1 = run()
    steps = s._fast._steps
    s.reset()
    second, out2 = run()
    assert first == second and s._fast._steps is steps and len(steps) == 1
    np.testing.assert_array_equal(out1, out2)
    n = (100 - K) // S
    tok, lens = greedy_decode(torch.from_numpy(_offline(model, pcfg, x, 0)),
                              torch.tensor([n]))
    assert first == tok[0, : lens[0]].tolist()
    s.reset()
    np.testing.assert_array_equal(s._decode_prev, [-1])


def test_refusals(model):
    _, port_params = model
    with pytest.raises(ValueError, match="unidirectional"):
        GRUStreamer(port_params, GRUConfig(**{**WIDTHS, "bidirectional": True}), 0,
                    device="cpu")
    s = GRUStreamer(port_params, _configs()[1], 0, device="cpu")
    with pytest.raises(ValueError, match="expected"):
        s.process(np.zeros((2, 4, WIDTHS["neural_dim"]), np.float32))
    s.flush()
    with pytest.raises(RuntimeError, match="flushed"):
        s.process(np.zeros((1, 4, WIDTHS["neural_dim"]), np.float32))


def test_cuda_without_a_card_raises(model):
    """The entry points default to the card; without one they raise, and
    never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, port_params = model
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GRUStreamer(port_params, _configs()[1], 0)
