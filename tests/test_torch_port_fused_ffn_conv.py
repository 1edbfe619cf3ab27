"""The port's fused FF and conv-module operations against the JAX package's
Pallas kernels (``ops/pallas/ffn_kernel.py``, ``conv_module_kernel.py``) run
in interpret mode, on the CPU, where the port's wrappers run their plain
versions.

The same numpy inputs (from a seed) go through ``jax.vjp`` of
``fused_ffn`` / ``fused_conv_module`` and through the port's ``fused_ffn``
/ ``fused_conv_module`` under autograd; the dropout seed is JAX's own draw
(``jax.random.randint(key, (1,), 0, int32 max)``), handed to the port. Small
shapes (B=2, T'=24, D=128, F=256; k=31 and k=7, 'same' and causal) keep
interpret mode quick.

Tolerances, relative to the reference's largest entry: float32 outputs
1e-5 and gradients 1e-4 (sums over D, F and B*T' in other orders); bfloat16
2 bf16 ulps of the largest entry (a rounding that falls the other way after
a float32 sigmoid or rsqrt one ulp apart moves a stored value by one bf16
step, and a second such step downstream). The masks are bit-equal. Each
rounding trap of the TPU kernels (the bf16 inverse keep rate at FF site 0,
the conv's float32 taps, the taps' gradient from the unrounded GLU, dW
rounded to bf16) has a test that fails for the plain reading.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neural_speech_decoder_tpu.models import conformer as jax_conformer
from neural_speech_decoder_tpu.ops.pallas import conv_module_kernel as jax_conv
from neural_speech_decoder_tpu.ops.pallas import ffn_kernel as jax_ffn
from neural_speech_decoder_tpu.training.trainer import (
    _loss_and_metrics as jax_loss_and_metrics,
)
from neural_speech_decoder_tpu.training.trainer import build_model as jax_build_model
from neural_speech_decoder_tpu_torch.models.api import build_model, config_from_args, forward
from neural_speech_decoder_tpu_torch.models.conformer import ConformerDecoder
from neural_speech_decoder_tpu_torch.models.convert import conformer_params_from_jax
from neural_speech_decoder_tpu_torch.ops.kernels import conv_module as port_conv
from neural_speech_decoder_tpu_torch.ops.kernels import ffn as port_ffn
from neural_speech_decoder_tpu_torch.training.trainer import _loss_and_metrics, step_generator


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's parallel workers would otherwise
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, T, D, F = 2, 24, 128, 256
DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _close(got, ref, dtype, tol=1e-4, what=""):
    """float32: within ``tol`` of the reference's largest entry; bfloat16:
    within 2 bf16 ulps of it."""
    got = np.asarray(torch.as_tensor(got).float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, what
    top = float(np.abs(ref).max())
    atol = tol * top if dtype == "float32" else 2 * 2.0 ** (np.floor(np.log2(top)) - 7)
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol, err_msg=what)


def _seed(key_int):
    """JAX's seed draw and the same int32 as a port tensor."""
    seed = jax.random.randint(jax.random.key(key_int), (1,), 0,
                              jnp.iinfo(jnp.int32).max, dtype=jnp.int32)
    return seed, torch.from_numpy(np.array(seed))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


# ------------------------------------------------------------------- FFN


def _ffn_inputs(seed=0, d=D, f=F):
    rng = np.random.default_rng(seed)
    r = lambda *s, sc=1.0: (sc * rng.standard_normal(s)).astype(np.float32)
    return r(B, T, d), [1.0 + r(d, sc=0.1), r(d, sc=0.1), r(d, f, sc=d**-0.5),
                        r(f, sc=0.1), r(f, d, sc=f**-0.5), r(d, sc=0.1)], r(B, T, d)


def _jax_ffn(x, params, g, dtype, rate, key_int=7):
    jdt = DT[dtype][0]
    key = jax.random.key(key_int)

    def fn(x, *p):
        return jax_ffn.fused_ffn(x, *p, key, dropout_rate=rate, train=rate > 0,
                                 interpret=True)

    out, vjp = jax.vjp(fn, jnp.asarray(x, jdt), *map(jnp.asarray, params))
    return out, vjp(jnp.asarray(g, jdt))


def _port_ffn(x, params, g, dtype, rate, key_int=7):
    tdt = DT[dtype][1]
    leaves = [_t(x, tdt).requires_grad_()] + [_t(p).requires_grad_() for p in params]
    seed = _seed(key_int)[1] if rate > 0 else torch.zeros(1, dtype=torch.int32)
    out = port_ffn.fused_ffn(*leaves, seed, rate=rate)
    grads = torch.autograd.grad(out, leaves, _t(g, tdt))
    return out.detach(), grads


@pytest.mark.parametrize("dtype,rate", [("float32", 0.0), ("float32", 0.3),
                                        ("bfloat16", 0.0), ("bfloat16", 0.3)])
def test_ffn_matches_jax_kernel(dtype, rate):
    x, params, g = _ffn_inputs()
    ref, ref_grads = _jax_ffn(x, params, g, dtype, rate)
    out, grads = _port_ffn(x, params, g, dtype, rate)
    assert out.dtype == DT[dtype][1]
    _close(out, ref.astype(jnp.float32), dtype, 1e-5, "out")
    names = ("dx", "dscale", "dbias", "dw1", "db1", "dw2", "db2")
    for name, a, r in zip(names, grads, ref_grads):
        _close(a, r.astype(jnp.float32), dtype, 1e-4, name)


def test_ffn_dropout_masks_match_jax_kernel():
    jseed, seed = _seed(11)
    m1, m2 = jax_ffn.dropout_masks(3, 19, 64, 96, jseed, 0.3, interpret=True)
    p1, p2 = port_ffn.ffn_dropout_masks(3, 19, 64, 96, seed, 0.3)
    assert p1.dtype == torch.bool and p1.shape == (3, 19, 96) and p2.shape == (3, 19, 64)
    np.testing.assert_array_equal(p1.numpy(), np.asarray(m1))
    np.testing.assert_array_equal(p2.numpy(), np.asarray(m2))
    assert 0.6 < p1.float().mean() < 0.8


def test_bf16_site0_scale_is_the_bf16_rounded_inverse(monkeypatch):
    """FF site 0 multiplies bf16 h by 1/(1-rate) rounded to bf16
    (1.4296875 at rate 0.3), as JAX's weak-typed scalar does. Inputs that
    make every value exact: W1 = 0 and b1 in [20, 40] (so s = b1 and
    SiLU(s) = s), W2 = I, b2 = 0: the output is h * inv0 * inv1 masked, bit
    for bit; with the float32 inverse at site 0, some columns differ."""
    rng = np.random.default_rng(3)
    d = f = 128
    x = rng.standard_normal((B, T, d)).astype(np.float32)
    b1 = np.asarray(jnp.asarray(rng.uniform(20, 40, f), jnp.bfloat16).astype(jnp.float32))
    params = [np.ones(d, np.float32), np.zeros(d, np.float32), np.zeros((d, f), np.float32),
              b1, np.eye(f, d, dtype=np.float32), np.zeros(d, np.float32)]
    assert port_ffn.inv_keep(0.3, torch.bfloat16) == 1.4296875
    ref, _ = _jax_ffn(x, params, x, "bfloat16", 0.3)
    out, _ = _port_ffn(x, params, x, "bfloat16", 0.3)
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref.astype(jnp.float32)))
    real = port_ffn.inv_keep
    monkeypatch.setattr(port_ffn, "inv_keep", lambda rate, dtype=None: real(rate))
    plain_reading, _ = _port_ffn(x, params, x, "bfloat16", 0.3)
    assert not torch.equal(plain_reading, out)


def test_bf16_dw_is_rounded_to_bf16():
    """dW1 and dW2 come back in the cast weights' dtype: in bf16 every entry
    of the float32 parameters' gradients is a bf16 value, as JAX's, and the
    two agree within one bf16 ulp of each entry."""
    x, params, g = _ffn_inputs(seed=5)
    _, ref_grads = _jax_ffn(x, params, g, "bfloat16", 0.3)
    _, grads = _port_ffn(x, params, g, "bfloat16", 0.3)
    for i in (3, 5):  # dw1, dw2
        got, ref = grads[i], np.asarray(ref_grads[i], np.float32)
        assert got.dtype == torch.float32
        assert torch.equal(got, got.bfloat16().float())
        assert np.array_equal(ref, np.asarray(jnp.asarray(ref, jnp.bfloat16), np.float32))
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
        assert np.all(np.abs(got.numpy() - ref) <= ulp)


# ------------------------------------------------------------ conv module


def _conv_inputs(kw, seed=0):
    rng = np.random.default_rng(seed)
    r = lambda *s, sc=1.0: (sc * rng.standard_normal(s)).astype(np.float32)
    params = [1.0 + r(D, sc=0.1), r(D, sc=0.1), r(D, 2 * D, sc=D**-0.5), r(2 * D, sc=0.1),
              r(kw, D, sc=kw**-0.5), r(D, sc=0.1), 1.0 + r(D, sc=0.1), r(D, sc=0.1),
              r(D, D, sc=D**-0.5), r(D, sc=0.1)]
    return r(B, T, D), params, r(B, T, D)


def _jax_conv(x, params, g, dtype, rate, causal, key_int=9):
    jdt = DT[dtype][0]
    key = jax.random.key(key_int)

    def fn(x, *p):
        return jax_conv.fused_conv_module(x, *p, key, dropout_rate=rate, train=rate > 0,
                                          causal=causal, interpret=True)

    out, vjp = jax.vjp(fn, jnp.asarray(x, jdt), *map(jnp.asarray, params))
    return out, vjp(jnp.asarray(g, jdt))


def _port_conv(x, params, g, dtype, rate, causal, key_int=9):
    tdt = DT[dtype][1]
    leaves = [_t(x, tdt).requires_grad_()] + [_t(p).requires_grad_() for p in params]
    seed = _seed(key_int)[1] if rate > 0 else torch.zeros(1, dtype=torch.int32)
    out = port_conv.fused_conv_module(*leaves, seed, rate=rate, causal=causal)
    grads = torch.autograd.grad(out, leaves, _t(g, tdt))
    return out.detach(), grads


CONV_NAMES = ("dx", "dln_s", "dln_b", "dw1", "db1", "ddw_w", "ddw_b", "dln2_s", "dln2_b",
              "dw2", "db2")


@pytest.mark.parametrize("dtype,kw,causal,rate", [
    ("float32", 31, False, 0.0),
    ("float32", 7, True, 0.3),
    ("bfloat16", 31, True, 0.3),
    ("bfloat16", 7, False, 0.0),
])
def test_conv_module_matches_jax_kernel(dtype, kw, causal, rate):
    x, params, g = _conv_inputs(kw)
    ref, ref_grads = _jax_conv(x, params, g, dtype, rate, causal)
    out, grads = _port_conv(x, params, g, dtype, rate, causal)
    assert out.dtype == DT[dtype][1]
    _close(out, ref.astype(jnp.float32), dtype, 1e-5, "out")
    for name, a, r in zip(CONV_NAMES, grads, ref_grads):
        _close(a, r.astype(jnp.float32), dtype, 1e-4, name)


def test_conv_taps_stay_float32():
    """The fused conv module convolves with float32 taps (the unfused module
    casts them to the compute dtype). Inputs that expose it: W1 = 0 and b1
    with a = 1 and g = 30 (so GLU = 1 exactly) and taps 1 + j * 2**-10,
    which bf16 rounds to 1: the conv output of some channels rounds to the
    next bf16 value only with the float32 taps, and the second layer norm
    spreads that over the whole row."""
    rng = np.random.default_rng(4)
    kw = 7
    x, params, g = _conv_inputs(kw, seed=4)
    params[2] = np.zeros((D, 2 * D), np.float32)
    params[3] = np.concatenate([np.ones(D, np.float32), np.full(D, 30.0, np.float32)])
    j = rng.integers(0, 4, D).astype(np.float32)
    params[4] = np.broadcast_to(1.0 + j * 2.0**-10, (kw, D)).astype(np.float32).copy()
    params[5] = np.zeros(D, np.float32)
    ref, _ = _jax_conv(x, params, g, "bfloat16", 0.0, False)
    out, _ = _port_conv(x, params, g, "bfloat16", 0.0, False)
    ref = ref.astype(jnp.float32)
    _close(out, ref, "bfloat16", what="f32 taps")
    rounded = list(params)
    rounded[4] = np.asarray(jnp.asarray(params[4], jnp.bfloat16), np.float32)
    cast_taps, _ = _port_conv(x, rounded, g, "bfloat16", 0.0, False)
    with pytest.raises(AssertionError):
        _close(cast_taps, ref, "bfloat16", what="bf16 taps")


def test_conv_taps_gradient_uses_the_float32_glu(monkeypatch):
    """The taps' gradient multiplies dc by the unrounded float32 GLU output
    (the TPU kernel's ``glup``), not the bf16 value the forward convolved:
    the port's ddw_w is much nearer JAX's than the same sum over the rounded
    GLU."""
    x, params, g = _conv_inputs(7, seed=6)
    _, ref_grads = _jax_conv(x, params, g, "bfloat16", 0.0, True)
    ref = np.asarray(ref_grads[5], np.float32)
    _, grads = _port_conv(x, params, g, "bfloat16", 0.0, True)
    real = port_conv._glu

    def rounded_glu(hq):
        glu, a, sig = real(hq)
        return glu.to(hq.dtype).float(), a, sig

    monkeypatch.setattr(port_conv, "_glu", rounded_glu)
    _, plain_reading = _port_conv(x, params, g, "bfloat16", 0.0, True)
    err = np.abs(grads[5].numpy() - ref).max()
    err_rounded = np.abs(plain_reading[5].numpy() - ref).max()
    assert err * 4 < err_rounded, (err, err_rounded)


def test_fused_conv_refuses_an_even_kernel():
    with pytest.raises(ValueError, match="odd conv_kernel"):
        build_model(_args(conformer_conv_kernel=6), N_DAYS, "cpu")
    build_model(_args(conformer_conv_kernel=6, fused_conv=False), N_DAYS, "cpu")


# --------------------------------------------------- the Conformer, fused

N_DAYS = 3


def _args(**kw):
    """``tests/test_torch_port_conformer.py``'s small Conformer (C=32, latent
    256 = 2 heads of 128, FF 256, conv k=7, 6 blocks) with both fused flags
    set to JAX's "force" and every random draw off."""
    args = dict(model_type="transformer_ctc", nInputFeatures=32, nClasses=40,
                frontend_dim=64, latent_dim=256, autoencoder_hidden_dim=64,
                transformer_num_layers=6, transformer_n_heads=2,
                transformer_dim_ff=256, conformer_conv_kernel=7,
                transformer_dropout=0.0, drop_path_prob=0.0,
                use_spec_augment=False, whiteNoiseSD=0.0, constantOffsetSD=0.0,
                optimizer="adamw", lrStart=4e-4, lrEnd=4e-4, l2_decay=1e-3,
                warmup_steps=2, nBatch=10, label_smoothing=0.1, seed=0,
                watch_log_freq=0, batchSize=3, fused_ffn="force", fused_conv="force")
    args.update(kw)
    return args


def test_force_flags_reach_the_config():
    cfg = config_from_args(_args(), N_DAYS)
    assert cfg.fused_ffn is True and cfg.fused_conv is True
    assert not config_from_args(_args(fused_ffn=False, fused_conv=False), N_DAYS).fused_ffn


def _both(args, seed=0):
    """The JAX model with the fused kernels forced (head dropout off) and
    the port's module on the same weights."""
    model = jax_build_model(args, N_DAYS)
    cfg = dataclasses.replace(model.config, head_dropout=0.0)
    assert cfg.fused_ffn == "force" and cfg.fused_conv == "force"

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
            np.array([120, 91, 44][:b], np.int32),
            np.array([6, 4, 2][:b], np.int32),
            (np.arange(b) % N_DAYS).astype(np.int32))


@pytest.fixture
def one_jax_device(monkeypatch):
    """The 8-device conftest would send JAX's fused FF to its einsum twin
    (no kernel mesh is registered); one device calls the kernel."""
    monkeypatch.setattr(jax, "device_count", lambda *a, **k: 1)


def _calls(monkeypatch):
    """Count the JAX package's fused kernel calls, to show the reference
    ran them."""
    calls = {"ffn": 0, "conv": 0}
    real_ffn, real_conv = jax_ffn.fused_ffn, jax_conv.fused_conv_module

    def ffn(*a, **k):
        calls["ffn"] += 1
        return real_ffn(*a, **k)

    def conv(*a, **k):
        calls["conv"] += 1
        return real_conv(*a, **k)

    monkeypatch.setattr(jax_ffn, "fused_ffn", ffn)
    monkeypatch.setattr(jax_conv, "fused_conv_module", conv)
    return calls


def test_fused_forward_matches_jax(one_jax_device, monkeypatch):
    """Eval-mode float32 log-probs of the fused Conformer (2 blocks) against
    JAX's "force" path, within 1e-5 of their largest entry."""
    model, params, module = _both(_args(transformer_num_layers=2))
    x, _, lens, _, day = _batch()
    calls = _calls(monkeypatch)
    ref = jax.jit(lambda *a: model.forward(*a, train=False, key=None))(
        params, jnp.asarray(x), jnp.asarray(day), jnp.asarray(lens))
    assert calls == {"ffn": 4, "conv": 2}
    launches = (port_ffn.ffn.launches, port_conv.conv_module.launches)
    with torch.no_grad():
        lp, out_lens, _ = forward(module, torch.from_numpy(x), torch.from_numpy(day),
                                  torch.from_numpy(lens))
    assert (port_ffn.ffn.launches, port_conv.conv_module.launches) == launches  # CPU
    ref_lp = np.asarray(ref[0])
    np.testing.assert_allclose(lp.numpy(), ref_lp, atol=1e-5 * np.abs(ref_lp).max())
    np.testing.assert_array_equal(out_lens.numpy(), np.asarray(ref[1]))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k in tree for k2, v2 in _flat(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: np.asarray(tree, np.float32)}


def test_fused_train_step_matches_jax(one_jax_device, monkeypatch):
    """One train step's loss (label smoothing, InterCTC) and every gradient
    leaf of the fused Conformer against JAX's "force" path: loss 1e-5
    relative, each leaf within 1e-4 of its largest entry."""
    args = _args()
    model, params, module = _both(args, seed=2)
    batch = _batch()
    calls = _calls(monkeypatch)
    (ref_loss, ref_metrics), ref_grads = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_and_metrics(args, model, p, batch, jax.random.key(0)),
        has_aux=True))(jax.tree.map(jnp.asarray, params))
    assert calls["ffn"] >= 12 and calls["conv"] >= 6
    loss, metrics = _loss_and_metrics(args, module, tuple(torch.from_numpy(a) for a in batch),
                                      step_generator(torch.device("cpu"), 0, 0))
    loss.backward()
    assert loss.item() == pytest.approx(float(ref_loss), rel=1e-5)
    assert float(metrics["train/inter_ctc_loss"]) == pytest.approx(
        float(ref_metrics["train/inter_ctc_loss"]), rel=1e-5)
    grads = _flat(jax.tree.map(lambda p: p.grad.float().numpy(), module.params,
                               is_leaf=lambda v: isinstance(v, torch.Tensor)))
    ref_grads = _flat(ref_grads)
    assert grads.keys() == ref_grads.keys() and len(grads) > 100
    for k, ref in ref_grads.items():
        np.testing.assert_allclose(grads[k], ref, atol=1e-4 * np.abs(ref).max(), err_msg=k)
