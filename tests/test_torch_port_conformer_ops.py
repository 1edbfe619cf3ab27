"""The Conformer slice's ops in the port against the JAX package, on the CPU.

- The hash RNG (``ops/hashrng.py``) and the attention kernels' dropout
  masks: bit-equal to JAX's.
- SpecAugment: equal masks given the same uniforms.
- ``mhsa_qkv_plain`` and its backward against JAX ``fused_mhsa_qkv`` in
  interpret mode (its Pallas kernels run by the interpreter, with the
  counter-hash dropout bits), in float32: forward and dqkv within 1e-5 of
  their largest entry (T-long float32 sums taken in other orders); the
  forward also in bfloat16 (the tensor-core kernel's oracle on the card),
  within 2**-7 of the largest output entry (p and the output are rounded to
  bf16, and a rounding that falls the other way moves an entry by one bf16
  step, 2**-8 relative).
- The single-rounding ``linear`` against the JAX package's ``_linear`` in
  bfloat16, the Conformer's 9-tap smoothing, its positional encoding and
  its output lengths.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neural_speech_decoder_tpu.models import conformer as jax_conformer
from neural_speech_decoder_tpu.ops import gaussian as jax_gaussian
from neural_speech_decoder_tpu.ops import hashrng as jax_hashrng
from neural_speech_decoder_tpu.ops.pallas.attention_kernel import (
    dropout_masks as jax_dropout_masks,
)
from neural_speech_decoder_tpu.ops.pallas.attention_kernel import (
    fused_mhsa_qkv as jax_fused_mhsa_qkv,
)
from neural_speech_decoder_tpu.ops.specaugment import spec_augment as jax_spec_augment
from neural_speech_decoder_tpu_torch.models import conformer
from neural_speech_decoder_tpu_torch.models.common import linear
from neural_speech_decoder_tpu_torch.ops import hashrng
from neural_speech_decoder_tpu_torch.ops.gaussian import (
    conformer_kernel_size,
    gaussian_smooth,
)
from neural_speech_decoder_tpu_torch.ops.kernels import attention
from neural_speech_decoder_tpu_torch.ops.specaugment import spec_augment

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small CPU ops gain nothing from more, and
    the suite's parallel workers would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATTN_TOL = 1e-5


@pytest.mark.parametrize("seed,salt", [(0, 0), (1, 2), (-7, 5), (2**31 - 1, 511),
                                       (-(2**31), 3)])
def test_uniform2d_bit_equal_to_jax(seed, salt):
    shape = (37, 130)
    ref = np.asarray(jax_hashrng.uniform2d(jnp.int32(seed), jnp.int32(salt), shape))
    ours = hashrng.uniform2d(seed, salt, shape).numpy()
    assert ours.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(
        hashrng.keep_mask2d(torch.tensor(seed, dtype=torch.int32), salt, shape, 0.3).numpy(),
        np.asarray(jax_hashrng.keep_mask2d(jnp.int32(seed), jnp.int32(salt), shape, 0.3)))


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.3])
def test_hash_dropout_bit_equal_to_jax(rate):
    key = jax.random.key(3)
    seed = int(jax_hashrng.key_to_seed(key))
    x = np.random.default_rng(0).standard_normal((3, 17, 40)).astype(np.float32)
    ref = np.asarray(jax_hashrng.hash_dropout(key, jnp.asarray(x), rate, True))
    ours = hashrng.hash_dropout(torch.tensor(seed, dtype=torch.int32),
                                torch.from_numpy(x), rate).numpy()
    np.testing.assert_array_equal(ours, ref)


def test_draw_seed_is_an_int32_tensor_in_range():
    s = hashrng.draw_seed(torch.Generator().manual_seed(0))
    assert s.dtype == torch.int32 and s.shape == (1,) and 0 <= int(s) < 2**31 - 1


def _jax_spec_uniforms(key):
    """The uniforms ``spec_augment`` draws from ``key``, in its split order."""
    keys = jax.random.split(key, 4)
    out = []
    for k in keys:
        k1, k2 = jax.random.split(k)
        out.append([float(jax.random.uniform(k1)), float(jax.random.uniform(k2))])
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("key", [0, 1, 2, 5])
def test_spec_augment_matches_jax_given_the_uniforms(key):
    x = np.random.default_rng(1).standard_normal((2, 50, 120)).astype(np.float32)
    k = jax.random.key(key)
    ref = np.asarray(jax_spec_augment(k, jnp.asarray(x), freq_mask_param=100,
                                      time_mask_param=40))
    ours = spec_augment(torch.from_numpy(x), freq_mask_param=100, time_mask_param=40,
                        uniforms=torch.from_numpy(_jax_spec_uniforms(k))).numpy()
    np.testing.assert_array_equal(ours, ref)
    assert (ours == 0).any()  # some mask has a width


def test_spec_augment_draws_from_the_generator():
    x = torch.ones((2, 60, 200))
    a = spec_augment(x, generator=torch.Generator().manual_seed(3))
    b = spec_augment(x, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and (a == 0).any()
    # one mask for the whole batch
    assert torch.equal(a[0], a[1])
    with pytest.raises(ValueError):
        spec_augment(x)


def _qkv(b, t, h, dh, seed=0):
    return np.random.default_rng(seed).standard_normal((b, t, 3 * h * dh)).astype(np.float32)


ATTN_CASES = [
    # (t, lens, left_context, interleaved, rate)
    (37, [37, 0, 20], None, False, 0.0),
    (37, [37, 12, 1], 8, False, 0.0),
    (130, [130, 0, 77], None, True, 0.0),
    (130, [130, 64, 9], 40, True, 0.0),
    (37, [37, 30, 0], None, False, 0.3),
    (130, [100, 130, 5], 16, True, 0.3),
]


@pytest.mark.parametrize("t,lens,left,interleaved,rate", ATTN_CASES)
def test_mhsa_plain_and_grad_match_pallas_interpret(t, lens, left, interleaved, rate):
    """Forward and dqkv at dh=128, 2 heads; lengths include 0 (every key
    masked: zero rows); dropout with the seed JAX derives from its key."""
    b, h, dh = 3, 2, 128
    qkv = _qkv(b, t, h, dh)
    lens_np = np.asarray(lens, np.int32)
    key = jax.random.key(4)
    w = np.random.default_rng(1).standard_normal((b, t, h * dh)).astype(np.float32)
    kw = dict(num_heads=h, dropout_rate=rate, train=rate > 0, interpret=True,
              left_context=left, interleaved=interleaved)

    def f(q):
        return jnp.sum(jax_fused_mhsa_qkv(q, jnp.asarray(lens_np), key, **kw) * w)

    ref = np.asarray(jax_fused_mhsa_qkv(jnp.asarray(qkv), jnp.asarray(lens_np), key, **kw))
    ref_grad = np.asarray(jax.grad(f)(jnp.asarray(qkv)))
    seed = (jax.random.randint(key, (1,), 0, jnp.iinfo(jnp.int32).max, dtype=jnp.int32)
            if rate > 0 else jnp.zeros((1,), jnp.int32))
    x = torch.from_numpy(qkv).requires_grad_()
    out = attention.mhsa(x, torch.from_numpy(lens_np), torch.from_numpy(np.array(seed)),
                         num_heads=h, rate=rate, left_context=left, interleaved=interleaved)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref,
                               atol=ATTN_TOL * np.abs(ref).max())
    np.testing.assert_allclose(x.grad.numpy(), ref_grad,
                               atol=ATTN_TOL * np.abs(ref_grad).max())
    dead = lens_np <= 0
    assert not out[torch.from_numpy(dead)].any()  # fully masked rows give 0


ATTN_BF16_TOL = 2.0**-7

ATTN_BF16_CASES = [
    # (t, dh, lens, left_context, interleaved, rate)
    (37, 128, [37, 0, 20], None, False, 0.0),
    (37, 64, [37, 12, 1], 8, False, 0.3),
    (130, 128, [130, 0, 77], None, True, 0.3),
    (130, 64, [130, 64, 9], 40, True, 0.0),
    (130, 128, [100, 130, 5], 16, False, 0.3),
    (37, 64, [0, 37, 30], None, True, 0.3),
]


@pytest.mark.parametrize("t,dh,lens,left,interleaved,rate", ATTN_BF16_CASES)
def test_mhsa_plain_bf16_matches_pallas_interpret(t, dh, lens, left, interleaved, rate):
    """The bfloat16 forward, 2 heads: ``mhsa_qkv_plain`` on bf16 qkv against
    ``fused_mhsa_qkv`` run in bfloat16 by the interpreter (scores summed in
    float32, p rounded to bf16 before ``p @ V``, one rounding of the output);
    lengths of 0 give zero rows."""
    b, h = 3, 2
    qkv = jnp.asarray(_qkv(b, t, h, dh, seed=2), jnp.bfloat16)
    lens_np = np.asarray(lens, np.int32)
    key = jax.random.key(5)
    ref = np.asarray(jax_fused_mhsa_qkv(
        qkv, jnp.asarray(lens_np), key, num_heads=h, dropout_rate=rate, train=rate > 0,
        interpret=True, left_context=left, interleaved=interleaved).astype(jnp.float32))
    seed = (jax.random.randint(key, (1,), 0, jnp.iinfo(jnp.int32).max, dtype=jnp.int32)
            if rate > 0 else jnp.zeros((1,), jnp.int32))
    x = torch.from_numpy(np.array(qkv.astype(jnp.float32))).bfloat16()
    out = attention.mhsa_qkv_plain(x, torch.from_numpy(lens_np), torch.from_numpy(np.array(seed)),
                                   num_heads=h, rate=rate, left_context=left,
                                   interleaved=interleaved)
    assert out.dtype == torch.bfloat16 and out.shape == (b, t, h * dh)
    np.testing.assert_allclose(out.float().numpy(), ref,
                               atol=ATTN_BF16_TOL * np.abs(ref).max())
    assert not out[torch.from_numpy(lens_np <= 0)].any()


@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_dropout_masks_plain_equal_jax(rate):
    seed = jnp.asarray([123456], jnp.int32)
    ref = np.asarray(jax_dropout_masks(6, 128, seed, rate, interpret=True))
    ours = attention.dropout_masks(6, 128, torch.tensor([123456], dtype=torch.int32), rate)
    assert ours.dtype == torch.bool
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_attention_wrappers_check_their_arguments():
    qkv = torch.zeros((2, 5, 3 * 2 * 64))
    lens = torch.tensor([5, 5], dtype=torch.int32)
    seed = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        attention.mhsa_qkv(qkv, lens, seed, num_heads=2, rate=1.0)
    with pytest.raises(ValueError):
        attention.mhsa_qkv(qkv.to("meta"), lens, seed, num_heads=2)
    with pytest.raises(ValueError):
        attention.dropout_masks(2, 5, seed.to("meta"), 0.3)
    # a CPU tensor runs the plain version and launches nothing
    before = attention.mhsa_qkv.launches
    assert attention.mhsa_qkv(qkv, lens, seed, num_heads=2).shape == (2, 5, 128)
    assert attention.mhsa_qkv.launches == before


def test_linear_rounds_once_like_jax_linear_in_bf16():
    """Forward: bf16 operands, float32 product and bias, one bf16 rounding,
    equal to JAX's ``_linear`` but for float32 summation order (at most one
    bf16 step of the output, 2**-8 relative). Gradients: bf16 products as
    JAX's cotangents (dx, dw within two bf16 steps of the largest entry;
    db, a float32 sum, within 1e-5 relative)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 9, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 48)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(48) * 0.1).astype(np.float32)
    g = rng.standard_normal((4, 9, 48)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)

    def f(x_, w_, b_):
        y = jax_conformer._linear({"w": w_, "b": b_}, x_)
        return jnp.sum(y.astype(jnp.float32) * g), y

    (_, ref), ref_grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        xb, jnp.asarray(w), jnp.asarray(b))
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    y = linear(xt, wt, bt)
    assert y.dtype == torch.bfloat16
    (y.float() * torch.from_numpy(g)).sum().backward()
    ref = np.asarray(ref, np.float32)
    step = 2.0**-8 * np.abs(ref).max()
    assert np.abs(y.detach().float().numpy() - ref).max() <= step
    for got, want, tol in ((xt.grad, ref_grads[0], 2 * 2.0**-8),
                           (wt.grad, ref_grads[1], 2 * 2.0**-8),
                           (bt.grad, ref_grads[2], 1e-5)):
        want = np.asarray(want, np.float32)
        assert got.dtype == (torch.bfloat16 if got is xt.grad else torch.float32)
        err = np.abs(got.float().numpy() - want).max()
        assert err <= tol * np.abs(want).max(), err


def test_linear_float32_equals_a_plain_product():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((3, 5, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((8, 6)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(6).astype(np.float32))
    assert torch.allclose(linear(x, w, b), x @ w + b, atol=1e-6)


@pytest.mark.parametrize("sigma", [1.0, 2.0, 2.5])
def test_conformer_smoothing_matches_jax(sigma):
    x = np.random.default_rng(2).standard_normal((2, 40, 12)).astype(np.float32)
    ks = conformer_kernel_size(sigma)
    assert ks == jax_gaussian.conformer_kernel_size(sigma)
    ref = jax_gaussian.gaussian_smooth(jnp.asarray(x), ks, sigma, padding=(ks // 2, ks // 2))
    ours = gaussian_smooth(torch.from_numpy(x), ks, sigma, padding=(ks // 2, ks // 2))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6)


def test_positional_encoding_matches_jax():
    np.testing.assert_array_equal(conformer.sinusoidal_pos_encoding(50, 33),
                                  np.asarray(jax_conformer.sinusoidal_pos_encoding(50, 33)))
    ref = np.asarray(jax_conformer.sinusoidal_pos_rows(17, 20, 64))
    ours = conformer.sinusoidal_pos_rows(17, 20, 64).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-6)


def test_output_lengths_match_jax():
    cfg = conformer.ConformerConfig()
    jcfg = jax_conformer.ConformerConfig()
    lens = np.array([0, 5, 31, 32, 33, 35, 36, 1280, 5000], np.int32)
    for t in (10, 313):
        ref = np.asarray(jax_conformer.conformer_output_lengths(jcfg, jnp.asarray(lens), t))
        ours = conformer.conformer_output_lengths(cfg, torch.from_numpy(lens), t)
        assert ours.dtype == torch.int32
        np.testing.assert_array_equal(ours.numpy(), ref)
