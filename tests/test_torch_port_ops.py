"""The PyTorch port's ops and frontend kernel's plain version against the
JAX package, on the CPU in float32.

Inputs are made with numpy from a seed and go through both. Tolerances:
1e-6 to 1e-5 absolute where both sides sum the same float32 terms in other
orders (smoothing, day affine, frontend), relative 1e-5 for long sums of
large terms (unfold products), exact for integer results (lengths,
decodes).
"""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neural_speech_decoder_tpu.ops.pallas.frontend_kernel import (
    fused_frontend as jax_fused_frontend,
)
from neural_speech_decoder_tpu_torch.models.common import (
    orthogonal,
    torch_linear_init,
    uniform_bound,
    xavier_uniform,
)
from neural_speech_decoder_tpu_torch.ops.day_affine import day_affine, init_day_affine
from neural_speech_decoder_tpu_torch.ops.decode import batch_per, edit_distance, greedy_decode
from neural_speech_decoder_tpu_torch.ops.gaussian import (
    gaussian_kernel,
    gaussian_smooth,
    same_padding,
)
from neural_speech_decoder_tpu_torch.ops.kernels.frontend import (
    fused_frontend,
    fused_frontend_plain,
)
from neural_speech_decoder_tpu_torch.ops.unfold import (
    ctc_input_lengths,
    unfold,
    unfold_matmul,
    unfold_output_length,
)

# The JAX package's modules themselves: its ops package re-exports functions
# under the same names.
jda = importlib.import_module("neural_speech_decoder_tpu.ops.day_affine")
jdec = importlib.import_module("neural_speech_decoder_tpu.ops.decode")
jg = importlib.import_module("neural_speech_decoder_tpu.ops.gaussian")
ju = importlib.import_module("neural_speech_decoder_tpu.ops.unfold")

F32_TOL = 1e-6


def _rng(seed=0):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("kernel_size", [20, 9, 1])
def test_taps_and_padding_match_jax(kernel_size):
    np.testing.assert_array_equal(
        gaussian_kernel(kernel_size, 2.0), jg.gaussian_kernel(kernel_size, 2.0)
    )
    assert same_padding(kernel_size) == jg.same_padding(kernel_size)
    assert same_padding(20) == (9, 10)


@pytest.mark.parametrize("kernel_size,sigma", [(20, 2.0), (9, 2.0), (20, 0.0)])
def test_gaussian_smooth_matches_jax(kernel_size, sigma):
    x = _rng().standard_normal((2, 50, 16)).astype(np.float32)
    ref = jg.gaussian_smooth(jnp.asarray(x), kernel_size, sigma)
    ours = gaussian_smooth(torch.from_numpy(x), kernel_size, sigma)
    assert ours.shape == x.shape
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=F32_TOL)


def test_day_affine_matches_jax_including_out_of_range_days():
    rng = _rng(1)
    n_days, c = 4, 16
    params = {
        "weight": rng.standard_normal((n_days, c, c)).astype(np.float32),
        "bias": rng.standard_normal((n_days, c)).astype(np.float32),
    }
    x = rng.standard_normal((5, 12, c)).astype(np.float32)
    day = np.array([0, 3, -1, 7, 2], np.int32)  # -1 -> 0 and 7 -> 3
    ref = jda.day_affine(jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                         jnp.asarray(day))
    ours = day_affine({k: torch.from_numpy(v) for k, v in params.items()},
                      torch.from_numpy(x), torch.from_numpy(day))
    assert np.isfinite(ours.numpy()).all()
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


def test_init_day_affine_matches_jax():
    ref = jda.init_day_affine(3, 8)
    ours = init_day_affine(3, 8)
    for k in ("weight", "bias"):
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]))


def test_ctc_input_lengths_matches_jax():
    # 0, 5 and 31 are shorter than the kernel: (len-32)/4 truncates toward
    # zero (-8, -6, 0), then clamps to 0
    lens = np.array([0, 5, 31, 32, 33, 35, 36, 100, 1200, 1280], np.int32)
    ref = ju.ctc_input_lengths(jnp.asarray(lens), 32, 4)
    ours = ctc_input_lengths(torch.from_numpy(lens), 32, 4)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert ours.dtype == torch.int32


@pytest.mark.parametrize("t,k,s", [(1280, 32, 4), (100, 32, 4), (40, 8, 3)])
def test_unfold_output_length_matches_jax(t, k, s):
    assert unfold_output_length(t, k, s) == ju.unfold_output_length(t, k, s)


def test_unfold_and_unfold_matmul_match_jax():
    rng = _rng(2)
    b, t, c, k, s, o = 2, 70, 8, 32, 4, 12
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    w = rng.standard_normal((c * k, o)).astype(np.float32)
    frames = unfold(torch.from_numpy(x), k, s)
    np.testing.assert_array_equal(frames.numpy(),
                                  np.asarray(ju.unfold(jnp.asarray(x), k, s)))
    ours = unfold_matmul(torch.from_numpy(x), torch.from_numpy(w), k, s)
    assert ours.shape == (b, unfold_output_length(t, k, s), o)
    # 256-term sums of unit normals reach |y| ~ 30: float32 rounding of the
    # summation order is relative
    np.testing.assert_allclose(ours.numpy(), (frames @ torch.from_numpy(w)).numpy(),
                               rtol=1e-5, atol=1e-5)
    ref = ju.unfold_matmul(jnp.asarray(x), jnp.asarray(w), k, s,
                           precision=jax.lax.Precision.HIGHEST)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_greedy_decode_matches_jax():
    rng = _rng(3)
    b, t, k = 5, 30, 6
    # few classes and long runs so that repeats and blanks both occur
    ids = np.repeat(rng.integers(0, k, size=(b, t // 3)), 3, axis=1)
    lp = np.log(np.full((b, t, k), 0.1 / (k - 1), np.float32))
    np.put_along_axis(lp, ids[..., None], np.log(0.9), axis=-1)
    lens = np.array([30, 17, 1, 0, 29], np.int32)
    ref_tok, ref_len = jdec.greedy_decode(jnp.asarray(lp), jnp.asarray(lens))
    tok, n = greedy_decode(torch.from_numpy(lp), torch.from_numpy(lens))
    np.testing.assert_array_equal(n.numpy(), np.asarray(ref_len))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))
    assert n[3] == 0 and (tok[3] == 0).all()


def test_edit_distance_and_batch_per_match_jax():
    rng = _rng(4)
    dec = rng.integers(1, 5, size=(4, 9))
    tgt = rng.integers(1, 5, size=(4, 9))
    dl = np.array([9, 3, 0, 5])
    tl = np.array([7, 9, 2, 5])
    assert batch_per(dec, dl, tgt, tl) == jdec.batch_per(dec, dl, tgt, tl)
    for a, b in [("kitten", "sitting"), ([], [1, 2]), ([1, 2, 3], [1, 2, 3])]:
        assert edit_distance(a, b) == jdec.edit_distance(a, b)


def _frontend_case(seed, b=3, t=40, c=128, n_days=4):
    rng = _rng(seed)
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    w = np.stack([np.eye(c) + 0.1 * rng.standard_normal((c, c))
                  for _ in range(n_days)]).astype(np.float32)
    bias = (0.1 * rng.standard_normal((n_days, c))).astype(np.float32)
    return x, w, bias


@pytest.mark.parametrize("day", [[0, 2, 3], [1, -1, 9]])
def test_frontend_plain_matches_jax_pallas_interpret(day):
    x, w, bias = _frontend_case(0)
    day = np.asarray(day, np.int32)
    ref = jax_fused_frontend(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
                             jnp.asarray(day), kernel_size=20, sigma=2.0,
                             interpret=True)
    args = [torch.from_numpy(a) for a in (x, w, bias, day)]
    ours = fused_frontend_plain(*args, kernel_size=20, sigma=2.0)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


def test_frontend_wrapper_runs_plain_for_cpu_tensors():
    x, w, bias = _frontend_case(1, b=2, t=16)
    args = [torch.from_numpy(a) for a in (x, w, bias)]
    day = torch.tensor([1, 0], dtype=torch.int32)
    before = fused_frontend.launches
    ours = fused_frontend(*args, day, kernel_size=20, sigma=2.0)
    ref = fused_frontend_plain(*args, day, kernel_size=20, sigma=2.0)
    assert fused_frontend.launches == before  # no kernel ran
    torch.testing.assert_close(ours, ref, rtol=0, atol=0)


def test_frontend_plain_bfloat16_rounds_like_the_tpu_kernel():
    x, w, bias = _frontend_case(2, b=2, t=24)
    xb = torch.from_numpy(x).bfloat16()
    day = torch.tensor([0, 3], dtype=torch.int32)
    ours = fused_frontend_plain(xb, torch.from_numpy(w), torch.from_numpy(bias),
                                day, kernel_size=20, sigma=2.0)
    ref = jax_fused_frontend(jnp.asarray(xb.float().numpy(), jnp.bfloat16),
                             jnp.asarray(w), jnp.asarray(bias),
                             jnp.asarray(day.numpy()), kernel_size=20,
                             sigma=2.0, interpret=True)
    assert ours.dtype == torch.bfloat16
    # one bf16 step (2**-8) near |y| = 1 where sums round differently
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), atol=4e-3)


def test_frontend_rejects_bad_arguments():
    x, w, bias = _frontend_case(3, b=1, t=8)
    args = [torch.from_numpy(a) for a in (x, w, bias)]
    day = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError):  # 0/0 taps
        fused_frontend(*args, day, kernel_size=20, sigma=0.0)
    with pytest.raises(ValueError):
        fused_frontend(*args, day, kernel_size=40, sigma=2.0)
    with pytest.raises(ValueError):  # neither CPU nor CUDA
        fused_frontend(*(a.to("meta") for a in args), day.to("meta"),
                       kernel_size=20, sigma=2.0)


def test_initializers_match_jax_distributions():
    g = torch.Generator().manual_seed(0)
    w = xavier_uniform((300, 500), g)
    bound = (6.0 / 800) ** 0.5
    assert w.abs().max() <= bound and w.abs().max() > 0.95 * bound
    assert abs(w.std().item() - bound / 3**0.5) < 0.01 * bound
    for shape in [(96, 32), (32, 96), (40, 40)]:
        q = orthogonal(shape, g).double()
        gram = q.T @ q if shape[0] >= shape[1] else q @ q.T
        torch.testing.assert_close(gram, torch.eye(min(shape), dtype=torch.float64),
                                   atol=1e-5, rtol=0)
    lw, lb = torch_linear_init(64, 41, g)
    assert lw.shape == (64, 41) and lb.shape == (41,)
    assert lw.abs().max() <= 1 / 8 and lb.abs().max() <= 1 / 8
    u = uniform_bound((10000,), 0.5, g)
    assert -0.5 <= u.min() and u.max() <= 0.5 and abs(u.mean().item()) < 0.02
