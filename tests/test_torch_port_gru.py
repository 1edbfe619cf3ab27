"""The port's GRU pieces against the JAX package, on the CPU.

The GRU-scan kernel's plain version is held against the Pallas kernel run
in interpret mode (as ``tests/test_pallas_gru.py`` runs it), the plain
per-step layer against the ``lax.scan`` twin, and the parameter tree and
its conversion against ``init_gru_params``. Inputs come from numpy with a
seed. Tolerance 1e-5 in float32 (gate math on sums of 128 products); 1e-2
in bfloat16, where one rounding step of the output near 1 is 2**-8.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neural_speech_decoder_tpu.models.gru import GRUConfig as JaxGRUConfig
from neural_speech_decoder_tpu.models.gru import _gru_layer
from neural_speech_decoder_tpu.models.gru import init_gru_params as jax_init_gru_params
from neural_speech_decoder_tpu.ops.pallas.gru_scan import gru_sequence as jax_gru_sequence
from neural_speech_decoder_tpu_torch.models.convert import (
    gru_params_from_jax,
    gru_params_to_numpy,
)
from neural_speech_decoder_tpu_torch.models.gru import (
    GRUConfig,
    GRUDecoder,
    gru_layer,
    gru_output_length,
    init_gru_params,
)
from neural_speech_decoder_tpu_torch.ops.kernels.gru_scan import (
    gru_sequence,
    gru_sequence_plain,
)


def _case(seed=0, l=6, d=2, b=16, h=128):
    rng = np.random.default_rng(seed)
    xp = rng.standard_normal((l, d, b, 3 * h)).astype(np.float32)
    w = (rng.standard_normal((d, h, 3 * h)) * 0.2).astype(np.float32)
    bb = (rng.standard_normal((d, 3 * h)) * 0.1).astype(np.float32)
    return xp, w, bb


def _flip_d1(x):
    """Direction 1 in flipped time order (the lax.scan twin's convention)."""
    if x.shape[1] == 2:
        x = x.copy()
        x[:, 1] = x[::-1, 1]
    return x


@pytest.mark.parametrize("d", [1, 2])
def test_scan_plain_matches_jax_pallas_interpret(d):
    xp, w, bb = _case(d=d)
    ref = jax_gru_sequence(jnp.asarray(xp), jnp.asarray(w), jnp.asarray(bb), True)
    ours = gru_sequence_plain(*(torch.from_numpy(a) for a in (xp, w, bb)))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


def test_scan_plain_bfloat16_keeps_a_float32_carry_like_the_pallas_kernel():
    xp, w, bb = _case(seed=1, l=5, d=2, b=16, h=128)
    xb = torch.from_numpy(xp).bfloat16()
    ref = jax_gru_sequence(jnp.asarray(xb.float().numpy(), jnp.bfloat16),
                           jnp.asarray(w), jnp.asarray(bb), True)
    ours = gru_sequence_plain(xb, torch.from_numpy(w), torch.from_numpy(bb))
    assert ours.dtype == torch.bfloat16
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), atol=1e-2)


@pytest.mark.parametrize("d", [1, 2])
def test_gru_layer_matches_jax_lax_scan_twin(d):
    xp, w, bb = _case(seed=2, l=7, d=d, b=5, h=24)
    h0 = np.zeros((d, 5, 24), np.float32)
    ref = _gru_layer(jnp.asarray(_flip_d1(xp)), jnp.asarray(w), jnp.asarray(bb),
                     jnp.asarray(h0))
    ours = gru_layer(*(torch.from_numpy(a) for a in (_flip_d1(xp), w, bb, h0)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)
    # in float32 the kernel's plain version is the same layer, unflipped
    np.testing.assert_allclose(
        _flip_d1(ours.numpy()),
        gru_sequence_plain(*(torch.from_numpy(a) for a in (xp, w, bb))).numpy(),
        atol=1e-6,
    )


def test_scan_wrapper_runs_plain_for_cpu_tensors_and_refuses_other_devices():
    xp, w, bb = (torch.from_numpy(a) for a in _case(seed=3, l=4, b=3, h=16))
    before = gru_sequence.launches
    torch.testing.assert_close(gru_sequence(xp, w, bb),
                               gru_sequence_plain(xp, w, bb), rtol=0, atol=0)
    assert gru_sequence.launches == before  # no kernel ran
    with pytest.raises(ValueError):
        gru_sequence(xp.to("meta"), w.to("meta"), bb.to("meta"))


def _small_cfgs():
    kw = dict(neural_dim=16, n_classes=40, hidden_dim=8, num_layers=2, n_days=3,
              kernel_len=8, stride_len=2)
    return (JaxGRUConfig(**kw), GRUConfig(**kw))


@pytest.mark.parametrize("bidirectional", [True, False])
def test_init_gru_params_tree_matches_jax(bidirectional):
    jcfg, cfg = _small_cfgs()
    jcfg = JaxGRUConfig(**{**jcfg.__dict__, "bidirectional": bidirectional})
    cfg = GRUConfig(**{**cfg.__dict__, "bidirectional": bidirectional})
    ref = jax.tree.map(np.asarray, jax_init_gru_params(jax.random.key(0), jcfg))
    ours = gru_params_to_numpy(init_gru_params(cfg, torch.Generator().manual_seed(0)))
    assert jax.tree.structure(ours) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(ref)):
        assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(ours["day"]["weight"], ref["day"]["weight"])
    for lp in ours["gru"]["layers"]:
        for w_hh in lp["w_hh"]:  # [H, 3H] with orthonormal rows
            np.testing.assert_allclose(w_hh @ w_hh.T, np.eye(cfg.hidden_dim),
                                       atol=1e-5)
        bound = 1 / cfg.hidden_dim**0.5
        assert np.abs(lp["b_ih"]).max() <= bound and np.abs(lp["b_hh"]).max() <= bound


def test_params_convert_round_trip_and_module_view():
    jcfg, cfg = _small_cfgs()
    tree = jax.tree.map(np.asarray, jax_init_gru_params(jax.random.key(1), jcfg))
    module = GRUDecoder(cfg, gru_params_from_jax(tree))
    back = gru_params_to_numpy(module)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    # the module's params tree is a view of its own parameters
    assert module.params["gru"]["layers"][1]["w_hh"] is module.layers[1]["w_hh"]
    assert len(list(module.parameters())) == len(jax.tree.leaves(tree))


def test_gru_output_length():
    assert gru_output_length(GRUConfig(), 1280) == 313
    assert gru_output_length(GRUConfig(), 160) == 33
