"""The port's training ops against the JAX package, on the CPU.

The plain versions of the training kernels (the gates-storing scan, the
scan's backward, the CTC alpha and beta recursions) go against the Pallas
kernels run in interpret mode, as ``tests/test_pallas_gru.py`` and
``tests/test_pallas_ctc.py`` run them; the autograd Functions and the
port's ``ctc_loss`` against ``jax.grad``/``jax.vjp`` of the JAX functions and
against torch's own CTC loss; noise, dropout and the optimizer against
their definitions and optax. Inputs come from numpy with a seed.

Tolerances, float32: 1e-5 absolute where both sides sum the same terms of
size ~1 in other orders (gates, states, gradients of a 6-step scan with
H=32); 1e-4 relative for CTC alpha/beta (log-adds over up to 23 frames of
values up to ~80, where a float32 ulp is ~1e-5) and losses; 1e-5 for CTC
gradients (probabilities in [0, 1]); optimizer parameters 1e-6 (a few
ulps of parameters ~1 after a handful of updates).
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from neural_speech_decoder_tpu.models.gru import GRUConfig as JaxGRUConfig
from neural_speech_decoder_tpu.models.gru import gru_encode as jax_gru_encode
from neural_speech_decoder_tpu.models.gru import init_gru_params as jax_init_gru_params
from neural_speech_decoder_tpu.ops import ctc as jax_ctc_mod
from neural_speech_decoder_tpu.ops.pallas import ctc_kernel as jax_ctc
from neural_speech_decoder_tpu.ops.pallas import gru_scan as jax_scan
from neural_speech_decoder_tpu.training.optim import make_optimizer as jax_make_optimizer
from neural_speech_decoder_tpu_torch.models.convert import gru_params_from_jax
import neural_speech_decoder_tpu_torch.models.gru as port_gru
from neural_speech_decoder_tpu_torch.models.gru import GRUConfig, dropout, gru_encode
from neural_speech_decoder_tpu_torch.ops.ctc import ctc_feasible, ctc_loss
from neural_speech_decoder_tpu_torch.ops.kernels import ctc as port_ctc
from neural_speech_decoder_tpu_torch.ops.kernels.gru_scan import (
    GRUScan,
    gru_scan,
    gru_sequence_bwd_plain,
    gru_sequence_gates_plain,
    gru_sequence_plain,
)
from neural_speech_decoder_tpu_torch.ops.noise import apply_noise
from neural_speech_decoder_tpu_torch.training.optim import (
    grad_clip_norm,
    linear_lr_schedule,
    lr_schedule,
    make_optimizer,
    warmup_cosine_schedule,
)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _scan_case(seed=0, l=7, d=2, b=5, h=32):
    rng = np.random.default_rng(seed)
    xp = rng.standard_normal((l, d, b, 3 * h)).astype(np.float32)
    w = (rng.standard_normal((d, h, 3 * h)) * 0.2).astype(np.float32)
    bb = (rng.standard_normal((d, 3 * h)) * 0.1).astype(np.float32)
    dys = rng.standard_normal((l, d, b, h)).astype(np.float32)
    return xp, w, bb, dys


# ---------------------------------------------------------------- GRU scan


@pytest.mark.parametrize("d,l", [(1, 7), (2, 7), (2, 1)])
def test_gates_forward_plain_matches_pallas_interpret(d, l):
    xp, w, bb, _ = _scan_case(d=d, l=l)
    ys_j, g_j = jax_scan._forward(*map(jnp.asarray, (xp, w, bb)), True,
                                  with_gates=True)
    ys, gates = gru_sequence_gates_plain(*_t(xp, w, bb))
    assert gates.shape == (l, d, 5, 4 * 32) and gates.dtype == torch.float32
    np.testing.assert_allclose(ys.numpy(), np.asarray(ys_j), atol=1e-5)
    np.testing.assert_allclose(gates.numpy(), np.asarray(g_j), atol=1e-5)
    # the inference scan's ys are the training scan's
    assert torch.equal(gru_sequence_plain(*_t(xp, w, bb)), ys)


@pytest.mark.parametrize("d,l", [(1, 7), (2, 7), (2, 1)])
def test_backward_plain_matches_pallas_interpret(d, l):
    xp, w, bb, dys = _scan_case(d=d, l=l)
    ys_j, g_j = jax_scan._forward(*map(jnp.asarray, (xp, w, bb)), True,
                                  with_gates=True)
    dxp_j, dw_j, db_j = jax_scan._backward(g_j, jnp.asarray(w), ys_j,
                                           jnp.asarray(dys), True)
    dxp, dw, db = gru_sequence_bwd_plain(*_t(g_j, w, ys_j, dys))
    assert dw.dtype == db.dtype == torch.float32
    np.testing.assert_allclose(dxp.numpy(), np.asarray(dxp_j), atol=1e-5)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_j), atol=1e-5)
    np.testing.assert_allclose(db.numpy(), np.asarray(db_j), atol=1e-5)


def test_backward_plain_bf16_matches_pallas_interpret():
    """bf16 gates, states and cotangents: dxp is rounded to bf16 on both
    sides (one bf16 step near the largest |dxp| ~4 is 2**-6); dW and db are
    float32 sums of the same rounded terms."""
    xp, w, bb, dys = _scan_case(d=2)
    bf = jnp.bfloat16
    ys_j, g_j = jax_scan._forward(jnp.asarray(xp, bf), jnp.asarray(w),
                                  jnp.asarray(bb), True, with_gates=True)
    dxp_j, dw_j, db_j = jax_scan._backward(g_j, jnp.asarray(w), ys_j,
                                           jnp.asarray(dys, bf), True)
    to_t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    dxp, dw, db = gru_sequence_bwd_plain(to_t(g_j), torch.from_numpy(w),
                                         to_t(ys_j), to_t(dys))
    assert dxp.dtype == torch.bfloat16
    np.testing.assert_allclose(dxp.float().numpy(), np.asarray(dxp_j, np.float32),
                               atol=2**-6)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_j), atol=1e-3)
    np.testing.assert_allclose(db.numpy(), np.asarray(db_j), atol=1e-3)


@pytest.mark.parametrize("d", [1, 2])
def test_scan_function_grads_match_jax_grad_and_torch_autograd(d):
    xp, w, bb, dys = _scan_case(d=d)

    def jax_loss(xp_, w_, b_):
        return jnp.sum(jax_scan.gru_sequence(xp_, w_, b_, True) * dys)

    ref = jax.grad(jax_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (xp, w, bb)))
    for fn in (lambda *a: gru_scan(*a), lambda *a: gru_sequence_plain(*a)):
        leaves = [t.requires_grad_() for t in _t(xp, w, bb)]
        (fn(*leaves) * torch.from_numpy(dys)).sum().backward()
        for got, want in zip(leaves, ref):
            np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), atol=1e-5)


def test_scan_function_casts_param_grads_and_skips_gates_without_grad():
    xp, w, bb, dys = _scan_case()
    xp_t, w_t, b_t = _t(xp, w, bb)
    w64 = w_t.double().requires_grad_()
    b16 = b_t.to(torch.bfloat16).requires_grad_()
    ys = GRUScan.apply(xp_t, w64, b16, False)
    (ys * torch.from_numpy(dys)).sum().backward()
    assert w64.grad.dtype == torch.float64 and b16.grad.dtype == torch.bfloat16
    with torch.no_grad():  # no autograd: the inference scan, no graph
        out = gru_scan(xp_t, w64, b16)
    assert out.grad_fn is None and torch.equal(out, ys.detach())


# --------------------------------------------------------------------- CTC


def _ctc_case(seed=0, b=8, t=23, k=9, u=6):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, t, k)).astype(np.float32)
    labels = rng.integers(1, k, size=(b, u)).astype(np.int32)
    labels[:, 1] = labels[:, 0]  # a repeat
    label_lens = rng.integers(1, u + 1, size=b).astype(np.int32)
    input_lens = rng.integers(u + 2, t + 1, size=b).astype(np.int32)
    label_lens[0] = 0                    # empty target
    input_lens[1], label_lens[1] = 3, u  # infeasible
    input_lens[2] = 0                    # no frames
    input_lens[3] = t
    return logits, labels, label_lens, input_lens


def test_ctc_alpha_beta_plain_match_pallas_interpret():
    logits, labels, label_lens, input_lens = _ctc_case()
    _, lpz, _, skip, s_end, lens = port_ctc.prepare(
        *_t(logits, labels, label_lens, input_lens))
    _, lpz_j, _, skip_j, send_j, lens_j, _ = jax_ctc._prepare(
        *map(jnp.asarray, (logits, labels, label_lens, input_lens)))
    s = lpz.shape[-1]  # the JAX package pads S to 128 lanes: compare the real ones
    # log_softmax of ~N(0, 1) logits: the two frameworks' differ by an ulp
    np.testing.assert_allclose(lpz.numpy(), np.asarray(lpz_j)[..., :s], atol=1e-6)
    np.testing.assert_array_equal(skip.numpy(), np.asarray(skip_j)[..., :s])
    np.testing.assert_array_equal(s_end.numpy(), np.asarray(send_j)[..., :s])
    for ours, ref in (
            (port_ctc.ctc_alpha_plain(lpz, skip, lens),
             jax_ctc._run_alpha(lpz_j, skip_j, lens_j, True)),
            (port_ctc.ctc_beta_plain(lpz, skip, lens, s_end),
             jax_ctc._run_beta(lpz_j, skip_j, lens_j, send_j, True))):
        ref = np.asarray(ref)[..., :s]
        ours = ours.numpy()
        np.testing.assert_array_equal(ours <= -1e29, ref <= -1e29)
        live = ref > -1e29
        np.testing.assert_allclose(ours[live], ref[live], rtol=1e-4, atol=1e-4)
    # the CPU wrappers are the plain versions
    assert torch.equal(port_ctc.ctc_alpha(lpz, skip, lens),
                       port_ctc.ctc_alpha_plain(lpz, skip, lens))


@pytest.fixture
def jax_single_device(monkeypatch):
    """The JAX package's kernel call sites run their Pallas kernels directly
    (in interpret mode off-TPU) only on one device; the tests' platform has
    eight virtual ones, and the sharded path then falls back to the XLA
    twins. Make it see one."""
    monkeypatch.setattr(jax, "device_count", lambda *a, **k: 1)


@pytest.mark.parametrize("reduction", ["none", "sum", "mean"])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_ctc_loss_matches_jax(jax_single_device, reduction, use_kernel):
    logits, labels, label_lens, input_lens = _ctc_case()
    rng = np.random.default_rng(1)
    cot = rng.standard_normal(8).astype(np.float32) if reduction == "none" else 1.0

    def jax_fn(u):
        out = jax_ctc_mod.ctc_loss(u, jnp.asarray(input_lens), jnp.asarray(labels),
                                   jnp.asarray(label_lens), reduction=reduction,
                                   use_kernel=use_kernel)
        return jnp.sum(out * cot), out

    (_, ref), ref_grad = jax.value_and_grad(jax_fn, has_aux=True)(
        jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_()
    out = ctc_loss(lg, *_t(input_lens, labels, label_lens), reduction=reduction)
    (out * torch.as_tensor(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    assert torch.isfinite(lg.grad).all()
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(ref_grad), atol=1e-5)


def test_ctc_loss_matches_torch_and_masks_infeasible_rows():
    logits, labels, label_lens, input_lens = _ctc_case()
    il, lab, ll = _t(input_lens, labels, label_lens)
    ok = ctc_feasible(lab, ll, il)
    assert ok.tolist()[:3] == [True, False, False]
    for zero_infinity in (True, False):
        lg = torch.from_numpy(logits).requires_grad_()
        ours = ctc_loss(lg, il, lab, ll, reduction="none",
                        zero_infinity=zero_infinity)
        ref_lg = torch.from_numpy(logits).requires_grad_()
        ref = torch.nn.functional.ctc_loss(
            torch.log_softmax(ref_lg, -1).transpose(0, 1), lab.long(), il.long(),
            ll.long(), reduction="none", zero_infinity=zero_infinity)
        if zero_infinity:
            np.testing.assert_allclose(ours.detach().numpy(), ref.detach().numpy(),
                                       rtol=1e-4, atol=1e-4)
            ours.sum().backward()
            ref.sum().backward()
            np.testing.assert_allclose(lg.grad.numpy(), ref_lg.grad.numpy(),
                                       atol=1e-5)
            assert lg.grad[~ok].abs().max().item() == 0.0
        else:  # infeasible rows are inf, as torch's
            assert torch.isinf(ours[~ok]).all() and torch.isinf(ref[~ok]).all()
            np.testing.assert_allclose(ours[ok].detach().numpy(),
                                       ref[ok].detach().numpy(), rtol=1e-4)
    with pytest.raises(ValueError):
        ctc_loss(lg, il, lab, ll, blank_id=1)


def test_ctc_loss_accepts_bf16_log_probs():
    logits, labels, label_lens, input_lens = _ctc_case()
    lg = torch.from_numpy(logits).to(torch.bfloat16).requires_grad_()
    out = ctc_loss(lg, *_t(input_lens, labels, label_lens))
    out.backward()
    assert out.dtype == torch.float32 and lg.grad.dtype == torch.bfloat16
    ref = ctc_loss(lg.detach().float(), *_t(input_lens, labels, label_lens))
    assert abs(out.item() - ref.item()) <= 1e-5 * abs(ref.item())


# ------------------------------------------------------ noise and dropout


def test_noise_identity_at_zero_and_statistics():
    gen = torch.Generator().manual_seed(0)
    x = torch.zeros((64, 200, 32))
    assert torch.equal(apply_noise(gen, x, 0.0, 0.0), x)
    white = apply_noise(gen, x, 0.8, 0.0)
    # the mean and SD of 409600 N(0, 0.8^2) draws: SEs 1.3e-3 and 8.8e-4
    assert abs(white.mean().item()) < 6e-3 and abs(white.std().item() - 0.8) < 5e-3
    offset = apply_noise(gen, x, 0.0, 0.2)
    # constant over time, one N(0, 0.2^2) draw per (row, channel)
    assert torch.equal(offset, offset[:, :1].expand_as(offset))
    assert abs(offset[:, 0].std().item() - 0.2) < 0.02  # 2048 draws: SE 3e-3


def _encode_case(dropout):
    cfg = GRUConfig(neural_dim=8, hidden_dim=16, num_layers=3, n_days=1,
                    kernel_len=4, stride_len=2, dropout=dropout)
    jcfg = JaxGRUConfig(neural_dim=8, hidden_dim=16, num_layers=3, n_days=1,
                        kernel_len=4, stride_len=2, dropout=dropout, use_pallas=False)
    params = jax_init_gru_params(jax.random.key(0), jcfg)
    x = np.random.default_rng(0).standard_normal((4, 40, 8)).astype(np.float32)
    return cfg, jcfg, params, x


def test_dropout_off_is_identity_and_matches_jax():
    cfg, jcfg, params, x = _encode_case(0.0)
    ours = gru_encode(gru_params_from_jax(jax.tree.map(np.asarray, params)), cfg,
                      torch.from_numpy(x), train=True,
                      generator=torch.Generator().manual_seed(0))
    ref = jax_gru_encode(params, jcfg, jnp.asarray(x), train=True,
                         dropout_key=jax.random.key(0))
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), atol=1e-5)


def test_dropout_keep_rate_and_scale():
    """Inverted dropout at p = 0.4 on 40000 entries: the dropped share is p
    (SE 2.4e-3), kept entries are scaled by exactly 1/(1-p)."""
    p = 0.4
    x = torch.ones((200, 200))
    out = dropout(x, p, torch.Generator().manual_seed(5))
    assert abs((out == 0).float().mean().item() - p) < 0.01
    assert torch.equal(out[out != 0], torch.full_like(out[out != 0], 1 / (1 - p)))
    assert torch.equal(out, dropout(x, p, torch.Generator().manual_seed(5)))


def test_dropout_follows_every_layer_but_the_last(monkeypatch):
    cfg, _, params, x = _encode_case(0.4)
    tree = gru_params_from_jax(jax.tree.map(np.asarray, params))
    calls = []

    def spy(t, p, generator):
        calls.append(p)
        return dropout(t, p, generator)

    monkeypatch.setattr(port_gru, "dropout", spy)
    out = gru_encode(tree, cfg, torch.from_numpy(x), train=True,
                     generator=torch.Generator().manual_seed(3))
    assert calls == [0.4] * (cfg.num_layers - 1)
    again = gru_encode(tree, cfg, torch.from_numpy(x), train=True,
                       generator=torch.Generator().manual_seed(3))
    assert torch.equal(out, again)  # the generator decides every mask
    calls.clear()
    gru_encode(tree, cfg, torch.from_numpy(x))  # eval: no dropout
    assert calls == []
    with pytest.raises(ValueError):
        gru_encode(tree, cfg, torch.from_numpy(x), train=True)


# --------------------------------------------------------------- optimizer


def _opt_args(**kw):
    args = dict(nBatch=7, lrStart=0.02, lrEnd=0.005, l2_decay=1e-3)
    args.update(kw)
    return args


@pytest.mark.parametrize("args", [
    _opt_args(),
    _opt_args(l2_decay=0.0, lrEnd=0.02),
    _opt_args(optimizer="adamw", warmup_steps=3, weight_decay=0.01),
    _opt_args(optimizer="adamw", warmup_steps=0, model_type="transformer_ctc"),
])
def test_optimizer_matches_optax_chain(args):
    """Ten updates (past nBatch, where LinearLR holds its end value) of the
    same parameters with the same gradients, through the port's torch
    optimizer and scheduler and through the JAX package's optax chain."""
    rng = np.random.default_rng(0)
    p0 = [rng.standard_normal((5, 3)).astype(np.float32),
          rng.standard_normal((4,)).astype(np.float32)]
    grads = [[rng.standard_normal(p.shape).astype(np.float32) * 3 for p in p0]
             for _ in range(10)]
    tx, jax_schedule = jax_make_optimizer(args)
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt, sched = make_optimizer(args, params)
    schedule = lr_schedule(args)
    clip = grad_clip_norm(args)
    for i, g in enumerate(grads):
        assert schedule(i) == pytest.approx(float(jax_schedule(i)), rel=1e-6)
        assert opt.param_groups[0]["lr"] == pytest.approx(schedule(i), rel=1e-6)
        updates, state = tx.update([jnp.asarray(a) for a in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, a in zip(params, g):
            p.grad = torch.from_numpy(a.copy())
        if clip is not None:
            torch.nn.utils.clip_grad_norm_(params, clip)
        opt.step()
        sched.step()
        for p, want in zip(params, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(want),
                                       atol=1e-6, rtol=1e-6)


def test_schedules():
    lin = linear_lr_schedule(0.02, 0.005, 10)
    assert lin(0) == 0.02 and lin(10) == pytest.approx(0.005) and lin(50) == lin(10)
    cos = warmup_cosine_schedule(1e-3, 4, 20)
    assert cos(0) == pytest.approx(2.5e-4) and cos(3) == pytest.approx(1e-3)
    assert cos(4) == pytest.approx(1e-3) and cos(20) == pytest.approx(0.0, abs=1e-12)
    assert cos(12) == pytest.approx(1e-3 * 0.5 * (1 + math.cos(math.pi * 0.5)))
