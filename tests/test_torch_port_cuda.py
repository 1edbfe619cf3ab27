"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with ``nvcc`` and skips without one.
This file imports no jax, and the tests' ``conftest.py`` does, so run it on
the card without that file:

    python -m pytest --noconftest -q -m cuda tests/test_torch_port_cuda.py

The shapes are small and ragged (not multiples of the kernels' tiles) so
that the edge handling is exercised; ``chip_smoke.py`` checks the serving
path's full shapes.
"""

import hashlib

import numpy as np
import pytest
import torch

from neural_speech_decoder_tpu_torch.ops.kernels.attention import (
    MHSA,
    dropout_masks,
    dropout_masks_plain,
    mhsa_qkv,
    mhsa_qkv_bwd,
    mhsa_qkv_bwd_plain,
    mhsa_qkv_plain,
)
from neural_speech_decoder_tpu_torch.ops.kernels.conv_module import (
    conv_module,
    conv_module_bwd,
    conv_module_bwd_plain,
    conv_module_plain,
    fused_conv_module,
)
from neural_speech_decoder_tpu_torch.ops.kernels.ffn import (
    ffn,
    ffn_bwd,
    ffn_bwd_plain,
    ffn_dropout_masks,
    ffn_dropout_masks_plain,
    ffn_plain,
    fused_ffn,
)
from neural_speech_decoder_tpu_torch.ops.kernels.frontend import (
    fused_frontend,
    fused_frontend_plain,
)
from neural_speech_decoder_tpu_torch.ops.ctc import ctc_feasible
from neural_speech_decoder_tpu_torch.ops.kernels.ctc import (
    ctc_alpha,
    ctc_alpha_plain,
    ctc_beta,
    ctc_beta_plain,
    ctc_loss_kernel,
    prepare,
)
from neural_speech_decoder_tpu_torch.ops.kernels.gru_scan import (
    GRUScan,
    device_limits,
    gru_sequence,
    gru_sequence_bwd,
    gru_sequence_bwd_plain,
    gru_sequence_gates,
    gru_sequence_gates_plain,
    gru_sequence_plain,
    dw_contraction,
    hh_grads_plain,
    plan_for,
    scan_backward,
    scan_forward,
    scan_plan,
)

pytestmark = pytest.mark.cuda

# Same reasoning as chip_smoke.py's TOL: float32 differs by summation order
# only; in bfloat16 that can flip a stored value's rounding by one step.
F32_TOL = 1e-5
BF16_TOL = 1.6e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("b,t,c", [(3, 37, 130), (2, 70, 256)])
def test_frontend_kernel_matches_plain(cuda, dtype, tol, b, t, c):
    g = torch.Generator(device=cuda).manual_seed(0)
    n_days = 4
    x = torch.randn((b, t, c), generator=g, device=cuda).to(dtype)
    w = torch.eye(c, device=cuda) + 0.05 * torch.randn(
        (n_days, c, c), generator=g, device=cuda)
    bias = 0.1 * torch.randn((n_days, c), generator=g, device=cuda)
    day = torch.tensor([-1, 3, 9][:b], dtype=torch.int32, device=cuda)
    before = fused_frontend.launches
    out = fused_frontend(x, w, bias, day, kernel_size=20, sigma=2.0)
    ref = fused_frontend_plain(x, w, bias, day, kernel_size=20, sigma=2.0)
    torch.cuda.synchronize()
    assert fused_frontend.launches == before + 1
    assert out.dtype == dtype and out.shape == x.shape
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d", [1, 2])
def test_gru_scan_kernel_matches_plain(cuda, dtype, tol, d):
    g = torch.Generator(device=cuda).manual_seed(0)
    length, b, h = 9, 37, 40
    xp = torch.randn((length, d, b, 3 * h), generator=g, device=cuda).to(dtype)
    w = 0.2 * torch.randn((d, h, 3 * h), generator=g, device=cuda)
    bias = 0.1 * torch.randn((d, 3 * h), generator=g, device=cuda)
    before = gru_sequence.launches
    out = gru_sequence(xp, w, bias)
    ref = gru_sequence_plain(xp, w, bias)
    torch.cuda.synchronize()
    assert gru_sequence.launches == before + 1
    assert out.dtype == dtype and out.shape == (length, d, b, h)
    assert (out.float() - ref.float()).abs().max().item() <= tol


def test_kernels_refuse_unsupported_dtype(cuda):
    x = torch.zeros((1, 8, 16), dtype=torch.float16, device=cuda)
    w = torch.zeros((1, 16, 16), device=cuda)
    with pytest.raises(TypeError):
        fused_frontend(x, w, w[:, 0], torch.zeros(1, dtype=torch.int32,
                       device=cuda), kernel_size=20, sigma=2.0)
    xp = torch.zeros((2, 1, 1, 12), dtype=torch.float16, device=cuda)
    with pytest.raises(TypeError):
        gru_sequence(xp, torch.zeros((1, 4, 12), device=cuda),
                     torch.zeros((1, 12), device=cuda))


def _scan_case(cuda, dtype, d, length=9, b=40, h=40):
    g = torch.Generator(device=cuda).manual_seed(1)
    xp = torch.randn((length, d, b, 3 * h), generator=g, device=cuda).to(dtype)
    w = 0.2 * torch.randn((d, h, 3 * h), generator=g, device=cuda)
    bias = 0.1 * torch.randn((d, 3 * h), generator=g, device=cuda)
    dys = torch.randn((length, d, b, h), generator=g, device=cuda).to(dtype)
    return xp, w, bias, dys


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d", [1, 2])
def test_gru_gates_kernel_matches_plain(cuda, dtype, tol, d):
    xp, w, bias, _ = _scan_case(cuda, dtype, d)
    before = gru_sequence_gates.launches
    ys, gates = gru_sequence_gates(xp, w, bias)
    ys_ref, gates_ref = gru_sequence_gates_plain(xp, w, bias)
    ys_inf = gru_sequence(xp, w, bias)
    torch.cuda.synchronize()
    assert gru_sequence_gates.launches == before + 1
    assert gates.dtype == dtype and gates.shape == xp.shape[:3] + (4 * 40,)
    # the training and inference kernels share their arithmetic
    assert torch.equal(ys, ys_inf)
    assert (ys.float() - ys_ref.float()).abs().max().item() <= tol
    # hp_n is a sum of 40 products of size ~0.5: its bf16 step is ~2**-6
    assert (gates.float() - gates_ref.float()).abs().max().item() <= 4 * tol


# dW_hh and db_hh sum L*B = 360 products of size ~1 in float32, in another
# order than the plain version; relative to their largest entry.
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d", [1, 2])
def test_gru_bwd_kernel_matches_plain(cuda, dtype, tol, d):
    xp, w, bias, dys = _scan_case(cuda, dtype, d)
    ys, gates = gru_sequence_gates_plain(xp, w, bias)
    before = gru_sequence_bwd.launches
    dxp, dw, db = gru_sequence_bwd(gates, w, ys, dys)
    dxp_ref, dw_ref, db_ref = gru_sequence_bwd_plain(gates, w, ys, dys)
    torch.cuda.synchronize()
    assert gru_sequence_bwd.launches == before + 1
    assert dxp.dtype == dtype and dw.dtype == db.dtype == torch.float32
    scale = dxp_ref.float().abs().max().item()
    assert (dxp.float() - dxp_ref.float()).abs().max().item() <= tol * scale
    for got, ref in ((dw, dw_ref), (db, db_ref)):
        err = (got - ref).abs().max().item()
        assert err <= tol * ref.abs().max().item(), err


def test_gru_scan_function_grads_match_plain(cuda):
    xp, w, bias, dys = _scan_case(cuda, torch.float32, 2, length=7, b=5)
    grads = []
    for plain in (False, True):
        leaves = [t.clone().requires_grad_() for t in (xp, w, bias)]
        ys = GRUScan.apply(*leaves, plain)
        (ys * dys).sum().backward()
        grads.append([t.grad for t in leaves])
    for got, ref in zip(*grads):
        assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


# The persistent bf16 bodies (one cooperative launch a layer, W_hh's slice in
# shared memory, mma.sync steps) against the plain versions, with the step
# body's tolerances above. Weights ~ 1.2/sqrt(H) keep the pre-activations
# of order 1 at every H (0.19 at H=40, the scale of the tests above).
PERSISTENT_SHAPES = [(h, b, d) for h in (40, 128, 1024) for b in (5, 64) for d in (1, 2)]


def _bf16_scan_case(cuda, h, b, d, length=9):
    g = torch.Generator(device=cuda).manual_seed(3)
    xp = torch.randn((length, d, b, 3 * h), generator=g, device=cuda).bfloat16()
    w = 1.2 / h**0.5 * torch.randn((d, h, 3 * h), generator=g, device=cuda)
    bias = 0.1 * torch.randn((d, 3 * h), generator=g, device=cuda)
    dys = torch.randn((length, d, b, h), generator=g, device=cuda).bfloat16()
    return xp, w, bias, dys


def _by_body(*wrappers):
    return [dict(f.launches_by_body) for f in wrappers]


@pytest.mark.parametrize("h,b,d", PERSISTENT_SHAPES)
def test_gru_persistent_forward_matches_plain(cuda, h, b, d):
    xp, w, bias, _ = _bf16_scan_case(cuda, h, b, d)
    assert plan_for(xp, h, b, d) != "step"
    before = _by_body(gru_sequence, gru_sequence_gates)
    ys = gru_sequence(xp, w, bias)
    ys_g, gates = gru_sequence_gates(xp, w, bias)
    ys_ref, gates_ref = gru_sequence_gates_plain(xp, w, bias)
    again = gru_sequence(xp, w, bias)
    torch.cuda.synchronize()
    for old, new, n in zip(before, _by_body(gru_sequence, gru_sequence_gates), (2, 1)):
        assert new == {"persistent": old["persistent"] + n, "step": old["step"]}
    assert torch.equal(ys, ys_g) and torch.equal(ys, again)
    assert (ys.float() - ys_ref.float()).abs().max().item() <= 2e-2
    assert (gates.float() - gates_ref.float()).abs().max().item() <= 8e-2


@pytest.mark.parametrize("length", [1, 2])
def test_gru_persistent_short_sequences(cuda, length):
    xp, w, bias, dys = _bf16_scan_case(cuda, 128, 5, 2, length)
    ys, gates = gru_sequence_gates(xp, w, bias)
    ys_ref, gates_ref = gru_sequence_gates_plain(xp, w, bias)
    dxp, dw, db = gru_sequence_bwd(gates_ref, w, ys_ref, dys)
    ref = gru_sequence_bwd_plain(gates_ref, w, ys_ref, dys)
    torch.cuda.synchronize()
    assert (ys.float() - ys_ref.float()).abs().max().item() <= 2e-2
    for got, want in zip((dxp, dw, db), ref):
        assert (got.float() - want.float()).abs().max().item() <= (
            2e-2 * want.float().abs().max().item())


@pytest.mark.parametrize("h,b,d", PERSISTENT_SHAPES)
def test_gru_persistent_backward_matches_plain(cuda, h, b, d):
    xp, w, bias, dys = _bf16_scan_case(cuda, h, b, d)
    ys, gates = gru_sequence_gates_plain(xp, w, bias)
    before = gru_sequence_bwd.launches_by_body["persistent"]
    out = gru_sequence_bwd(gates, w, ys, dys)
    again = gru_sequence_bwd(gates, w, ys, dys)
    ref = gru_sequence_bwd_plain(gates, w, ys, dys)
    torch.cuda.synchronize()
    assert gru_sequence_bwd.launches_by_body["persistent"] == before + 2
    assert out[0].dtype == torch.bfloat16 and out[1].dtype == out[2].dtype == torch.float32
    for got, rerun, want in zip(out, again, ref):
        assert torch.equal(got, rerun)
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 2e-2 * want.float().abs().max().item(), err


@pytest.mark.parametrize("h,b,d", [(40, 5, 1), (128, 64, 2), (1024, 64, 2)])
def test_gru_dw_contraction_matches_plain(cuda, h, b, d):
    g = torch.Generator(device=cuda).manual_seed(4)
    length = 9
    ys = torch.randn((length, d, b, h), generator=g, device=cuda).bfloat16()
    dxp = torch.randn((length, d, b, 3 * h), generator=g, device=cuda).bfloat16()
    dhp_n = torch.randn((length, d, b, h), generator=g, device=cuda).bfloat16()
    dw = dw_contraction(ys, dxp, dhp_n)
    dw2 = dw_contraction(ys, dxp, dhp_n)
    dw_ref = hh_grads_plain(ys, dxp, dhp_n)[0]
    torch.cuda.synchronize()
    assert torch.equal(dw, dw2)
    # float32 sums of L*B exact products of bf16 values, in another order
    assert (dw - dw_ref).abs().max().item() <= 1e-5 * dw_ref.abs().max().item()


def test_gru_scan_bodies_by_dtype_and_shape(cuda):
    # float32, and bf16 with H % 8 != 0, take the step body
    for dtype, h, body in ((torch.float32, 40, "step"), (torch.bfloat16, 36, "step"),
                           (torch.bfloat16, 40, "persistent")):
        xp, w, bias, dys = _bf16_scan_case(cuda, h, 5, 2)
        xp, dys = xp.to(dtype), dys.to(dtype)
        before = _by_body(gru_sequence, gru_sequence_gates, gru_sequence_bwd)
        ys = gru_sequence(xp, w, bias)
        ys_g, gates = gru_sequence_gates(xp, w, bias)
        gru_sequence_bwd(gates, w, ys_g, dys)
        torch.cuda.synchronize()
        assert torch.equal(ys, ys_g)
        for old, new in zip(before, _by_body(gru_sequence, gru_sequence_gates,
                                             gru_sequence_bwd)):
            assert new[body] == old[body] + 1 and sum(new.values()) == sum(old.values()) + 1


def test_gru_step_body_on_demand_matches_persistent(cuda):
    xp, w, bias, dys = _bf16_scan_case(cuda, 128, 64, 2)
    ys_p, gates_p = scan_forward(xp, w, bias, gates=True)
    ys_s, gates_s = scan_forward(xp, w, bias, gates=True, plan="step")
    dxp_p, dw_p, db_p = scan_backward(gates_s, w, ys_s, dys)
    dxp_s, dw_s, db_s = scan_backward(gates_s, w, ys_s, dys, plan="step")
    torch.cuda.synchronize()
    assert (ys_p.float() - ys_s.float()).abs().max().item() <= 2e-2
    for got, want in ((dxp_p, dxp_s), (dw_p, dw_s), (db_p, db_s)):
        assert (got.float() - want.float()).abs().max().item() <= (
            2e-2 * want.float().abs().max().item())


@pytest.mark.parametrize("d", [1, 2])
def test_gru_bf16_step_body_matches_plain(cuda, d):
    # the step body, kept for the bf16 shapes the persistent body cannot
    # hold, against the plain versions with the bf16 tolerances above
    xp, w, bias, dys = _scan_case(cuda, torch.bfloat16, d)
    before = _by_body(gru_sequence_gates, gru_sequence_bwd)
    ys, gates = scan_forward(xp, w, bias, gates=True, plan="step")
    ys_ref, gates_ref = gru_sequence_gates_plain(xp, w, bias)
    out = scan_backward(gates_ref, w, ys_ref, dys, plan="step")
    ref = gru_sequence_bwd_plain(gates_ref, w, ys_ref, dys)
    torch.cuda.synchronize()
    for old, new in zip(before, _by_body(gru_sequence_gates, gru_sequence_bwd)):
        assert new == {"persistent": old["persistent"], "step": old["step"] + 1}
    assert (ys.float() - ys_ref.float()).abs().max().item() <= 2e-2
    assert (gates.float() - gates_ref.float()).abs().max().item() <= 8e-2
    for got, want in zip(out, ref):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 2e-2 * want.float().abs().max().item(), err


def test_gru_scan_function_bf16_grads_match_plain(cuda):
    # GRUScan's autograd on the persistent forward and backward
    xp, w, bias, dys = _bf16_scan_case(cuda, 128, 64, 2)
    grads = []
    for plain in (False, True):
        before = _by_body(gru_sequence_gates, gru_sequence_bwd)
        leaves = [t.clone().requires_grad_() for t in (xp, w, bias)]
        ys = GRUScan.apply(*leaves, plain)
        (ys.float() * dys.float()).sum().backward()
        grads.append([t.grad for t in leaves])
        n = 0 if plain else 1
        for old, new in zip(before, _by_body(gru_sequence_gates, gru_sequence_bwd)):
            assert new == {"persistent": old["persistent"] + n, "step": old["step"]}
    torch.cuda.synchronize()
    assert grads[0][0].dtype == torch.bfloat16 and grads[0][1].dtype == torch.float32
    for got, ref in zip(*grads):
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= 2e-2 * ref.float().abs().max().item(), err


def test_gru_persistent_plan_that_cannot_be_coresident_raises(cuda):
    n_sms, smem = device_limits(cuda.index or 0)
    h, b, d = 1024, 64, 2
    # planned for a card with four times the SMs: 8 units a block, 256 blocks
    plan = scan_plan(h, b, d, torch.bfloat16, 4 * n_sms, smem)
    assert plan != "step" and plan.blocks > n_sms
    xp, w, bias, dys = _bf16_scan_case(cuda, h, b, d, length=3)
    before = _by_body(gru_sequence, gru_sequence_gates, gru_sequence_bwd)
    with pytest.raises(RuntimeError, match="co-resident"):
        scan_forward(xp, w, bias, gates=False, plan=plan)
    with pytest.raises(RuntimeError, match="co-resident"):
        scan_forward(xp, w, bias, gates=True, plan=plan)
    ys, gates = gru_sequence_gates_plain(xp, w, bias)
    with pytest.raises(RuntimeError, match="co-resident"):
        scan_backward(gates, w, ys, dys, plan=plan)
    assert _by_body(gru_sequence, gru_sequence_gates, gru_sequence_bwd) == before


def _ctc_case(cuda, b=40, t=37, k=11, u=6):
    g = torch.Generator(device=cuda).manual_seed(2)
    logits = torch.randn((b, t, k), generator=g, device=cuda)
    labels = torch.randint(1, k, (b, u), generator=g, device=cuda)
    labels[:, 1] = labels[:, 0]  # a repeat: needs a blank between
    label_lens = torch.randint(1, u + 1, (b,), generator=g, device=cuda)
    input_lens = torch.randint(u + 2, t + 1, (b,), generator=g, device=cuda)
    label_lens[0] = 0    # empty target
    input_lens[1] = 3    # infeasible: 3 frames for up to 6 labels + repeat
    label_lens[1] = u
    input_lens[2] = 0    # no frames at all
    input_lens[3] = t    # full length
    return logits, labels, label_lens, input_lens


# alpha and beta are sums of a few log-adds per frame over 37 frames; the
# card's expf/logf and the CPU's agree to a few float32 ulps of values up
# to ~100.
CTC_TOL = 1e-4


def test_ctc_alpha_beta_kernels_match_plain(cuda):
    logits, labels, label_lens, input_lens = _ctc_case(cuda)
    _, lpz, _, skip, s_end, lens = prepare(logits, labels, label_lens, input_lens)
    before = (ctc_alpha.launches, ctc_beta.launches)
    alpha = ctc_alpha(lpz, skip, lens)
    beta = ctc_beta(lpz, skip, lens, s_end)
    torch.cuda.synchronize()
    assert (ctc_alpha.launches, ctc_beta.launches) == (before[0] + 1, before[1] + 1)
    for got, ref in ((alpha, ctc_alpha_plain(lpz, skip, lens)),
                     (beta, ctc_beta_plain(lpz, skip, lens, s_end))):
        # the sentinel lanes must match exactly, the rest within CTC_TOL
        assert torch.equal(got <= -1e29, ref <= -1e29)
        live = ref > -1e29
        assert (got[live] - ref[live]).abs().max().item() <= CTC_TOL


def test_ctc_loss_kernel_matches_plain_and_torch(cuda):
    logits, labels, label_lens, input_lens = _ctc_case(cuda)
    out = []
    for plain in (False, True):
        lg = logits.clone().requires_grad_()
        loss = ctc_loss_kernel(lg, input_lens, labels, label_lens, plain=plain)
        loss.sum().backward()
        out.append((loss.detach(), lg.grad))
    (loss, grad), (loss_ref, grad_ref) = out
    assert loss[1].item() >= 1e29  # the sentinel, not inf
    assert torch.isfinite(grad).all()
    assert (loss - loss_ref).abs().max().item() <= CTC_TOL * 10
    assert (grad - grad_ref).abs().max().item() <= CTC_TOL
    # feasible rows against torch's own CTC loss
    ok = ctc_feasible(labels, label_lens, input_lens)
    assert not ok[1] and not ok[2] and ok[0]
    ref = torch.nn.functional.ctc_loss(
        torch.log_softmax(logits[ok], -1).transpose(0, 1), labels[ok],
        input_lens[ok], label_lens[ok], reduction="none", zero_infinity=True)
    assert (loss[ok] - ref).abs().max().item() <= 1e-3


@pytest.mark.parametrize("model_type", ["gru_baseline", "transformer_ctc"])
def test_train_step_is_reproducible(cuda, model_type):
    """Two runs of three bf16 train steps (dropout and noise on; for the
    Conformer also DropPath, SpecAugment, label smoothing and InterCTC)
    from one seed give bit-equal losses and parameters: every kernel of the
    step sums in a fixed order (the CTC gradient gathers its extended
    states with a one-hot product, the attention backward has no
    atomics)."""
    from neural_speech_decoder_tpu_torch.models.api import build_model
    from neural_speech_decoder_tpu_torch.training.optim import make_optimizer
    from neural_speech_decoder_tpu_torch.training.profile import (
        BENCH_ARGS,
        CONFORMER_ARGS,
        bench_batch,
    )
    from neural_speech_decoder_tpu_torch.training.trainer import (
        batch_tensors,
        make_train_step,
        step_generator,
    )

    if model_type == "gru_baseline":
        args = {**BENCH_ARGS, "nInputFeatures": 64, "nUnits": 96, "nLayers": 2}
    else:
        args = {**CONFORMER_ARGS, "nInputFeatures": 64, "frontend_dim": 128,
                "latent_dim": 256, "transformer_n_heads": 2,
                "transformer_num_layers": 6, "transformer_dim_ff": 256}
    batch = batch_tensors(bench_batch(b=40, t=301, u=24, c=64), cuda)
    runs = []
    for _ in range(2):
        model = build_model(args, 24, cuda, seed=0)
        opt, sched = make_optimizer(args, model.parameters())
        step = make_train_step(args, model, opt, sched)
        losses = [step(batch, step_generator(cuda, 0, i))["train/loss"].item()
                  for i in range(3)]
        runs.append((losses, [p.detach().clone() for p in model.parameters()]))
    (l1, p1), (l2, p2) = runs
    assert l1 == l2
    assert all(torch.equal(a, b) for a, b in zip(p1, p2))


# Attention: relative to the output's largest entry, float32 differs by
# summation order only; bfloat16 by roundings of p, dS and the outputs that
# fall the other way (a bf16 step is 2**-8 relative).
ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0**-6}


def _rel(a, b):
    b = b.float()
    return ((a.float() - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,dh,lens,rate,left,interleaved", [
    (3, 37, 2, 128, [37, 0, 20], 0.0, None, False),
    (3, 130, 2, 128, [130, 5, 64], 0.3, None, True),
    (2, 200, 3, 64, [200, 150], 0.3, 40, False),
    (2, 70, 1, 64, [0, 0], 0.1, 8, True),
])
def test_attention_kernels_match_plain(cuda, dtype, b, t, h, dh, lens, rate, left,
                                       interleaved):
    """Ragged T (not a multiple of the 64-row tiles), lengths of 0 (zero
    rows), a band, both column layouts, both head widths."""
    g = torch.Generator(device=cuda).manual_seed(0)
    qkv = torch.randn((b, t, 3 * h * dh), generator=g, device=cuda).to(dtype)
    gout = torch.randn((b, t, h * dh), generator=g, device=cuda).to(dtype)
    lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    seed = torch.tensor([-123], dtype=torch.int32, device=cuda)
    kw = dict(num_heads=h, rate=rate, left_context=left, interleaved=interleaved)
    f0, b0 = mhsa_qkv.launches, mhsa_qkv_bwd.launches
    by_body = dict(mhsa_qkv.launches_by_body)
    out, ref = mhsa_qkv(qkv, lens, seed, **kw), mhsa_qkv_plain(qkv, lens, seed, **kw)
    d, dref = (mhsa_qkv_bwd(qkv, lens, seed, gout, **kw),
               mhsa_qkv_bwd_plain(qkv, lens, seed, gout, **kw))
    torch.cuda.synchronize()
    assert (mhsa_qkv.launches, mhsa_qkv_bwd.launches) == (f0 + 1, b0 + 1)
    # the bf16 forward runs on the tensor cores, the float32 one on FMAs
    body = "tc" if dtype == torch.bfloat16 else "fma"
    assert {k: v - by_body[k] for k, v in mhsa_qkv.launches_by_body.items()} == {
        k: int(k == body) for k in by_body}
    assert out.dtype == dtype and d.dtype == dtype and d.shape == qkv.shape
    assert _rel(out, ref) <= ATTN_TOL[dtype] and _rel(d, dref) <= ATTN_TOL[dtype]
    assert not out[lens == 0].any()


def test_attention_bf16_forward_reruns_bit_equal(cuda):
    """The tensor-core forward at the Conformer's shapes (B=64, T'=313, 8
    heads of dh=128, rate 0.3, two rows of length 0): two runs give the same
    bits, within the tolerance of the plain version, zero rows zero."""
    g = torch.Generator(device=cuda).manual_seed(1)
    b, t, h, dh = 64, 313, 8, 128
    qkv = torch.randn((b, t, 3 * h * dh), generator=g, device=cuda).bfloat16()
    lens = ((torch.randint(400, 1281, (b,), generator=g, device=cuda) - 32) // 4).int()
    lens[1], lens[2], lens[3] = t, 0, 0
    seed = torch.tensor([987654], dtype=torch.int32, device=cuda)
    kw = dict(num_heads=h, rate=0.3)
    before = mhsa_qkv.launches_by_body["tc"]
    out, again = mhsa_qkv(qkv, lens, seed, **kw), mhsa_qkv(qkv, lens, seed, **kw)
    ref = mhsa_qkv_plain(qkv, lens, seed, **kw)
    torch.cuda.synchronize()
    assert mhsa_qkv.launches_by_body["tc"] == before + 2
    assert torch.equal(out, again)
    assert _rel(out, ref) <= ATTN_TOL[torch.bfloat16]
    assert not out[lens == 0].any()


def test_dropout_masks_kernel_equals_plain(cuda):
    seed = torch.tensor([2**31 - 1], dtype=torch.int32, device=cuda)
    for rate in (0.0, 0.3, 0.9):
        m = dropout_masks(7, 131, seed, rate)
        torch.cuda.synchronize()
        assert m.dtype == torch.bool and torch.equal(m, dropout_masks_plain(7, 131, seed, rate))


def test_attention_function_grads_match_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn((2, 90, 3 * 256), generator=g, device=cuda)
    lens = torch.tensor([90, 33], dtype=torch.int32, device=cuda)
    seed = torch.tensor([7], dtype=torch.int32, device=cuda)
    w = torch.randn((2, 90, 256), generator=g, device=cuda)
    grads = []
    for plain in (False, True):
        x = qkv.clone().requires_grad_()
        out = MHSA.apply(x, lens, seed, 2, 0.3, None, False, plain)
        (out * w).sum().backward()
        grads.append(x.grad)
    assert _rel(grads[0], grads[1]) <= 1e-5


@pytest.mark.parametrize("dh", [128, 64])
@pytest.mark.parametrize("left", [None, 128])
def test_attention_bf16_grads_at_conformer_length(cuda, dh, left):
    """The bf16 backward (tensor cores) through ``MHSA.apply`` at the
    Conformer's T'=313, 8 heads, rate 0.3, with and without the band, and
    a row of length 0 (its gradient is zero), against the plain path."""
    g = torch.Generator(device=cuda).manual_seed(2)
    b, t, h = 3, 313, 8
    qkv = torch.randn((b, t, 3 * h * dh), generator=g, device=cuda).bfloat16()
    w = torch.randn((b, t, h * dh), generator=g, device=cuda).bfloat16()
    lens = torch.tensor([t, 0, 200], dtype=torch.int32, device=cuda)
    seed = torch.tensor([11], dtype=torch.int32, device=cuda)
    grads = []
    for plain in (False, True):
        before = mhsa_qkv_bwd.launches
        x = qkv.clone().requires_grad_()
        out = MHSA.apply(x, lens, seed, h, 0.3, left, False, plain)
        (out * w).sum().backward()
        torch.cuda.synchronize()
        assert mhsa_qkv_bwd.launches == before + (0 if plain else 1)
        grads.append(x.grad)
    assert grads[0].dtype == torch.bfloat16 and not grads[0][1].any()
    assert _rel(grads[0], grads[1]) <= ATTN_TOL[torch.bfloat16]


def test_attention_kernels_refuse_unsupported_shapes(cuda):
    qkv = torch.zeros((1, 8, 3 * 96), device=cuda)  # dh = 96
    lens = torch.tensor([8], dtype=torch.int32, device=cuda)
    seed = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head widths"):
        mhsa_qkv(qkv, lens, seed, num_heads=1)
    with pytest.raises(ValueError, match="lens"):
        mhsa_qkv(torch.zeros((1, 8, 384), device=cuda), lens.cpu(), seed, num_heads=1)


# The fused FF and conv-module kernels against their plain versions, output
# and every gradient relative to its largest entry. Float32: the same sums
# in another order. Bfloat16: the intermediates (s, h, the GLU, the conv
# output, the norms) and dW are rounded to bf16, and a rounding that falls
# the other way moves an entry by a bf16 step (2**-8 relative); up to four
# steps of the largest entry are allowed, as for the attention.
FUSED_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0**-6}
# Gradients: float32 sums over all B*T rows (the dW products, the column
# sums) in another order; bfloat16 also dW rounded to bf16 and the
# cotangents rounded before their products.
FUSED_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0**-5}


def _ffn_case(cuda, dtype, b, t, d, f):
    g = torch.Generator(device=cuda).manual_seed(4)
    r = lambda *s, sc=1.0: sc * torch.randn(s, generator=g, device=cuda)
    x = r(b, t, d).to(dtype)
    params = (1.0 + r(d, sc=0.1), r(d, sc=0.1), r(d, f, sc=d**-0.5).to(dtype),
              r(f, sc=0.1), r(f, d, sc=f**-0.5).to(dtype), r(d, sc=0.1))
    return x, params, r(b, t, d).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,d,f,rate", [(3, 37, 96, 200, 0.0), (2, 70, 128, 256, 0.3),
                                          (1, 300, 256, 512, 0.1)])
def test_ffn_kernels_match_plain(cuda, dtype, b, t, d, f, rate):
    """Ragged shapes (not multiples of the 128-wide product tiles)."""
    x, (sc, bi, w1, b1, w2, b2), gout = _ffn_case(cuda, dtype, b, t, d, f)
    seed = torch.tensor([-77], dtype=torch.int32, device=cuda)
    f0, b0 = ffn.launches, ffn_bwd.launches
    out = ffn(x, sc, bi, w1, b1, w2, b2, seed, rate=rate)
    ref = ffn_plain(x, sc, bi, w1, b1, w2, b2, seed, rate=rate)
    grads = ffn_bwd(x, sc, bi, w1, b1, w2, seed, gout, rate=rate)
    refs = ffn_bwd_plain(x, sc, bi, w1, b1, w2, seed, gout, rate=rate)
    torch.cuda.synchronize()
    assert (ffn.launches, ffn_bwd.launches) == (f0 + 1, b0 + 1)
    assert out.dtype == dtype and _rel(out, ref) <= FUSED_TOL[dtype]
    for name, a, r in zip(("dx", "dscale", "dbias", "dw1", "db1", "dw2", "db2"),
                          grads, refs):
        assert a.dtype == r.dtype and a.shape == r.shape, name
        assert _rel(a, r) <= FUSED_GRAD_TOL[dtype], (name, _rel(a, r))


def test_ffn_dropout_masks_kernel_equals_plain(cuda):
    seed = torch.tensor([2**31 - 1], dtype=torch.int32, device=cuda)
    for rate in (0.0, 0.3, 0.9):
        m1, m2 = ffn_dropout_masks(3, 41, 96, 200, seed, rate)
        r1, r2 = ffn_dropout_masks_plain(3, 41, 96, 200, seed, rate)
        torch.cuda.synchronize()
        assert torch.equal(m1, r1) and torch.equal(m2, r2)


def _conv_case(cuda, dtype, b, t, d, kw):
    g = torch.Generator(device=cuda).manual_seed(5)
    r = lambda *s, sc=1.0: sc * torch.randn(s, generator=g, device=cuda)
    x = r(b, t, d).to(dtype)
    params = (1.0 + r(d, sc=0.1), r(d, sc=0.1), r(d, 2 * d, sc=d**-0.5).to(dtype),
              r(2 * d, sc=0.1), r(kw, d, sc=kw**-0.5), r(d, sc=0.1), 1.0 + r(d, sc=0.1),
              r(d, sc=0.1), r(d, d, sc=d**-0.5).to(dtype), r(d, sc=0.1))
    return x, params, r(b, t, d).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,d,kw,causal,rate", [(3, 37, 96, 7, False, 0.0),
                                                  (2, 70, 128, 31, True, 0.3),
                                                  (2, 150, 256, 31, False, 0.1)])
def test_conv_module_kernels_match_plain(cuda, dtype, b, t, d, kw, causal, rate):
    x, params, gout = _conv_case(cuda, dtype, b, t, d, kw)
    seed = torch.tensor([913], dtype=torch.int32, device=cuda)
    kwargs = dict(rate=rate, causal=causal)
    f0, b0 = conv_module.launches, conv_module_bwd.launches
    out = conv_module(x, *params, seed, **kwargs)
    ref = conv_module_plain(x, *params, seed, **kwargs)
    bwd_in = params[:-1]  # not b2
    grads = conv_module_bwd(x, *bwd_in, seed, gout, **kwargs)
    refs = conv_module_bwd_plain(x, *bwd_in, seed, gout, **kwargs)
    torch.cuda.synchronize()
    assert (conv_module.launches, conv_module_bwd.launches) == (f0 + 1, b0 + 1)
    assert out.dtype == dtype and _rel(out, ref) <= FUSED_TOL[dtype]
    names = ("dx", "dln_s", "dln_b", "dw1", "db1", "ddw_w", "ddw_b", "dln2_s", "dln2_b",
             "dw2", "db2")
    for name, a, r in zip(names, grads, refs):
        assert a.dtype == r.dtype and a.shape == r.shape, name
        assert _rel(a, r) <= FUSED_GRAD_TOL[dtype], (name, _rel(a, r))


def test_fused_functions_grads_match_plain(cuda):
    x, p, gout = _ffn_case(cuda, torch.float32, 2, 50, 128, 256)
    xc, pc, _ = _conv_case(cuda, torch.float32, 2, 50, 128, 15)
    seed = torch.tensor([3], dtype=torch.int32, device=cuda)
    grads = []
    for plain in (False, True):
        leaves = [v.clone().requires_grad_() for v in (x, *p, xc, *pc)]
        out = fused_ffn(*leaves[:7], seed, rate=0.2, plain=plain)
        out2 = fused_conv_module(*leaves[7:], seed, rate=0.2, causal=True, plain=plain)
        ((out + out2) * gout).sum().backward()
        grads.append([v.grad for v in leaves])
    for a, b in zip(*grads):
        assert _rel(a, b) <= 1e-4


def _bwd_run(module, x, params, seed, gout, **kw):
    """One backward of ``module`` ("ffn" or "conv") on the kernel."""
    if module == "ffn":
        return ffn_bwd(x, *params[:5], seed, gout, **kw)
    return conv_module_bwd(x, *params[:9], seed, gout, **kw)


def _bwd_plain(module, x, params, seed, gout, **kw):
    if module == "ffn":
        return ffn_bwd_plain(x, *params[:5], seed, gout, **kw)
    return conv_module_bwd_plain(x, *params[:9], seed, gout, **kw)


def _bwd_case(cuda, module, b, t, d, f_or_kw):
    case = _ffn_case if module == "ffn" else _conv_case
    return case(cuda, torch.bfloat16, b, t, d, f_or_kw)


_BWD_WRAPPER = {"ffn": ffn_bwd, "conv": conv_module_bwd}


@pytest.mark.parametrize("module, b, t, d, f_or_kw, extra", [
    # B*T' = 129 (not a multiple of 128), F = 264 (not of 256), D = 136 (not
    # of the 64-deep k-step)
    ("ffn", 3, 43, 136, 264, {}),
    ("conv", 3, 43, 136, 7, {}),
    ("conv", 3, 43, 136, 31, {"causal": True}),
    # the recipe's shapes
    ("ffn", 64, 313, 1024, 2048, {}),
    ("conv", 64, 313, 1024, 31, {}),
    ("conv", 64, 313, 1024, 31, {"causal": True}),
])
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_fused_bwd_sm90_body_matches_plain(cuda, module, b, t, d, f_or_kw, extra, rate):
    """The bf16 backwards on the sm90 body (TMA + wgmma), every gradient
    against the plain version within the tolerances of the tile body;
    reruns bit-equal."""
    x, params, gout = _bwd_case(cuda, module, b, t, d, f_or_kw)
    seed = torch.tensor([41], dtype=torch.int32, device=cuda)
    wrapper = _BWD_WRAPPER[module]
    before = dict(wrapper.launches_by_body)
    grads = _bwd_run(module, x, params, seed, gout, rate=rate, **extra)
    again = _bwd_run(module, x, params, seed, gout, rate=rate, **extra)
    refs = _bwd_plain(module, x, params, seed, gout, rate=rate, **extra)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in wrapper.launches_by_body.items()} == {"sm90": 2,
                                                                              "tile": 0}
    for i, (a, a2, r) in enumerate(zip(grads, again, refs)):
        assert a.dtype == r.dtype and a.shape == r.shape, i
        assert torch.equal(a, a2), i
        assert _rel(a, r) <= FUSED_GRAD_TOL[torch.bfloat16], (i, _rel(a, r))


@pytest.mark.parametrize("module", ["ffn", "conv"])
def test_fused_bwd_bodies_by_dtype_and_shape(cuda, module):
    """bf16 with widths that are multiples of 8 runs on sm90, float32 and a
    bf16 D of 100 on the tile body; body="tile" forces the tile body, which
    stays within the tolerance of the plain version; body="sm90" where it
    cannot run raises."""
    wrapper = _BWD_WRAPPER[module]
    seed = torch.tensor([5], dtype=torch.int32, device=cuda)
    cases = [(torch.bfloat16, 96, {}, "sm90"), (torch.float32, 96, {}, "tile"),
             (torch.bfloat16, 100, {}, "tile"),
             (torch.bfloat16, 96, {"body": "tile"}, "tile")]
    for dtype, d, kw, body in cases:
        case = _ffn_case if module == "ffn" else _conv_case
        x, params, gout = case(cuda, dtype, 2, 37, d, 200 if module == "ffn" else 7)
        before = dict(wrapper.launches_by_body)
        grads = _bwd_run(module, x, params, seed, gout, rate=0.2, **kw)
        refs = _bwd_plain(module, x, params, seed, gout, rate=0.2)
        torch.cuda.synchronize()
        assert {k: v - before[k] for k, v in wrapper.launches_by_body.items()} == {
            b: int(b == body) for b in before}, (dtype, d, kw)
        for a, r in zip(grads, refs):
            assert _rel(a, r) <= FUSED_GRAD_TOL[dtype]
    x, params, gout = (_ffn_case if module == "ffn" else _conv_case)(
        cuda, torch.float32, 2, 37, 96, 200 if module == "ffn" else 7)
    with pytest.raises(ValueError, match="sm90"):
        _bwd_run(module, x, params, seed, gout, body="sm90")


def _fwd_run(module, x, params, seed, **kw):
    """One forward of ``module`` ("ffn" or "conv") on the kernel."""
    return (ffn if module == "ffn" else conv_module)(x, *params, seed, **kw)


def _fwd_plain(module, x, params, seed, **kw):
    return (ffn_plain if module == "ffn" else conv_module_plain)(x, *params, seed, **kw)


_FWD_WRAPPER = {"ffn": ffn, "conv": conv_module}


@pytest.mark.parametrize("module, b, t, d, f_or_kw, extra", [
    # B*T' = 129, F = 264, D = 136 (a ragged channel tile of the window kernel)
    ("ffn", 3, 43, 136, 264, {}),
    ("conv", 3, 43, 136, 7, {}),
    ("conv", 3, 43, 136, 31, {"causal": True}),
    ("conv", 2, 70, 136, 63, {"causal": True}),  # the window kernel's largest taps
    # the recipe's shapes
    ("ffn", 64, 313, 1024, 2048, {}),
    ("conv", 64, 313, 1024, 31, {}),
    ("conv", 64, 313, 1024, 31, {"causal": True}),
])
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_fused_fwd_sm90_body_matches_plain(cuda, module, b, t, d, f_or_kw, extra, rate):
    """The bf16 forwards on the sm90 body (TMA + wgmma, the wide window
    kernel) against the plain version within FUSED_TOL; reruns bit-equal."""
    x, params, _ = _bwd_case(cuda, module, b, t, d, f_or_kw)
    seed = torch.tensor([41], dtype=torch.int32, device=cuda)
    wrapper = _FWD_WRAPPER[module]
    before = dict(wrapper.launches_by_body)
    out = _fwd_run(module, x, params, seed, rate=rate, **extra)
    again = _fwd_run(module, x, params, seed, rate=rate, **extra)
    ref = _fwd_plain(module, x, params, seed, rate=rate, **extra)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in wrapper.launches_by_body.items()} == {"sm90": 2,
                                                                              "tile": 0}
    assert out.dtype == ref.dtype and torch.equal(out, again)
    assert _rel(out, ref) <= FUSED_TOL[torch.bfloat16], _rel(out, ref)


@pytest.mark.parametrize("module", ["ffn", "conv"])
def test_fused_fwd_bodies_by_dtype_and_shape(cuda, module):
    """bf16 with widths that are multiples of 8 runs on sm90, float32 and a
    bf16 D of 100 on the tile body; body="tile" forces the tile body within
    the plain version's tolerance; body="sm90" where it cannot run raises."""
    wrapper = _FWD_WRAPPER[module]
    seed = torch.tensor([5], dtype=torch.int32, device=cuda)
    case = _ffn_case if module == "ffn" else _conv_case
    cases = [(torch.bfloat16, 96, {}, "sm90"), (torch.float32, 96, {}, "tile"),
             (torch.bfloat16, 100, {}, "tile"),
             (torch.bfloat16, 96, {"body": "tile"}, "tile")]
    for dtype, d, kw, body in cases:
        x, params, _ = case(cuda, dtype, 2, 37, d, 200 if module == "ffn" else 7)
        before = dict(wrapper.launches_by_body)
        out = _fwd_run(module, x, params, seed, rate=0.2, **kw)
        ref = _fwd_plain(module, x, params, seed, rate=0.2)
        torch.cuda.synchronize()
        assert {k: v - before[k] for k, v in wrapper.launches_by_body.items()} == {
            b: int(b == body) for b in before}, (dtype, d, kw)
        assert _rel(out, ref) <= FUSED_TOL[dtype]
    x, params, _ = case(cuda, torch.float32, 2, 37, 96, 200 if module == "ffn" else 7)
    with pytest.raises(ValueError, match="sm90"):
        _fwd_run(module, x, params, seed, body="sm90")


def test_conv_sm90_window_stages_unaligned_taps(cuda):
    """Taps whose pointer is off 16 bytes take the window kernel's scalar
    staging: the same bits as aligned taps, on the sm90 body."""
    x, params, _ = _conv_case(cuda, torch.bfloat16, 2, 70, 136, 31)
    seed = torch.tensor([8], dtype=torch.int32, device=cuda)
    buf = torch.empty(params[4].numel() + 4, device=cuda)
    taps = buf[1:1 + params[4].numel()].view(params[4].shape)
    taps.copy_(params[4])
    assert taps.data_ptr() % 16 and taps.is_contiguous()
    before = dict(conv_module.launches_by_body)
    for rate in (0.0, 0.3):
        out = conv_module(x, *params, seed, rate=rate, causal=True)
        odd = conv_module(x, *params[:4], taps, *params[5:], seed, rate=rate, causal=True)
        torch.cuda.synchronize()
        assert torch.equal(out, odd)
    assert conv_module.launches_by_body["sm90"] - before["sm90"] == 4


def test_fused_kernels_refuse_unsupported_shapes(cuda):
    x, (sc, bi, w1, b1, w2, b2), _ = _ffn_case(cuda, torch.float32, 1, 8, 32, 64)
    seed = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="w1"):
        ffn(x, sc, bi, w1.bfloat16(), b1, w2, b2, seed)
    with pytest.raises(ValueError, match="seed"):
        ffn(x, sc, bi, w1, b1, w2, b2, seed.cpu())
    xc, pc, _ = _conv_case(cuda, torch.float32, 1, 8, 32, 65)
    with pytest.raises(ValueError, match="taps"):
        conv_module(xc, *pc, seed)


# ------------------------------------------------- fused Adam, projection matmul

from neural_speech_decoder_tpu_torch.ops.kernels.adam import (  # noqa: E402
    adam_scalars,
    adam_update,
    adam_update_plain,
)
from neural_speech_decoder_tpu_torch.ops.kernels.matmul import (  # noqa: E402
    ProjectionMatmul,
    tiled_matmul,
    tiled_matmul_plain,
)
from neural_speech_decoder_tpu_torch.training.optim import FusedAdam  # noqa: E402

ADAM_HYPER = dict(lr=0.02, b1=0.9, b2=0.999, eps=0.1, l2=1e-3)


def _adam_leaves(cuda, sizes, seed=3):
    """(g, p, m, v) per size; the last leaf is a view one float past an
    aligned start (not 16-byte aligned), so it takes the scalar path."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    leaves = []
    for i, n in enumerate(sizes):
        quad = [torch.randn((n + 1,), generator=g, device=cuda) for _ in range(4)]
        quad[3] = quad[3].abs()
        leaves.append([q[1:] if i == len(sizes) - 1 else q[:n] for q in quad])
    return leaves


def test_adam_kernel_matches_plain(cuda):
    """One launch per 48 leaves, any size (ragged ends, an unaligned leaf):
    the same float32 operations, each rounded once, as the plain version."""
    sizes = [7, 41, 4096, 4097, 3000, 1] + [130] * 44
    ref = _adam_leaves(cuda, sizes)
    got = [[t.clone() for t in quad] for quad in ref]
    c1, c2 = adam_scalars(2, 0.9, 0.999)
    before = adam_update.launches
    adam_update(*zip(*got), c1=c1, c2=c2, **ADAM_HYPER)
    adam_update_plain(*zip(*ref), c1=c1, c2=c2, **ADAM_HYPER)
    torch.cuda.synchronize()
    assert adam_update.launches == before + 2  # 50 leaves
    for a, b in zip(got, ref):
        for x, y, tol in zip(a[1:], b[1:], (1e-6, 1e-7, 1e-7)):
            assert (x - y).abs().max().item() <= tol


def test_fused_adam_steps_on_the_kernel(cuda):
    g = torch.Generator(device=cuda).manual_seed(4)
    ps = [torch.nn.Parameter(torch.randn(s, generator=g, device=cuda))
          for s in ((64, 96), (5,), (3, 7))]
    ref = [p.detach().clone() for p in ps]
    m, v = [torch.zeros_like(p) for p in ref], [torch.zeros_like(p) for p in ref]
    opt = FusedAdam(ps, lr=0.02, eps=0.1, weight_decay=1e-3)
    before = adam_update.launches
    for step in range(3):
        grads = [torch.randn(p.shape, generator=g, device=cuda) for p in ps]
        for p, gr in zip(ps, grads):
            p.grad = gr
        opt.step()
        c1, c2 = adam_scalars(step, 0.9, 0.999)
        adam_update_plain(grads, ref, m, v, c1=c1, c2=c2, **ADAM_HYPER)
    torch.cuda.synchronize()
    assert adam_update.launches == before + 3
    for p, r in zip(ps, ref):
        assert (p.detach() - r).abs().max().item() <= 1e-6


MM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0**-7}


def _mm_case(cuda, kind, dtype, m=1000, k=136, n=72):
    g = torch.Generator(device=cuda).manual_seed(5)
    shapes = {"nn": ((m, k), (k, n)), "nt": ((m, n), (k, n)), "tn": ((m, k), (m, n))}[kind]
    return [torch.randn(s, generator=g, device=cuda).to(dtype) for s in shapes]


def _by_body_since(before):
    return {k: v - before[k] for k, v in tiled_matmul.launches_by_body.items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind, bias", [("nn", True), ("nn", False), ("nt", False),
                                        ("tn", False)])
@pytest.mark.parametrize("m, k, n", [(1000, 136, 72), (1001, 2048, 384), (333, 2044, 136)])
def test_matmul_kernel_matches_plain(cuda, dtype, kind, bias, m, k, n):
    """Ragged M=1000, K=136, N=72 (no dim a multiple of the 128 tile), M=1001
    with K=2048, and K=2044 (4 mod 8: a stride TMA cannot take in bf16, a
    ragged last k slab in float32). Float32 takes the pipelined f32 body in
    every layout, bf16 the sm90 body unless K=2044 (the tile body); reruns
    bit-equal."""
    a, b = _mm_case(cuda, kind, dtype, m=m, k=k, n=n)
    cols = {"nn": n, "nt": k, "tn": n}[kind]
    bb = torch.randn((cols,), device=cuda) if bias else None
    body = "f32" if dtype == torch.float32 else "tile" if k % 8 else "sm90"
    before = tiled_matmul.launches
    by_body = dict(tiled_matmul.launches_by_body)
    out = tiled_matmul(a, b, kind=kind, bias=bb)
    ref = tiled_matmul_plain(a, b, kind=kind, bias=bb)
    again = tiled_matmul(a, b, kind=kind, bias=bb)
    torch.cuda.synchronize()
    assert tiled_matmul.launches == before + 2
    assert _by_body_since(by_body) == {key: 2 * (key == body) for key in by_body}
    assert out.dtype == dtype and out.shape == ref.shape and torch.equal(out, again)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= MM_TOL[dtype] * ref.float().abs().max().item(), err


@pytest.mark.parametrize("kind, bias", [("nn", True), ("nn", False), ("nt", False),
                                        ("tn", False)])
@pytest.mark.parametrize("m, k, n", [(40, 72, 264), (1001, 200, 136), (300, 2048, 384)])
def test_matmul_sm90_body_matches_plain(cuda, kind, bias, m, k, n):
    """bfloat16 products on the sm90 body (TMA + wgmma): M < 64, M ragged
    against the 128-row block tile, K not a multiple of the 64-deep k-step
    (each layout contracts over a different one of m, k, n), all three
    layouts; reruns bit-equal."""
    a, b = _mm_case(cuda, kind, torch.bfloat16, m=m, k=k, n=n)
    cols = {"nn": n, "nt": k, "tn": n}[kind]
    bb = torch.randn((cols,), device=cuda) if bias else None
    before = dict(tiled_matmul.launches_by_body)
    out = tiled_matmul(a, b, kind=kind, bias=bb)
    ref = tiled_matmul_plain(a, b, kind=kind, bias=bb)
    again = tiled_matmul(a, b, kind=kind, bias=bb)
    torch.cuda.synchronize()
    assert _by_body_since(before) == {"sm90": 2, "f32": 0, "tile": 0}
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape and torch.equal(out, again)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= MM_TOL[torch.bfloat16] * ref.float().abs().max().item(), err


@pytest.mark.parametrize("dtype, k", [(torch.bfloat16, 130), (torch.float32, 134)])
def test_matmul_tile_body_takes_what_tma_cannot(cuda, dtype, k):
    """A bf16 row stride that is not a multiple of 8 (K=130), and a float32
    one that is not a multiple of 4 (K=134: the f32 body's 16-byte copies
    cannot read it), take the tile body of gemm_tile.cuh."""
    a, b = _mm_case(cuda, "nn", dtype, m=100, k=k, n=72)
    before = dict(tiled_matmul.launches_by_body)
    out = tiled_matmul(a, b, kind="nn")
    ref = tiled_matmul_plain(a, b, kind="nn")
    torch.cuda.synchronize()
    assert _by_body_since(before) == {"sm90": 0, "f32": 0, "tile": 1}
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= MM_TOL[dtype] * ref.float().abs().max().item(), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_projection_matmul_function_grads_match_plain(cuda, dtype):
    x, w = _mm_case(cuda, "nn", dtype, m=333, k=256, n=384)
    bias = torch.randn((384,), device=cuda)
    cot = torch.randn((333, 384), device=cuda).to(dtype)
    outs = []
    for plain in (False, True):
        leaves = [t.clone().requires_grad_() for t in (x, w, bias)]
        y = ProjectionMatmul.apply(*leaves, plain)
        y.backward(cot)
        outs.append([y.detach()] + [t.grad for t in leaves])
    for got, ref in zip(*outs):
        assert got.dtype == ref.dtype
        tol = 1e-5 if ref.dtype == torch.float32 else MM_TOL[dtype]
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= tol * ref.float().abs().max().item(), err


# sha256 of the sm90 body's bf16 output (its int16 bits) at row 16's shapes,
# M=20032, K=2048, N=6144, on the numpy-seeded operands of _row16_operands,
# as the body computed it before gemm_sm90.cuh took an epilogue functor: the
# bias + bf16 store is now one instance of that functor, and its bits must
# not move.
SM90_ROW16_SHA256 = {
    "nn": "720f5376a65621eb23ed7da700ec9faf9a104951ef49d10246579cffa1fb6e66",
    "nt": "ab7334375c2111e78164a4e1492526582c0d5ea0d4174738e6c481407fbb7639",
    "tn": "996a67dbef110eebc68c287e95e059402538bfe3b52940fa81b8af486a887d34",
}


def _row16_operands(kind, device):
    m, k, n = 20032, 2048, 6144
    rng = np.random.default_rng(16)
    shapes = {"nn": ((m, k), (k, n)), "nt": ((m, n), (k, n)), "tn": ((m, k), (m, n))}[kind]
    a, b = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(device)
            .to(torch.bfloat16) for s in shapes)
    bias = (torch.from_numpy(rng.standard_normal(n, dtype=np.float32)).to(device)
            if kind == "nn" else None)
    return a, b, bias


def row16_digest(kind, device) -> str:
    """The sm90 body's output at row 16's shapes, as a sha256 of its bits."""
    a, b, bias = _row16_operands(kind, device)
    before = dict(tiled_matmul.launches_by_body)
    out = tiled_matmul(a, b, kind=kind, bias=bias)
    torch.cuda.synchronize()
    assert _by_body_since(before) == {"sm90": 1, "f32": 0, "tile": 0}
    return hashlib.sha256(out.view(torch.int16).cpu().numpy().tobytes()).hexdigest()


@pytest.mark.parametrize("kind", ["nn", "nt", "tn"])
def test_matmul_sm90_bits_unchanged_by_epilogue_functor(cuda, kind):
    assert row16_digest(kind, cuda) == SM90_ROW16_SHA256[kind]


# ------------------------------------- the serving kernels as operators

from neural_speech_decoder_tpu_torch.models.api import build_model  # noqa: E402
from neural_speech_decoder_tpu_torch.ops.kernels import library  # noqa: E402
from neural_speech_decoder_tpu_torch.serving import (  # noqa: E402
    export_inference,
    load_exported,
)
from neural_speech_decoder_tpu_torch.serving.model import InferenceModel  # noqa: E402
from neural_speech_decoder_tpu_torch.training import checkpoints  # noqa: E402


def _op_case(cuda, name, dtype):
    """Small ragged inputs of each operator on the card; ``(args, wrapper,
    plain, tolerance check)``."""
    g = torch.Generator(device=cuda).manual_seed(6)
    r = lambda *s, sc=1.0: sc * torch.randn(s, generator=g, device=cuda)
    seed = torch.tensor([41], dtype=torch.int32, device=cuda)
    if name == "fused_frontend":
        args = (r(3, 37, 130).to(dtype), torch.eye(130, device=cuda) + r(4, 130, 130, sc=0.05),
                r(4, 130, sc=0.1), torch.tensor([-1, 3, 9], dtype=torch.int32, device=cuda),
                20, 2.0)
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        return (args, fused_frontend, fused_frontend_plain,
                lambda a, b: (a.float() - b.float()).abs().max().item() <= tol)
    if name == "gru_sequence":
        args = (r(9, 2, 37, 120).to(dtype), r(2, 40, 120, sc=0.2), r(2, 120, sc=0.1))
        tol = 1e-5 if dtype == torch.float32 else 2e-2
        return (args, gru_sequence, gru_sequence_plain,
                lambda a, b: (a.float() - b.float()).abs().max().item() <= tol)
    if name == "projection_matmul":
        args = (r(37, 136).to(dtype), r(136, 200, sc=0.1).to(dtype), r(200, sc=0.1))
        return (args, tiled_matmul, tiled_matmul_plain, lambda a, b: (
            (a.float() - b.float()).abs().max().item()
            <= MM_TOL[dtype] * b.float().abs().max().item()))
    check = lambda a, b: _rel(a, b) <= FUSED_TOL[dtype]
    if name == "mhsa_qkv":
        args = (r(3, 130, 3 * 2 * 64).to(dtype),
                torch.tensor([130, 5, 64], dtype=torch.int32, device=cuda), seed, 2, 0.3, 40,
                True)
        return (args, mhsa_qkv, mhsa_qkv_plain, lambda a, b: _rel(a, b) <= ATTN_TOL[dtype])
    if name == "ffn":
        x, params, _ = _ffn_case(cuda, dtype, 3, 37, 96, 200)
        return (x, *params, seed, 0.3), ffn, ffn_plain, check
    x, params, _ = _conv_case(cuda, dtype, 2, 70, 128, 31)
    return (x, *params, seed, 0.3, True), conv_module, conv_module_plain, check


def _call(fn, name, args):
    """A wrapper or plain version called as the operator is."""
    if name == "fused_frontend":
        return fn(*args[:4], kernel_size=args[4], sigma=args[5])
    if name == "gru_sequence":
        return fn(*args)
    if name == "projection_matmul":
        return fn(*args[:2], kind="nn", bias=args[2])
    if name == "mhsa_qkv":
        return fn(*args[:3], num_heads=args[3], rate=args[4], left_context=args[5],
                  interleaved=args[6])
    if name == "ffn":
        return fn(*args[:8], rate=args[8])
    return fn(*args[:12], rate=args[12], causal=args[13])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(library.OPS))
def test_operator_launches_its_kernel(cuda, name, dtype):
    """``torch.ops.nsd_torch.<name>`` on CUDA tensors launches the kernel
    once (the wrapper's count), gives the wrapper's bits, and matches the
    plain version within the kernel tests' tolerance."""
    args, wrapper, plain, close = _op_case(cuda, name, dtype)
    before = wrapper.launches
    out = getattr(torch.ops.nsd_torch, name)(*args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert torch.equal(out, _call(wrapper, name, args))
    assert out.dtype == dtype and close(out, _call(plain, name, args))


def test_operator_refuses_host_input_beside_card_input(cuda):
    """The CUDA implementation never runs the twin: a CPU x beside CUDA
    weights raises."""
    args, *_ = _op_case(cuda, "gru_sequence", torch.float32)
    with pytest.raises(ValueError, match="not on the card"):
        torch.ops.nsd_torch.gru_sequence(args[0].cpu(), *args[1:])


_EXPORT_ARGS = {
    "gru": {"nInputFeatures": 32, "nClasses": 40, "nUnits": 64, "nLayers": 2,
            "dropout": 0.0, "strideLen": 4, "kernelLen": 32, "gaussianSmoothWidth": 2.0,
            "bidirectional": True},
    "conformer": {"model_type": "transformer_ctc", "nInputFeatures": 32, "nClasses": 40,
                  "frontend_dim": 64, "latent_dim": 128, "autoencoder_hidden_dim": 64,
                  "transformer_num_layers": 2, "transformer_n_heads": 2,
                  "transformer_dim_ff": 256, "conformer_conv_kernel": 7,
                  "fused_ffn": True, "fused_conv": True},
}
# K = 2 * 64 and N = 3 * 64 * 2, multiples of 128: layer 1 takes the kernel
_EXPORT_ARGS["gru-matmul"] = {**_EXPORT_ARGS["gru"], "use_pallas_matmul": True}


@pytest.mark.parametrize("family, per_request", [
    ("gru", {"frontend": 1, "gru_scan": 2}),
    ("gru-matmul", {"frontend": 1, "gru_scan": 2, "tiled_matmul": 1}),
    ("conformer", {"mhsa_qkv": 2, "ffn": 4, "conv_module": 2}),
])
def test_cuda_export_launches_the_kernels(cuda, tmp_path, family, per_request):
    """A bf16 CUDA export of each family: a request of the loaded artifact
    launches the serving kernels as the eager forward does (the counts
    above, nothing else; with ``use_pallas_matmul`` layer 1's projection
    too), and gives the eager ``InferenceModel``'s pads and bits."""
    args = {**_EXPORT_ARGS[family], "compute_dtype": "bfloat16", "nDays": 3, "seed": 0,
            "device": "cuda", "time_multiple": 32}  # the envelope stays at T=160
    model = build_model(args, 3, cuda, 0)
    checkpoints.save_args(str(tmp_path / "run"), args)
    checkpoints.CheckpointManager(str(tmp_path / "run")).save("modelState",
                                                              {"params": model.params})
    art = load_exported(export_inference(str(tmp_path / "run"), str(tmp_path / "art"),
                                         batch_size=3, t_max=160, device="cuda"))
    assert art.meta["device"] == "cuda" and art.meta["t_max"] == 160
    eager = InferenceModel(model.params, model.cfg, cuda, batch_size=3, t_max=160)
    rng = np.random.default_rng(7)
    trials = [rng.standard_normal((n, 32)).astype(np.float32) for n in (160, 99)]
    wrappers = {"frontend": fused_frontend, "gru_scan": gru_sequence, "mhsa_qkv": mhsa_qkv,
                "ffn": ffn, "conv_module": conv_module, "ffn_bwd": ffn_bwd,
                "conv_module_bwd": conv_module_bwd, "mhsa_qkv_bwd": mhsa_qkv_bwd,
                "tiled_matmul": tiled_matmul}
    batch, ref_batch = art.pad_batch(trials, days=[2, 1]), eager.pad_batch(trials, days=[2, 1])
    assert all(torch.equal(a, b) for a, b in zip(batch, ref_batch))
    before = {k: w.launches for k, w in wrappers.items()}
    lp, out_lens = art(*batch)
    torch.cuda.synchronize()
    launched = {k: w.launches - before[k] for k, w in wrappers.items()}
    assert launched == {k: per_request.get(k, 0) for k in wrappers}
    ref_lp, ref_lens = eager(*ref_batch)
    assert torch.equal(lp, ref_lp) and torch.equal(out_lens, ref_lens)
    assert out_lens[2].item() == 0 and torch.isfinite(lp).all()
