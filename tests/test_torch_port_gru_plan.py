"""The GRU time scan's choice of body and the persistent backward's
contraction, in the port, on the CPU.

- ``ops/kernels/gru_scan.py::scan_plan``: bfloat16 and float32 scans whose
  slice fits run on the persistent body, the shapes that do not fit on the
  step body; a persistent plan owns every hidden unit once, in at most one
  block an SM, within the shared memory one block may hold (the H100's
  132 SMs and 227 KB) in the dtype's element size.
- On a CPU tensor the three wrappers run their plain twins and count no
  launch.
- ``hh_grads_plain``, the plain model of the contraction (dW_hh and db_hh
  from the shifted views of ys and dhp after the recurrence), against
  ``jax_scan._backward`` in interpret mode, as
  ``tests/test_torch_port_train_ops.py`` runs it: float32 within 1e-5 (the
  same float32 sums of ~L*B terms of size ~1 in another order), bfloat16
  within that file's 1e-3 (sums of the same bf16-rounded terms).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from neural_speech_decoder_tpu.ops.pallas import gru_scan as jax_scan
from neural_speech_decoder_tpu_torch.ops.kernels.gru_scan import (
    ScanPlan,
    bwd_recurrence_plain,
    gru_sequence,
    gru_sequence_bwd,
    gru_sequence_bwd_plain,
    gru_sequence_gates,
    gru_sequence_gates_plain,
    gru_sequence_plain,
    hh_grads_plain,
    scan_plan,
)

H100_SMS = 132
H100_SMEM = 232_448  # 227 KB, what one block may opt in to


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's parallel workers would otherwise
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("b", [1, 37, 64])
@pytest.mark.parametrize("h", [40, 256, 1024])
def test_scan_plan_owns_every_unit_once_within_the_card(h, b, d):
    plan = scan_plan(h, b, d, torch.bfloat16, H100_SMS, H100_SMEM)
    assert isinstance(plan, ScanPlan)
    per_dir = plan.blocks // d
    assert plan.blocks == d * per_dir and plan.blocks <= H100_SMS
    assert plan.units % 8 == 0
    owners = np.zeros(h, dtype=int)
    for k in range(per_dir):
        lo = k * plan.units
        assert lo < h  # no block without a unit
        owners[lo : lo + plan.units] += 1
    assert (owners == 1).all()
    assert max(plan.smem_fwd, plan.smem_bwd) <= H100_SMEM
    # one warp a 16-row tile and 8 units
    assert plan.threads == 32 * -(-b // 16) * (plan.units // 8) <= 512


def test_scan_plan_at_the_recipe_shape():
    # B=64, H=1024, both directions: 128 blocks of 16 units, one an SM
    plan = scan_plan(1024, 64, 2, torch.bfloat16, H100_SMS, H100_SMEM)
    assert plan == ScanPlan(units=16, blocks=128, threads=256, smem_fwd=231_168,
                            smem_bwd=168_192)


@pytest.mark.parametrize("h,b,d", [(40, 5, 1), (1024, 64, 2), (256, 37, 2),
                                   (1024, 64, 1), (128, 16, 2)])
def test_scan_plan_float32_owns_every_unit_once_within_the_card(h, b, d):
    plan = scan_plan(h, b, d, torch.float32, H100_SMS, H100_SMEM)
    assert isinstance(plan, ScanPlan)
    per_dir = plan.blocks // d
    assert plan.blocks == d * per_dir and plan.blocks <= H100_SMS and plan.units % 8 == 0
    owners = np.zeros(h, dtype=int)
    for k in range(per_dir):
        assert k * plan.units < h
        owners[k * plan.units : (k + 1) * plan.units] += 1
    assert (owners == 1).all()
    # 4-byte W slices ([3U, H] forward padded to 32 columns, [U, 3H] backward
    # padded to 64) beside each warp's chunks of the rows of its tile (8 rows
    # x 16 units, or 16 x 8 where U % 16 != 0): four of 32 columns forward,
    # two of 64 backward
    tile_rows = plan.threads // 32 * (8 if plan.units % 16 == 0 else 16)
    assert plan.smem_fwd == 4 * (3 * plan.units * -(-h // 32) * 32 + 4 * tile_rows * 32)
    assert plan.smem_bwd == 4 * (plan.units * -(-3 * h // 64) * 64 + 2 * tile_rows * 64)
    assert max(plan.smem_fwd, plan.smem_bwd) <= H100_SMEM
    assert plan.threads == 32 * -(-b // 16) * (plan.units // 8) <= 256


def test_scan_plan_float32_at_the_recipe_shape():
    # B=64, H=1024, both directions: 128 blocks of 16 units, W's slice 192
    # KiB beside 32 KiB of warp buffers; one direction (the streaming
    # config's offline forward): 128 blocks of 8 units, a 96 KiB slice
    plan = scan_plan(1024, 64, 2, torch.float32, H100_SMS, H100_SMEM)
    assert plan == ScanPlan(units=16, blocks=128, threads=256, smem_fwd=229_376,
                            smem_bwd=229_376)
    plan = scan_plan(1024, 64, 1, torch.float32, H100_SMS, H100_SMEM)
    assert plan == ScanPlan(units=8, blocks=128, threads=128, smem_fwd=131_072,
                            smem_bwd=131_072)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_scan_plan_takes_the_step_body_for_other_dtypes(dtype):
    assert scan_plan(1024, 64, 2, dtype, H100_SMS, H100_SMEM) == "step"


@pytest.mark.parametrize("h,b,sms,smem", [
    (36, 5, H100_SMS, H100_SMEM),     # H not a multiple of 8: no 16-byte rows
    (1024, 65, H100_SMS, H100_SMEM),  # h's 80 rows and W's slice overfill 227 KB
    (40, 300, H100_SMS, H100_SMEM),   # 19 row tiles: 608 threads
    (1024, 64, 2, H100_SMEM),         # 2 SMs: every unit in two blocks
    (1024, 64, H100_SMS, 100_000),    # a card with less shared memory
])
def test_scan_plan_takes_the_step_body_where_the_slice_does_not_fit(h, b, sms, smem):
    assert scan_plan(h, b, 2, torch.bfloat16, sms, smem) == "step"


@pytest.mark.parametrize("h,b,sms,smem", [
    (36, 5, H100_SMS, H100_SMEM),     # H not a multiple of 8: no 16-byte rows
    (1024, 65, H100_SMS, H100_SMEM),  # 5 row tiles x 2 unit groups: 320 threads
    (40, 300, H100_SMS, H100_SMEM),   # 19 row tiles: 608 threads
    (1024, 64, 2, H100_SMEM),         # 2 SMs: every unit in two blocks
    (1024, 64, H100_SMS, 100_000),    # a card with less shared memory
])
def test_scan_plan_float32_takes_the_step_body_where_the_slice_does_not_fit(h, b, sms, smem):
    assert scan_plan(h, b, 2, torch.float32, sms, smem) == "step"


def test_scan_plan_float32_slice_overfills_where_bfloat16_fits():
    # B=16, H=1024 on a card of 200,000 bytes a block: the float32 forward
    # needs 204,800 (a 192 KiB slice and 8 KiB of warp rings), the bf16 one
    # 132,096
    assert scan_plan(1024, 16, 2, torch.float32, H100_SMS, 200_000) == "step"
    assert isinstance(scan_plan(1024, 16, 2, torch.bfloat16, H100_SMS, 200_000), ScanPlan)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_wrappers_run_the_plain_twins_and_count_nothing(dtype):
    rng = np.random.default_rng(0)
    length, d, b, h = 5, 2, 3, 16
    xp = torch.from_numpy(rng.standard_normal((length, d, b, 3 * h), dtype=np.float32)).to(dtype)
    w = torch.from_numpy(0.3 * rng.standard_normal((d, h, 3 * h), dtype=np.float32))
    bias = torch.from_numpy(0.1 * rng.standard_normal((d, 3 * h), dtype=np.float32))
    dys = torch.from_numpy(rng.standard_normal((length, d, b, h), dtype=np.float32)).to(dtype)
    wrappers = (gru_sequence, gru_sequence_gates, gru_sequence_bwd)
    before = [(f.launches, dict(f.launches_by_body)) for f in wrappers]
    ys = gru_sequence(xp, w, bias)
    ys_g, gates = gru_sequence_gates(xp, w, bias)
    grads = gru_sequence_bwd(gates, w, ys_g, dys)
    assert torch.equal(ys, gru_sequence_plain(xp, w, bias))
    ys_p, gates_p = gru_sequence_gates_plain(xp, w, bias)
    assert torch.equal(ys_g, ys_p) and torch.equal(gates, gates_p)
    for got, want in zip(grads, gru_sequence_bwd_plain(gates, w, ys_g, dys)):
        assert torch.equal(got, want)
    assert [(f.launches, dict(f.launches_by_body)) for f in wrappers] == before


def _jax_backward(d, length, dtype):
    rng = np.random.default_rng(d)
    b, h = 5, 32
    xp = rng.standard_normal((length, d, b, 3 * h)).astype(np.float32)
    w = (rng.standard_normal((d, h, 3 * h)) * 0.2).astype(np.float32)
    bb = (rng.standard_normal((d, 3 * h)) * 0.1).astype(np.float32)
    dys = rng.standard_normal((length, d, b, h)).astype(np.float32)
    ys_j, g_j = jax_scan._forward(jnp.asarray(xp, dtype), jnp.asarray(w), jnp.asarray(bb),
                                  True, with_gates=True)
    grads = jax_scan._backward(g_j, jnp.asarray(w), ys_j, jnp.asarray(dys, dtype), True)
    to_t = lambda a, dt: torch.from_numpy(np.array(a, np.float32)).to(dt)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    return (to_t(g_j, tdt), torch.from_numpy(w), to_t(ys_j, tdt), to_t(dys, tdt)), grads


@pytest.mark.parametrize("d,length", [(1, 7), (2, 7), (2, 1)])
def test_contraction_of_the_shifted_views_matches_pallas_interpret(d, length):
    (gates, w, ys, dys), (_, dw_j, db_j) = _jax_backward(d, length, jnp.float32)
    dxp, dhp_n = bwd_recurrence_plain(gates, w, ys, dys)
    dw, db = hh_grads_plain(ys, dxp, dhp_n)
    assert dw.dtype == db.dtype == torch.float32
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_j), atol=1e-5)
    np.testing.assert_allclose(db.numpy(), np.asarray(db_j), atol=1e-5)


@pytest.mark.parametrize("d", [1, 2])
def test_contraction_of_the_shifted_views_matches_pallas_interpret_bf16(d):
    (gates, w, ys, dys), (_, dw_j, db_j) = _jax_backward(d, 7, jnp.bfloat16)
    dxp, dhp_n = bwd_recurrence_plain(gates, w, ys, dys)
    assert dxp.dtype == dhp_n.dtype == torch.bfloat16
    dw, db = hh_grads_plain(ys, dxp, dhp_n)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_j), atol=1e-3)
    np.testing.assert_allclose(db.numpy(), np.asarray(db_j), atol=1e-3)


def test_contraction_uses_only_the_rows_with_a_previous_state():
    # direction 0 pairs ys[t-1] with dhp[t], direction 1 ys[t+1] with dhp[t];
    # dhp at each direction's first scan position counts in db only
    length, d, b, h = 4, 2, 1, 8
    ys = torch.zeros((length, d, b, h))
    dxp = torch.zeros((length, d, b, 3 * h))
    dhp_n = torch.zeros((length, d, b, h))
    dxp[0, 0, 0, 0] = 1.0   # direction 0, t = 0: no previous state
    dxp[3, 1, 0, 0] = 1.0   # direction 1, t = L-1: no previous state
    ys[:, :, 0, 5] = 1.0
    dw, db = hh_grads_plain(ys, dxp, dhp_n)
    assert not dw.any()
    assert db[0, 0] == 1.0 and db[1, 0] == 1.0
    dxp[2, 0, 0, 1] = 2.0   # pairs with ys[1, 0]
    dxp[2, 1, 0, 1] = 3.0   # pairs with ys[3, 1]
    ys[1, 0, 0, 7] = 5.0
    ys[3, 1, 0, 6] = 7.0
    dw, _ = hh_grads_plain(ys, dxp, dhp_n)
    assert dw[0, 7, 1] == 10.0 and dw[0, 6, 1] == 0.0
    assert dw[1, 6, 1] == 21.0 and dw[1, 7, 1] == 0.0
