"""The operation counts against hand counts at the shapes of PERF.md's
kernel table: B=64, T=1280 (L=313 frames), C=256, H=1024, D=2, the
projection 20032 x 2048 x 6144, attention at 8 heads of 128."""

import numpy as np
import pytest

from portbench import harness
from portbench.flops import attention, conformer, fused_modules, gru, gru_scan, peaks


def _config(name):
    return harness.load_json(harness.HERE / "configs" / f"{name}.json")


def test_scan_is_252_gflop_a_layer():
    assert gru_scan.forward_ops(64, 1024, 313, 2) == pytest.approx(252.06e9, rel=1e-4)
    assert gru_scan.backward_ops(64, 1024, 313, 2) == 2 * gru_scan.forward_ops(64, 1024, 313, 2)
    # 3.762 ms at 67 TFLOP/s, bound by operations
    b = peaks.bound_s(gru_scan.forward_ops(64, 1024, 313, 2),
                      gru_scan.forward_bytes(64, 1024, 313, 2, False))
    assert b == pytest.approx(3.762e-3, rel=1e-3)


def test_gru_forward_counts_the_projections_and_scans():
    cfg = _config("gru_baseline_f32")
    total = gru.forward_flops(cfg, 64, 1280)
    projection = 2.0 * 20032 * 2048 * 6144
    assert projection == pytest.approx(504.1e9, rel=1e-4)
    layer0 = 2.0 * 20032 * 8192 * 6144
    scans = 5 * gru_scan.forward_ops(64, 1024, 313, 2)
    head = 2.0 * 20032 * 2048 * 41
    front = 2.0 * 20 * 64 * 1280 * 256 + 2.0 * 64 * 1280 * 256 * 256
    assert total == pytest.approx(layer0 + 4 * projection + scans + head + front, rel=1e-12)
    assert total == pytest.approx(5.31e12, rel=2e-3)


def test_attention_is_17_42_and_43_54_gflop():
    # the smoke's rows let 13,584 keys in over the batch (212 a row)
    lens = np.full(64, 13584 // 64)
    lens[: 13584 % 64] += 1
    assert attention.forward_ops(lens, 313, 8, 128) / 1e9 == pytest.approx(17.42, abs=0.005)
    assert attention.backward_ops(lens, 313, 8, 128) / 1e9 == pytest.approx(43.54, abs=0.005)
    # a key at or past the frame count is not counted twice
    assert attention.forward_ops([400], 313, 8, 128) == attention.forward_ops([313], 313, 8, 128)


def test_fused_modules_are_11_1_and_3_71_tflop():
    rows, d = 20032, 1024
    fwd = 2 * fused_modules.ffn_forward_ops(rows, d, 2048) + fused_modules.conv_forward_ops(rows, d, 31)
    assert 8 * fwd / 1e12 == pytest.approx(3.71, abs=0.005)
    assert 3 * 8 * fwd / 1e12 == pytest.approx(11.12, abs=0.01)


def test_conformer_forward_counts_every_block():
    cfg = _config("conformer_fused_f32")
    lens = np.full(64, 200)
    fwd = conformer.forward_flops(cfg, 64, 1280, lens, False)
    train = conformer.forward_flops(cfg, 64, 1280, lens, True)
    assert train - fwd == pytest.approx(2.0 * 20032 * 1024 * 41)
    assert 5.0e12 < fwd < 5.5e12
