"""The per-layer readers on a synthetic timeline whose kernels overlap."""

import numpy as np
import pytest

from portbench import harness, readers
from portbench.trace import Run, Timeline

MS = 1_000_000  # ns

# kernel names as the profiler gives them on the card
GRU_FWD = "void (anonymous namespace)::gru_fwd_persistent_f32<true, 8>(float const*, float*, int)"
GRU_DW = "(anonymous namespace)::gru_bwd_dw_f32(float const*, float const*, float*, int, int)"
ATTN = "void (anonymous namespace)::f32::attn_bwd_dkv_f32<128>(float const*, int const*)"
GEMM_F32 = "void nsd::f32::gemm_f32_kernel<false, true, 1, false>(int, int, float const*, float*)"
EACH = "void nsd::each_cols_kernel<(anonymous namespace)::SiluDropPass<float> >(int, int)"
GLU = "void (anonymous namespace)::glu_dwconv_kernel<float>(float const*, float*, int)"
LIBRARY = [
    "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8_stage3_warpsize2x2x1_ffma_aligna4"
    "_alignc4_execute_kernel__5x_cublas",
    "sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_tilesize256x64x8_stage3"
    "_warpsize2x2x1_g1_ffma_aligna4_alignc4_execute_kernel__5x_cudnn",
    "sm80_xmma_wgrad_implicit_gemm_indexed_f32f32_f32f32_f32_nhwckrsc_nhwc_tilesize32x32x8_stage3"
    "_warpsize1x2x1_g1_ffma_execute_kernel__5x_cudnn",
    "void cutlass::Kernel2<cutlass_80_simt_sgemm_256x128_8x4_nn_align1>"
    "(cutlass_80_simt_sgemm_256x128_8x4_nn_align1::Params)",
    "void cudnn::detail::dgrad_engine<float, 512, 6, 5, 3, 3, 3, false>(int, int, int)",
    "void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float, float>(int)",
    "void at::native::gru_cell_forward<float, float, int, 1>(int)",
    "Memcpy HtoD (Pageable -> Device)",
]


def _timeline():
    # a 100 ms window; two kernels overlap (10-40 and 20-50), a copy 60-70,
    # a kernel that starts before the window and one that ends after it
    device = [(GRU_FWD, 10 * MS, 40 * MS), ("sgemm", 20 * MS, 50 * MS),
              ("Memcpy HtoD", 60 * MS, 70 * MS), (ATTN, 0, 5 * MS),
              (GEMM_F32, 95 * MS, 100 * MS)]
    host = [("feed", 50 * MS, 60 * MS), ("train_step", 0, 100 * MS)]
    return Timeline((0, 100 * MS), device, host)


def _run(kind="train", family="gru", tl=None, units=1):
    cfg = harness.load_json(harness.HERE / "configs" /
                            ("gru_baseline_f32.json" if family == "gru" else "conformer_fused_f32.json"))
    mix = harness.load_json(harness.HERE / "traffic" / "train_recipe.json")
    return Run(kind, cfg, mix, units, [np.full(64, 800)] * units,
               {"train_step": [0.01, 0.03]}, tl)


def test_overlapping_kernels_count_once():
    tl = _timeline()
    assert tl.busy_s() == pytest.approx((5 + 40 + 10 + 5) / 1e3)
    assert [(s // MS, t // MS) for s, t in tl.gaps()] == [(5, 10), (50, 60), (70, 95)]
    share = readers.idle_share(_run(tl=tl))
    assert 0.0 <= share <= 100.0 and share == pytest.approx(40.0)


def test_a_fully_busy_window_reads_zero_idle_never_below():
    tl = Timeline((0, 10 * MS), [("a", 0, 8 * MS), ("b", 2 * MS, 10 * MS)], [])
    assert readers.idle_share(_run(tl=tl)) == pytest.approx(0.0)


def test_breakdown_names_gaps_by_the_host_span():
    b = _timeline().breakdown()
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    assert b["idle_gaps"][0] == ["train_step", pytest.approx(0.025)]
    assert ["feed", pytest.approx(0.01)] in b["idle_gaps"]


@pytest.mark.parametrize("name", ["scan_roofline.train", "mfu.train", "idle_share.train"])
def test_shares_never_pass_100(name):
    # a timeline whose kernels take longer than their work's bound reads
    # under 100; the readers never clip, so a share over 100 would show
    # operations counted too high
    reader = harness.metric_reader(name)
    honest = Timeline((0, 10_000 * MS), [(GRU_FWD, 0, 9_000 * MS)], [])
    value = reader.read(_run(tl=honest))
    assert value is not None and 0.0 <= value <= 100.0


def test_a_reader_with_nothing_to_read_returns_none():
    tl = Timeline((0, 10 * MS), [("sgemm", 0, MS)], [])
    assert harness.metric_reader("scan_roofline.train").read(_run(tl=tl)) is None
    assert harness.metric_reader("fused_roofline.train").read(_run(tl=tl)) is None
    assert harness.metric_reader("attention_roofline.train").read(
        _run(family="conformer", tl=tl)) is None
    assert harness.metric_reader("pad_ms.decode").read(_run(kind="decode", tl=tl)) is None
    assert readers.idle_share(_run(tl=None)) is None


def test_span_means():
    assert harness.metric_reader("dispatch_ms.train").read(_run()) == pytest.approx(20.0)


@pytest.mark.parametrize("name", ["scan_roofline", "fused_roofline", "attention_roofline"])
def test_library_kernels_never_count_as_the_ports(name):
    # cuBLAS's and cuDNN's names hold ``gemm_f32`` and more; a roofline reads
    # the port's own kernels alone, so a window of library kernels reads nothing
    reader = harness.metric_reader(name + ".train")
    family = "gru" if name == "scan_roofline" else "conformer"
    tl = Timeline((0, 10 * MS), [(n, i * MS, (i + 1) * MS) for i, n in enumerate(LIBRARY)], [])
    assert reader.read(_run(family=family, tl=tl)) is None


@pytest.mark.parametrize("prefixes, hits", [
    (("gru_",), {GRU_FWD, GRU_DW}),
    (("attn_",), {ATTN}),
    (("gemm_f32", "each_cols", "glu_dwconv"), {GEMM_F32, EACH, GLU}),
])
def test_port_kernels_match_the_ports_names_alone(prefixes, hits):
    match = readers.port_kernels(*prefixes)
    names = [GRU_FWD, GRU_DW, ATTN, GEMM_F32, EACH, GLU, *LIBRARY]
    assert {n for n in names if match(n)} == hits


def test_fused_roofline_counts_the_stage_kernels_and_not_cublas():
    # the same window read twice, once with a cuBLAS xmma SGEMM beside the
    # port's kernels: the share is unchanged
    port = [(GEMM_F32, 0, 400 * MS), (EACH, 400 * MS, 450 * MS), (GLU, 450 * MS, 500 * MS)]
    with_library = port + [(LIBRARY[0], 500 * MS, 900 * MS), (LIBRARY[1], 900 * MS, 1000 * MS)]
    reader = harness.metric_reader("fused_roofline.decode")
    a = reader.read(_run(kind="decode", family="conformer", tl=Timeline((0, 1000 * MS), port, [])))
    b = reader.read(_run(kind="decode", family="conformer",
                         tl=Timeline((0, 1000 * MS), with_library, [])))
    assert a is not None and a == b


def test_a_family_reader_serves_both_kinds():
    assert harness.metric_reader("mfu.train").__file__ == harness.metric_reader("mfu.decode").__file__
    tl = Timeline((0, 10_000 * MS), [(GRU_FWD, 0, 9_000 * MS)], [])
    reader = harness.metric_reader("scan_roofline.decode")
    # a train step's scan does the forward and twice its work backward
    assert reader.read(_run(kind="train", tl=tl)) > 2.5 * reader.read(_run(kind="decode", tl=tl))
