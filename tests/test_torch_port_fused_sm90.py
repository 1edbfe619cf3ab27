"""The fused FF and conv-module forwards' and backwards' choice of body, in
the port, on the CPU.

- ``ops/kernels/ffn.py::bwd_plan`` (shared by ``conv_module.py``): bfloat16
  whose widths are multiples of 8 and whose pointers are 16-byte aligned
  runs on the sm90 body (``csrc/gemm_sm90.cuh``: TMA + wgmma), float32 on
  the f32 body (``tests/test_torch_port_fused_f32.py``), every other bf16
  shape on the tile body (``csrc/gemm_tile.cuh``); the dW
  products' K ranges cover all B*T rows once and in order, and at the
  recipe's shapes their grids reach the H100's 132 SMs. The forwards ask
  the same rule through ``fwd_plan`` with their weights' shapes.
- The premise of the sm90 body: it writes each product's operand once as a
  bf16 array (xn = cdt(LN(x)), gq = cdt(gm), dsq = cdt(ds) in the FF; xn,
  s = cdt(SiLU(cdt(LN2(cq)))), gq and dhq = cdt(dh) in the conv module)
  where the tile body rounds them as it loads. A staged plain model that
  materialises those arrays in bf16, in the order the sm90 body writes
  them, and then takes float32 products of their values equals
  ``ffn_bwd_plain`` / ``conv_module_bwd_plain`` bit for bit; the forwards'
  staged models (xn, s, h, the float32 o, then the output dropout and one
  rounding) equal ``ffn_plain`` / ``conv_module_plain``.
- The sm90 bodies' window kernel (``csrc/conv_module.cu::
  glu_dwconv_wide_kernel``): a plain model of its tiling (128 channels by
  64 frames a block, 8 channels by 4 frames a thread, a ring of 4 window
  rows, the taps walked in order from -0) equals ``conv_module.py::
  _dwconv`` on gluq bit for bit, ragged T and D included.
- On a CPU tensor the forwards and backwards run their plain twins and
  count no launch.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from neural_speech_decoder_tpu_torch.ops.kernels import conv_module as conv_mod
from neural_speech_decoder_tpu_torch.ops.kernels import ffn as ffn_mod
from neural_speech_decoder_tpu_torch.ops.kernels.ffn import (
    MAX_SPLITS,
    MIN_SPLIT_LEN,
    SM90_BK,
    SM90_TILE,
    BwdPlan,
    bwd_plan,
    dw_splits,
    split_ranges,
)

H100_SMS = 132
RECIPE = dict(b=64, t=313, d=1024, f=2048)  # B, T', D, F of the Conformer recipe


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ffn_dw(d, f):
    return ((f, d), (d, f))  # dW2 [F, D], dW1 [D, F]


def _conv_dw(d):
    return ((d, d), (d, 2 * d))  # dW2 [D, D], dW1 [D, 2D]


# ---------------------------------------------------------------- the plan

@pytest.mark.parametrize("rows, dw_shapes", [
    (64 * 313, _ffn_dw(1024, 2048)),
    (64 * 313, _conv_dw(1024)),
    (3 * 43, _ffn_dw(136, 264)),
    (2 * 37, _conv_dw(96)),
])
def test_bf16_with_widths_of_eight_takes_the_sm90_body(rows, dw_shapes):
    plan = bwd_plan(torch.bfloat16, rows, dw_shapes, H100_SMS)
    assert plan.body == "sm90" and len(plan.splits) == 2
    assert all(1 <= s <= MAX_SPLITS for s in plan.splits)


@pytest.mark.parametrize("dtype, rows, dw_shapes, aligned, want", [
    # wgmma's float32 is TF32: float32 runs on the f32 body's FP32 FMA tile
    (torch.float32, 64 * 313, _ffn_dw(1024, 2048), True, BwdPlan("f32", (2, 2))),
    (torch.bfloat16, 2 * 37, _ffn_dw(100, 200), True, BwdPlan("tile")),  # D % 8 = 4
    (torch.bfloat16, 2 * 37, _ffn_dw(96, 204), True, BwdPlan("tile")),  # F % 8 = 4
    (torch.bfloat16, 2 * 37, _conv_dw(100), True, BwdPlan("tile")),
    # a pointer off 16 bytes
    (torch.bfloat16, 64 * 313, _conv_dw(1024), False, BwdPlan("tile")),
])
def test_float32_and_what_tma_cannot_read_take_the_tile_body(dtype, rows, dw_shapes,
                                                               aligned, want):
    assert bwd_plan(dtype, rows, dw_shapes, H100_SMS, aligned=aligned) == want


@pytest.mark.parametrize("k, splits", [(20032, 1), (20032, 4), (20032, 8), (20032, 16),
                                       (129, 1), (1000, 3), (64 * 5, 2)])
def test_split_ranges_cover_k_once_in_order(k, splits):
    ranges = split_ranges(k, splits)
    assert len(ranges) == splits and ranges[0][0] == 0 and ranges[-1][1] == k
    for (lo, hi), (nxt, _) in zip(ranges, ranges[1:]):
        assert hi == nxt and (hi - lo) % SM90_BK == 0  # every range but the last ends on a k-step
    assert all(hi > lo for lo, hi in ranges)


@pytest.mark.parametrize("rows, cols, k", [(2048, 1024, 20032), (1024, 2048, 20032),
                                           (1024, 1024, 20032), (264, 136, 129),
                                           (96, 200, 74), (4096, 4096, 20032),
                                           (1024, 1024, 1500)])
def test_dw_splits_ranges_hold_rows_and_are_long_enough(rows, cols, k):
    s = dw_splits(rows, cols, k, H100_SMS)
    assert 1 <= s <= MAX_SPLITS
    ranges = split_ranges(k, s)
    assert all(hi > lo for lo, hi in ranges)
    assert s == 1 or all(hi - lo >= MIN_SPLIT_LEN for lo, hi in ranges[:-1])


@pytest.mark.parametrize("module", ["ffn", "conv"])
def test_dw_grids_reach_every_sm_at_the_recipe(module):
    d, f, rows = RECIPE["d"], RECIPE["f"], RECIPE["b"] * RECIPE["t"]
    shapes = _ffn_dw(d, f) if module == "ffn" else _conv_dw(d)
    plan = bwd_plan(torch.bfloat16, rows, shapes, H100_SMS)
    for (r, c), s in zip(shapes, plan.splits):
        tiles = -(-r // SM90_TILE[0]) * -(-c // SM90_TILE[1])
        assert tiles * s >= H100_SMS, ((r, c), s)
        # whole waves: no wave less than half full
        assert (tiles * s) % H100_SMS == 0 or (tiles * s) % H100_SMS >= H100_SMS // 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_backwards_run_the_plain_twins_and_count_nothing(dtype):
    g = torch.Generator().manual_seed(0)
    b, t, d, f, kw = 2, 5, 16, 24, 3
    r = lambda *s: torch.randn(s, generator=g)  # noqa: E731
    x, gout = r(b, t, d).to(dtype), r(b, t, d).to(dtype)
    seed = torch.tensor([3], dtype=torch.int32)
    ff = (1 + r(d), r(d), r(d, f).to(dtype), r(f), r(f, d).to(dtype))
    cv = (1 + r(d), r(d), r(d, 2 * d).to(dtype), r(2 * d), r(kw, d), r(d), 1 + r(d), r(d),
          r(d, d).to(dtype))
    counts = (dict(ffn_mod.ffn_bwd.launches_by_body),
              dict(conv_mod.conv_module_bwd.launches_by_body))
    got = ffn_mod.ffn_bwd(x, *ff, seed, gout, rate=0.3, body="sm90")
    ref = ffn_mod.ffn_bwd_plain(x, *ff, seed, gout, rate=0.3)
    got_c = conv_mod.conv_module_bwd(x, *cv, seed, gout, rate=0.3, body="tile")
    ref_c = conv_mod.conv_module_bwd_plain(x, *cv, seed, gout, rate=0.3)
    assert all(torch.equal(a, b) for a, b in zip((*got, *got_c), (*ref, *ref_c)))
    assert (ffn_mod.ffn_bwd.launches_by_body,
            conv_mod.conv_module_bwd.launches_by_body) == counts


# ---------------------------------------------- the staged model of each body

def _ln_apply(x, scale, bias, cdt, silu=False):
    """A row pass of the sm90 body: the layer norm of x (float32 statistics)
    rounded to cdt, optionally cdt(SiLU) of that, as one cdt array."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((xf - mean) ** 2).mean(-1, keepdim=True) + ffn_mod.LN_EPS)
    v = ((xf - mean) * rstd * scale + bias).to(cdt)
    if silu:
        v = (v.float() * torch.sigmoid(v.float())).to(cdt)
    return v, (xf - mean) * rstd, rstd


def _mm(a, b):
    """A product of materialised operands: their float32 values."""
    return a.float() @ b.float()


def _norm_bwd(dxn, xhat, rstd, scale):
    dxhat = dxn * scale
    return rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                   - xhat * (dxhat * xhat).mean(-1, keepdim=True))


def ffn_bwd_staged(x, scale, bias, w1, b1, w2, seed, g, *, rate):
    """ffn_bwd as the sm90 body stages it: every product's operand written
    once in bf16 (xn, hq, gq, dsq), then a float32 product of its values."""
    b, t, d = x.shape
    f = w1.shape[-1]
    cdt = x.dtype
    xn, xhat, rstd = _ln_apply(x.reshape(-1, d), scale, bias, cdt)
    s = (_mm(xn, w1) + b1).to(cdt)  # the recompute's epilogue keeps s and h
    sf = s.float()
    sig = torch.sigmoid(sf)
    hq = (sf * sig).to(cdt)
    gm = g.float().reshape(-1, d)
    if rate > 0:
        m1, m2 = (m.reshape(-1, m.shape[-1])
                  for m in ffn_mod.ffn_dropout_masks_plain(b, t, d, f, seed, rate))
        hq = torch.where(m1, (hq.float() * ffn_mod.inv_keep(rate, cdt)).to(cdt), 0.0)
        gm = torch.where(m2, gm * ffn_mod.inv_keep(rate), 0.0)
    gq = gm.to(cdt)  # written by mask_grad beside gm
    dw2 = _mm(hq.T, gq).to(cdt)
    dh = _mm(gq, w2.T)
    if rate > 0:
        dh = torch.where(m1, dh * ffn_mod.inv_keep(rate), 0.0)
    ds = dh * sig * (1.0 + sf * (1.0 - sig))
    dsq = ds.to(cdt)  # written by the dh product's epilogue beside ds
    dw1 = _mm(xn.T, dsq).to(cdt)
    dxn = _mm(dsq, w1.T)
    dx = _norm_bwd(dxn, xhat, rstd, scale)
    return (dx.to(cdt).reshape(b, t, d), (dxn * xhat).sum(0), dxn.sum(0), dw1, ds.sum(0),
            dw2, gm.sum(0))


def conv_bwd_staged(x, ln_s, ln_b, w1, b1, dw_w, dw_b, ln2_s, ln2_b, w2, seed, g, *, rate,
                    causal):
    """conv_module_bwd as the sm90 body stages it: xn, hq, cq, s, gq and dhq
    written once in bf16, then float32 products of their values."""
    b, t, d = x.shape
    kw = dw_w.shape[0]
    pad_l, pad_r = conv_mod.pads(kw, causal)
    cdt = x.dtype
    xn, xhat, rstd = _ln_apply(x.reshape(-1, d), ln_s, ln_b, cdt)
    hq = (_mm(xn, w1) + b1).to(cdt)
    a, gate = hq[:, :d].float(), torch.sigmoid(hq[:, d:].float())
    glu = a * gate
    hp = F.pad(glu.to(cdt).float().reshape(b, t, d), (0, 0, pad_l, pad_r))
    c = hp[:, 0:t] * dw_w[0]
    for k in range(1, kw):
        c = c + hp[:, k:k + t] * dw_w[k]
    cq = (c + dw_b).to(cdt).reshape(-1, d)
    s, chat, rstd2 = _ln_apply(cq, ln2_s, ln2_b, cdt, silu=True)
    cnb = (chat * ln2_s + ln2_b).to(cdt).float()
    sig_s = torch.sigmoid(cnb)
    gm = g.float().reshape(-1, d)
    if rate > 0:
        keep = ffn_mod.keep_mask(seed, 0, b, t, d, rate).reshape(-1, d)
        gm = torch.where(keep, gm * ffn_mod.inv_keep(rate), 0.0)
    gq = gm.to(cdt)
    dw2 = _mm(s.T, gq).to(cdt)
    dcn = _mm(gq, w2.T) * sig_s * (1.0 + cnb * (1.0 - sig_s))
    dc = _norm_bwd(dcn, chat, rstd2, ln2_s)
    dc3 = dc.reshape(b, t, d)
    dcp = F.pad(dc3, (0, 0, pad_r, pad_l))
    dglu = dcp[:, kw - 1:kw - 1 + t] * dw_w[0]
    for k in range(1, kw):
        dglu = dglu + dcp[:, kw - 1 - k:kw - 1 - k + t] * dw_w[k]
    glup = F.pad(glu.reshape(b, t, d), (0, 0, pad_l, pad_r))
    ddw_w = torch.stack([(dc3 * glup[:, k:k + t]).sum((0, 1)) for k in range(kw)])
    dglu = dglu.reshape(-1, d)
    dh = torch.cat([dglu * gate, dglu * a * gate * (1.0 - gate)], dim=-1)
    dhq = dh.to(cdt)  # written by the depthwise conv's backward beside dh
    dw1 = _mm(xn.T, dhq).to(cdt)
    dxn = _mm(dhq, w1.T)
    dx = _norm_bwd(dxn, xhat, rstd, ln_s)
    return (dx.to(cdt).reshape(b, t, d), (dxn * xhat).sum(0), dxn.sum(0), dw1, dh.sum(0),
            ddw_w, dc.sum(0), (dcn * chat).sum(0), dcn.sum(0), dw2, gm.sum(0))


def _inputs(module, dtype, seed=7, b=2, t=9, d=16, f=40, kw=7):
    rng = np.random.default_rng(seed)
    r = lambda *s, sc=1.0: torch.from_numpy(  # noqa: E731
        (sc * rng.standard_normal(s)).astype(np.float32))
    x, g = r(b, t, d).to(dtype), r(b, t, d).to(dtype)
    if module == "ffn":
        params = (1 + r(d, sc=0.1), r(d, sc=0.1), r(d, f, sc=d**-0.5).to(dtype),
                  r(f, sc=0.1), r(f, d, sc=f**-0.5).to(dtype))
    else:
        params = (1 + r(d, sc=0.1), r(d, sc=0.1), r(d, 2 * d, sc=d**-0.5).to(dtype),
                  r(2 * d, sc=0.1), r(kw, d, sc=kw**-0.5), r(d, sc=0.1), 1 + r(d, sc=0.1),
                  r(d, sc=0.1), r(d, d, sc=d**-0.5).to(dtype))
    return x, params, torch.tensor([-123], dtype=torch.int32), g


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_staged_ffn_bwd_equals_the_plain_version_bit_for_bit(rate):
    x, params, seed, g = _inputs("ffn", torch.bfloat16)
    got = ffn_bwd_staged(x, *params, seed, g, rate=rate)
    ref = ffn_mod.ffn_bwd_plain(x, *params, seed, g, rate=rate)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.dtype == b.dtype and torch.equal(a, b), i


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("causal", [False, True])
def test_staged_conv_bwd_equals_the_plain_version_bit_for_bit(rate, causal):
    x, params, seed, g = _inputs("conv", torch.bfloat16)
    got = conv_bwd_staged(x, *params, seed, g, rate=rate, causal=causal)
    ref = conv_mod.conv_module_bwd_plain(x, *params, seed, g, rate=rate, causal=causal)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.dtype == b.dtype and torch.equal(a, b), i


# ------------------------------------------------------------ the forwards

def _fake_card(monkeypatch):
    """fwd_plan on CPU tensors: the device query answers for an H100."""
    class _Props:
        multi_processor_count = H100_SMS
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda *_: _Props())


def _weights(module, dtype, d, f=None):
    g = torch.Generator().manual_seed(1)
    if module == "ffn":
        return torch.randn(d, f, generator=g).to(dtype), torch.randn(f, d, generator=g).to(dtype)
    return (torch.randn(d, 2 * d, generator=g).to(dtype),
            torch.randn(d, d, generator=g).to(dtype))


def _unaligned(t):
    """t's values in a contiguous tensor whose data lies 2 bytes off 16."""
    buf = torch.empty(t.numel() + 8, dtype=t.dtype)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("module, d, f", [("ffn", 16, 40), ("ffn", 1024, 2048),
                                          ("conv", 16, None), ("conv", 1024, None)])
def test_forward_plan_bf16_with_widths_of_eight_takes_sm90(monkeypatch, module, d, f):
    _fake_card(monkeypatch)
    x = torch.zeros(2, 3, d, dtype=torch.bfloat16)
    weights = _weights(module, torch.bfloat16, d, f)
    assert ffn_mod.fwd_plan(module, x, *weights).body == "sm90"
    assert ffn_mod.fwd_plan(module, x, *weights, body="tile") == BwdPlan("tile")


@pytest.mark.parametrize("module, dtype, d, f, unaligned", [
    ("ffn", torch.float32, 16, 40, None),  # wgmma's float32 is TF32
    ("conv", torch.float32, 16, None, None),
    ("ffn", torch.bfloat16, 20, 40, None),  # D % 8 = 4
    ("ffn", torch.bfloat16, 16, 36, None),  # F % 8 = 4
    ("conv", torch.bfloat16, 20, None, None),
    ("ffn", torch.bfloat16, 16, 40, "x"),  # a pointer off 16 bytes
    ("conv", torch.bfloat16, 16, None, "w2"),
])
def test_forward_plan_float32_and_what_tma_cannot_read_take_tile(monkeypatch, module, dtype,
                                                                 d, f, unaligned):
    _fake_card(monkeypatch)
    x = torch.zeros(2, 3, d, dtype=dtype)
    w1, w2 = _weights(module, dtype, d, f)
    x, w2 = (_unaligned(x) if unaligned == "x" else x), (_unaligned(w2) if unaligned == "w2"
                                                         else w2)
    assert ffn_mod.fwd_plan(module, x, w1, w2) == BwdPlan("tile")
    assert ffn_mod.fwd_plan(module, x, w1, w2, body="tile") == BwdPlan("tile")
    with pytest.raises(ValueError, match="sm90"):
        ffn_mod.fwd_plan(module, x, w1, w2, body="sm90")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("body", [None, "sm90", "tile"])
def test_cpu_forwards_run_the_plain_twins_and_count_nothing(dtype, body):
    x, ff, seed, _ = _inputs("ffn", dtype)
    xc, cv, _, _ = _inputs("conv", dtype)
    b2 = torch.linspace(-0.1, 0.1, x.shape[-1])
    counts = (dict(ffn_mod.ffn.launches_by_body), dict(conv_mod.conv_module.launches_by_body),
              ffn_mod.ffn.launches, conv_mod.conv_module.launches)
    for rate in (0.0, 0.3):
        got = ffn_mod.ffn(x, *ff, b2, seed, rate=rate, body=body)
        assert torch.equal(got, ffn_mod.ffn_plain(x, *ff, b2, seed, rate=rate))
        got = conv_mod.conv_module(xc, *cv, b2, seed, rate=rate, causal=True, body=body)
        assert torch.equal(got, conv_mod.conv_module_plain(xc, *cv, b2, seed, rate=rate,
                                                           causal=True))
    assert (dict(ffn_mod.ffn.launches_by_body), dict(conv_mod.conv_module.launches_by_body),
            ffn_mod.ffn.launches, conv_mod.conv_module.launches) == counts


# The window kernel's tiling (csrc/conv_module.cu: kWideChan, kWideFrames,
# kWideTime)
WIDE_CHAN, WIDE_FRAMES, WIDE_TIME = 128, 4, 64


def wide_window_model(gluq, taps, dw_b, pad_l):
    """cq = cdt(window sums + dw_b) as glu_dwconv_wide_kernel tiles it: per
    block (128 channels, 64 frames, one batch row) a zero-padded window of
    64 + k - 1 rows; per thread 4 frames whose sums start at -0 and take the
    taps in order, each tap's window rows read from a ring of 4 (row r0 + x
    in slot x % 4, one new row a tap)."""
    b, t, d = gluq.shape
    kw = taps.shape[0]
    out = torch.empty_like(gluq)
    for c0 in range(0, d, WIDE_CHAN):
        ch = slice(c0, min(d, c0 + WIDE_CHAN))
        for t0 in range(0, t, WIDE_TIME):
            rows = WIDE_TIME + kw - 1
            win = torch.zeros(b, rows, ch.stop - c0)
            lo, hi = max(0, t0 - pad_l), min(t, t0 - pad_l + rows)
            win[:, lo - (t0 - pad_l):hi - (t0 - pad_l)] = gluq[:, lo:hi, ch].float()
            for r0 in range(0, WIDE_TIME, WIDE_FRAMES):
                if t0 + r0 >= t:
                    break
                ring = [win[:, r0 + x] for x in range(WIDE_FRAMES - 1)] + [None]
                acc = [torch.full((b, ch.stop - c0), -0.0) for _ in range(WIDE_FRAMES)]
                for k0 in range(0, kw, WIDE_FRAMES):
                    for kk in range(WIDE_FRAMES):
                        k = k0 + kk
                        if k >= kw:
                            continue
                        ring[(kk + WIDE_FRAMES - 1) % WIDE_FRAMES] = win[:, r0 + k
                                                                         + WIDE_FRAMES - 1]
                        for j in range(WIDE_FRAMES):
                            acc[j] = acc[j] + ring[(j + kk) % WIDE_FRAMES] * taps[k, ch]
                for j in range(WIDE_FRAMES):
                    if t0 + r0 + j < t:
                        out[:, t0 + r0 + j, ch] = (acc[j] + dw_b[ch]).to(gluq.dtype)
    return out


@pytest.mark.parametrize("t, d, kw, causal", [
    (313, 256, 31, False),  # the recipe's T' (a ragged last time tile), two channel tiles
    (70, 136, 31, True),  # a ragged channel tile of 8
    (37, 96, 7, False),  # one ragged tile each way
    (150, 264, 7, True),
    (5, 8, 63, True),  # the largest odd tap count, T shorter than the taps
])
def test_wide_window_tiling_equals_the_plain_dwconv(t, d, kw, causal):
    rng = np.random.default_rng(kw + t)
    b = 2
    gluq = torch.from_numpy(rng.standard_normal((b, t, d), dtype=np.float32)).to(torch.bfloat16)
    taps = torch.from_numpy(rng.standard_normal((kw, d), dtype=np.float32) * kw**-0.5)
    dw_b = torch.from_numpy(rng.standard_normal(d, dtype=np.float32) * 0.1)
    # four channels of -0 with positive taps and a -0 bias: away from the
    # padding each sum is -0, which only a sum started at -0 keeps
    gluq[1, :, :4] = -0.0
    taps[:, :4] = taps[:, :4].abs()
    dw_b[:4] = -0.0
    pad_l, pad_r = conv_mod.pads(kw, causal)
    ref = (conv_mod._dwconv(gluq, taps, pad_l, pad_r) + dw_b).to(torch.bfloat16)
    got = wide_window_model(gluq, taps, dw_b, pad_l)
    assert torch.equal(got.view(torch.int16), ref.view(torch.int16))


def ffn_fwd_staged(x, scale, bias, w1, b1, w2, b2, seed, *, rate):
    """ffn as the sm90 forward stages it: xn, s and h written once in x's
    dtype, o = h . W2 + b2 stored in float32, then dropout site 1 and one
    rounding."""
    b, t, d = x.shape
    f = w1.shape[-1]
    cdt = x.dtype
    xn, _, _ = _ln_apply(x.reshape(-1, d), scale, bias, cdt)  # the row pass
    s = (_mm(xn, w1) + b1).to(cdt)  # bias + one rounding in the product's store
    sf = s.float()
    h = (sf * torch.sigmoid(sf)).to(cdt)  # the SiLU and site-0 pass
    if rate > 0:
        m1, m2 = (m.reshape(-1, m.shape[-1])
                  for m in ffn_mod.ffn_dropout_masks_plain(b, t, d, f, seed, rate))
        h = torch.where(m1, (h.float() * ffn_mod.inv_keep(rate, cdt)).to(cdt), 0.0)
    o = _mm(h, w2) + b2  # float32 sums with the bias
    if rate > 0:  # the output pass
        o = torch.where(m2, o * ffn_mod.inv_keep(rate), 0.0)
    return o.to(cdt).reshape(b, t, d)


def conv_fwd_staged(x, ln_s, ln_b, w1, b1, dw_w, dw_b, ln2_s, ln2_b, w2, b2, seed, *, rate,
                    causal):
    """conv_module as the sm90 forward stages it: xn, hq, gluq (in the window
    kernel's shared memory), cq (its tiling) and s written once in x's
    dtype, o = s . W2 + b2 in float32, then the output dropout and one
    rounding."""
    b, t, d = x.shape
    cdt = x.dtype
    xn, _, _ = _ln_apply(x.reshape(-1, d), ln_s, ln_b, cdt)
    hq = (_mm(xn, w1) + b1).to(cdt)
    gluq = (hq[:, :d].float() * torch.sigmoid(hq[:, d:].float())).to(cdt)
    cq = wide_window_model(gluq.reshape(b, t, d), dw_w, dw_b,
                           conv_mod.pads(dw_w.shape[0], causal)[0]).reshape(-1, d)
    s, _, _ = _ln_apply(cq, ln2_s, ln2_b, cdt, silu=True)
    o = _mm(s, w2) + b2
    if rate > 0:
        keep = ffn_mod.keep_mask(seed, 0, b, t, d, rate).reshape(-1, d)
        o = torch.where(keep, o * ffn_mod.inv_keep(rate), 0.0)
    return o.to(cdt).reshape(b, t, d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_staged_ffn_fwd_equals_the_plain_version_bit_for_bit(dtype, rate):
    x, params, seed, _ = _inputs("ffn", dtype)
    b2 = torch.from_numpy(np.random.default_rng(3).standard_normal(x.shape[-1],
                                                                    dtype=np.float32))
    got = ffn_fwd_staged(x, *params, b2, seed, rate=rate)
    ref = ffn_mod.ffn_plain(x, *params, b2, seed, rate=rate)
    assert got.dtype == ref.dtype and torch.equal(got, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kw", [31, 7])
def test_staged_conv_fwd_equals_the_plain_version_bit_for_bit(dtype, rate, causal, kw):
    x, params, seed, _ = _inputs("conv", dtype, t=70, kw=kw)
    b2 = torch.from_numpy(np.random.default_rng(4).standard_normal(x.shape[-1],
                                                                    dtype=np.float32))
    got = conv_fwd_staged(x, *params, b2, seed, rate=rate, causal=causal)
    ref = conv_mod.conv_module_plain(x, *params, b2, seed, rate=rate, causal=causal)
    assert got.dtype == ref.dtype and torch.equal(got, ref)
