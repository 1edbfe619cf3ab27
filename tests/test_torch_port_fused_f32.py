"""The float32 fused FF and conv-module forwards' and backwards' f32 body,
in the port, on the CPU.

- ``ops/kernels/ffn.py::body_plan`` (shared by ``conv_module.py``):
  float32 whose widths are multiples of 4 and whose pointers are 16-byte
  aligned runs its forward and its backward on the f32 body
  (``csrc/gemm_f32.cuh``'s pipelined FP32 FMA tile), at the recipe's
  shapes and at small ones; any other float32 shape on the tile body.
  ``body=`` takes ``"f32"`` where the plan can and raises ``ValueError``
  where the dtype or shape cannot. Every call naming no body asks one of
  two hooks at call time: ``fwd_plan`` (both modules' forwards) and
  ``bwd_plan`` (both modules' backwards); replacing one leaves the other
  direction alone.
- ``f32_dw_splits``: the dW products' K ranges cover all B*T rows once, in
  order, each a multiple of the 16-deep slab, and at the recipe's shapes
  their grids fill the H100's 132 SMs at two blocks an SM in one wave.
- The f32 body's arithmetic: a plain staging of its stages (xn and, in the
  conv module, s = SiLU(LN2(cq)) written once; every product in float32,
  the dW products as the sum of their K ranges' partial products added in
  order; the element passes' math) against JAX's ``fused_ffn`` /
  ``fused_conv_module`` forward and backward run by the Pallas
  interpreter, within 1e-5 of each output's largest entry (float32 sums
  over D, F and B*T' in other orders); the staged forward's operand of
  its second product (the FF's h, the conv's s) equals the staged
  backward's front bit for bit.
"""

import contextlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from neural_speech_decoder_tpu.ops.pallas import conv_module_kernel as jax_conv
from neural_speech_decoder_tpu.ops.pallas import ffn_kernel as jax_ffn
from neural_speech_decoder_tpu_torch.ops.kernels import conv_module as conv_mod
from neural_speech_decoder_tpu_torch.ops.kernels import ffn as ffn_mod
from neural_speech_decoder_tpu_torch.ops.kernels.ffn import (
    F32_MIN_SPLIT_LEN,
    F32_SLAB,
    F32_TILE,
    MAX_SPLITS,
    BwdPlan,
    bwd_plan,
    f32_dw_splits,
    split_ranges,
)

H100_SMS = 132
RECIPE = dict(b=64, t=313, d=1024, f=2048)  # B, T', D, F of the Conformer recipe
TOL = 1e-5


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

@pytest.mark.parametrize("rows, dw_shapes, splits", [
    (64 * 313, _ffn_dw(1024, 2048), (2, 2)),
    (64 * 313, _conv_dw(1024), (4, 2)),
    (2 * 37, _ffn_dw(20, 40), (1, 1)),  # D % 8 = 4 is fine: widths of 4
    (2 * 37, _conv_dw(16), (1, 1)),
    (3 * 43, _ffn_dw(136, 264), (1, 1)),
])
def test_float32_backward_takes_the_f32_body(rows, dw_shapes, splits):
    assert bwd_plan(torch.float32, rows, dw_shapes, H100_SMS) == BwdPlan("f32", splits)


@pytest.mark.parametrize("rows, dw_shapes, aligned", [
    (2 * 37, _ffn_dw(22, 40), True),  # D % 4 = 2
    (2 * 37, _ffn_dw(20, 42), True),  # F % 4 = 2
    (2 * 37, _conv_dw(18), True),
    (64 * 313, _ffn_dw(1024, 2048), False),  # a pointer off 16 bytes
])
def test_float32_that_gemm_f32_cannot_read_takes_the_tile_body(rows, dw_shapes, aligned):
    assert bwd_plan(torch.float32, rows, dw_shapes, H100_SMS, aligned=aligned) == BwdPlan("tile")


def _fake_card(monkeypatch):
    """The plans on CPU tensors: the device query answers for an H100."""
    class _Props:
        multi_processor_count = H100_SMS
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda *_: _Props())


def _weights(module, dtype, d, f=None):
    g = torch.Generator().manual_seed(1)
    if module == "ffn":
        return torch.randn(d, f, generator=g).to(dtype), torch.randn(f, d, generator=g).to(dtype)
    return (torch.randn(d, 2 * d, generator=g).to(dtype),
            torch.randn(d, d, generator=g).to(dtype))


def _bwd_plan(module, x, w1, w2, body=None):
    """The backward's plan as ``ffn_bwd`` / ``conv_module_bwd`` ask it."""
    d = x.shape[-1]
    shapes = _ffn_dw(d, w1.shape[1]) if module == "ffn" else _conv_dw(d)
    return ffn_mod.cuda_bwd_plan(module, x, (x, w1, w2, x), shapes, body)


@pytest.mark.parametrize("module, d, f", [("ffn", 20, 40), ("ffn", 1024, 2048),
                                          ("conv", 16, None), ("conv", 1024, None)])
def test_body_f32_is_taken_and_tile_forced_and_the_forwards_stay_on_tile(monkeypatch, module,
                                                                         d, f):
    """Both directions take the f32 body, by the plan and by ``body="f32"``;
    ``body="tile"`` forces the tile body, and a forward so forced stays on
    it (the tile arm of a forwards A/B)."""
    _fake_card(monkeypatch)
    x = torch.zeros(2, 37, d)
    w1, w2 = _weights(module, torch.float32, d, f)
    got = _bwd_plan(module, x, w1, w2)
    assert got.body == "f32" and got == _bwd_plan(module, x, w1, w2, body="f32")
    assert _bwd_plan(module, x, w1, w2, body="tile") == BwdPlan("tile")
    assert ffn_mod.fwd_plan(module, x, w1, w2) == BwdPlan("f32")
    assert ffn_mod.fwd_plan(module, x, w1, w2, body="f32") == BwdPlan("f32")
    assert ffn_mod.fwd_plan(module, x, w1, w2, body="tile") == BwdPlan("tile")


def _unaligned(t):
    """t's values in a contiguous tensor whose data lies 4 bytes off 16."""
    buf = torch.empty(t.numel() + 4, dtype=t.dtype)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("module, d, f, unaligned, body", [
    ("ffn", 20, 40, None, "f32"),  # D % 8 = 4 is fine: widths of 4
    ("ffn", 1024, 2048, None, "f32"),
    ("conv", 16, None, None, "f32"),
    ("conv", 1024, None, None, "f32"),
    ("ffn", 22, 40, None, "tile"),  # D % 4 = 2
    ("ffn", 20, 42, None, "tile"),  # F % 4 = 2
    ("conv", 18, None, None, "tile"),
    ("ffn", 20, 40, "x", "tile"),  # a pointer off 16 bytes
    ("conv", 16, None, "w1", "tile"),
])
def test_float32_forward_plan(monkeypatch, module, d, f, unaligned, body):
    """Aligned float32 forwards whose widths are multiples of 4 take the f32
    body; any other float32 forward the tile body, and ``body="f32"`` there
    raises."""
    _fake_card(monkeypatch)
    x = torch.zeros(2, 37, d)
    w1, w2 = _weights(module, torch.float32, d, f)
    x, w1 = (_unaligned(x) if unaligned == "x" else x), (_unaligned(w1) if unaligned == "w1"
                                                         else w1)
    assert ffn_mod.fwd_plan(module, x, w1, w2) == BwdPlan(body)
    if body == "tile":
        with pytest.raises(ValueError, match="'f32'"):
            ffn_mod.fwd_plan(module, x, w1, w2, body="f32")


@pytest.mark.parametrize("module, dtype, d, f, body", [
    ("ffn", torch.bfloat16, 16, 40, "f32"),  # the f32 body takes float32 only
    ("conv", torch.bfloat16, 16, None, "f32"),
    ("ffn", torch.float32, 22, 40, "f32"),  # D % 4 = 2
    ("conv", torch.float32, 18, None, "f32"),
    ("ffn", torch.float32, 16, 40, "sm90"),  # wgmma's float32 is TF32
    ("conv", torch.float32, 16, None, "sm90"),
])
def test_a_body_the_dtype_or_shape_cannot_take_raises(monkeypatch, module, dtype, d, f, body):
    _fake_card(monkeypatch)
    x = torch.zeros(2, 37, d, dtype=dtype)
    w1, w2 = _weights(module, dtype, d, f)
    with pytest.raises(ValueError, match=repr(body)):
        _bwd_plan(module, x, w1, w2, body=body)


def test_a_replaced_bwd_plan_answers_every_call_naming_no_body(monkeypatch):
    """``bwd_plan`` is the hook an A/B harness replaces (``chip_smoke.py::
    fused_bwd_body``): both modules' backwards ask it; the forwards ask
    ``fwd_plan`` and keep their body."""
    _fake_card(monkeypatch)
    x = torch.zeros(2, 37, 16)
    w1, w2 = _weights("ffn", torch.float32, 16, 40)
    monkeypatch.setattr(ffn_mod, "bwd_plan", lambda *a, **k: BwdPlan("tile"))
    assert _bwd_plan("ffn", x, w1, w2) == BwdPlan("tile")
    assert _bwd_plan("conv", x, *_weights("conv", torch.float32, 16)) == BwdPlan("tile")
    assert ffn_mod.fwd_plan("ffn", x, w1, w2) == BwdPlan("f32")
    # a body the replaced plan does not give is refused
    with pytest.raises(ValueError, match="'f32'"):
        _bwd_plan("ffn", x, w1, w2, body="f32")


class _Asked(Exception):
    """Raised by a replaced ``fwd_plan`` once a forward has asked it."""


def test_a_replaced_fwd_plan_answers_both_modules_forwards(monkeypatch):
    """``fwd_plan`` is the hook an A/B harness replaces (``chip_smoke.py::
    fused_fwd_body``): the FF's and the conv module's forwards ask it at
    call time (the card path is reached here by answering ``on_cuda`` for
    the CPU tensors; the replaced plan stops the call before any launch),
    and the backwards keep ``bwd_plan``'s body."""
    _fake_card(monkeypatch)
    asked = []

    def plan(what, x, w1, w2, body=None):
        asked.append((what, body))
        raise _Asked

    monkeypatch.setattr(ffn_mod, "fwd_plan", plan)
    monkeypatch.setattr(ffn_mod, "on_cuda", lambda *_: True)
    monkeypatch.setattr(conv_mod, "on_cuda", lambda *_: True)
    monkeypatch.setattr(torch.cuda, "device", lambda *_: contextlib.nullcontext())
    x, ff, _ = _inputs("ffn", 16)
    xc, conv, _ = _inputs("conv", 16)
    seed = torch.tensor([5], dtype=torch.int32)
    with pytest.raises(_Asked):
        ffn_mod.ffn(torch.from_numpy(x), *map(torch.from_numpy, ff), seed)
    with pytest.raises(_Asked):
        conv_mod.conv_module(torch.from_numpy(xc), *map(torch.from_numpy, conv), seed,
                             body="tile")
    assert asked == [("ffn", None), ("conv_module", "tile")]
    w1, w2 = _weights("ffn", torch.float32, 16, 40)
    assert _bwd_plan("ffn", torch.zeros(2, 37, 16), w1, w2).body == "f32"


def test_backwards_count_launches_on_f32_and_forwards_do_not_have_it():
    """Every fused wrapper, forward and backward, counts its launches on
    the f32 body beside sm90 and tile."""
    for wrapper in (ffn_mod.ffn_bwd, conv_mod.conv_module_bwd, ffn_mod.ffn,
                    conv_mod.conv_module):
        assert set(wrapper.launches_by_body) == {"sm90", "f32", "tile"}


# ------------------------------------------------------ the K ranges of dW

@pytest.mark.parametrize("rows, cols, k", [(2048, 1024, 20032), (1024, 2048, 20032),
                                           (1024, 1024, 20032), (264, 136, 129),
                                           (40, 20, 74), (4096, 4096, 20032),
                                           (1024, 1024, 1500), (128, 128, 100000)])
def test_f32_dw_splits_cover_k_once_in_order_on_the_slab(rows, cols, k):
    s = f32_dw_splits(rows, cols, k, H100_SMS)
    assert 1 <= s <= MAX_SPLITS
    ranges = split_ranges(k, s, F32_SLAB)
    assert len(ranges) == s and ranges[0][0] == 0 and ranges[-1][1] == k
    for (lo, hi), (nxt, _) in zip(ranges, ranges[1:]):
        assert hi == nxt and (hi - lo) % F32_SLAB == 0
        assert hi - lo >= F32_MIN_SPLIT_LEN
    assert all(hi > lo for lo, hi in ranges)  # every range holds rows


@pytest.mark.parametrize("module", ["ffn", "conv"])
def test_f32_dw_grids_fill_the_card_in_one_wave_at_the_recipe(module):
    d, f, rows = RECIPE["d"], RECIPE["f"], RECIPE["b"] * RECIPE["t"]
    shapes = _ffn_dw(d, f) if module == "ffn" else _conv_dw(d)
    plan = bwd_plan(torch.float32, rows, shapes, H100_SMS)
    for (r, c), s in zip(shapes, plan.splits):
        blocks = -(-r // F32_TILE) * -(-c // F32_TILE) * s
        assert H100_SMS <= blocks <= 2 * H100_SMS, ((r, c), s)


# ------------------------------------------ the staged f32 body against JAX

def _ln(x, scale, bias):
    """The row pass: LN(x) with float32 statistics (rowops.cuh::row_stats),
    and xhat, rstd for the norm's backward."""
    mean = x.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((x - mean) ** 2).mean(-1, keepdim=True) + ffn_mod.LN_EPS)
    xhat = (x - mean) * rstd
    return xhat * scale + bias, xhat, rstd


def _dw(a, b, splits):
    """a^T . b over all rows as the f32 body forms it: each K range's
    partial product (gemm_f32.cuh's split tile), added in order
    (split_sum)."""
    parts = [a[lo:hi].T @ b[lo:hi] for lo, hi in split_ranges(a.shape[0], splits, F32_SLAB)]
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def _ln_bwd(dxn, xhat, rstd, scale):
    dxhat = dxn * scale
    return rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                   - xhat * (dxhat * xhat).mean(-1, keepdim=True))


def _ffn_masks(x, f, seed, rate):
    """Both dropout sites' keep masks as [B*T, F] and [B*T, D] rows."""
    b, t, d = x.shape
    return [m.reshape(-1, m.shape[-1])
            for m in ffn_mod.ffn_dropout_masks_plain(b, t, d, f, seed, rate)]


def ffn_fwd_f32_staged(x, scale, bias, w1, b1, w2, b2, seed, *, rate):
    """ffn as the f32 body stages it (csrc/ffn.cu::ffn_fwd_f32): the front
    with h written over s, then h . W2 + b2 straight into out and dropout
    site 1 in place; ``(out, h)``."""
    b, t, d = x.shape
    xn, _, _ = _ln(x.reshape(-1, d), scale, bias)  # ln_apply
    h = xn @ w1 + b1  # nn, b1 in the tile's store
    h = h * torch.sigmoid(h)  # SiluDropPass<float>, over s
    if rate > 0:
        m1, m2 = _ffn_masks(x, w1.shape[-1], seed, rate)
        h = torch.where(m1, h * ffn_mod.inv_keep(rate), 0.0)
    out = h @ w2 + b2  # nn, b2 in the tile's store
    if rate > 0:
        out = torch.where(m2, out * ffn_mod.inv_keep(rate), 0.0)  # DropRoundPass<float>
    return out.reshape(b, t, d), h


def ffn_bwd_f32_staged(x, scale, bias, w1, b1, w2, seed, g, *, rate, splits, front=None):
    """ffn_bwd as the f32 body stages it (csrc/ffn.cu::ffn_bwd_f32); its
    front's h is put in ``front`` (a dict) where one is given."""
    b, t, d = x.shape
    f = w1.shape[-1]
    xn, xhat, rstd = _ln(x.reshape(-1, d), scale, bias)  # ln_apply
    s = xn @ w1 + b1  # nn, b1 in the tile's store
    sig = torch.sigmoid(s)
    h = s * sig  # SiluDropPass<float>
    gm = g.reshape(-1, d)
    if rate > 0:
        m1, m2 = _ffn_masks(x, f, seed, rate)
        inv = ffn_mod.inv_keep(rate)
        h = torch.where(m1, h * inv, 0.0)
        gm = torch.where(m2, gm * inv, 0.0)  # mask_grad
    if front is not None:
        front["h"] = h
    dw2 = _dw(h, gm, splits[0])  # tn
    dh = gm @ w2.T  # nt
    if rate > 0:
        dh = torch.where(m1, dh * inv, 0.0)
    ds = dh * sig * (1.0 + s * (1.0 - sig))  # DsPass<float>, in place
    dw1 = _dw(xn, ds, splits[1])
    dxn = ds @ w1.T  # nt
    return (_ln_bwd(dxn, xhat, rstd, scale).reshape(b, t, d), (dxn * xhat).sum(0), dxn.sum(0),
            dw1, ds.sum(0), dw2, gm.sum(0))


def _window(glu, dw_w, dw_b, causal):
    """cq = the depthwise conv of glu [B, T, D] (glu_dwconv_kernel: the taps
    in order from tap 0, then dw_b), as [B*T, D] rows."""
    b, t, d = glu.shape
    kw = dw_w.shape[0]
    hp = F.pad(glu, (0, 0, *conv_mod.pads(kw, causal)))
    c = hp[:, 0:t] * dw_w[0]
    for k in range(1, kw):
        c = c + hp[:, k:k + t] * dw_w[k]
    return (c + dw_b).reshape(-1, d)


def conv_fwd_f32_staged(x, ln_s, ln_b, w1, b1, dw_w, dw_b, ln2_s, ln2_b, w2, b2, seed, *, rate,
                        causal):
    """conv_module as the f32 body stages it (csrc/conv_module.cu::
    conv_fwd_f32): the front, then s . W2 + b2 straight into out and the
    output dropout in place; ``(out, s)``."""
    b, t, d = x.shape
    xn, _, _ = _ln(x.reshape(-1, d), ln_s, ln_b)  # ln_apply
    hq = xn @ w1 + b1  # nn, b1 in the tile's store
    glu = hq[:, :d] * torch.sigmoid(hq[:, d:])
    cn, _, _ = _ln(_window(glu.reshape(b, t, d), dw_w, dw_b, causal), ln2_s, ln2_b)
    s = cn * torch.sigmoid(cn)  # ln_apply<float, true>
    out = s @ w2 + b2  # nn, b2 in the tile's store
    if rate > 0:  # DropRoundPass<float>, salt b
        keep = ffn_mod.keep_mask(seed, 0, b, t, d, rate).reshape(-1, d)
        out = torch.where(keep, out * ffn_mod.inv_keep(rate), 0.0)
    return out.reshape(b, t, d), s


def conv_bwd_f32_staged(x, ln_s, ln_b, w1, b1, dw_w, dw_b, ln2_s, ln2_b, w2, seed, g, *, rate,
                        causal, splits, front=None):
    """conv_module_bwd as the f32 body stages it (csrc/conv_module.cu::
    conv_bwd_f32); its front's s is put in ``front`` (a dict) where one is
    given."""
    b, t, d = x.shape
    kw = dw_w.shape[0]
    pad_l, pad_r = conv_mod.pads(kw, causal)
    xn, xhat, rstd = _ln(x.reshape(-1, d), ln_s, ln_b)
    hq = xn @ w1 + b1
    a, gate = hq[:, :d], torch.sigmoid(hq[:, d:])
    glu = a * gate
    cq = _window(glu.reshape(b, t, d), dw_w, dw_b, causal)
    cn, chat, rstd2 = _ln(cq, ln2_s, ln2_b)
    sig_s = torch.sigmoid(cn)
    s = cn * sig_s  # ln_apply<float, true>
    if front is not None:
        front["s"] = s
    gm = g.reshape(-1, d)
    if rate > 0:
        keep = ffn_mod.keep_mask(seed, 0, b, t, d, rate).reshape(-1, d)
        gm = torch.where(keep, gm * ffn_mod.inv_keep(rate), 0.0)
    dw2 = _dw(s, gm, splits[0])
    dcn = (gm @ w2.T) * sig_s * (1.0 + cn * (1.0 - sig_s))  # nt, then DcnPass<float>
    dc = _ln_bwd(dcn, chat, rstd2, ln2_s)
    dc3 = dc.reshape(b, t, d)
    dcp = F.pad(dc3, (0, 0, pad_r, pad_l))  # dwconv_bwd_kernel
    dglu = dcp[:, kw - 1:kw - 1 + t] * dw_w[0]
    for k in range(1, kw):
        dglu = dglu + dcp[:, kw - 1 - k:kw - 1 - k + t] * dw_w[k]
    glup = F.pad(glu.reshape(b, t, d), (0, 0, pad_l, pad_r))
    ddw_w = torch.stack([(dc3 * glup[:, k:k + t]).sum((0, 1)) for k in range(kw)])
    dglu = dglu.reshape(-1, d)
    dh = torch.cat([dglu * gate, dglu * a * gate * (1.0 - gate)], dim=-1)
    dw1 = _dw(xn, dh, splits[1])
    dxn = dh @ w1.T
    return (_ln_bwd(dxn, xhat, rstd, ln_s).reshape(b, t, d), (dxn * xhat).sum(0), dxn.sum(0),
            dw1, dh.sum(0), ddw_w, dc.sum(0), (dcn * chat).sum(0), dcn.sum(0), dw2, gm.sum(0))


B, T, F_FF, KW = 2, 37, 40, 7


def _inputs(module, d, seed=3):
    rng = np.random.default_rng(seed)
    r = lambda *s, sc=1.0: (sc * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    if module == "ffn":
        params = [1.0 + r(d, sc=0.1), r(d, sc=0.1), r(d, F_FF, sc=d**-0.5), r(F_FF, sc=0.1),
                  r(F_FF, d, sc=F_FF**-0.5), r(d, sc=0.1)]
    else:
        params = [1.0 + r(d, sc=0.1), r(d, sc=0.1), r(d, 2 * d, sc=d**-0.5), r(2 * d, sc=0.1),
                  r(KW, d, sc=KW**-0.5), r(d, sc=0.1), 1.0 + r(d, sc=0.1), r(d, sc=0.1),
                  r(d, d, sc=d**-0.5), r(d, sc=0.1)]
    return r(B, T, d), params, r(B, T, d)


def _jax_fn(module, rate, causal, key_int=7):
    """JAX's fused module in float32, by the Pallas interpreter, and the
    int32 seed it draws from its key (the port's seed)."""
    key = jax.random.key(key_int)
    seed = jax.random.randint(key, (1,), 0, jnp.iinfo(jnp.int32).max, dtype=jnp.int32)

    def fn(x, *p):
        if module == "ffn":
            return jax_ffn.fused_ffn(x, *p, key, dropout_rate=rate, train=rate > 0,
                                     interpret=True)
        return jax_conv.fused_conv_module(x, *p, key, dropout_rate=rate, train=rate > 0,
                                          causal=causal, interpret=True)

    return fn, torch.from_numpy(np.array(seed))


def _jax_grads(module, x, params, g, rate, causal, key_int=7):
    """JAX's fused backward (``_jax_fn``'s gradients) and the port's seed."""
    fn, seed = _jax_fn(module, rate, causal, key_int)
    _, vjp = jax.vjp(fn, jnp.asarray(x), *map(jnp.asarray, params))
    grads = vjp(jnp.asarray(g))
    return [np.asarray(v, np.float32) for v in grads], seed


def _close(got, ref, what):
    top = float(np.abs(ref).max())
    err = float(np.abs(got.numpy() - ref).max())
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape, what
    assert err <= TOL * top, (what, err, top)


# splits (dW2, dW1): 3 and 2 K ranges of B*T' = 74 rows on the 16-deep slab
# ((0, 32), (32, 64), (64, 74) and (0, 48), (48, 74)), so that the ranges'
# partial sums are exercised at these small shapes
SPLITS = (3, 2)


@pytest.mark.parametrize("d, rate", [(20, 0.0), (24, 0.3)])
def test_staged_ffn_bwd_f32_matches_jax(d, rate):
    x, params, g = _inputs("ffn", d)
    ref, seed = _jax_grads("ffn", x, params, g, rate, False)
    t = [torch.from_numpy(v) for v in (x, *params[:5])]
    got = ffn_bwd_f32_staged(*t, seed, torch.from_numpy(g), rate=rate, splits=SPLITS)
    names = ("dx", "dscale", "dbias", "dw1", "db1", "dw2", "db2")
    assert len(ref) == len(names)
    for name, a, r in zip(names, got, ref):
        _close(a, r, name)


@pytest.mark.parametrize("d, rate, causal", [(16, 0.0, False), (20, 0.3, True)])
def test_staged_conv_bwd_f32_matches_jax(d, rate, causal):
    x, params, g = _inputs("conv", d)
    ref, seed = _jax_grads("conv", x, params, g, rate, causal)
    t = [torch.from_numpy(v) for v in (x, *params[:9])]
    got = conv_bwd_f32_staged(*t, seed, torch.from_numpy(g), rate=rate, causal=causal,
                              splits=SPLITS)
    names = ("dx", "dln_s", "dln_b", "dw1", "db1", "ddw_w", "ddw_b", "dln2_s", "dln2_b",
             "dw2", "db2")
    assert len(ref) == len(names)
    for name, a, r in zip(names, got, ref):
        _close(a, r, name)


@pytest.mark.parametrize("d, rate", [(20, 0.0), (24, 0.3)])
def test_staged_ffn_fwd_f32_matches_jax_and_the_backwards_front(d, rate):
    x, params, g = _inputs("ffn", d)
    fn, seed = _jax_fn("ffn", rate, False)
    ref = np.asarray(fn(jnp.asarray(x), *map(jnp.asarray, params)), np.float32)
    t = [torch.from_numpy(v) for v in (x, *params)]
    out, h = ffn_fwd_f32_staged(*t, seed, rate=rate)
    _close(out, ref, "out")
    front = {}
    ffn_bwd_f32_staged(*t[:6], seed, torch.from_numpy(g), rate=rate, splits=SPLITS,
                       front=front)
    assert torch.equal(h, front["h"])


@pytest.mark.parametrize("d, rate, causal", [(16, 0.0, False), (20, 0.3, False),
                                             (20, 0.3, True), (16, 0.0, True)])
def test_staged_conv_fwd_f32_matches_jax_and_the_backwards_front(d, rate, causal):
    x, params, g = _inputs("conv", d)
    fn, seed = _jax_fn("conv", rate, causal)
    ref = np.asarray(fn(jnp.asarray(x), *map(jnp.asarray, params)), np.float32)
    t = [torch.from_numpy(v) for v in (x, *params)]
    out, s = conv_fwd_f32_staged(*t, seed, rate=rate, causal=causal)
    _close(out, ref, "out")
    front = {}
    conv_bwd_f32_staged(*t[:10], seed, torch.from_numpy(g), rate=rate, causal=causal,
                        splits=SPLITS, front=front)
    assert torch.equal(s, front["s"])


def test_splits_of_the_staging_are_ranges_the_kernel_takes():
    """SPLITS' ranges are what gemm_f32.cuh::gemm_split launches: each a
    multiple of the slab but the last, every one holding rows."""
    for s in SPLITS:
        ranges = split_ranges(B * T, s, F32_SLAB)
        assert ranges[-1][1] == B * T and all(hi > lo for lo, hi in ranges)
        assert all((hi - lo) % F32_SLAB == 0 for lo, hi in ranges[:-1])
