"""The attention's body plan and the algorithm of its float32 body, on the CPU.

- ``attention_plan`` per dtype and head width, and ``body=`` accepted or
  refused by the wrappers (``ops/kernels/attention.py``).
- The ``"f32"`` body's residuals (``mhsa_qkv_residuals``) in plain PyTorch.
- A plain-PyTorch walk of the ``"f32"`` body's algorithm
  (``csrc/attention.cu`` namespace ``f32``), step for step: the forward in
  one walk over 64-key tiles per 64 query rows (online softmax: the running
  max, the sum and the output rescaled when it grows; keys at ``j >= T``
  score -inf, masked keys -1e9; the tiles the kernel skips skipped; dropout
  applied to ``exp(s - m)`` as it is formed), keeping each row's max and
  sum; the backward from them and ``Delta = g . out``: dK/dV per 64 keys,
  storing dS, then dQ per 64 query rows from the stored dS (NaN where the
  dK/dV walk stored none, so a block of dS that dQ reads unwritten shows).
  It is held against JAX's
  ``fused_mhsa_qkv`` and its gradient, run by the Pallas interpreter, in
  float32, within 1e-5 of each output's largest entry (float32 sums in
  another order), at 2 heads of dh 64 with dropout, a band, interleaved
  columns and rows of length 0 and 5.
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neural_speech_decoder_tpu.ops.pallas.attention_kernel import (
    fused_mhsa_qkv as jax_fused_mhsa_qkv,
)
from neural_speech_decoder_tpu_torch.ops.kernels import attention

NEG = attention.NEG
TILE = 64  # keys per tile, query rows per block
ATTN_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small CPU ops gain nothing from more, and
    the suite's parallel workers would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dh", [64, 128])
def test_attention_plan_by_dtype_and_width(dh):
    assert attention.attention_plan(torch.float32, dh) == "f32"
    assert attention.attention_plan(torch.bfloat16, dh) == "tc"
    assert attention.plan_for(torch.float32, dh) == "f32"
    with pytest.raises(ValueError, match="head widths"):
        attention.attention_plan(torch.float32, dh + 32)
    with pytest.raises(ValueError, match="no body"):
        attention.attention_plan(torch.float16, dh)


def _inputs(dtype, b=2, t=9, h=2, dh=64, seed=0):
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.standard_normal((b, t, 3 * h * dh)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((b, t, h * dh)).astype(np.float32))
    lens = torch.tensor([t, 5][:b], dtype=torch.int32)
    return qkv.to(dtype), g.to(dtype), lens, torch.tensor([77], dtype=torch.int32)


@pytest.mark.parametrize("dtype,body,ok", [
    (torch.float32, "f32", True),
    (torch.float32, "fma", True),
    (torch.float32, "tc", False),
    (torch.bfloat16, "tc", True),
    (torch.bfloat16, "f32", False),
    (torch.bfloat16, "fma", False),
    (torch.float32, "wgmma", False),
])
def test_wrappers_take_or_refuse_a_body(dtype, body, ok):
    """A body that takes the dtype runs (the plain twin, for CPU tensors,
    launching nothing); one that does not raises ValueError on any
    device."""
    qkv, g, lens, seed = _inputs(dtype)
    kw = dict(num_heads=2, rate=0.3)
    before = (attention.mhsa_qkv.launches, attention.mhsa_qkv_bwd.launches)
    if not ok:
        with pytest.raises(ValueError, match="does not take"):
            attention.mhsa_qkv(qkv, lens, seed, body=body, **kw)
        with pytest.raises(ValueError, match="does not take"):
            attention.mhsa_qkv_bwd(qkv, lens, seed, g, body=body, **kw)
        return
    out = attention.mhsa_qkv(qkv, lens, seed, body=body, **kw)
    dqkv = attention.mhsa_qkv_bwd(qkv, lens, seed, g, body=body, **kw)
    assert torch.equal(out, attention.mhsa_qkv_plain(qkv, lens, seed, **kw))
    assert torch.equal(dqkv, attention.mhsa_qkv_bwd_plain(qkv, lens, seed, g, **kw))
    assert (attention.mhsa_qkv.launches, attention.mhsa_qkv_bwd.launches) == before


def test_backward_residuals_come_both_or_not_at_all():
    qkv, g, lens, seed = _inputs(torch.float32)
    out, stats = attention.mhsa_qkv_residuals(qkv, lens, seed, num_heads=2)
    with pytest.raises(ValueError, match="both or neither"):
        attention.mhsa_qkv_bwd(qkv, lens, seed, g, num_heads=2, out=out)
    with pytest.raises(ValueError, match="both or neither"):
        attention.mhsa_qkv_bwd(qkv, lens, seed, g, num_heads=2, body="fma", out=out,
                               stats=stats)
    dqkv = attention.mhsa_qkv_bwd(qkv, lens, seed, g, num_heads=2, out=out, stats=stats)
    assert torch.equal(dqkv, attention.mhsa_qkv_bwd_plain(qkv, lens, seed, g, num_heads=2))
    with pytest.raises(ValueError, match="does not take"):
        attention.mhsa_qkv_residuals(qkv.bfloat16(), lens, seed, num_heads=2)


def test_residuals_plain_give_the_softmax():
    """``mhsa_qkv_residuals`` on CPU tensors: ``mhsa_qkv_plain``'s output and
    each row's (max, sum), from which ``exp(s - m) / l`` is the softmax;
    rows of length 0 have max -1e9."""
    b, t, h, dh = 3, 11, 2, 64
    qkv, _, _, seed = _inputs(torch.float32, b=2, t=t, h=h, dh=dh)
    qkv = torch.cat([qkv, qkv[:1]])
    lens = torch.tensor([t, 4, 0], dtype=torch.int32)
    kw = dict(num_heads=h, rate=0.3, left_context=3, interleaved=True)
    before = attention.mhsa_qkv.launches
    out, stats = attention.mhsa_qkv_residuals(qkv, lens, seed, **kw)
    assert attention.mhsa_qkv.launches == before
    assert torch.equal(out, attention.mhsa_qkv_plain(qkv, lens, seed, **kw))
    assert stats.dtype == torch.float32 and stats.shape == (2, b * h * t)
    q, k, _ = attention._split_heads(qkv, h, True)
    s = attention._scores(q, k, lens, 3)
    m, l = stats.reshape(2, b, h, t, 1)
    p = attention._probs(q, k, lens, 3)
    live = (m > NEG).expand_as(p)
    torch.testing.assert_close(torch.exp(s - m) / l * live, p, rtol=0, atol=1e-6)
    assert bool((m[2] == NEG).all())


def _key_tiles(q0, rows, limit, t, left):
    """The key tiles that hold an unmasked key of some row in [q0, q0+rows)
    (``attention.cu::key_tiles``)."""
    kt0, kt1 = 0, -(-max(limit, 0) // TILE)
    if left is not None:
        kt0 = max(q0 - left, 0) // TILE
        kt1 = min(kt1, min(q0 + rows - 1, t - 1) // TILE + 1)
    return kt0, kt1


def _masked(rows, keys, limit, left):
    i, j = rows[:, None], keys[None, :]
    m = j >= limit
    if left is not None:
        m = m | (j > i) | (i - j > left)
    return m


def _scores(q, k, rows, keys, t, limit, left, scale):
    """The kernel's scores of query rows x key tile: -inf past T, -1e9 at
    masked keys, else the scaled product."""
    s = torch.matmul(q[:, rows], k[:, keys].transpose(-1, -2))
    s = torch.where(_masked(rows, keys, limit, left), NEG, s * scale)
    return torch.where(keys[None, :] >= t, -math.inf, s)


def _prob(s, keys, t, m, l):
    """``attention.cu::prob``: 0 past T or in a row whose max is <= -1e9."""
    p = torch.exp(s - m[..., None]) / l[..., None]
    dead = (keys[None, None, :] >= t) | (m[..., None] <= NEG)
    return torch.where(dead, 0.0, p)


def _pad(x, n):
    return torch.cat([x, x.new_zeros(x.shape[0], n - x.shape[1], x.shape[2])], dim=1)


def _walk_forward(q, k, v, t, limit, left, keep, inv):
    """One (batch) row's heads, ``[H, Tp, dh]`` zero-padded: out, m, l."""
    h, tp, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    out = torch.zeros(h, t, dh)
    m_all, l_all = torch.full((h, t), -math.inf), torch.zeros(h, t)
    for q0 in range(0, t, TILE):
        rows = torch.arange(q0, q0 + TILE)
        m = torch.full((h, TILE), -math.inf)
        l = torch.zeros(h, TILE)
        o = torch.zeros(h, TILE, dh)
        kt0, kt1 = _key_tiles(q0, TILE, limit, t, left)
        for kt in range(kt0, kt1):
            keys = torch.arange(kt * TILE, (kt + 1) * TILE)
            s = _scores(q, k, rows, keys, t, limit, left, scale)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            e = torch.exp(s - m_new[..., None])
            l = l * alpha + e.sum(-1)
            if keep is not None:
                e = torch.where(keep[:, rows][:, :, keys], e * inv, 0.0)
            o = o * alpha[..., None] + torch.matmul(e, v[:, keys])
            m = m_new
        n = min(TILE, t - q0)
        dead = (m <= NEG)[..., None]
        out[:, q0:q0 + n] = torch.where(dead, 0.0, o / l[..., None])[:, :n]
        m_all[:, q0:q0 + n], l_all[:, q0:q0 + n] = m[:, :n], l[:, :n]
    return out, m_all, l_all


def _walk_backward(q, k, v, g, out, m, l, t, limit, left, keep, inv):
    """dq, dk, dv ``[H, t, dh]`` from the forward's out and (m, l)."""
    h, tp, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    delta = _pad((g[:, :t] * out).sum(-1, keepdim=True), tp)[..., 0]
    m = torch.cat([m, torch.full((h, tp - t), -math.inf)], dim=1)
    l = torch.cat([l, torch.ones(h, tp - t)], dim=1)
    dq, dk, dv = (torch.zeros(h, tp, dh) for _ in range(3))
    ds_all = torch.full((h, tp, tp), math.nan)
    for k0 in range(0, t, TILE):  # the dK/dV kernel: a block per 64 keys
        keys = torch.arange(k0, k0 + TILE)
        qt0, qt1 = 0, -(-t // TILE)
        if k0 >= limit:
            qt1 = 0
        if left is not None:
            qt0, qt1 = k0 // TILE, min(qt1, (k0 + TILE - 1 + left) // TILE + 1)
        for qt in range(qt0, qt1):
            rows = torch.arange(qt * TILE, (qt + 1) * TILE)
            p = _prob(_scores(q, k, rows, keys, t, limit, left, scale), keys, t,
                      m[:, rows], l[:, rows])
            dp = torch.matmul(g[:, rows], v[:, keys].transpose(-1, -2))
            dropped = p
            if keep is not None:
                kept = keep[:, rows][:, :, keys]
                dropped, dp = (torch.where(kept, x * inv, 0.0) for x in (p, dp))
            ds = p * (dp - delta[:, rows, None])
            ds_all[:, qt * TILE:(qt + 1) * TILE, k0:k0 + TILE] = ds
            dv[:, keys] += torch.matmul(dropped.transpose(-1, -2), g[:, rows])
            dk[:, keys] += torch.matmul(ds.transpose(-1, -2), q[:, rows])
    for q0 in range(0, t, TILE):  # the dQ kernel: a block per 64 query rows
        for kt in range(*_key_tiles(q0, TILE, limit, t, left)):
            dq[:, q0:q0 + TILE] += torch.matmul(
                ds_all[:, q0:q0 + TILE, kt * TILE:(kt + 1) * TILE], k[:, kt * TILE:(kt + 1) * TILE])
    return dq[:, :t] * scale, dk[:, :t] * scale, dv[:, :t]


def _walk(qkv, lens, seed, g, h, rate, left, interleaved):
    """The ``"f32"`` body's forward and backward, batch row by batch row."""
    b, t, _ = qkv.shape
    q, k, v = attention._split_heads(qkv, h, interleaved)
    gh = g.reshape(b, t, h, -1).transpose(1, 2)
    tp = -(-t // TILE) * TILE
    keeps = (attention.dropout_masks_plain(b * h, tp, seed, rate).reshape(b, h, tp, tp)
             if rate > 0 else None)
    inv = 1.0 / (1.0 - rate) if rate > 0 else 1.0
    outs, grads = [], []
    for i in range(b):
        qi, ki, vi, gi = (_pad(x[i], tp) for x in (q, k, v, gh))
        limit = min(int(lens[i]), t)
        keep = None if keeps is None else keeps[i]
        out, m, l = _walk_forward(qi, ki, vi, t, limit, left, keep, inv)
        outs.append(out)
        grads.append(_walk_backward(qi, ki, vi, gi, out, m, l, t, limit, left, keep, inv))
    out = torch.stack(outs).transpose(1, 2).reshape(b, t, -1)
    dq, dk, dv = (torch.stack([gr[j] for gr in grads]) for j in range(3))
    return out, attention._merge_grads(dq, dk, dv, interleaved)


@pytest.mark.parametrize("t,lens,left,interleaved", [
    (37, [37, 0, 5], None, False),
    (130, [130, 5, 0], 40, True),
])
def test_f32_walk_matches_pallas_interpret(t, lens, left, interleaved):
    """Forward and dqkv, 2 heads of dh 64, rate 0.3, with the seed JAX
    derives from its key; rows of length 0 are zero."""
    b, h, dh, rate = 3, 2, 64, 0.3
    rng = np.random.default_rng(t + (left or 0))
    qkv = rng.standard_normal((b, t, 3 * h * dh)).astype(np.float32)
    w = rng.standard_normal((b, t, h * dh)).astype(np.float32)
    lens_np = np.asarray(lens, np.int32)
    key = jax.random.key(6)
    kw = dict(num_heads=h, dropout_rate=rate, train=True, interpret=True,
              left_context=left, interleaved=interleaved)

    ref, vjp = jax.vjp(lambda x: jax_fused_mhsa_qkv(x, jnp.asarray(lens_np), key, **kw),
                       jnp.asarray(qkv))
    ref, ref_grad = np.asarray(ref), np.asarray(vjp(jnp.asarray(w))[0])
    seed = jax.random.randint(key, (1,), 0, jnp.iinfo(jnp.int32).max, dtype=jnp.int32)
    out, dqkv = _walk(torch.from_numpy(qkv), lens_np, torch.from_numpy(np.array(seed)),
                      torch.from_numpy(w), h, rate, left, interleaved)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATTN_TOL * np.abs(ref).max())
    np.testing.assert_allclose(dqkv.numpy(), ref_grad, atol=ATTN_TOL * np.abs(ref_grad).max())
    assert not out[torch.from_numpy(lens_np <= 0)].any()
