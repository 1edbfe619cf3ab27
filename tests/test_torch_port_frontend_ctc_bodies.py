"""The bodies of the serving frontend and of the CTC recursions, in the
port, on the CPU (the kernels themselves run only on the card: the tests
marked ``cuda`` below skip here).

- ``ops/kernels/ctc.py::ctc_plan``: the prefetch body (one block a row,
  one thread a state, whole warps) for 1 <= S <= 256, the block body
  otherwise. A plain model of the prefetch body, with alpha's neighbours
  read from a shared row padded by two sentinels on the left, beta's m[s+1]
  and (m + skip)[s+2] from rows whose cells past S hold the sentinel, the
  idle threads past S computing on NaN (never read by a live state), and
  lpz read as its ring of three frames ahead gives it (beta's row min(T-i,
  T-1) at step i), is bit-equal to ``ctc_alpha_plain`` /
  ``ctc_beta_plain`` for S < 32, S a multiple of 32, S one past a warp,
  S = 129, S = 1 and S = 256, with rows of length 0, 1, T and past T.
- The warp body of ``csrc/ctc.cu`` (built only for ``tools/ctc_ablation.py``,
  which times it beside the prefetch body): a plain model of its lane
  partition (lane l keeps states [lK, (l+1)K), K = ceil(S/32)), its
  neighbours taken from the lanes below (alpha) or above (beta) with a
  shuffle's rule (a lane with no source keeps its own value, which the
  range tests then discard), the states past S on NaN and lpz through its
  ring of four frames, is bit-equal to the plain versions for the same S
  and lengths.
- ``ops/kernels/frontend.py::frontend_plan``: the tensor-core body for
  bfloat16 with 20 taps, C = 256 and aligned pointers, the float32 body for
  float32 with C a multiple of 4 and aligned pointers, the FMA body
  otherwise. A plain model of the tensor-core body's
  tiling (64-row tiles, each smoothing its rows from the tile and its
  19-row halo, zero outside [0, T), rounded to bf16, a float32 product,
  bias, Softsign, one rounding), with T not a multiple of the tile and day
  indices -1 and 24 clipped, agrees with ``frontend_kernel.py::
  fused_frontend(interpret=True)``; the launch's cut of a trial's tiles
  into runs, one block each, covers every tile once. A plain model of the
  float32 body's tiling (128-row tiles of a trial smoothed from their
  19-row halo, zero outside [0, T), 16-channel slabs summed in order into
  128-column tiles, bias, Softsign) agrees with ``fused_frontend(interpret=
  True)`` in float32, and its grid covers each (trial, row tile, column
  tile) once.
- On a CPU tensor both wrappers run their plain versions and count no
  launch.

The tests marked ``cuda`` run on the card without the tests' ``conftest.py``
(which imports jax; this file imports it only inside the one test that
compares with the JAX package):

    python -m pytest --noconftest -q -m cuda tests/test_torch_port_frontend_ctc_bodies.py
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from neural_speech_decoder_tpu_torch.ops.gaussian import gaussian_kernel, same_padding
from neural_speech_decoder_tpu_torch.ops.kernels.ctc import (
    NEG_INF,
    PREFETCH_MAX_STATES,
    ctc_alpha,
    ctc_alpha_plain,
    ctc_beta,
    ctc_beta_plain,
    ctc_plan,
    logsum3,
    prepare,
)
from neural_speech_decoder_tpu_torch.ops.kernels.frontend import (
    F32_SLAB,
    F32_TILE,
    TC_CHANNELS,
    TC_TAPS,
    TC_TILE_ROWS,
    frontend_plan,
    fused_frontend,
    fused_frontend_plain,
)

H100_SMS = 132


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ CTC

def block_threads(n_states):
    """The prefetch body's block: one thread a state, whole warps
    (``csrc/ctc.cu::prefetch_body``)."""
    return -(-n_states // 32) * 32


def _padded(row, left, right, fill):
    return F.pad(row, (left, right), value=fill)


def alpha_prefetch_model(lpz, skip, lens):
    """The prefetch body's alpha (``csrc/ctc.cu::ctc_alpha_prefetch``) in
    plain PyTorch: thread s of a block of whole warps keeps state s; each
    frame's states go to a shared row with two sentinels on the left, from
    which thread s reads s-1 and s-2 with no test; threads past S compute on
    NaN here (never read by a live state); lpz of frame t is the entry
    requested three frames before."""
    t_max, bsz, n = lpz.shape
    threads = block_threads(n)
    idle = threads - n
    s = torch.arange(threads)
    sk = _padded(skip, 0, idle, NEG_INF)
    a = torch.where((s <= 1) & (s < n), _padded(lpz[0], 0, idle, 0.0), NEG_INF)
    a[:, n:] = float("nan")
    ring = [_padded(lpz[f], 0, idle, 0.0) for f in range(1, min(4, t_max))]
    out = [a[:, :n]]
    for t in range(1, t_max):
        cur = ring.pop(0)
        if t + 3 < t_max:
            ring.append(_padded(lpz[t + 3], 0, idle, 0.0))
        row = _padded(a, 2, 0, NEG_INF)  # row[2 + s] = state s
        a1, a2 = row[:, 1:-1], row[:, :-2]
        new = torch.cat([logsum3(a[:, :n].contiguous(), a1[:, :n].contiguous(),
                                 (a2[:, :n] + sk[:, :n]).contiguous()) + cur[:, :n],
                         a[:, n:]], dim=1)
        a = torch.where((t < lens)[:, None], new, a)
        out.append(a[:, :n])
    return torch.stack(out)


def beta_prefetch_model(lpz, skip, lens, s_end):
    """The prefetch body's beta (``ctc_beta_prefetch``): step i is frame
    t = T-1-i, whose lpz row is min(T-i, T-1); thread s writes m = beta +
    lpz and m + skip to shared rows whose cells past S (idle threads, right
    pad) hold the sentinel, and reads m[s+1] and (m + skip)[s+2] there."""
    t_max, bsz, n = lpz.shape
    threads = block_threads(n)
    v = torch.full((bsz, n), NEG_INF)
    out = [None] * t_max
    for i in range(t_max):
        t = t_max - 1 - i
        m0 = v + lpz[min(t_max - i, t_max - 1)]
        m = _padded(m0, 0, threads + 2 - n, NEG_INF)
        ms = _padded(m0 + skip, 0, threads + 2 - n, NEG_INF)
        new = logsum3(m0, m[:, 1:n + 1].contiguous(), ms[:, 2:n + 2].contiguous())
        lens_c = lens[:, None]
        v = torch.where(t == lens_c - 1, s_end, torch.where(t >= lens_c, v, new))
        out[t] = v
    return torch.stack(out)


def _ctc_arrays(seed, t_max, bsz, n):
    """Random recursion inputs at S = n: log-probs with the sentinel on some
    states, skips of 0 or the sentinel (never into s < 2), a start row of
    two zeros, and lengths 0, 1, T, T + 3 and random ones."""
    rng = np.random.default_rng(seed)
    lpz = np.log(rng.uniform(0.01, 1.0, (t_max, bsz, n))).astype(np.float32)
    lpz[:, 0, n // 2:] = NEG_INF
    skip = np.where(rng.uniform(size=(bsz, n)) < 0.6, 0.0, NEG_INF).astype(np.float32)
    skip[:, :2] = NEG_INF
    s_end = np.full((bsz, n), NEG_INF, np.float32)
    for b in range(bsz):
        hi = int(rng.integers(0, n))
        s_end[b, hi] = 0.0
        s_end[b, max(hi - 1, 0)] = 0.0
    lens = rng.integers(0, t_max + 1, bsz).astype(np.int32)
    lens[:4] = [0, 1, t_max, t_max + 3]
    return (torch.from_numpy(lpz), torch.from_numpy(skip), torch.from_numpy(lens),
            torch.from_numpy(s_end))


@pytest.mark.parametrize("n_states", [1, 15, 32, 33, 96, 129, PREFETCH_MAX_STATES])
@pytest.mark.parametrize("direction", ["alpha", "beta"])
def test_ctc_prefetch_model_is_bit_equal_to_plain(n_states, direction):
    lpz, skip, lens, s_end = _ctc_arrays(n_states, 23, 6, n_states)
    if direction == "alpha":
        got, ref = alpha_prefetch_model(lpz, skip, lens), ctc_alpha_plain(lpz, skip, lens)
    else:
        got = beta_prefetch_model(lpz, skip, lens, s_end)
        ref = ctc_beta_plain(lpz, skip, lens, s_end)
    assert torch.equal(got, ref)


def test_ctc_prefetch_model_on_prepared_rows():
    """The same model on ``prepare``'s arrays at S = 129 (U = 64): an empty
    target, an infeasible row, a row of length 0 and one of length T."""
    g = torch.Generator().manual_seed(3)
    t_max, bsz, u = 40, 5, 64
    logits = torch.randn((bsz, t_max, 41), generator=g)
    labels = torch.randint(1, 41, (bsz, u), generator=g)
    label_lens = torch.tensor([0, u, 10, 19, 5])
    input_lens = torch.tensor([12, 40, 0, t_max, 1])
    _, lpz, _, skip, s_end, lens = prepare(logits, labels, label_lens, input_lens)
    assert lpz.shape[-1] == 2 * u + 1 and ctc_plan(lpz.shape[-1]) == "prefetch"
    assert torch.equal(alpha_prefetch_model(lpz, skip, lens), ctc_alpha_plain(lpz, skip, lens))
    assert torch.equal(beta_prefetch_model(lpz, skip, lens, s_end),
                       ctc_beta_plain(lpz, skip, lens, s_end))


@pytest.mark.parametrize("n_states, body", [
    (1, "prefetch"), (129, "prefetch"), (PREFETCH_MAX_STATES, "prefetch"),
    (PREFETCH_MAX_STATES + 1, "block"), (1025, "block"), (0, "block"),
])
def test_ctc_plan(n_states, body):
    assert ctc_plan(n_states) == body


def test_ctc_wrappers_run_plain_on_cpu_and_count_nothing():
    lpz, skip, lens, s_end = _ctc_arrays(7, 9, 4, 13)
    before = (ctc_alpha.launches, ctc_beta.launches, dict(ctc_alpha.launches_by_body),
              dict(ctc_beta.launches_by_body))
    assert torch.equal(ctc_alpha(lpz, skip, lens, body="block"), ctc_alpha_plain(lpz, skip, lens))
    assert torch.equal(ctc_beta(lpz, skip, lens, s_end), ctc_beta_plain(lpz, skip, lens, s_end))
    assert (ctc_alpha.launches, ctc_beta.launches, ctc_alpha.launches_by_body,
            ctc_beta.launches_by_body) == before
    assert (set(ctc_alpha.launches_by_body) == set(ctc_beta.launches_by_body)
            == {"prefetch", "block"})


WARP_LANES = 32
WARP_AHEAD = 4  # csrc/ctc.cu kWarpAhead: the frames of lpz in flight


def _shfl_up(x, delta):
    """``__shfl_up_sync`` over the lanes of x [B, 32]: lane l gets lane
    l - delta's value, lanes below delta keep their own."""
    return torch.cat([x[:, :delta], x[:, :-delta]], dim=1)


def _shfl_down(x, delta):
    """``__shfl_down_sync``: lane l gets lane l + delta's value, the top
    delta lanes keep their own."""
    return torch.cat([x[:, delta:], x[:, -delta:]], dim=1)


def _lanes(row, k, fill):
    """[B, S] -> [B, 32, K]: lane l's states lK..lK+K-1, fill past S."""
    return F.pad(row, (0, WARP_LANES * k - row.shape[-1]), value=fill).view(
        row.shape[0], WARP_LANES, k)


def _lanes_ring(lpz, k, rows):
    """The warp body's lpz ring: the rows of the first WARP_AHEAD steps,
    then each step's row WARP_AHEAD steps after it is asked for."""
    ring = [_lanes(lpz[r], k, 0.0) for r in rows[:WARP_AHEAD]]
    for r in rows[WARP_AHEAD:] + [None] * WARP_AHEAD:
        yield ring.pop(0)
        ring.append(None if r is None else _lanes(lpz[r], k, 0.0))


def _log_adds(n, *operands):
    """logsum3 of the live states' operands, laid out [B, S] as the plain
    versions lay theirs (so that the vectorised exp and log see the same
    lanes), the states past S NaN."""
    bsz = operands[0].shape[0]
    flat = [x.reshape(bsz, -1)[:, :n].contiguous() for x in operands]
    out = logsum3(*flat)
    return F.pad(out, (0, operands[0][0].numel() - n), value=float("nan")).view(
        operands[0].shape)


def alpha_warp_model(lpz, skip, lens):
    """The warp body's alpha (``ctc_alpha_warp``): s-1 and s-2 of a lane's
    first states from the lane below's last two (K = 1: the two lanes
    below), tested against s >= 1 and s >= 2 after the shuffle."""
    t_max, bsz, n = lpz.shape
    k = -(-n // WARP_LANES)
    s = torch.arange(WARP_LANES * k).view(WARP_LANES, k)
    sk = _lanes(skip, k, NEG_INF)
    a = torch.where((s <= 1) & (s < n), _lanes(lpz[0], k, 0.0), NEG_INF)
    a = torch.where(s < n, a, float("nan"))
    ring = _lanes_ring(lpz, k, list(range(1, t_max)))
    out = [a.reshape(bsz, -1)[:, :n]]
    for t in range(1, t_max):
        cur = next(ring)
        up1 = _shfl_up(a[:, :, k - 1], 1)
        up2 = _shfl_up(a[:, :, k - 2], 1) if k >= 2 else _shfl_up(a[:, :, 0], 2)
        a1 = torch.stack([a[:, :, j - 1] if j >= 1 else
                          torch.where(s[:, 0] >= 1, up1, NEG_INF) for j in range(k)], dim=2)
        a2 = torch.stack([a[:, :, j - 2] if j >= 2 else
                          torch.where(s[:, j] >= 2, up1 if j == 1 else up2, NEG_INF)
                          for j in range(k)], dim=2)
        new = _log_adds(n, a, a1, a2 + sk) + cur
        a = torch.where((t < lens)[:, None, None], new, a)
        out.append(a.reshape(bsz, -1)[:, :n])
    return torch.stack(out)


def beta_warp_model(lpz, skip, lens, s_end):
    """The warp body's beta (``ctc_beta_warp``): step i is frame T-1-i, its
    lpz row min(T-i, T-1); m[s+1] and (m + skip)[s+2] of a lane's last
    states from the lane above's first two (K = 1: the two lanes above),
    tested against s+1 < S and s+2 < S after the shuffle."""
    t_max, bsz, n = lpz.shape
    k = -(-n // WARP_LANES)
    s = torch.arange(WARP_LANES * k).view(WARP_LANES, k)
    sk, se = _lanes(skip, k, NEG_INF), _lanes(s_end, k, NEG_INF)
    v = torch.where(s < n, torch.full((bsz, WARP_LANES, k), NEG_INF), float("nan"))
    ring = _lanes_ring(lpz, k, [min(t_max - i, t_max - 1) for i in range(t_max)])
    lens_c = lens[:, None, None]
    out = [None] * t_max
    for i in range(t_max):
        t = t_max - 1 - i
        m = v + next(ring)
        ms = m + sk
        dn_m, dn_ms0 = _shfl_down(m[:, :, 0], 1), _shfl_down(ms[:, :, 0], 1)
        dn_ms1 = _shfl_down(ms[:, :, 1], 1) if k >= 2 else _shfl_down(ms[:, :, 0], 2)
        m1 = torch.stack([torch.where(s[:, j] + 1 < n, m[:, :, j + 1] if j + 1 < k else dn_m,
                                      NEG_INF) for j in range(k)], dim=2)
        m2 = torch.stack([torch.where(s[:, j] + 2 < n, ms[:, :, j + 2] if j + 2 < k else
                                      (dn_ms0 if j + 2 == k else dn_ms1), NEG_INF)
                          for j in range(k)], dim=2)
        new = _log_adds(n, m, m1, m2)
        v = torch.where(t == lens_c - 1, se, torch.where(t >= lens_c, v, new))
        out[t] = v.reshape(bsz, -1)[:, :n]
    return torch.stack(out)


@pytest.mark.parametrize("n_states", [1, 15, 32, 33, 129, 256])
@pytest.mark.parametrize("direction", ["alpha", "beta"])
def test_ctc_warp_model_is_bit_equal_to_plain(n_states, direction):
    lpz, skip, lens, s_end = _ctc_arrays(n_states + 1, 23, 6, n_states)
    if direction == "alpha":
        got, ref = alpha_warp_model(lpz, skip, lens), ctc_alpha_plain(lpz, skip, lens)
    else:
        got = beta_warp_model(lpz, skip, lens, s_end)
        ref = ctc_beta_plain(lpz, skip, lens, s_end)
    assert torch.equal(got, ref)


# ------------------------------------------------------------- frontend

def frontend_tiles(x, day_w, day_b, day_idx, *, kernel_size, sigma, rows=TC_TILE_ROWS):
    """The tensor-core body's tiling (``csrc/frontend.cu::tc``) in plain
    PyTorch: each 64-row tile of a trial smooths its rows from the tile's
    input rows and their halo (zero outside [0, T)) in float32, each row's
    taps in order, rounds them to x's dtype, multiplies by the clipped
    day's matrix with float32 sums, adds the float32 bias, applies Softsign
    and rounds once; rows past T are dropped."""
    bsz, t_max, c = x.shape
    taps = torch.as_tensor(gaussian_kernel(kernel_size, sigma), dtype=torch.float32)
    pad_left, _ = same_padding(kernel_size)
    days = day_idx.long().clamp(0, day_w.shape[0] - 1)
    out = torch.empty_like(x)
    for b in range(bsz):
        w = day_w[days[b]].to(x.dtype).float()
        bias = day_b[days[b]].float()
        for t0 in range(0, t_max, rows):
            src = torch.arange(t0 - pad_left, t0 + rows + kernel_size - 1 - pad_left)
            ok = (src >= 0) & (src < t_max)
            raw = torch.where(ok[:, None], x[b, src.clamp(0, t_max - 1)].float(), 0.0)
            acc = torch.zeros((rows, c))
            for j in range(kernel_size):
                acc = acc + taps[j] * raw[j: j + rows]
            y = acc.to(x.dtype).float() @ w + bias
            n = min(rows, t_max - t0)
            out[b, t0: t0 + n] = F.softsign(y[:n]).to(x.dtype)
    return out


def _frontend_inputs(seed, b, t, c, n_days=24):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    w = np.stack([np.eye(c) + 0.1 * rng.standard_normal((c, c))
                  for _ in range(n_days)]).astype(np.float32)
    bias = (0.1 * rng.standard_normal((n_days, c))).astype(np.float32)
    return x, w, bias


@pytest.mark.parametrize("t_max", [TC_TILE_ROWS, 150, 20])
def test_frontend_tile_model_matches_jax_pallas_interpret(t_max):
    """bf16, the tensor-core body's dtype: within one bf16 step near |y| = 1
    (2**-8), where a float32 sum that falls on the other side of a rounding
    boundary moves a value by a step."""
    import jax.numpy as jnp

    from neural_speech_decoder_tpu.ops.pallas.frontend_kernel import (
        fused_frontend as jax_fused_frontend,
    )

    x, w, bias = _frontend_inputs(t_max, 3, t_max, 32)
    day = np.asarray([-1, 24, 5], np.int32)  # 24 days: -1 and 24 clip to 0 and 23
    xb = torch.from_numpy(x).bfloat16()
    ref = jax_fused_frontend(jnp.asarray(xb.float().numpy(), jnp.bfloat16), jnp.asarray(w),
                             jnp.asarray(bias), jnp.asarray(day), kernel_size=TC_TAPS,
                             sigma=2.0, interpret=True)
    ours = frontend_tiles(xb, torch.from_numpy(w), torch.from_numpy(bias),
                          torch.from_numpy(day), kernel_size=TC_TAPS, sigma=2.0)
    assert ours.dtype == torch.bfloat16 and ours.shape == xb.shape
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               atol=4e-3)


def test_frontend_tile_model_matches_plain_in_float32():
    x, w, bias = _frontend_inputs(4, 2, 150, 32)
    args = [torch.from_numpy(a) for a in (x, w, bias)]
    day = torch.tensor([24, -1], dtype=torch.int32)
    ours = frontend_tiles(*args, day, kernel_size=TC_TAPS, sigma=2.0)
    ref = fused_frontend_plain(*args, day, kernel_size=TC_TAPS, sigma=2.0)
    torch.testing.assert_close(ours, ref, rtol=0, atol=1e-5)


def tile_runs(batch, n_time, sms):
    """The tensor-core launch's grid (``csrc/frontend.cu::tc::launch``):
    each trial's 64-row tiles cut into runs of equal length, about one
    block an SM; returns the [start, end) tiles of each block of a trial."""
    n_tiles = -(-n_time // TC_TILE_ROWS)
    groups = min(max(sms // batch, 1), n_tiles)
    per_block = -(-n_tiles // groups)
    groups = -(-n_tiles // per_block)
    return [(g * per_block, min(n_tiles, (g + 1) * per_block)) for g in range(groups)]


@pytest.mark.parametrize("batch, n_time", [(64, 1280), (1, 1280), (200, 1000), (3, 20),
                                           (64, 1281)])
def test_frontend_tile_runs_cover_every_tile_once(batch, n_time):
    runs = tile_runs(batch, n_time, H100_SMS)
    tiles = [t for lo, hi in runs for t in range(lo, hi)]
    assert tiles == list(range(-(-n_time // TC_TILE_ROWS)))
    assert all(hi > lo for lo, hi in runs)
    assert len(runs) * batch <= max(H100_SMS, batch)


def test_frontend_recipe_grid_fills_the_card():
    """B=64, T=1280: two blocks a trial, ten tiles each, 128 blocks on the
    H100's 132 SMs."""
    assert tile_runs(64, 1280, H100_SMS) == [(0, 10), (10, 20)]


def frontend_f32_tiles(x, day_w, day_b, day_idx, *, kernel_size, sigma):
    """The float32 body's tiling (``csrc/frontend.cu::f32`` on ``gemm_f32.cuh``)
    in plain PyTorch: a block per (trial, 128-row tile, 128-column tile);
    its A operand, slab by slab of 16 channels, the tile's rows smoothed
    from its input rows and their ``kernel_size - 1`` halo rows (zero
    outside [0, T)), each row's taps in order; the slabs' products summed
    in order into the tile's float32 sums; then the bias and Softsign. Rows
    past T and columns past C are dropped."""
    bsz, t_max, c = x.shape
    taps = torch.as_tensor(gaussian_kernel(kernel_size, sigma), dtype=torch.float32)
    pad_left, _ = same_padding(kernel_size)
    days = day_idx.long().clamp(0, day_w.shape[0] - 1)
    out = torch.full_like(x, float("nan"))
    for b, t0, n0 in f32_grid(bsz, t_max, c):
        src = torch.arange(t0 - pad_left, t0 + F32_TILE + kernel_size - 1 - pad_left)
        ok = (src >= 0) & (src < t_max)
        raw = torch.where(ok[:, None], x[b, src.clamp(0, t_max - 1)].float(), 0.0)
        w = day_w[days[b], :, n0: n0 + F32_TILE].float()
        acc = torch.zeros((F32_TILE, w.shape[1]))
        for k0 in range(0, c, F32_SLAB):
            a = torch.zeros((F32_TILE, min(F32_SLAB, c - k0)))
            for j in range(kernel_size):
                a = a + taps[j] * raw[j: j + F32_TILE, k0: k0 + F32_SLAB]
            acc = acc + a @ w[k0: k0 + F32_SLAB]
        n = min(F32_TILE, t_max - t0)
        out[b, t0: t0 + n, n0: n0 + F32_TILE] = F.softsign(
            acc[:n] + day_b[days[b], n0: n0 + F32_TILE].float())
    return out


def f32_grid(batch, n_time, n_ch):
    """The float32 body's launch (``csrc/frontend.cu::f32::launch_taps``):
    grid (ceil(C/128), ceil(T/128), B), block (x, y, z) the output columns
    from 128x, the rows from 128y of trial z; returns each block's (trial,
    first row, first column) in launch order."""
    return [(b, F32_TILE * y, F32_TILE * xx) for b in range(batch)
            for y in range(-(-n_time // F32_TILE)) for xx in range(-(-n_ch // F32_TILE))]


@pytest.mark.parametrize("t_max, c", [(150, 256), (20, 256), (150, 132)])
def test_frontend_f32_tile_model_matches_jax_pallas_interpret(t_max, c):
    """float32, the float32 body's dtype, with days -1 and 24 clipped: the
    JAX kernel smooths the whole trial and multiplies once, the model sums
    16-channel slabs; the two float32 sums differ by rounding, under 1e-5
    of the output (|y| < 1)."""
    import jax.numpy as jnp

    from neural_speech_decoder_tpu.ops.pallas.frontend_kernel import (
        fused_frontend as jax_fused_frontend,
    )

    x, w, bias = _frontend_inputs(t_max + c, 3, t_max, c)
    day = np.asarray([-1, 24, 5], np.int32)  # 24 days: -1 and 24 clip to 0 and 23
    ref = jax_fused_frontend(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
                             jnp.asarray(day), kernel_size=20, sigma=2.0, interpret=True)
    ours = frontend_f32_tiles(*(torch.from_numpy(a) for a in (x, w, bias, day)),
                              kernel_size=20, sigma=2.0)
    assert ours.dtype == torch.float32 and not ours.isnan().any()
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("batch, n_time, n_ch", [(64, 1280, 256), (3, 150, 256), (2, 20, 132),
                                                 (1, 129, 4), (5, 1281, 260)])
def test_frontend_f32_grid_covers_every_output_once(batch, n_time, n_ch):
    blocks = f32_grid(batch, n_time, n_ch)
    assert len(set(blocks)) == len(blocks)
    seen = np.zeros((batch, n_time, n_ch), np.int8)
    for b, t0, n0 in blocks:
        assert t0 < n_time and n0 < n_ch  # no block without an output
        seen[b, t0: t0 + F32_TILE, n0: n0 + F32_TILE] += 1
    assert (seen == 1).all()


def test_frontend_f32_recipe_grid():
    """B=64, T=1280, C=256: two column tiles, ten row tiles a trial, 1280
    blocks, 4.85 waves of two blocks on each of the H100's 132 SMs."""
    assert len(f32_grid(64, 1280, 256)) == 2 * 10 * 64


@pytest.mark.parametrize("dtype, n_ch, n_taps, aligned, body", [
    (torch.bfloat16, 256, 20, True, "tc"),
    (torch.bfloat16, 16, 20, True, "fma"),
    (torch.bfloat16, 144, 20, True, "fma"),
    (torch.float32, 256, 20, True, "f32"),
    (torch.bfloat16, 130, 20, True, "fma"),
    (torch.bfloat16, 8, 20, True, "fma"),
    (torch.bfloat16, TC_CHANNELS + 16, 20, True, "fma"),
    (torch.bfloat16, 256, 19, True, "fma"),
    (torch.bfloat16, 256, 20, False, "fma"),
    (torch.float32, 132, 20, True, "f32"),
    (torch.float32, 4, 1, True, "f32"),
    (torch.float32, 256, 32, True, "f32"),
    (torch.float32, 256, 9, True, "f32"),
    (torch.float32, 130, 20, True, "fma"),
    (torch.float32, 258, 20, True, "fma"),
    (torch.float32, 256, 20, False, "fma"),
    (torch.float32, 256, 33, True, "fma"),
])
def test_frontend_plan(dtype, n_ch, n_taps, aligned, body):
    assert frontend_plan(dtype, n_ch, n_taps, aligned) == body


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_frontend_wrapper_runs_plain_on_cpu_and_counts_nothing(dtype):
    x, w, bias = _frontend_inputs(5, 2, 70, 32, n_days=4)
    xt = torch.from_numpy(x).to(dtype)
    day = torch.tensor([3, -1], dtype=torch.int32)
    before = (fused_frontend.launches, dict(fused_frontend.launches_by_body))
    ours = fused_frontend(xt, torch.from_numpy(w), torch.from_numpy(bias), day,
                          kernel_size=20, sigma=2.0, body="fma")
    ref = fused_frontend_plain(xt, torch.from_numpy(w), torch.from_numpy(bias), day,
                               kernel_size=20, sigma=2.0)
    assert torch.equal(ours, ref)
    assert (fused_frontend.launches, fused_frontend.launches_by_body) == before
    assert set(fused_frontend.launches_by_body) == {"tc", "f32", "fma"}


# ------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_states", [1, 15, 32, 33, 96, 129, PREFETCH_MAX_STATES])
def test_ctc_prefetch_body_bit_equal_to_block_body(cuda, n_states):
    lpz, skip, lens, s_end = (a.to(cuda) for a in _ctc_arrays(n_states, 37, 9, n_states))
    before = (dict(ctc_alpha.launches_by_body), dict(ctc_beta.launches_by_body))
    alpha = ctc_alpha(lpz, skip, lens)
    beta = ctc_beta(lpz, skip, lens, s_end)
    assert torch.equal(alpha, ctc_alpha(lpz, skip, lens, body="block"))
    assert torch.equal(beta, ctc_beta(lpz, skip, lens, s_end, body="block"))
    assert ctc_alpha.launches_by_body["prefetch"] == before[0]["prefetch"] + 1
    assert ctc_beta.launches_by_body["block"] == before[1]["block"] + 1
    for got, ref in ((alpha, ctc_alpha_plain(lpz, skip, lens)),
                     (beta, ctc_beta_plain(lpz, skip, lens, s_end))):
        assert torch.equal(got <= -1e29, ref <= -1e29)
        live = ref > -1e29
        assert ((got[live] - ref[live]).abs() / ref[live].abs().clamp_min(1)).max() <= 1e-5


@pytest.mark.cuda
def test_ctc_prefetch_body_refuses_too_many_states(cuda):
    n = PREFETCH_MAX_STATES + 1
    lpz, skip, lens, _ = (a.to(cuda) for a in _ctc_arrays(1, 5, 4, n))
    with pytest.raises(ValueError, match="prefetch"):
        ctc_alpha(lpz, skip, lens, body="prefetch")


@pytest.mark.cuda
@pytest.mark.parametrize("t_max", [1280, 150, 20])
def test_frontend_tc_body_matches_plain_and_fma_body(cuda, t_max):
    x, w, bias = _frontend_inputs(t_max, 5, t_max, 256)
    xb = torch.from_numpy(x).to(cuda, torch.bfloat16)
    w, bias = torch.from_numpy(w).to(cuda), torch.from_numpy(bias).to(cuda)
    day = torch.tensor([-1, 24, 5, 0, 23], dtype=torch.int32, device=cuda)
    before = dict(fused_frontend.launches_by_body)
    out = fused_frontend(xb, w, bias, day, kernel_size=20, sigma=2.0)
    again = fused_frontend(xb, w, bias, day, kernel_size=20, sigma=2.0)
    fma = fused_frontend(xb, w, bias, day, kernel_size=20, sigma=2.0, body="fma")
    ref = fused_frontend_plain(xb, w, bias, day, kernel_size=20, sigma=2.0)
    assert fused_frontend.launches_by_body == {"tc": before["tc"] + 2, "f32": before["f32"],
                                               "fma": before["fma"] + 1}
    assert torch.equal(out, again)
    assert (out.float() - ref.float()).abs().max().item() <= 1.6e-2
    assert (out.float() - fma.float()).abs().max().item() <= 1.6e-2


@pytest.mark.cuda
@pytest.mark.parametrize("t_max, c, n_taps", [(1280, 256, 20), (150, 256, 20), (20, 256, 20),
                                              (150, 132, 20), (37, 12, 7), (300, 256, 32)])
def test_frontend_f32_body_bit_equal_to_fma_body(cuda, t_max, c, n_taps):
    """The float32 body keeps the FMA body's arithmetic (taps in order from
    0, the product over k in order from 0 in one thread, + bias, Softsign),
    so the two agree bit for bit; both within 1e-5 of the plain version.
    20 taps run the body built for them, 7 and 32 the one that reads the
    count at run time."""
    x, w, bias = _frontend_inputs(t_max + c, 5, t_max, c)
    x = torch.from_numpy(x).to(cuda)
    w, bias = torch.from_numpy(w).to(cuda), torch.from_numpy(bias).to(cuda)
    day = torch.tensor([-1, 24, 5, 0, 23], dtype=torch.int32, device=cuda)
    fe = dict(kernel_size=n_taps, sigma=2.0)
    before = dict(fused_frontend.launches_by_body)
    out = fused_frontend(x, w, bias, day, **fe)
    again = fused_frontend(x, w, bias, day, **fe)
    fma = fused_frontend(x, w, bias, day, body="fma", **fe)
    ref = fused_frontend_plain(x, w, bias, day, **fe)
    assert fused_frontend.launches_by_body == {"tc": before["tc"], "f32": before["f32"] + 2,
                                               "fma": before["fma"] + 1}
    assert torch.equal(out, again) and torch.equal(out, fma)
    assert (out - ref).abs().max().item() <= 1e-5


@pytest.mark.cuda
def test_frontend_f32_body_refuses_what_it_cannot_take(cuda):
    """C not a multiple of 4 and a misaligned x go to the FMA body; asking
    for ``"f32"`` there raises (no quiet fallback)."""
    x, w, bias = _frontend_inputs(3, 2, 40, 130, n_days=4)
    x, w, bias = (torch.from_numpy(a).to(cuda) for a in (x, w, bias))
    day = torch.tensor([0, 3], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="does not take"):
        fused_frontend(x, w, bias, day, kernel_size=20, sigma=2.0, body="f32")
    x4 = torch.zeros((2 * 40 * 128 + 1,), device=cuda)[1:].view(2, 40, 128)  # 4-byte offset
    before = dict(fused_frontend.launches_by_body)
    fused_frontend(x4, w[:, :128, :128].contiguous(), bias[:, :128].contiguous(), day,
                   kernel_size=20, sigma=2.0)
    assert fused_frontend.launches_by_body["fma"] == before["fma"] + 1
