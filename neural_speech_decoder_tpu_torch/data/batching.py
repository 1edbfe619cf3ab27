"""Static-shape batching.

The port's own copy of ``neural_speech_decoder_tpu/data/batching.py``
(numpy only; the port imports nothing of the JAX package). The fixed
envelope below serves the port too: one set of shapes for every step, so
the card's allocator and the kernels see the same sizes each step.

The reference pads each batch dynamically to its own max length
(``neural_decoder_trainer.py:26-37``) — a recompile per shape under XLA.
Here every batch is padded to a *fixed* ``[B, T_max, C]`` / ``[B, U_max]``
envelope computed once from the dataset, so the train step compiles exactly
once; validity is carried by lengths.

Sampling semantics: the reference draws ``next(iter(trainLoader))`` from a
freshly shuffled DataLoader every step (``neural_decoder_trainer.py:184``),
i.e. each step sees one uniformly-random batch of distinct trials — NOT epoch
semantics. ``sample_batch`` reproduces exactly that.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from .dataset import PackedDataset


@dataclasses.dataclass
class Batch:
    """One padded batch. ``weight`` masks padded (duplicated) eval rows.

    ``idx``/``t_env`` record the trial indices and time envelope so the
    device-resident data path (``data/device_data.py``) can re-assemble
    ``x`` on-device; with ``materialize_x=False`` the host ``x`` is skipped
    entirely (``x is None``) and only the assembler may consume the batch.
    """

    x: np.ndarray | None  # [B, T_env, C] float32, zero-padded (or None)
    y: np.ndarray  # [B, U_max] int32
    x_lens: np.ndarray  # [B] int32
    y_lens: np.ndarray  # [B] int32
    days: np.ndarray  # [B] int32
    weight: np.ndarray  # [B] float32: 1 real row, 0 pad row
    idx: np.ndarray | None = None  # [B] trial indices into the dataset
    t_env: int = 0  # time envelope this batch pads to


def _gather(ds: PackedDataset, idx: np.ndarray, t_max: int, u_max: int,
            weight: np.ndarray, materialize_x: bool = True) -> Batch:
    b = len(idx)
    c = ds.n_channels
    lens = ds.lengths[idx]
    if materialize_x:
        x = np.zeros((b, t_max, c), dtype=np.float32)
        for j, i in enumerate(idx):
            n = min(int(lens[j]), t_max)
            x[j, :n] = ds.features[ds.offsets[i] : ds.offsets[i] + n]
    else:
        x = None
    y = np.zeros((b, u_max), dtype=np.int32)
    width = min(u_max, ds.labels.shape[1])
    y[:, :width] = ds.labels[idx][:, :width]
    return Batch(
        x=x,
        y=y,
        x_lens=np.minimum(lens, t_max).astype(np.int32),
        y_lens=ds.label_lens[idx],
        days=ds.days[idx],
        weight=weight.astype(np.float32),
        idx=np.asarray(idx),
        t_env=t_max,
    )


def bucket_batch_sizes(
    buckets: list[int], token_budget: int, t_max: int,
    max_batch: int = 256, multiple: int = 8,
) -> list[int]:
    """Tokens-constant per-bucket batch sizes: ``B_k = token_budget / T_k``
    rounded down to a multiple of ``multiple``, clamped to
    ``[multiple, max_batch]``.

    Every bucket's step then moves the same activation volume, so short
    envelopes stop under-filling the chip. ``multiple`` must match the
    model's MXU row granularity — measured on the v5e (BASELINE.md
    "tokens-constant bucketing"): the Conformer flattens batch into
    ``[B·T, D]`` GEMMs and gains at any multiple of 8, but the
    bidirectional GRU's recurrent matmuls have only ``M = 2·B`` rows, so
    a B that is not a multiple of 64 leaves the 128-row MXU tile
    part-empty at every scan step (B=104 measured −22%, B=128 +9%) —
    use ``multiple=64`` for the GRU family. Multiples ≥8 also keep every
    B_k data-parallel-shardable on meshes up to 8-way.

    NOTE: ``multiple`` is also a hard FLOOR — a bucket whose
    budget-derived B_k falls below it is clamped UP, so a small
    ``tokensPerBatch`` can exceed its token budget by up to
    ``multiple·T_k / token_budget``× on long-envelope buckets (a memory
    surprise if the budget was chosen to bound HBM). A warning is issued
    when the floor overrides the budget.
    """
    sizes = []
    for t in buckets:
        b_k = int(token_budget // min(t, t_max)) // multiple * multiple
        if b_k < multiple:
            import warnings

            warnings.warn(
                f"tokensPerBatch={token_budget} derives B_k={b_k} < "
                f"batchMultiple={multiple} for bucket T={t}; clamping up "
                f"to {multiple} ({multiple * min(t, t_max)} tokens — over "
                f"budget). Raise tokensPerBatch or lower batchMultiple.",
                stacklevel=2,
            )
        sizes.append(min(max(multiple, b_k), max_batch))
    return sizes


def sample_batch(
    ds: PackedDataset,
    rng: np.random.Generator,
    batch_size: int,
    t_max: int,
    u_max: int,
    *,
    buckets: list[int] | None = None,
    bucket_sizes: list[int] | None = None,
    materialize_x: bool = True,
) -> Batch:
    """One uniformly-random batch of distinct trials (reference per-step
    semantics).

    With ``buckets``, batches are composed *within* one length bucket:
    draw an anchor trial uniformly (which selects its bucket with
    probability ∝ bucket size), then fill the batch from that bucket and
    pad to its ceiling. Each trial's marginal sampling probability stays
    the uniform ``B/N`` (``n_k/N · B/n_k``), so the training distribution
    is unchanged; only trial *co-occurrence* becomes length-local —
    standard bucket-by-length batching. This matters because padding to
    the batch max never engages short buckets at production batch sizes
    (a uniform B=64 draw almost surely contains one near-max trial), so
    the earlier pad-to-batch-max variant delivered no speedup. A bucket
    smaller than ``batch_size`` repeats trials to fill the static shape.

    With ``bucket_sizes`` (tokens-constant batching, ``tokensPerBatch``),
    bucket ``k``'s batches use ``bucket_sizes[k]`` rows instead of
    ``batch_size``, and the bucket is drawn with probability
    ``∝ n_k / B_k`` so each trial's *expected visits per step* stay equal
    across buckets (``p_k · B_k / n_k = 1/Z``) — the uniform marginal is
    preserved exactly as in the fixed-B case, just amortized over steps
    that now carry more short rows each.
    """
    if buckets is not None and len(buckets) > 1 and ds.n_trials > 0:
        edges = np.asarray(buckets)
        bins = np.searchsorted(edges, np.minimum(ds.lengths, t_max))
        bins = np.minimum(bins, len(buckets) - 1)  # fallback bucket
        if bucket_sizes is not None:
            counts = np.bincount(bins, minlength=len(buckets))
            sizes = np.asarray(bucket_sizes, dtype=np.float64)
            p = np.where(counts > 0, counts / sizes, 0.0)
            p /= p.sum()
            k = int(rng.choice(len(buckets), p=p))
            b_k = int(bucket_sizes[k])
        else:
            k = int(bins[int(rng.integers(ds.n_trials))])
            b_k = batch_size
        members = np.flatnonzero(bins == k)
        idx = rng.choice(members, size=min(b_k, len(members)),
                         replace=False)
        if len(idx) < b_k:
            pad = rng.choice(members, size=b_k - len(idx), replace=True)
            idx = np.concatenate([idx, pad])
        t_env = min(int(buckets[k]), t_max)
        return _gather(ds, idx, t_env, u_max, np.ones(b_k),
                       materialize_x=materialize_x)
    idx = rng.choice(ds.n_trials, size=min(batch_size, ds.n_trials),
                     replace=False)
    if len(idx) < batch_size:  # tiny datasets: repeat to fill the envelope
        pad = rng.choice(ds.n_trials, size=batch_size - len(idx), replace=True)
        idx = np.concatenate([idx, pad])
    return _gather(ds, idx, t_max, u_max, np.ones(batch_size),
                   materialize_x=materialize_x)


def eval_batches(
    ds: PackedDataset, batch_size: int, t_max: int, u_max: int,
    *, buckets: list[int] | None = None, materialize_x: bool = True,
) -> Iterator[Batch]:
    """Full-coverage iterator; the final partial batch is padded to the
    static batch size with repeated rows carrying weight 0.

    With ``buckets``, trials are visited in length order and each batch
    pads to the smallest bucket ceiling covering it — identical aggregate
    metrics (PER/loss are masked and order-independent), same compile
    count as bucketed training, less padding compute."""
    n = ds.n_trials
    order = (
        np.argsort(np.minimum(ds.lengths, t_max), kind="stable")
        if buckets is not None and len(buckets) > 1
        else np.arange(n)
    )
    for start in range(0, n, batch_size):
        idx = order[start : min(start + batch_size, n)]
        weight = np.ones(batch_size)
        if len(idx) < batch_size:
            weight[len(idx):] = 0.0
            idx = np.concatenate(
                [idx, np.full(batch_size - len(idx), idx[0], dtype=idx.dtype)]
            )
        t_env = t_max
        if buckets is not None and len(buckets) > 1:
            t_env = min(bucket_for(buckets, int(ds.lengths[idx].max())),
                        t_max)
        yield _gather(ds, idx, t_env, u_max, weight,
                      materialize_x=materialize_x)


def round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def length_buckets(
    ds: PackedDataset,
    n_buckets: int,
    t_max: int,
    *,
    time_multiple: int = 128,
) -> list[int]:
    """Quantile-based time buckets, each a multiple of ``time_multiple``.

    The reference pads every batch to its own max (dynamic shapes); under
    XLA we quantize that to a few fixed envelopes — one compile per bucket,
    short batches stop paying for the global max. Returns ascending bucket
    ceilings ending at ``t_max``.
    """
    if n_buckets <= 1 or ds.n_trials == 0:
        return [t_max]
    qs = np.quantile(
        np.minimum(ds.lengths, t_max), np.linspace(0, 1, n_buckets + 1)[1:-1]
    )
    buckets = sorted(
        {min(round_up(int(q), time_multiple), t_max) for q in qs} | {t_max}
    )
    return [b for b in buckets if b > 0]


def bucket_for(buckets: list[int], batch_max_len: int) -> int:
    """Smallest bucket ceiling >= the batch's max length (last as fallback)."""
    for b in buckets:
        if b >= batch_max_len:
            return b
    return buckets[-1]


def choose_envelope(
    train: PackedDataset,
    test: PackedDataset | None = None,
    *,
    time_multiple: int = 128,
    max_time: int | None = None,
) -> tuple[int, int]:
    """Pick the static (T_max, U_max) envelope.

    T is rounded up to a lane-friendly multiple so downstream unfold frames
    tile well on the MXU; ``max_time`` mirrors the reference's
    ``maxTimeSeriesLen`` arg (scripts/train_model.py:14).
    """
    t = train.max_len
    u = int(train.label_lens.max()) if train.n_trials else 1
    if test is not None and test.n_trials:
        t = max(t, test.max_len)
        u = max(u, int(test.label_lens.max()))
    t = round_up(t, time_multiple)
    if max_time is not None:
        t = min(t, max_time)
    return t, max(u, 1)
