"""Training and eval loop with the reference's ``trainModel(args)`` surface,
on one device or data-parallel over several.

Port of ``neural_speech_decoder_tpu/training/trainer.py`` for both model
families (``model_type`` ``gru_baseline`` or ``transformer_ctc``): per-step
uniformly random batches (``data/batching.py``), noise augmentation, the
train forward with its dropout, the CTC loss with the reference's
reductions, label smoothing and InterCTC blending, Adam with L2 and a
linear schedule (or AdamW with warmup-cosine, the Conformer's, with its gradients
clipped to norm 1.0), eval every ``evalEvery`` steps (CTC loss and greedy
PER), the best-CER ``modelState``, the periodic ``lastState``,
SIGTERM/SIGUSR1 preemption and an exact ``resume``, device-resident data
(``deviceResidentData``: ``data/device_data.py``) and a ``torch.profiler``
trace of the steps ``profile_steps = [start, stop]`` into
``outputDir/profile``.

Data parallelism (the JAX trainer's default over its mesh's 'data' axis,
``training/trainer.py:531-690``) runs one process per device
(``parallel/``): either in a process group made already (by
``parallel/multihost.py::initialize`` or ``torchrun``: each process is one
rank), or, with no group and ``n_data_devices`` resolving above 1
(``parallel/data_parallel.py::resolve_n_data``, JAX's rule), in rank
processes ``train_model`` starts itself (``spawn``, one card each, or gloo
ranks on the CPU), returning rank 0's summary. Every rank samples the same
global batch and keeps its rows; its noise, dropout and DropPath are its
rows of the global draws (``ops/rows.py``); the gradients are averaged
before the clip and the optimizer, and the logged loss terms too; the eval
rows are split over the ranks and gathered; rank 0 alone writes the run
directory; a SIGTERM or SIGUSR1 on any rank stops every rank at the same
step.

Tensor parallelism (``n_model_devices`` > 1, the JAX trainer's
``parallel/shardings.py`` branch, ``training/trainer.py:532-575``) makes
the ranks an ``(n_data, n_model)`` grid (``parallel/mesh.py``): rank ``r``
at ``(d, m) = divmod(r, n_model)``, ``n_data * n_model`` rank processes
when ``train_model`` starts them. Every rank builds the same whole model,
then keeps its shards of the sharded leaves (``models/api.py::
shard_model``; the Conformer's qkv interleaved first, as JAX's
``shard_params``), and the optimizer updates them; the model ranks of one
data coordinate hold its rows and run the forward together; the gradients
are averaged over the data group only; the clip's global norm and the watch
norms sum the squares of sharded leaves over the model group and count a
replicated leaf once; the checkpoints hold the whole parameters (and Adam
moments), gathered, in the run's layout (interleaved for a TP Conformer,
as JAX's), with the run's ``args``. ``resume`` reshards them at any grid,
as JAX's restore re-installs its live shardings; a Conformer checkpoint
whose qkv layout differs from the run's (a TP run resumed on one model
rank, or the reverse) is relaid out, where JAX would read the columns in
the wrong order. Deliberate differences from JAX: a process per device,
not one process driving every local device; ``multihost_staging`` takes
the one path (every rank stages its own rows; device-resident data stays
on); the backend is an argument of ``initialize`` (``nccl`` for cards and
``gloo`` for the CPU by default; gloo on a card only when the caller makes
such a group); the eval is split and gathered on one host too; sharded
dimensions must divide by ``n_model`` (JAX pads uneven shards);
``fused_ffn`` under tensor parallelism raises (``models/conformer.py``),
and the GRU's recurrence runs whole on every model rank (``models/
gru.py``).

The device comes from ``args["device"]`` (default ``"cuda"``, which raises
without a card). The noise and dropout of step ``i`` come from a
``torch.Generator`` seeded from ``(seed, i)``, as the JAX package folds the
step into its key, so a resumed run draws what an uninterrupted one would,
at any world size. A finished run's last ``metrics.jsonl`` record also
holds the wall-clock span of its steps (``summary/steps_wall_start``,
``summary/steps_wall_end``) and its kernel launches by wrapper and body
(``summary/launches/<wrapper>[/<body>]``, ``ops/kernels.launch_counts``;
summed over the ranks, and each rank's under ``summary/rank<r>/``), which
show what each of a sweep's worker processes or a run's ranks ran, and
when.
"""

from __future__ import annotations

import math
import signal
import threading
import time
import warnings
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from ..data.batching import (
    Batch,
    batch_rows,
    bucket_batch_sizes,
    choose_envelope,
    eval_batches,
    length_buckets,
    sample_batch,
)
from ..data.dataset import PackedDataset, load_pickle_dataset, pack_days
from ..data.device_data import DeviceData
from ..models.api import (
    Decoder,
    build_model,
    config_from_args,
    forward,
    model_type_of,
    shard_model,
)
from ..ops.ctc import ctc_loss
from ..ops.decode import batch_per, greedy_decode
from ..ops.kernels import launch_counts
from ..ops.noise import apply_noise
from ..ops.rows import BatchShard
from ..parallel import data_parallel as dp
from ..parallel.mesh import (
    Mesh,
    batch_shard,
    batch_sharding,
    default_device,
    make_mesh,
    replicated,
)
from ..parallel.multihost import default_backend
from ..parallel.shardings import (
    check_shardable,
    gather_params,
    leaf_dim,
    named_leaves,
    relayout_attention,
    relayout_leaf,
    shard_params,
)
from ..parallel.tensor_parallel import ModelShard, join, split
from ..utils.logging import MetricLogger
from .checkpoints import CheckpointManager, load_args, save_args, save_training_stats
from .optim import grad_clip_norm, lr_schedule, make_optimizer

WATCH_PREFIXES = ("train/grad_norm/", "train/param_norm/")


def resolve_device(args: dict) -> torch.device:
    """``args["device"]`` (default ``"cuda"``); a CUDA device with no card
    raises instead of falling back to the CPU."""
    device = torch.device(args.get("device", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} asked for, but torch.cuda.is_available() is "
            f"False; pass device: cpu to train on the CPU")
    return device


def n_model_devices(args: dict) -> int:
    """The size of the 'model' axis (``n_model_devices``; a YAML null is 1)."""
    return int(args.get("n_model_devices") or 1)


_warned_rng_impl = False


def warn_unused_args(args: dict) -> None:
    """Warn, once per process, about ``rng_impl``: the JAX trainer picks its
    key's PRNG with it (``jax.random.key(seed, impl=...)``); the port draws
    from ``torch.Generator`` seeded per step, which is bit-reproducible
    already, so the arg changes nothing here."""
    global _warned_rng_impl
    if args.get("rng_impl") is not None and not _warned_rng_impl:
        _warned_rng_impl = True
        warnings.warn(
            f"rng_impl={args['rng_impl']!r} has no effect in the PyTorch port: it draws "
            f"its noise and dropout from torch.Generator seeded per step, which is "
            f"bit-reproducible whatever the JAX key's implementation", stacklevel=2)


def ctc_plain(args: dict | None) -> bool:
    """``ctc_use_kernel: false`` runs the CTC loss's plain version (the JAX
    trainer takes optax's CTC there); None and True keep the kernels."""
    return (args or {}).get("ctc_use_kernel") is False


def step_generator(device: torch.device, seed: int, step: int) -> torch.Generator:
    """The noise and dropout generator of one train step."""
    return torch.Generator(device=device).manual_seed(
        (seed % 2**31) * 2**32 + step)


def batch_tensors(batch: Batch, device: torch.device) -> tuple[torch.Tensor, ...]:
    """``(x, y, x_lens, y_lens, days)`` of a host batch, on the device."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (batch.x, batch.y, batch.x_lens, batch.y_lens,
                           batch.days))


def _loss_and_metrics(
    args: dict,
    model: Decoder,
    batch: tuple[torch.Tensor, ...],
    generator: torch.Generator,
    *,
    plain: bool = False,
    shard: BatchShard | None = None,
) -> tuple[torch.Tensor, dict]:
    """Training loss with the reference's blending (``trainer.py::
    _loss_and_metrics``) of the noisy batch. Without label smoothing: the
    length-normalized batch-mean CTC loss. With ``label_smoothing`` s:
    ``(1-s)`` times the batch mean of the per-sequence CTC losses plus ``s``
    times the KL to the uniform distribution, summed over every frame
    (padding included) and divided by the frame count T'. With an InterCTC
    head (the Conformer): ``(1-w)`` times that plus ``w`` times the same
    CTC reduction of the InterCTC log-probs, ``w = interctc_weight``.

    With a ``shard`` (data parallelism) the batch is this rank's rows of the
    global batch, and the loss is this rank's term of a mean over the ranks
    that equals the single-device loss: the CTC means are means over equal
    row counts already, the KL (a sum over rows) is scaled by the world
    size, and ``tokensPerBatch``'s scale reads the global row count."""
    x, y, x_lens, y_lens, days = batch
    x = apply_noise(generator, x, args["whiteNoiseSD"], args["constantOffsetSD"], shard)
    log_probs, out_lens, inter_log_probs = forward(
        model, x, days, x_lens, train=True, generator=generator, plain=plain,
        shard=shard)
    smoothing = args.get("label_smoothing", 0.0)
    metrics = {}
    plain_ctc = plain or ctc_plain(args)

    def ctc(lp):
        if smoothing > 0:
            return ctc_loss(lp, out_lens, y, y_lens, reduction="none",
                            plain=plain_ctc).mean()
        return ctc_loss(lp, out_lens, y, y_lens, reduction="mean", plain=plain_ctc)

    main_loss = ctc(log_probs)
    if smoothing > 0:
        n_classes = args["nClasses"] + 1
        uni = -math.log(n_classes)
        kl = ((1.0 / n_classes) * (uni - log_probs)).sum() / log_probs.shape[1]
        if shard is not None:
            kl = kl * shard.count
        metrics["train/ctc_loss"] = main_loss
        metrics["train/kl_loss"] = kl
        main_loss = (1 - smoothing) * main_loss + smoothing * kl
    loss = main_loss
    if inter_log_probs is not None:
        inter = ctc(inter_log_probs)
        w = args.get("interctc_weight", 0.3)
        loss = (1.0 - w) * main_loss + w * inter
        metrics["train/inter_ctc_loss"] = inter
        metrics["train/main_loss"] = main_loss
    # tokens-constant bucketing: a batch of B_k rows weighs B_k / batchSize,
    # so every trial's gradient weight stays what it is at fixed B
    if args.get("tokensPerBatch", 0) and args.get("tokensLossScale", True):
        rows = shard.total if shard is not None else x.shape[0]
        loss = loss * (rows / int(args.get("batchSize", rows)))
    metrics["train/loss"] = loss
    return loss, metrics


def _named_leaves(tree, prefix: str) -> list[tuple[str, torch.Tensor]]:
    if isinstance(tree, dict):
        return [kv for k in tree for kv in _named_leaves(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _named_leaves(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def sharded_flags(model: Decoder) -> list[bool]:
    """For each of ``model.parameters()``, whether it is a shard of a leaf
    that tensor parallelism splits (all False for a whole model)."""
    if getattr(model, "tp", None) is None:
        return [False] * len(list(model.parameters()))
    paths = _param_paths(model)
    mt = model_type_of(model.cfg)
    return [leaf_dim(paths[id(p)], mt) is not None for p in model.parameters()]


def _param_paths(model: Decoder) -> dict[int, tuple]:
    """``id(parameter) -> path`` in the model's parameter tree."""
    return {id(p): path for path, p in named_leaves(model.params)}


def _sum_over_model(squares: torch.Tensor, flags: list[bool], tp: ModelShard | None):
    """Per-leaf squared norms with a sharded leaf's summed over the model
    group (one all-reduce), a replicated leaf's as they are."""
    if tp is None or not any(flags):
        return squares
    mask = torch.tensor(flags, device=squares.device)
    part = torch.where(mask, squares, torch.zeros((), device=squares.device,
                                                  dtype=squares.dtype))
    dist.all_reduce(part, group=tp.group)
    return torch.where(mask, part, squares)


def clip_grad_norm(params: list[torch.Tensor], max_norm: float, flags: list[bool],
                   tp: ModelShard | None) -> torch.Tensor:
    """``torch.nn.utils.clip_grad_norm_`` over the whole model when some
    ``params`` (``flags``) are this model rank's shards: the global norm
    sums the squares of the sharded leaves over the model group and counts
    each replicated leaf once, so every rank scales by the single-device
    factor. Returns the norm before clipping."""
    if tp is None:
        return torch.nn.utils.clip_grad_norm_(params, max_norm)
    grads = [p.grad for p in params]
    norms = torch.stack([torch.linalg.vector_norm(g, 2.0) for g in grads])
    total = _sum_over_model(norms.float() ** 2, flags, tp).sum().sqrt()
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    for g in grads:
        g.mul_(coef.to(g.dtype))
    return total


def make_train_step(
    args: dict,
    model: Decoder,
    optimizer: torch.optim.Optimizer,
    scheduler: torch.optim.lr_scheduler.LRScheduler,
    mesh: Mesh | None = None,
) -> Callable[[tuple, torch.Generator], dict]:
    """``train_step(batch, generator) -> metrics``: loss, backward, the
    optional clip, one optimizer and scheduler step. The metrics are device
    tensors (reading them waits for the step). With ``watch_log_freq > 0``
    they include per-leaf gradient and parameter norms
    (``train/grad_norm/<path>``, ``train/param_norm/<path>``, on the
    parameters before the update). With a 'data' axis in ``mesh`` the batch
    is this rank's rows of the global batch: the gradients and the loss
    terms are averaged over the data group after the backward, so that the
    clip, the norms, the update and the metrics are the global batch's.
    With a 'model' axis (``model.tp``) the model holds this rank's shards:
    the clip and the norms of the sharded leaves are the whole leaves'."""
    watch = int(args.get("watch_log_freq", 100)) > 0
    clip = grad_clip_norm(args)
    data_parallel = mesh is not None and mesh.n_data > 1
    params = list(model.parameters())
    flags = sharded_flags(model)
    tp = getattr(model, "tp", None)
    leaves = _named_leaves(model.params, "")
    leaf_flags = dict(zip(map(id, params), flags))

    def train_step(batch, generator):
        optimizer.zero_grad(set_to_none=True)
        shard = batch_shard(mesh, batch[0].shape[0]) if data_parallel else None
        loss, metrics = _loss_and_metrics(args, model, batch, generator, shard=shard)
        loss.backward()
        if data_parallel:
            dp.average_gradients(params, mesh)
            metrics = dp.mean_metrics(metrics, mesh)
        if clip is not None:
            # clip_grad_norm_ returns the norm before clipping
            metrics["train/grad_norm"] = clip_grad_norm(params, clip, flags, tp)
        if watch:
            with torch.no_grad():
                gn = [p.grad.float().norm() for _, p in leaves]
                pn = [p.float().norm() for _, p in leaves]
                if tp is not None:
                    lf = [leaf_flags[id(p)] for _, p in leaves]
                    gn = _sum_over_model(torch.stack(gn) ** 2, lf, tp).sqrt().unbind()
                    pn = _sum_over_model(torch.stack(pn) ** 2, lf, tp).sqrt().unbind()
                for (path, _), g, w in zip(leaves, gn, pn):
                    metrics["train/grad_norm" + path] = g
                    metrics["train/param_norm" + path] = w
        optimizer.step()
        scheduler.step()
        return {k: v.detach() for k, v in metrics.items()}

    return train_step


def make_eval_step(model: Decoder, args: dict | None = None) -> Callable[..., tuple]:
    """``eval_step(x, y, x_lens, y_lens, days) -> (per_seq_loss [B],
    tokens [B, L], decoded_lens [B])``: the eval forward, the per-sequence
    CTC loss (alpha only: no gradient; its plain version with the run's
    ``ctc_use_kernel: false``) and the greedy decode."""
    plain_ctc = ctc_plain(args)

    @torch.inference_mode()
    def eval_step(x, y, x_lens, y_lens, days):
        log_probs, out_lens, _ = forward(model, x, days, x_lens, train=False)
        per_seq = ctc_loss(log_probs, out_lens, y, y_lens, reduction="none",
                           plain=plain_ctc)
        tokens, dec_lens = greedy_decode(log_probs, out_lens)
        return per_seq, tokens, dec_lens

    return eval_step


def run_eval(
    eval_step,
    test_ds: PackedDataset,
    batch_size: int,
    t_max: int,
    u_max: int,
    device: torch.device,
    *,
    buckets: list[int] | None = None,
    torch_mean_semantics: bool = True,
    device_data: DeviceData | None = None,
    mesh: Mesh | None = None,
) -> tuple[float, float, int, int]:
    """Full test pass: ``(avg_day_loss, per, edit_dist, seq_len)``.

    ``avg_day_loss`` follows the reference: per batch a scalar, then the
    mean over batches. The scalar is the mean over real rows of the
    length-normalized loss (``torch_mean_semantics``, the runs without
    label smoothing) or the sum of the real rows' losses. With
    ``device_data`` (``test_ds`` on the device) the batches are assembled
    there. With a 'data' axis in ``mesh`` each data coordinate runs its
    rows of every batch (its model ranks together) and the outputs are
    gathered over the data group, so every rank computes the single-device
    metrics (JAX's ``process_allgather``)."""
    distributed = mesh is not None and mesh.n_data > 1
    batch_scalars = []
    total_dist = 0
    total_len = 0
    for batch in eval_batches(test_ds, batch_size, t_max, u_max, buckets=buckets,
                              materialize_x=device_data is None and not distributed):
        local = batch
        if distributed:
            local = batch_rows(test_ds, batch, batch_sharding(mesh, batch_size),
                               materialize_x=device_data is None)
        tensors = (batch_tensors(local, device) if device_data is None
                   else device_data.assemble(local))
        per_seq, tokens, dec_lens = eval_step(*tensors)
        if distributed:
            per_seq, tokens, dec_lens = (dp.gather_rows(t, mesh)
                                         for t in (per_seq, tokens, dec_lens))
        per_seq = per_seq.cpu().numpy()
        w = batch.weight
        if torch_mean_semantics:
            norm = per_seq / np.maximum(batch.y_lens, 1)
            batch_scalars.append(float((norm * w).sum() / max(w.sum(), 1)))
        else:
            batch_scalars.append(float((per_seq * w).sum()))
        real = w > 0
        d, n = batch_per(tokens.cpu().numpy()[real], dec_lens.cpu().numpy()[real],
                         batch.y[real], batch.y_lens[real])
        total_dist += d
        total_len += n
    avg_day_loss = float(np.sum(batch_scalars) / max(len(batch_scalars), 1))
    per = total_dist / max(total_len, 1)
    return avg_day_loss, per, total_dist, total_len


def train_model(args: dict) -> dict:
    """Train per the reference contract; returns a summary dict.

    SIGTERM and SIGUSR1 make the run checkpoint and return at the next step
    boundary; ``resume: true`` then continues from that step exactly (same
    sampler state, same per-step noise, same metric history), at any world
    size. The handlers are installed before the slow set-up and restored on
    every exit. With no process group and ``n_data_devices`` resolving
    above 1, or ``n_model_devices`` above 1, the run goes to ``n_data x
    n_model`` rank processes started here (the signals passed on to them),
    and rank 0's summary is returned. A config that tensor parallelism
    cannot shard raises ``ValueError`` before anything is written."""
    n_model = n_model_devices(args)
    if n_model > 1:
        check_shardable(config_from_args(args, 1), n_model)
    if not dist.is_initialized():
        device = resolve_device(args)
        n_ranks = dp.resolve_n_data(args, device) * n_model
        if n_ranks > 1:
            return _train_ranks(args, device, n_ranks)
    preempt_requested = threading.Event()

    def _request_stop(signum, frame):
        print(f"signal {signum} received — will checkpoint and exit")
        preempt_requested.set()

    prev_handlers: dict[int, Any] = {}
    if (bool(args.get("preempt_signals", True))
            and threading.current_thread() is threading.main_thread()):
        for sig in (signal.SIGTERM, signal.SIGUSR1):
            prev_handlers[sig] = signal.signal(sig, _request_stop)
    try:
        return _train_model_impl(args, preempt_requested)
    finally:
        for sig, h in prev_handlers.items():
            signal.signal(sig, h)


def _train_ranks(args: dict, device: torch.device, n_ranks: int) -> dict:
    """``train_model`` over ``n_ranks`` rank processes of a new group: card
    ``r`` of the visible ones for rank ``r`` (or the CPU for each), the
    group's timeout ``dist_timeout_s`` (default the backend's)."""
    devices = ([torch.device("cuda", r) for r in range(n_ranks)] if device.type == "cuda"
               else [device] * n_ranks)
    rank_args = [({**args, "device": str(d)},) for d in devices]
    timeout = args.get("dist_timeout_s")
    return dp.launch(train_model, rank_args, devices=devices,
                     backend=default_backend(device),
                     timeout_s=None if timeout is None else float(timeout))[0]


def _start_profile(device: torch.device) -> torch.profiler.profile:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _stop_profile(prof, device: torch.device, output_dir: str, first: int,
                  last: int) -> None:
    """Wait for the device, stop the trace and write it as a Chrome trace
    ``outputDir/profile/trace_steps_<first>-<last>.json``."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    path = Path(output_dir) / "profile" / f"trace_steps_{first}-{last}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    print(f"profile of steps {first}-{last} written to {path}")


def make_run_mesh(args: dict, device: torch.device) -> Mesh:
    """The run's mesh: the process group's ranks as an ``(n_data,
    n_model_devices)`` grid when one is initialized (each on ``device``;
    ``cuda`` means ``cuda:LOCAL_RANK``), else this process alone. The
    group's size over ``n_model_devices`` must be the size JAX's rule gives
    the 'data' axis, and the eval batches must split over it too."""
    n_model = n_model_devices(args)
    if not dist.is_initialized():
        return make_mesh(n_model=n_model, device=device)
    if device.type == "cuda" and device.index is None:
        device = default_device()  # cuda:LOCAL_RANK
    if dist.get_backend() == "nccl" and device.type != "cuda":
        raise ValueError(f"device {device} in an nccl process group; use gloo for the CPU")
    world = dist.get_world_size()
    n_data = dp.resolve_n_data(args, device, world=world)
    if n_data * n_model != world or int(args["batchSize"]) % n_data:
        raise ValueError(
            f"the process group has {world} ranks, but batchSize={args['batchSize']}, "
            f"n_data_devices={args.get('n_data_devices')}, n_model_devices={n_model}, "
            f"tokensPerBatch={args.get('tokensPerBatch', 0)} give the 'data' axis "
            f"{n_data} (JAX's rule) or do not split the eval batches")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return make_mesh(n_model=n_model, device=device)


def _train_model_impl(args: dict, preempt_requested: threading.Event) -> dict:
    warn_unused_args(args)
    mesh = make_run_mesh(args, resolve_device(args))
    device, primary, distributed = mesh.device, mesh.primary, mesh.distributed
    data_parallel = mesh.n_data > 1
    output_dir = args["outputDir"]
    seed = int(args.get("seed", 0))
    np_rng = np.random.default_rng(seed)

    # rank 0 alone writes the run directory (the logger of another rank is
    # disabled, utils/logging.py)
    logger = MetricLogger(
        output_dir,
        project=args.get("wandb_project", "neural-speech-decoder"),
        run_name=args.get("wandb_run_name"),
        config={k: v for k, v in args.items() if k != "dataset"},
        mode=args.get("wandb_mode", "offline"),
    )
    raw = args.get("dataset") or load_pickle_dataset(args["datasetPath"])
    train_ds = pack_days(raw["train"])
    test_ds = pack_days(raw["test"])
    n_days = len(raw["train"])
    # the day count, so that load_model rebuilds the same day layer
    if primary:
        save_args(output_dir, {**{k: v for k, v in args.items() if k != "dataset"},
                               "nDays": n_days})

    batch_size = int(args["batchSize"])
    time_multiple = int(args.get("time_multiple", 128))
    t_max, u_max = choose_envelope(train_ds, test_ds, time_multiple=time_multiple,
                                   max_time=args.get("maxTimeSeriesLen"))

    # the same seed on every rank, and rank 0's weights broadcast, so that
    # the ranks start from one model whatever their devices
    model = build_model(args, n_days, device, seed)
    replicated(mesh, list(model.parameters()))
    n_params = sum(p.numel() for p in model.parameters())
    tp = mesh.model_shard
    if tp is not None:  # this rank's shards, as JAX's shard_params after init
        model = shard_model(model, tp)
    print(f"Model has {n_params:,} parameters ({n_params:,} trainable)")
    logger.log({"model/total_parameters": n_params,
                "model/trainable_parameters": n_params}, step=0)

    optimizer, scheduler = make_optimizer(args, model.parameters())
    schedule = lr_schedule(args)
    train_step = make_train_step(args, model, optimizer, scheduler, mesh)
    eval_step = make_eval_step(model, args)
    torch_mean = args.get("label_smoothing", 0.0) == 0

    n_batch = int(args["nBatch"])
    eval_every = int(args.get("evalEvery", 100))
    ckpt_every = int(args.get("checkpointEvery", 0))
    ckpt = CheckpointManager(output_dir)
    compat_skip_first = bool(args.get("compat_skip_first_eval_save", False))

    test_loss: list[float] = []
    test_cer: list[float] = []
    start_step = 0
    if args.get("resume") and ckpt.exists("lastState"):
        # every rank reads what rank 0 wrote: whole leaves, resharded
        state = ckpt.restore("lastState", device)
        params, opt_state = _restore_layout(model, state)
        model.load_params(shard_params(params, model.tp, model_type_of(model.cfg)))
        optimizer.load_state_dict(_map_optimizer_state(
            model, opt_state, lambda path, v, dim: split(v, dim, tp)))
        scheduler.load_state_dict(state["scheduler"])
        side = ckpt.load_sidecar()
        start_step = int(side["step"])
        test_loss = list(side["testLoss"])
        test_cer = list(side["testCER"])
        np_rng.bit_generator.state = side["np_rng_state"]
        print(f"Resumed from step {start_step}")

    def save_last(step):
        # the model group joins the whole leaves; rank (0, 0) writes them
        params = _whole_params(model)
        opt_state = _map_optimizer_state(model, optimizer.state_dict(),
                                         lambda path, v, dim: join(v, dim, tp))
        if not primary:
            return
        ckpt.save("lastState", {
            "params": params,
            "optimizer": opt_state,
            "scheduler": scheduler.state_dict(),
            "step": step + 1,
            **_layout_of(model),
        })
        ckpt.save_sidecar({
            "step": step + 1,
            "testLoss": test_loss,
            "testCER": test_cer,
            "np_rng_state": np_rng.bit_generator.state,
        })

    # length bucketing and tokens-constant batch sizes, as the JAX trainer
    n_buckets = int(args.get("lengthBuckets", 1))
    buckets = (length_buckets(train_ds, n_buckets, t_max,
                              time_multiple=time_multiple)
               if n_buckets > 1 else None)
    token_budget = int(args.get("tokensPerBatch", 0))
    bucket_sizes = (
        bucket_batch_sizes(buckets, token_budget, t_max,
                           max_batch=int(args.get("maxBatchSize", 256)),
                           multiple=int(args.get("batchMultiple", 64)))
        if buckets is not None and token_budget > 0 else None
    )

    # device-resident data: the packed features on the device once, each
    # batch gathered there from the host-sampled indices (on every rank,
    # which gathers only its rows)
    device_data = bool(args.get("deviceResidentData", False))
    train_dd = DeviceData(train_ds, device) if device_data else None
    test_dd = DeviceData(test_ds, device) if device_data else None

    def put_batch(batch: Batch) -> tuple[torch.Tensor, ...]:
        if data_parallel:
            # every rank sampled the same global batch: keep this rank's rows
            batch = batch_rows(train_ds, batch, batch_sharding(mesh, len(batch.idx)),
                               materialize_x=not device_data)
        return train_dd.assemble(batch) if device_data else batch_tensors(batch, device)

    profile_start, profile_stop = args.get("profile_steps") or (None, None)
    if not primary:  # one trace, rank 0's
        profile_start = profile_stop = None
    prof = None

    watch_freq = int(args.get("watch_log_freq", 100))
    # under a process group a stop is agreed: each step's preemption flag
    # is all-reduced with MAX and read with that step's metrics (after the
    # next step is queued, so no step waits for it), and every rank stops
    # before the same step, one step later than a process alone would
    stop_agreed = [False]

    def flush_metrics(pending):
        if pending is None:
            return
        held, at_step, stop = pending
        # per-layer watch norms only on the watch interval
        if not (watch_freq and at_step % watch_freq == 0):
            held = {k: v for k, v in held.items()
                    if not k.startswith(WATCH_PREFIXES)}
        log_dict = {k: float(v) for k, v in held.items()}
        if stop is not None and float(stop) > 0:
            stop_agreed[0] = True
        steps_wall[1] = time.time()
        log_dict["train/learning_rate"] = schedule(at_step)
        log_dict["train/batch"] = at_step
        logger.log(log_dict, step=at_step)

    def stop_now() -> bool:
        return stop_agreed[0] if distributed else preempt_requested.is_set()

    launches0 = launch_counts()
    start_time = time.time()
    # wall clock of the first step queued and of the last step's metrics read
    steps_wall = [start_time, start_time]
    pending = None  # (metrics, step, stop flag) of the previous step, read after the next
    preempted_at: int | None = None
    for step in range(start_step, n_batch):
        if stop_now():
            preempted_at = step
            break
        if step == profile_start:
            prof = _start_profile(device)
        batch = sample_batch(train_ds, np_rng, batch_size, t_max, u_max,
                             buckets=buckets, bucket_sizes=bucket_sizes,
                             materialize_x=not (device_data or data_parallel))
        metrics = train_step(put_batch(batch), step_generator(device, seed, step))
        stop = dp.agree_max(preempt_requested.is_set(), mesh) if distributed else None
        if step == profile_stop and prof is not None:
            _stop_profile(prof, device, output_dir, profile_start, step)
            prof = None
        # reading the metrics waits for the device: read the previous
        # step's after this one is queued, so host batch prep overlaps it
        flush_metrics(pending)
        pending = (metrics, step, stop)

        if step % eval_every == 0:
            flush_metrics(pending)
            pending = None
            avg_loss, cer, edit_dist, seq_len = run_eval(
                eval_step, test_ds, batch_size, t_max, u_max, device,
                buckets=buckets, torch_mean_semantics=torch_mean,
                device_data=test_dd, mesh=mesh)
            time_per_batch = (time.time() - start_time) / eval_every
            print(f"batch {step}, ctc loss: {avg_loss:>7f}, cer: {cer:>7f}, "
                  f"time/batch: {time_per_batch:>7.3f}")
            start_time = time.time()
            logger.log({
                "eval/loss": avg_loss,
                "eval/cer": cer,
                "eval/time_per_batch": time_per_batch,
                "eval/edit_distance": edit_dist,
                "eval/sequence_length": seq_len,
            }, step=step)
            # best-on-CER weights (params only, the reference's modelWeights);
            # every rank gathered the same outputs, so all decide alike
            prev_best = np.min(test_cer) if test_cer else np.inf
            if cer < prev_best and not (compat_skip_first and not test_cer):
                best = _whole_params(model)
                if primary:
                    ckpt.save("modelState", {"params": best})
                logger.log({"eval/best_cer": cer}, step=step)
                print(f"  → New best model saved! CER: {cer:.6f}")
            test_loss.append(avg_loss)
            test_cer.append(cer)
            if primary:
                save_training_stats(output_dir, test_loss, test_cer)

        if ckpt_every and (step + 1) % ckpt_every == 0:
            save_last(step)

    if prof is not None:  # the run ended inside the window
        _stop_profile(prof, device, output_dir, profile_start, step)

    if preempted_at is not None:
        # steps [0, preempted_at) are done; the sidecar's step is preempted_at
        flush_metrics(pending)
        save_last(preempted_at - 1)
        logger.finish()
        if distributed:  # every rank returns once rank 0's checkpoint is written
            dp.sync(mesh)
        print(f"Preempted: checkpointed at step {preempted_at - 1}; rerun "
              f"with resume: true to continue from step {preempted_at}")
        return {
            "summary/preempted_at": preempted_at,
            "summary/best_cer": float(np.min(test_cer)) if test_cer else float("inf"),
        }

    flush_metrics(pending)
    save_last(n_batch - 1)
    final_cer = test_cer[-1] if test_cer else float("inf")
    best_cer = float(np.min(test_cer)) if test_cer else float("inf")
    summary = {
        "summary/final_cer": final_cer,
        "summary/best_cer": best_cer,
        "summary/final_loss": test_loss[-1] if test_loss else float("inf"),
        "summary/best_loss": float(np.min(test_loss)) if test_loss else float("inf"),
    }
    # the steps' wall-clock span and the run's kernel launches, by wrapper
    # and body, go to the metrics only (every rank's, gathered: a rank's
    # launches are otherwise seen by no other process)
    logger.log({**summary, **_run_trace(mesh, steps_wall, launches0)})
    logger.finish()
    print(f"\n{'=' * 60}\nTraining completed!\nFinal CER: {final_cer:.6f}\n"
          f"Best CER: {best_cer:.6f}\n{'=' * 60}\n")
    return summary


def _whole_params(model: Decoder) -> dict:
    """The model's parameter tree with every shard joined over the model
    group (a collective under tensor parallelism)."""
    return gather_params(model.params, model.tp, model_type_of(model.cfg))


def _map_optimizer_state(model: Decoder, state_dict: dict, fn,
                         sharded_only: bool = True) -> dict:
    """An optimizer state dict with ``fn(path, v, dim)`` applied to every
    per-element state tensor (Adam's moments) of a sharded leaf (or of
    every leaf, ``sharded_only=False``), in one order on every rank; the
    state dict itself for a whole model when ``sharded_only``."""
    if sharded_only and getattr(model, "tp", None) is None:
        return state_dict
    paths = _param_paths(model)
    mt = model_type_of(model.cfg)
    order = [paths[id(p)] for p in model.parameters()]
    state = {}
    for i in sorted(state_dict["state"]):
        path = order[i]
        dim = leaf_dim(path, mt)
        apply = dim is not None or not sharded_only
        state[i] = {k: fn(path, v, dim) if apply and torch.is_tensor(v) and v.dim() else v
                    for k, v in state_dict["state"][i].items()}
    return {**state_dict, "state": state}


def _layout_of(model: Decoder) -> dict:
    """What a checkpoint records of the Conformer's qkv layout."""
    cfg = model.cfg
    return {"qkv_interleaved": cfg.qkv_interleaved} if hasattr(cfg, "num_heads") else {}


def _restore_layout(model: Decoder, state: dict) -> tuple[dict, dict]:
    """A ``lastState``'s whole params and optimizer state in the model's qkv
    layout: a Conformer checkpoint written in the other layout (a
    tensor-parallel run resumed on one model rank, or the reverse) has its
    in_proj columns and their Adam moments relaid out. A checkpoint that
    records no layout is read as it is."""
    params, opt = state["params"], state["optimizer"]
    cfg = model.cfg
    saved = state.get("qkv_interleaved")
    if saved is None or not hasattr(cfg, "num_heads") or saved == cfg.qkv_interleaved:
        return params, opt
    heads, to = cfg.num_heads, cfg.qkv_interleaved
    return (relayout_attention(params, heads, to),
            _map_optimizer_state(model, opt, lambda path, v, dim: relayout_leaf(
                path, v, heads, to), sharded_only=False))


def _run_trace(mesh: Mesh, steps_wall: list[float], launches0: dict) -> dict:
    """The metrics of a finished run's last record: its steps' wall span
    and its launches since ``launches0``; under a process group the span
    from the first rank's first step to the last rank's last read, the
    launches summed over the ranks, and each rank's under
    ``summary/rank<r>/``."""
    launches = {k: n - launches0[k] for k, n in launch_counts().items()}
    if not mesh.distributed:
        return {"summary/steps_wall_start": steps_wall[0],
                "summary/steps_wall_end": steps_wall[1],
                **{f"summary/launches/{k}": n for k, n in launches.items()}}
    names = list(launches)
    ranks = dp.gather_values(steps_wall + [launches[k] for k in names], mesh)
    out = {"summary/steps_wall_start": float(ranks[:, 0].min()),
           "summary/steps_wall_end": float(ranks[:, 1].max()),
           **{f"summary/launches/{k}": int(ranks[:, 2 + i].sum())
              for i, k in enumerate(names)}}
    for r, row in enumerate(ranks):
        out[f"summary/rank{r}/steps_wall_start"] = float(row[0])
        out[f"summary/rank{r}/steps_wall_end"] = float(row[1])
        out.update({f"summary/rank{r}/launches/{k}": int(row[2 + i])
                    for i, k in enumerate(names)})
    return out


def load_model(
    model_dir: str,
    n_input_layers: int | None = None,
    device: torch.device | str | None = None,
) -> tuple[Decoder, dict]:
    """Rebuild a trained model from a run directory: ``(model, args)``,
    with the best-CER ``modelState`` weights (or ``lastState``'s). The
    device is ``device``, else the run's ``args["device"]`` (default
    ``"cuda"``); ``n_input_layers`` overrides the day count."""
    args = load_args(model_dir)
    dev = resolve_device({"device": device} if device is not None else args)
    n_days = n_input_layers or args.get("nDays", 24)
    model = build_model(args, n_days, dev, int(args.get("seed", 0)))
    ckpt = CheckpointManager(model_dir)
    name = "modelState" if ckpt.exists("modelState") else "lastState"
    model.load_params(ckpt.restore(name, dev)["params"])
    return model, args
