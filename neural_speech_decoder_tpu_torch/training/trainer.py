"""Training and eval loop with the reference's ``trainModel(args)`` surface,
on one device.

Port of ``neural_speech_decoder_tpu/training/trainer.py`` for both model
families (``model_type`` ``gru_baseline`` or ``transformer_ctc``): per-step
uniformly random batches (``data/batching.py``), noise augmentation, the
train forward with its dropout, the CTC loss with the reference's
reductions, label smoothing and InterCTC blending, Adam with L2 and
LinearLR (or AdamW with warmup-cosine, the Conformer's, with its gradients
clipped to norm 1.0), eval every ``evalEvery`` steps (CTC loss and greedy
PER), the best-CER ``modelState``, the periodic ``lastState``,
SIGTERM/SIGUSR1 preemption and an exact ``resume``, device-resident data
(``deviceResidentData``: ``data/device_data.py``) and a ``torch.profiler``
trace of the steps ``profile_steps = [start, stop]`` into
``outputDir/profile``.

The port runs on one device: the mesh, tensor parallelism and multi-host
staging are not ported (ROADMAP queue 1 item 10), and a run that asks for
them (``n_data_devices`` or ``n_model_devices`` > 1, ``multihost_staging``)
raises ``NotImplementedError``. The device comes from ``args["device"]``
(default ``"cuda"``, which raises without a card). The noise and dropout of
step ``i`` come from a ``torch.Generator`` seeded from ``(seed, i)``, as the
JAX package folds the step into its key, so a resumed run draws what an
uninterrupted one would.
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

from ..data.batching import (
    Batch,
    bucket_batch_sizes,
    choose_envelope,
    eval_batches,
    length_buckets,
    sample_batch,
)
from ..data.dataset import PackedDataset, load_pickle_dataset, pack_days
from ..data.device_data import DeviceData
from ..models.api import Decoder, build_model, forward
from ..ops.ctc import ctc_loss
from ..ops.decode import batch_per, greedy_decode
from ..ops.noise import apply_noise
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


def check_single_device(args: dict) -> None:
    """Raise ``NotImplementedError`` for the multi-device args the port does
    not implement (the JAX trainer's mesh, tensor parallelism and multi-host
    staging)."""
    asked = [f"{k}={args[k]}" for k in ("n_data_devices", "n_model_devices")
             if int(args.get(k) or 1) > 1]
    if args.get("multihost_staging"):
        asked.append(f"multihost_staging={args['multihost_staging']}")
    if asked:
        raise NotImplementedError(
            f"{', '.join(asked)}: the port trains on one device; the mesh, tensor "
            f"parallelism and multi-host staging are ROADMAP queue 1 item 10")


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
) -> tuple[torch.Tensor, dict]:
    """Training loss with the reference's blending (``trainer.py::
    _loss_and_metrics``) of the noisy batch. Without label smoothing: the
    length-normalized batch-mean CTC loss. With ``label_smoothing`` s:
    ``(1-s)`` times the batch mean of the per-sequence CTC losses plus ``s``
    times the KL to the uniform distribution, summed over every frame
    (padding included) and divided by the frame count T'. With an InterCTC
    head (the Conformer): ``(1-w)`` times that plus ``w`` times the same
    CTC reduction of the InterCTC log-probs, ``w = interctc_weight``."""
    x, y, x_lens, y_lens, days = batch
    x = apply_noise(generator, x, args["whiteNoiseSD"], args["constantOffsetSD"])
    log_probs, out_lens, inter_log_probs = forward(
        model, x, days, x_lens, train=True, generator=generator, plain=plain)
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
        loss = loss * (x.shape[0] / int(args.get("batchSize", x.shape[0])))
    metrics["train/loss"] = loss
    return loss, metrics


def _named_leaves(tree, prefix: str) -> list[tuple[str, torch.Tensor]]:
    if isinstance(tree, dict):
        return [kv for k in tree for kv in _named_leaves(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _named_leaves(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def make_train_step(
    args: dict,
    model: Decoder,
    optimizer: torch.optim.Optimizer,
    scheduler: torch.optim.lr_scheduler.LRScheduler,
) -> Callable[[tuple, torch.Generator], dict]:
    """``train_step(batch, generator) -> metrics``: loss, backward, the
    optional clip, one optimizer and scheduler step. The metrics are device
    tensors (reading them waits for the step). With ``watch_log_freq > 0``
    they include per-leaf gradient and parameter norms
    (``train/grad_norm/<path>``, ``train/param_norm/<path>``, on the
    parameters before the update)."""
    watch = int(args.get("watch_log_freq", 100)) > 0
    clip = grad_clip_norm(args)

    def train_step(batch, generator):
        optimizer.zero_grad(set_to_none=True)
        loss, metrics = _loss_and_metrics(args, model, batch, generator)
        loss.backward()
        if clip is not None:
            # clip_grad_norm_ returns the norm before clipping
            metrics["train/grad_norm"] = torch.nn.utils.clip_grad_norm_(
                model.parameters(), clip)
        if watch:
            with torch.no_grad():
                for path, p in _named_leaves(model.params, ""):
                    metrics["train/grad_norm" + path] = p.grad.float().norm()
                    metrics["train/param_norm" + path] = p.float().norm()
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
) -> tuple[float, float, int, int]:
    """Full test pass: ``(avg_day_loss, per, edit_dist, seq_len)``.

    ``avg_day_loss`` follows the reference: per batch a scalar, then the
    mean over batches. The scalar is the mean over real rows of the
    length-normalized loss (``torch_mean_semantics``, the runs without
    label smoothing) or the sum of the real rows' losses. With
    ``device_data`` (``test_ds`` on the device) the batches are assembled
    there."""
    batch_scalars = []
    total_dist = 0
    total_len = 0
    for batch in eval_batches(test_ds, batch_size, t_max, u_max, buckets=buckets,
                              materialize_x=device_data is None):
        tensors = (batch_tensors(batch, device) if device_data is None
                   else device_data.assemble(batch))
        per_seq, tokens, dec_lens = eval_step(*tensors)
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
    sampler state, same per-step noise, same metric history). The handlers
    are installed before the slow set-up and restored on every exit."""
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


def _train_model_impl(args: dict, preempt_requested: threading.Event) -> dict:
    check_single_device(args)
    warn_unused_args(args)
    device = resolve_device(args)
    output_dir = args["outputDir"]
    seed = int(args.get("seed", 0))
    np_rng = np.random.default_rng(seed)

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
    save_args(output_dir, {**{k: v for k, v in args.items() if k != "dataset"},
                           "nDays": n_days})

    batch_size = int(args["batchSize"])
    time_multiple = int(args.get("time_multiple", 128))
    t_max, u_max = choose_envelope(train_ds, test_ds, time_multiple=time_multiple,
                                   max_time=args.get("maxTimeSeriesLen"))

    model = build_model(args, n_days, device, seed)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"Model has {n_params:,} parameters ({n_params:,} trainable)")
    logger.log({"model/total_parameters": n_params,
                "model/trainable_parameters": n_params}, step=0)

    optimizer, scheduler = make_optimizer(args, model.parameters())
    schedule = lr_schedule(args)
    train_step = make_train_step(args, model, optimizer, scheduler)
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
        state = ckpt.restore("lastState", device)
        model.load_params(state["params"])
        optimizer.load_state_dict(state["optimizer"])
        scheduler.load_state_dict(state["scheduler"])
        side = ckpt.load_sidecar()
        start_step = int(side["step"])
        test_loss = list(side["testLoss"])
        test_cer = list(side["testCER"])
        np_rng.bit_generator.state = side["np_rng_state"]
        print(f"Resumed from step {start_step}")

    def save_last(step):
        ckpt.save("lastState", {
            "params": model.params,
            "optimizer": optimizer.state_dict(),
            "scheduler": scheduler.state_dict(),
            "step": step + 1,
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
    # batch gathered there from the host-sampled indices
    device_data = bool(args.get("deviceResidentData", False))
    train_dd = DeviceData(train_ds, device) if device_data else None
    test_dd = DeviceData(test_ds, device) if device_data else None

    def put_batch(batch: Batch) -> tuple[torch.Tensor, ...]:
        return train_dd.assemble(batch) if device_data else batch_tensors(batch, device)

    profile_start, profile_stop = args.get("profile_steps") or (None, None)
    prof = None

    watch_freq = int(args.get("watch_log_freq", 100))

    def flush_metrics(pending):
        if pending is None:
            return
        held, at_step = pending
        # per-layer watch norms only on the watch interval
        if not (watch_freq and at_step % watch_freq == 0):
            held = {k: v for k, v in held.items()
                    if not k.startswith(WATCH_PREFIXES)}
        log_dict = {k: float(v) for k, v in held.items()}
        log_dict["train/learning_rate"] = schedule(at_step)
        log_dict["train/batch"] = at_step
        logger.log(log_dict, step=at_step)

    start_time = time.time()
    pending = None  # (metrics, step) of the previous step, read after the next
    preempted_at: int | None = None
    for step in range(start_step, n_batch):
        if preempt_requested.is_set():
            preempted_at = step
            break
        if step == profile_start:
            prof = _start_profile(device)
        batch = sample_batch(train_ds, np_rng, batch_size, t_max, u_max,
                             buckets=buckets, bucket_sizes=bucket_sizes,
                             materialize_x=not device_data)
        metrics = train_step(put_batch(batch), step_generator(device, seed, step))
        if step == profile_stop and prof is not None:
            _stop_profile(prof, device, output_dir, profile_start, step)
            prof = None
        # reading the metrics waits for the device: read the previous
        # step's after this one is queued, so host batch prep overlaps it
        flush_metrics(pending)
        pending = (metrics, step)

        if step % eval_every == 0:
            flush_metrics(pending)
            pending = None
            avg_loss, cer, edit_dist, seq_len = run_eval(
                eval_step, test_ds, batch_size, t_max, u_max, device,
                buckets=buckets, torch_mean_semantics=torch_mean,
                device_data=test_dd)
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
            # best-on-CER weights (params only, the reference's modelWeights)
            prev_best = np.min(test_cer) if test_cer else np.inf
            if cer < prev_best and not (compat_skip_first and not test_cer):
                ckpt.save("modelState", {"params": model.params})
                logger.log({"eval/best_cer": cer}, step=step)
                print(f"  → New best model saved! CER: {cer:.6f}")
            test_loss.append(avg_loss)
            test_cer.append(cer)
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
    logger.log(summary)
    logger.finish()
    print(f"\n{'=' * 60}\nTraining completed!\nFinal CER: {final_cer:.6f}\n"
          f"Best CER: {best_cer:.6f}\n{'=' * 60}\n")
    return summary


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
