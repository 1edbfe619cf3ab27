"""Training cells: the port's train step, fed as ``train_model`` feeds it.

Set-up draws the mix's pool of host batches and the weights from the seed,
builds the model, the optimizer and ``make_train_step``'s step, and drives
that same step through its first ``checked_steps`` steps on batches whose
rows all differ; it reads each step's loss, the first gradient as the
optimizer took it (from Adam's first moment after one step) and each
leaf's change after the last checked step. Those steps warm up every shape
the window uses. The window then runs further steps of the same object, each
batch copied to the card by ``batch_tensors`` and the previous step's loss
read after the next is queued (as ``train_model`` does), until
``--seconds`` have passed, and ends with a synchronise. After the window the
program is freed, the plain reference (``portbench/reference/<family>.py``)
takes the same weights (drawn again from the seed) and batches through the
checked steps with the same noise and dropout, and the three numbers are
compared: the widest relative gap of a step's loss, the worst leaf's gap of
the first gradient's norm, and the worst leaf's gap of the change's norm.
"""

from __future__ import annotations

import importlib
import sys
import time

import numpy as np
import torch

from .. import generate, judge, weights
from ..reference.common import Adam
from ..trace import Run, Spans
from . import (Context, Outcome, memory_peak, phase, release, start_profiler, step_generator,
               stop_profiler, synchronize, window_range)


def program(ctx: Context, params: dict):
    """``(model, optimizer, train_step)`` of the port for the cell's
    configuration, on the benchmark's weights."""
    from neural_speech_decoder_tpu_torch.models.api import config_from_args
    from neural_speech_decoder_tpu_torch.models.conformer import ConformerConfig, ConformerDecoder
    from neural_speech_decoder_tpu_torch.models.gru import GRUDecoder
    from neural_speech_decoder_tpu_torch.training.optim import make_optimizer
    from neural_speech_decoder_tpu_torch.training.trainer import make_train_step

    args = ctx.config["args"]
    cfg = config_from_args(args, ctx.config["n_days"])
    model = (ConformerDecoder if isinstance(cfg, ConformerConfig) else GRUDecoder)(cfg, params)
    opt, sched = make_optimizer(args, model.parameters())
    return model, opt, make_train_step(args, model, opt, sched)


def feed(batch: dict, device: torch.device):
    """A host batch onto the card through the port's ``batch_tensors``."""
    from neural_speech_decoder_tpu_torch.data.batching import Batch
    from neural_speech_decoder_tpu_torch.training.trainer import batch_tensors

    b = Batch(x=batch["x"], y=batch["y"], x_lens=batch["x_lens"], y_lens=batch["y_lens"],
              days=batch["days"], weight=np.ones(len(batch["x_lens"]), np.float32))
    return batch_tensors(b, device)


def _norms(tensors) -> np.ndarray:
    return torch.stack([torch.linalg.vector_norm(t.detach(), dtype=torch.float64)
                        for t in tensors]).cpu().numpy()


def _by_path(tree) -> dict:
    return dict(weights.leaf_paths(tree))


def run(ctx: Context) -> Outcome:
    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    fam = importlib.import_module(f"portbench.reference.{cfg['family']}")
    a = cfg["args"]
    t = phase(ctx, "start", ctx.started)
    importlib.import_module("neural_speech_decoder_tpu_torch.training.trainer")
    t = phase(ctx, "import", t)
    pool = generate.make_batches(mix, a["nInputFeatures"], a["nClasses"], cfg["n_days"], ctx.seed,
                                  dev)
    t = phase(ctx, "traffic", t)
    checked = mix["checked_steps"]
    if mix["pool"] < checked:
        raise ValueError("the pool must hold a distinct batch for every checked step")

    model, opt, step = program(ctx, weights.draw(fam.leaf_specs(cfg), ctx.seed, dev))
    leaves = _by_path(model.params)
    paths = sorted(leaves, key=str)
    p0 = [leaves[p].detach().clone() for p in paths]
    t = phase(ctx, "program", t)
    losses, g1 = [], None
    for i in range(checked):
        metrics = step(feed(pool[i], dev), step_generator(ctx, i))
        losses.append(float(metrics["train/loss"]))
        if i == 0:
            beta1 = opt.param_groups[0]["betas"][0]
            g1 = _norms([opt.state[leaves[p]]["exp_avg"] / (1.0 - beta1) for p in paths])
    d3 = _norms([leaves[p].detach() - q for p, q in zip(paths, p0)])
    del p0
    metrics = None
    phase(ctx, "checked_steps", t)

    spans = Spans(ctx.trace, dev)
    prof = start_profiler(ctx)
    synchronize(dev)
    t0 = time.perf_counter()
    setup_s = t0 - ctx.started
    n, pending, window_losses, lens = 0, None, [], []
    with window_range(ctx):
        while time.perf_counter() - t0 < ctx.seconds:
            i = checked + n
            batch = pool[i % len(pool)]
            with spans("feed"):
                tensors = feed(batch, dev)
            with spans("train_step"):
                metrics = step(tensors, step_generator(ctx, i))
            if pending is not None:
                with spans("read_loss"):
                    window_losses.append(float(pending))
            pending = metrics["train/loss"]
            lens.append(batch["x_lens"])
            n += 1
        synchronize(dev)
    window_s = time.perf_counter() - t0
    if pending is not None:
        window_losses.append(float(pending))
    timeline = stop_profiler(prof)
    peak = memory_peak(dev)
    del model, opt, step, metrics, pending, leaves
    release(dev)

    t = time.perf_counter()
    ref_losses, ref_g1, ref_d3 = _reference(ctx, fam, pool, paths)
    phase(ctx, "reference", t)
    print(f"portbench: {ctx.cell} losses {losses} reference {ref_losses}", file=sys.stderr)
    checks = {"loss_gap": judge.loss_gap(losses, ref_losses),
              "grad_gap": judge.worst_leaf(g1, ref_g1),
              "update_gap": judge.worst_leaf(d3, ref_d3, judge.moved(ref_g1))}
    run_rec = Run("train", cfg, mix, n, lens, dict(spans.times), timeline)
    return Outcome({"setup_s": setup_s,
                    "train_seq_per_s": mix["batch"] * n / window_s if window_s > 0 else 0.0},
                   n, int(sum(not np.isfinite(v) for v in window_losses)), peak, checks, run_rec)


def _reference(ctx: Context, fam, pool, paths):
    """The reference's losses, first-gradient norms and change norms over
    the checked steps, leaf by leaf in ``paths``' order."""
    tree = weights.draw(fam.leaf_specs(ctx.config), ctx.seed, ctx.device)
    by_path = _by_path(tree)
    leaves = [by_path[p].requires_grad_(True) for p in paths]
    p0 = [t.detach().clone() for t in leaves]
    adam = Adam(leaves, ctx.config["optimizer"])
    losses, g1 = [], None
    for i in range(ctx.mix["checked_steps"]):
        batch = {k: torch.from_numpy(v).to(ctx.device) for k, v in pool[i].items()}
        loss = fam.loss(tree, ctx.config, batch, step_generator(ctx, i))
        grads = torch.autograd.grad(loss, leaves)
        losses.append(float(loss.detach()))
        del loss
        adam.step(list(grads))
        del grads
        if i == 0:
            g1 = _norms(adam.seen)
    d3 = _norms([t.detach() - q for t, q in zip(leaves, p0)])
    return losses, g1, d3

