"""Optimizers and learning-rate schedules of the reference's two recipes.

Port of ``neural_speech_decoder_tpu/training/optim.py::make_optimizer``
(whose optax chains were written to torch's semantics, so here they are
torch's own):

- GRU: ``torch.optim.Adam(lr=lrStart, betas=(0.9, 0.999), eps=0.1,
  weight_decay=l2_decay)`` — L2 added to the gradient before the moments,
  eps outside the sqrt — with the linear schedule from lrStart to lrEnd
  over nBatch steps, in the closed form of the JAX package's schedule
  (torch's ``LinearLR`` computes it recursively and refuses an ``lrEnd``
  above ``lrStart``, which a sweep over lrStart can give).
  With ``fused_optimizer: true`` (the JAX trainer's condition: not
  ``adamw``, not the Conformer) the same update runs as ``FusedAdam``, on
  the hand-written kernel of ``ops/kernels/adam.py`` (the JAX package's
  ``fused_adam_update``).
- Conformer (``optimizer: adamw``): ``torch.optim.AdamW(eps=1e-6,
  weight_decay=...)`` (decoupled) with a linear warmup over
  ``warmup_steps`` then a cosine to 0; its gradients are clipped to a
  global norm of 1.0 (``grad_clip_norm``).

The schedulers step after the optimizer, so update i (0-based) uses the
schedule at i, as optax's counts do.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import torch

from ..ops.kernels.adam import adam_scalars, adam_update


def linear_lr_factor(
    lr_start: float, lr_end: float, total_iters: int
) -> Callable[[int], float]:
    """The factor on ``lr_start`` at a step: 1 at step 0, ``lr_end/lr_start``
    from ``total_iters`` on (1 when ``lr_start`` is 0)."""
    end_factor = lr_end / lr_start if lr_start != 0 else 1.0

    def factor(count: int) -> float:
        frac = min(count, total_iters) / max(total_iters, 1)
        return 1.0 + (end_factor - 1.0) * frac

    return factor


def linear_lr_schedule(
    lr_start: float, lr_end: float, total_iters: int
) -> Callable[[int], float]:
    """torch LinearLR with start_factor=1.0, as a function of the step."""
    factor = linear_lr_factor(lr_start, lr_end, total_iters)
    return lambda count: lr_start * factor(count)


def warmup_cosine_schedule(
    lr_start: float, warmup_steps: int, total_steps: int
) -> Callable[[int], float]:
    """The reference's warmup-then-cosine ``lr_lambda`` times ``lr_start``."""

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return lr_start * (count + 1.0) / max(1, warmup_steps)
        progress = (count - warmup_steps) / max(1, total_steps - warmup_steps)
        return lr_start * 0.5 * (1.0 + math.cos(math.pi * progress))

    return schedule


def lr_schedule(args: dict) -> Callable[[int], float]:
    """The learning rate of update ``count`` for a run's ``args``."""
    n_batch = int(args["nBatch"])
    lr_start = float(args["lrStart"])
    if args.get("optimizer", "adam") == "adamw":
        return warmup_cosine_schedule(
            lr_start, int(args.get("warmup_steps", 0)), n_batch)
    return linear_lr_schedule(
        lr_start, float(args.get("lrEnd", lr_start)), n_batch)


def grad_clip_norm(args: dict) -> float | None:
    """The global gradient norm the run clips to: 1.0 for the Conformer
    (the reference clips iff the model is the Conformer), else None."""
    return 1.0 if args.get("model_type", "gru_baseline") == "transformer_ctc" else None


class FusedAdam(torch.optim.Optimizer):
    """Adam with L2 (``torch.optim.Adam``'s update with ``weight_decay``) in
    one kernel launch over every leaf (``ops/kernels/adam.py``): the JAX
    package's ``fused_adam_update``. It keeps ``torch.optim.Adam``'s state
    (``step``, a float32 CPU tensor, ``exp_avg``, ``exp_avg_sq``) and
    parameter-group keys, so a scheduler drives it unchanged and a state
    dict moves between the two. The parameters and both moments are updated
    in place, as the JAX package donates them to its kernel; ``lr`` and the
    bias corrections reach the kernel by value (no tensor is made on the
    device per step). Leaves without a gradient are skipped, as Adam skips
    them."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            by_count: dict[int, list] = {}
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = torch.tensor(0.0, dtype=torch.float32)
                    state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                    state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                by_count.setdefault(int(state["step"]), []).append(p)
            for count, ps in by_count.items():
                c1, c2 = adam_scalars(count, b1, b2)
                states = [self.state[p] for p in ps]
                adam_update([p.grad for p in ps], ps, [s["exp_avg"] for s in states],
                            [s["exp_avg_sq"] for s in states], lr=float(group["lr"]),
                            c1=c1, c2=c2, b1=b1, b2=b2, eps=group["eps"],
                            l2=group["weight_decay"])
                for s in states:
                    s["step"] += 1
        return loss


def fused_optimizer(args: dict) -> bool:
    """Whether a run takes ``FusedAdam``: ``fused_optimizer`` set, the
    optimizer not ``adamw`` and the model not the Conformer (the JAX
    trainer's condition)."""
    return (bool(args.get("fused_optimizer", False))
            and args.get("optimizer", "adam") != "adamw"
            and args.get("model_type", "gru_baseline") != "transformer_ctc")


def make_optimizer(
    args: dict, params: Iterable[torch.nn.Parameter]
) -> tuple[torch.optim.Optimizer, torch.optim.lr_scheduler.LRScheduler]:
    """``(optimizer, scheduler)`` from a reference-style args dict."""
    n_batch = int(args["nBatch"])
    lr_start = float(args["lrStart"])
    if args.get("optimizer", "adam") == "adamw":
        wd = float(args.get("weight_decay", args.get("l2_decay", 0)))
        opt = torch.optim.AdamW(params, lr=lr_start, betas=(0.9, 0.999),
                                eps=1e-6, weight_decay=wd)
        schedule = lr_schedule(args)
        sched = torch.optim.lr_scheduler.LambdaLR(
            opt, lambda count: schedule(count) / lr_start if lr_start else 0.0)
        return opt, sched
    lr_end = float(args.get("lrEnd", lr_start))
    adam = FusedAdam if fused_optimizer(args) else torch.optim.Adam
    opt = adam(params, lr=lr_start, betas=(0.9, 0.999), eps=0.1,
               weight_decay=float(args.get("l2_decay", 0)))
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, linear_lr_factor(lr_start, lr_end, n_batch))
    return opt, sched
