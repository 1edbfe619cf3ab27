"""What a cell's window drives, by the ``kind`` of its traffic mix: each
module here has ``run(ctx) -> Outcome``. ``train``: the port's train step
(``training/trainer.py::make_train_step``); ``decode``: batch requests to
``serving/model.py::InferenceModel``. A mix of a new kind brings its module.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import sys
import time

import torch

from ..trace import WINDOW, Run, Timeline


@dataclasses.dataclass
class Context:
    cell: str
    config: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    started: float  # time.perf_counter() at the process's start


@dataclasses.dataclass
class Outcome:
    end_to_end: dict[str, float]  # setup_s and the kind's own metrics
    attempted: int
    failed: int
    memory_peak_bytes: int
    checks: dict[str, float]
    run: Run


def phase(ctx: Context, name: str, t0: float) -> float:
    """Print a set-up phase's host seconds to standard error; returns now."""
    now = time.perf_counter()
    print(f"portbench: {ctx.cell} {name} {now - t0:.3f} s", file=sys.stderr, flush=True)
    return now


def step_generator(ctx: Context, i: int) -> torch.Generator:
    """The noise and dropout generator of train step ``i`` of the run."""
    from ..seeds import derive
    return torch.Generator(device=ctx.device).manual_seed(derive(ctx.seed, "step", i))


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def release(device: torch.device) -> None:
    """Give the program's freed memory back before the reference runs."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def start_profiler(ctx: Context):
    """A started ``torch.profiler`` run for a traced window, else None."""
    if not ctx.trace:
        return None
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if ctx.device.type == "cuda" else [])
    prof = profile(activities=acts)
    prof.__enter__()
    return prof


def stop_profiler(prof) -> Timeline | None:
    if prof is None:
        return None
    prof.__exit__(None, None, None)
    return Timeline.read(prof)


def window_range(ctx: Context):
    """The ``portbench.window`` range a traced window sits in."""
    return torch.profiler.record_function(WINDOW) if ctx.trace else contextlib.nullcontext()
