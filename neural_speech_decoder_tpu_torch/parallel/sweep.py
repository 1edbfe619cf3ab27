"""Hyperparameter sweep driver (task parallelism).

Port of ``neural_speech_decoder_tpu/parallel/sweep.py``. The reference fans
sweeps out as SLURM job arrays via hydra-submitit with
``array_parallelism: 50`` and declares the optuna sweeper as a dependency;
this driver gives the same on one host:

  * grid or random search over parameter spaces,
  * bounded concurrency (the ``array_parallelism`` semantic) in ``spawn``
    worker processes, each with its own CUDA context, so that a trial's
    device memory or a fault cannot leak into another's; each worker gets
    the base args once, through the pool initializer. Each worker slot is
    a ``concurrent.futures.ProcessPoolExecutor`` of one process: a worker
    that dies (a crash, ``os._exit``) breaks its own slot only, its trial
    is recorded ``failed`` with the ``BrokenProcessPool`` error and the
    slot restarts, so the other trials run on and report (JAX's
    ``multiprocessing.Pool.map`` waits for ever there, a deliberate
    difference). The workers are not daemonic, so a trial can start rank
    processes of its own. A parent whose ``__main__`` was read from
    ``<stdin>`` (``python -``) is refused up front with a ``RuntimeError``:
    spawn children cannot re-import it,
  * per-trial output dirs and a ``sweep_summary.json`` ranked by best CER
    (the JAX package's keys), a trial that SIGTERM or SIGUSR1 preempted
    recorded as ``preempted``, not ``failed``,
  * optional Optuna TPE search when optuna is installed, else the port's
    copy of the random-search shim (``_optuna_shim.py``).

Each trial trains with the port's ``training/trainer.py::train_model`` on
its ``args["device"]`` (default ``cuda``). ``chips_per_trial`` pins each
worker slot to its own cards with ``CUDA_VISIBLE_DEVICES`` (``slice_env``),
set in the worker before its first CUDA call, and a trial then trains
data-parallel over all of them (``train_model``'s default for ``cuda``,
one rank process a card), as JAX's trial does in one process; without it,
concurrent trials share the visible cards (on one card, by time-slicing).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import multiprocessing as mp
import os
import sys
import traceback
import warnings
from concurrent.futures import FIRST_COMPLETED, ProcessPoolExecutor, wait
from concurrent.futures.process import BrokenProcessPool
from dataclasses import dataclass
from typing import Any, Callable, Sequence

import numpy as np


@dataclass
class Trial:
    trial_id: int
    overrides: dict[str, Any]
    output_dir: str
    best_cer: float = float("inf")
    status: str = "pending"
    error: str | None = None
    chips: str | None = None  # the CUDA_VISIBLE_DEVICES the trial ran under


def grid_space(space: dict[str, Sequence[Any]]) -> list[dict[str, Any]]:
    keys = list(space)
    return [
        dict(zip(keys, combo))
        for combo in itertools.product(*(space[k] for k in keys))
    ]


def random_space(
    space: dict[str, Callable[[np.random.Generator], Any]],
    n_trials: int,
    seed: int = 0,
) -> list[dict[str, Any]]:
    rng = np.random.default_rng(seed)
    return [{k: fn(rng) for k, fn in space.items()} for _ in range(n_trials)]


def slice_env(slot: int, chips_per_trial: int) -> dict[str, str]:
    """The environment that pins worker slot ``slot`` to its own
    ``chips_per_trial`` consecutive cards: ``CUDA_VISIBLE_DEVICES``, which
    CUDA reads once, at the process's first CUDA call."""
    first = slot * chips_per_trial
    return {"CUDA_VISIBLE_DEVICES": ",".join(str(first + i) for i in range(chips_per_trial))}


def _pin(slot: int, chips_per_trial: int) -> None:
    """Set ``slice_env`` in this process, which must not have touched CUDA
    yet (torch may be imported: its CUDA initialization is lazy)."""
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        raise RuntimeError("CUDA_VISIBLE_DEVICES must be set before the process's "
                           "first CUDA call, and CUDA is initialized already")
    os.environ.update(slice_env(slot, chips_per_trial))


_WORKER_BASE_ARGS: dict | None = None
_WORKER_INIT_ERROR: str | None = None


def _worker_init(base_args: dict, slot_queue, chips_per_trial: int) -> None:
    """Pool initializer: receive base_args ONCE per worker (they may embed
    an in-memory dataset; pickling them per trial would ship it with every
    trial) and claim a card slot when pinning is on. A failed pin fails the
    worker's trials (an initializer that raised would be restarted by the
    pool without end)."""
    global _WORKER_BASE_ARGS, _WORKER_INIT_ERROR
    _WORKER_BASE_ARGS = base_args
    if slot_queue is not None:
        try:
            _pin(slot_queue.get(), chips_per_trial)
        except Exception:
            _WORKER_INIT_ERROR = traceback.format_exc()


def _run_trial(base_args: dict, trial: Trial) -> Trial:
    trial.chips = os.environ.get("CUDA_VISIBLE_DEVICES")
    try:
        from ..training.trainer import train_model

        args = dict(base_args)
        args.update(trial.overrides)
        args["outputDir"] = trial.output_dir
        summary = train_model(args)
        trial.best_cer = float(summary.get("summary/best_cer", float("inf")))
        # a preempted trial checkpointed cleanly and can be resumed
        trial.status = "preempted" if "summary/preempted_at" in summary else "done"
    except Exception:
        trial.status = "failed"
        trial.error = traceback.format_exc()
    return trial


def _worker(trial: Trial) -> Trial:
    if _WORKER_INIT_ERROR is not None:
        trial.status, trial.error = "failed", _WORKER_INIT_ERROR
        return trial
    return _run_trial(_WORKER_BASE_ARGS, trial)


def _run_in_workers(base_args: dict, trials: list[Trial], n_slots: int,
                    chips_per_trial: int) -> list[Trial]:
    """The trials on ``n_slots`` worker slots, each a one-process
    ``ProcessPoolExecutor`` (``spawn``) whose initializer pins it to its
    slot's cards (one slot in its own queue); a slot whose worker died is
    restarted, the worker's trial recorded ``failed``."""
    from .data_parallel import check_spawnable_main

    check_spawnable_main()
    ctx = mp.get_context("spawn")  # a fresh CUDA context per worker
    with contextlib.ExitStack() as stack:
        manager = stack.enter_context(ctx.Manager()) if chips_per_trial else None

        def start(slot: int) -> ProcessPoolExecutor:
            slot_queue = None
            if manager is not None:
                slot_queue = manager.Queue()
                slot_queue.put(slot)
            return ProcessPoolExecutor(1, mp_context=ctx, initializer=_worker_init,
                                       initargs=(base_args, slot_queue, chips_per_trial))

        pools = [start(s) for s in range(n_slots)]
        stack.callback(lambda: [p.shutdown(wait=True, cancel_futures=True) for p in pools])
        todo, running, results = list(trials), {}, []
        while todo or running:
            busy = {slot for slot, _ in running.values()}
            for slot in range(n_slots):
                if todo and slot not in busy:
                    trial = todo.pop(0)
                    running[pools[slot].submit(_worker, trial)] = (slot, trial)
            done, _ = wait(running, return_when=FIRST_COMPLETED)
            for fut in done:
                slot, trial = running.pop(fut)
                try:
                    results.append(fut.result())
                except BrokenProcessPool:
                    # the worker died inside the trial: only its slot broke
                    trial.status = "failed"
                    trial.error = traceback.format_exc()
                    results.append(trial)
                    pools[slot].shutdown(wait=True)
                    pools[slot] = start(slot)
        return results


def run_sweep(
    base_args: dict,
    override_list: list[dict[str, Any]],
    sweep_dir: str,
    *,
    array_parallelism: int = 1,
    use_processes: bool = True,
    chips_per_trial: int | None = None,
    total_chips: int | None = None,
    subdir_names: Sequence[str] | None = None,
) -> list[Trial]:
    """Run every override set; returns the trials sorted by best CER.

    ``chips_per_trial`` (with ``total_chips``) gives each concurrent trial
    its own cards; concurrency is then bounded by ``total_chips //
    chips_per_trial`` as well as ``array_parallelism``. ``subdir_names``
    replaces the default ``trial_NNNN`` directory names (the CLI's multirun
    passes hydra's override dirnames)."""
    os.makedirs(sweep_dir, exist_ok=True)
    if subdir_names is not None and len(subdir_names) != len(override_list):
        raise ValueError("subdir_names must match override_list length")
    trials = [
        Trial(i, ov, os.path.join(
            sweep_dir, subdir_names[i] if subdir_names else f"trial_{i:04d}"))
        for i, ov in enumerate(override_list)
    ]
    if len({t.output_dir for t in trials}) != len(trials):
        raise ValueError("per-trial output dirs collide")
    if chips_per_trial:
        n_slots = max((total_chips or chips_per_trial) // chips_per_trial, 1)
        array_parallelism = min(array_parallelism, n_slots)
    if use_processes and array_parallelism > 1:
        results = _run_in_workers(base_args, trials, array_parallelism, chips_per_trial or 0)
    else:
        if chips_per_trial:
            _pin(0, chips_per_trial)
        results = [_run_trial(base_args, t) for t in trials]
    results.sort(key=lambda t: t.best_cer)
    with open(os.path.join(sweep_dir, "sweep_summary.json"), "w") as f:
        json.dump(
            [{"trial_id": t.trial_id, "overrides": t.overrides, "outputDir": t.output_dir,
              "best_cer": t.best_cer, "status": t.status, "error": t.error,
              "chips": t.chips}
             for t in results],
            f, indent=2, default=str,
        )
    return results


def run_optuna_sweep(
    base_args: dict,
    suggest: Callable[[Any], dict[str, Any]],
    sweep_dir: str,
    *,
    n_trials: int = 20,
    direction: str = "minimize",
):
    """Optuna-driven search: the real optuna (TPE) when installed, else the
    port's random-search shim (``_optuna_shim``, with a warning). The
    ``suggest`` callback receives an optuna(-compatible) Trial and returns
    the override dict for ``train_model``; trials run in this process."""
    try:
        import optuna
    except ImportError:
        from . import _optuna_shim as optuna

        warnings.warn(
            "optuna not installed: run_optuna_sweep is using the port's "
            "random-search shim (uniform sampling, no TPE).",
            stacklevel=2,
        )

    def objective(trial):
        overrides = suggest(trial)
        t = Trial(trial.number, overrides,
                  os.path.join(sweep_dir, f"trial_{trial.number:04d}"))
        t = _run_trial(base_args, t)
        if t.status == "failed":
            raise optuna.TrialPruned()
        return t.best_cer

    study = optuna.create_study(direction=direction)
    study.optimize(objective, n_trials=n_trials)
    return study
