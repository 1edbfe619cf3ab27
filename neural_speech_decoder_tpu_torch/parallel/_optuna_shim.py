"""Minimal optuna-API-compatible fallback sampler (random search).

The port's own copy of ``neural_speech_decoder_tpu/parallel/_optuna_shim.py``
(numpy only): the same draws for the same seed. ``run_optuna_sweep``
(``parallel/sweep.py``) uses the real optuna (TPE) when it is installed and
this shim otherwise: independent uniform random search, the standard
no-dependency baseline sampler, so the sweep path runs without optuna.

Implemented surface (what ``run_optuna_sweep`` and user ``suggest``
callbacks need): ``create_study``, ``Study.optimize/best_value/
best_params/best_trial/trials``, ``Trial.suggest_float`` (linear + log),
``suggest_int``, ``suggest_categorical``, ``TrialPruned``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np


class TrialPruned(Exception):
    """Raised by objectives to discard a trial without failing the study."""


@dataclass
class Trial:
    number: int
    _rng: np.random.Generator
    params: dict[str, Any] = field(default_factory=dict)

    def suggest_float(
        self, name: str, low: float, high: float, *, log: bool = False
    ) -> float:
        if log:
            v = math.exp(self._rng.uniform(math.log(low), math.log(high)))
        else:
            v = float(self._rng.uniform(low, high))
        self.params[name] = v
        return v

    def suggest_int(self, name: str, low: int, high: int) -> int:
        v = int(self._rng.integers(low, high + 1))  # inclusive, like optuna
        self.params[name] = v
        return v

    def suggest_categorical(self, name: str, choices) -> Any:
        v = choices[int(self._rng.integers(0, len(choices)))]
        self.params[name] = v
        return v


@dataclass
class FrozenTrial:
    number: int
    value: float | None
    params: dict[str, Any]
    state: str  # "COMPLETE" | "PRUNED"


class Study:
    def __init__(self, direction: str = "minimize", seed: int = 0):
        if direction not in ("minimize", "maximize"):
            raise ValueError(f"unknown direction {direction!r}")
        self.direction = direction
        self._rng = np.random.default_rng(seed)
        self.trials: list[FrozenTrial] = []

    def optimize(
        self, objective: Callable[[Trial], float], n_trials: int
    ) -> None:
        for _ in range(n_trials):
            t = Trial(len(self.trials), self._rng)
            try:
                value = float(objective(t))
                self.trials.append(
                    FrozenTrial(t.number, value, t.params, "COMPLETE")
                )
            except TrialPruned:
                self.trials.append(
                    FrozenTrial(t.number, None, t.params, "PRUNED")
                )

    @property
    def best_trial(self) -> FrozenTrial:
        done = [t for t in self.trials if t.state == "COMPLETE"]
        if not done:
            raise ValueError("no completed trials")
        key = (min if self.direction == "minimize" else max)
        return key(done, key=lambda t: t.value)

    @property
    def best_value(self) -> float:
        return self.best_trial.value

    @property
    def best_params(self) -> dict[str, Any]:
        return self.best_trial.params


def create_study(*, direction: str = "minimize", seed: int = 0) -> Study:
    return Study(direction=direction, seed=seed)
