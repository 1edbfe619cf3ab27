"""Checkpoints: the train state through ``torch.save``, and the reference's
artifact contract.

Port of ``neural_speech_decoder_tpu/training/checkpoints.py`` (Orbax there).
In ``<outputDir>``:

- ``args``: the pickled run config, written at start (same file as the
  reference's and the JAX package's);
- ``trainingStats``: the pickled ``{testLoss, testCER}`` history;
- ``modelState``: ``{"params": tree}``, the weights at the best eval CER;
- ``lastState``: ``{"params", "optimizer", "scheduler", "step"}``, the full
  train state, written every ``checkpointEvery`` steps, at the end and on
  preemption;
- ``trainerState``: the pickled host-side resume state (``step``,
  ``testLoss``, ``testCER``, the numpy sampler's ``np_rng_state``).

Tensors are saved on the CPU and loaded onto the device asked for.
"""

from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np
import torch


def save_args(output_dir: str, args: dict) -> None:
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "args"), "wb") as f:
        pickle.dump(dict(args), f)


def load_args(output_dir: str) -> dict:
    with open(os.path.join(output_dir, "args"), "rb") as f:
        return pickle.load(f)


def save_training_stats(output_dir: str, test_loss, test_cer) -> None:
    stats = {
        "testLoss": np.asarray(test_loss),
        "testCER": np.asarray(test_cer),
    }
    with open(os.path.join(output_dir, "trainingStats"), "wb") as f:
        pickle.dump(stats, f)


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


class CheckpointManager:
    """Named ``torch.save`` slots in one run directory, plus the pickled
    resume sidecar."""

    def __init__(self, output_dir: str):
        self.output_dir = os.path.abspath(output_dir)
        os.makedirs(self.output_dir, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.output_dir, name)

    def save(self, name: str, state: dict) -> None:
        """Write atomically: a reader sees the old slot or the new one."""
        path = self._path(name)
        torch.save(_to_cpu(state), path + ".tmp")
        os.replace(path + ".tmp", path)

    def restore(self, name: str, device: torch.device | str = "cpu") -> dict:
        return torch.load(self._path(name), map_location=device,
                          weights_only=True)

    def exists(self, name: str) -> bool:
        return os.path.isfile(self._path(name))

    def save_sidecar(self, payload: dict) -> None:
        """Host-side resume metadata (sampler RNG state, metric history)."""
        with open(os.path.join(self.output_dir, "trainerState"), "wb") as f:
            pickle.dump(payload, f)

    def load_sidecar(self) -> dict:
        with open(os.path.join(self.output_dir, "trainerState"), "rb") as f:
            return pickle.load(f)
