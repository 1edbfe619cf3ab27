"""Metric logging with the reference's wandb metric-name contract.

Port of ``neural_speech_decoder_tpu/utils/logging.py::MetricLogger``:
per-step ``train/*``, per-eval ``eval/*`` and final ``summary/*`` metrics go
to wandb when it is installed and ``mode="online"``, otherwise to
``<output_dir>/metrics.jsonl`` with the same names and steps. In a process
group only rank 0 logs (every rank would otherwise write the same file),
as JAX's logger does on its primary process.
"""

from __future__ import annotations

import json
import os
from typing import Any

import torch.distributed as dist


class MetricLogger:
    def __init__(
        self,
        output_dir: str,
        *,
        project: str = "neural-speech-decoder",
        run_name: str | None = None,
        config: dict | None = None,
        mode: str = "offline",
    ):
        self.output_dir = output_dir
        self._wandb = None
        self._jsonl = None
        if dist.is_available() and dist.is_initialized() and dist.get_rank() != 0:
            mode = "disabled"
        if mode == "disabled":
            return
        if mode == "online":
            try:
                import wandb

                wandb.init(
                    project=project,
                    name=run_name or os.path.basename(output_dir),
                    config=config,
                    mode=mode,
                )
                self._wandb = wandb
            except Exception:  # no wandb or no login: fall back to JSONL
                self._wandb = None
        if self._wandb is None:
            os.makedirs(output_dir, exist_ok=True)
            self._jsonl = open(
                os.path.join(output_dir, "metrics.jsonl"), "a", buffering=1
            )

    def log(self, metrics: dict[str, Any], step: int | None = None) -> None:
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)
        if self._jsonl is not None:
            rec = {"step": step}
            rec.update({k: _to_py(v) for k, v in metrics.items()})
            self._jsonl.write(json.dumps(rec) + "\n")

    def finish(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None


def _to_py(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)
