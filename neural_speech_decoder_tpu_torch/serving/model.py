"""Batch inference of the GRU decoder on one device.

Port of ``neural_speech_decoder_tpu/serving/export.py::ExportedModel``
without the artifact: the weights go to the device once, requests are
padded to a fixed ``(batch_size, t_max)`` envelope, and the eval forward
returns ``(log_probs, out_lens)``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.api import forward
from ..models.gru import GRUConfig, GRUDecoder, Params
from ..ops.decode import greedy_decode


class InferenceModel:
    """``model(x, days, x_lens) -> (log_probs [B, L, K], out_lens [B])`` for
    one envelope of ``batch_size`` trials of up to ``t_max`` bins."""

    def __init__(
        self,
        params: Params,
        cfg: GRUConfig,
        device: torch.device | str,
        *,
        batch_size: int = 64,
        t_max: int = 1280,
    ):
        self.cfg = cfg
        self.device = torch.device(device)
        self.batch_size = batch_size
        self.t_max = t_max
        self.module = GRUDecoder(cfg, params).to(self.device).eval()

    def pad_batch(self, trials, days=None):
        """Pad up to ``batch_size`` trials (``[T_i, C]`` arrays, ``T_i <=
        t_max``) to the envelope. Returns ``(x [B, t_max, C], days [B],
        x_lens [B])`` on the device. Unused rows are zero with length 0,
        so their ``out_lens`` are 0 and they decode empty."""
        b, t, c = self.batch_size, self.t_max, self.cfg.neural_dim
        if len(trials) > b:
            raise ValueError(f"{len(trials)} trials > batch_size {b}")
        x = np.zeros((b, t, c), np.float32)
        lens = np.zeros((b,), np.int32)
        day_arr = np.zeros((b,), np.int32)
        for i, tr in enumerate(trials):
            tr = np.asarray(tr, np.float32)
            if tr.ndim != 2 or tr.shape[0] > t or tr.shape[1] != c:
                raise ValueError(
                    f"trial {i} shape {tr.shape} exceeds the envelope "
                    f"(t_max={t}, n_channels={c})"
                )
            x[i, : tr.shape[0]] = tr
            lens[i] = tr.shape[0]
            if days is not None:
                day_arr[i] = int(days[i])
        return tuple(
            torch.from_numpy(a).to(self.device) for a in (x, day_arr, lens)
        )

    @torch.inference_mode()
    def __call__(
        self, x: torch.Tensor, days: torch.Tensor, x_lens: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        want = (self.batch_size, self.t_max, self.cfg.neural_dim)
        if tuple(x.shape) != want:
            raise ValueError(f"x {tuple(x.shape)} != envelope {want}")
        return forward(self.module, x, days, x_lens)[:2]

    @torch.inference_mode()
    def decode(
        self, log_probs: torch.Tensor, out_lens: torch.Tensor
    ) -> list[list[int]]:
        """Greedy CTC decode of each row, as lists of label ids."""
        tokens, lens = greedy_decode(log_probs, out_lens)
        tokens, lens = tokens.cpu().numpy(), lens.cpu().numpy()
        return [tokens[i, : lens[i]].tolist() for i in range(len(lens))]
