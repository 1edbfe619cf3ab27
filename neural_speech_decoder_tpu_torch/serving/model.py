"""Batch inference of either decoder family on one device, eagerly.

Port of ``neural_speech_decoder_tpu/serving/export.py::ExportedModel``
without the artifact (``serving/export.py`` has the artifact): the
decoder is built from its config as ``models/api.py::build_model`` builds
it (``GRUDecoder`` for a ``GRUConfig``, ``ConformerDecoder`` for a
``ConformerConfig``), the weights go to the device once, requests are
padded to a fixed ``(batch_size, t_max)`` envelope through one pinned
buffer (``serving/pad.py``), and the eval forward returns ``(log_probs,
out_lens)``: the run's own forward, its ``use_pallas_matmul`` included.
"""

from __future__ import annotations

import torch

from ..models.api import forward
from ..models.conformer import ConformerConfig, ConformerDecoder
from ..models.gru import GRUConfig, GRUDecoder, Params
from ..ops.decode import greedy_decode
from .pad import Padder


def n_channels(cfg: GRUConfig | ConformerConfig) -> int:
    return cfg.neural_dim if isinstance(cfg, GRUConfig) else cfg.n_channels


class InferenceModel:
    """``model(x, days, x_lens) -> (log_probs [B, L, K], out_lens [B])`` for
    one envelope of ``batch_size`` trials of up to ``t_max`` bins, for the
    GRU or the Conformer."""

    def __init__(
        self,
        params: Params,
        cfg: GRUConfig | ConformerConfig,
        device: torch.device | str = "cuda",
        *,
        batch_size: int = 64,
        t_max: int = 1280,
    ):
        self.cfg = cfg
        self.device = torch.device(device)
        self.batch_size = batch_size
        self.t_max = t_max
        decoder = ConformerDecoder if isinstance(cfg, ConformerConfig) else GRUDecoder
        self.module = decoder(self.cfg, params).to(self.device).eval()
        self._pad = Padder(batch_size, t_max, n_channels(self.cfg), self.device)

    def pad_batch(self, trials, days=None):
        """Pad up to ``batch_size`` trials (``[T_i, C]`` arrays, ``T_i <=
        t_max``) to the envelope. Returns ``(x [B, t_max, C], days [B],
        x_lens [B])`` on the device. Unused rows are zero with length 0,
        so their ``out_lens`` are 0 and they decode empty."""
        return self._pad(trials, days)

    @torch.inference_mode()
    def __call__(
        self, x: torch.Tensor, days: torch.Tensor, x_lens: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        want = (self.batch_size, self.t_max, n_channels(self.cfg))
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
