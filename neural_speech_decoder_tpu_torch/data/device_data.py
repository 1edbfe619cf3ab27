"""Device-resident dataset: the packed features go to the device once, and
each batch is gathered and zero-padded there.

Port of ``neural_speech_decoder_tpu/data/device_data.py``. The host path
(``data/batching.py::_gather`` then ``training/trainer.py::batch_tensors``)
copies a padded ``[B, T, C]`` float32 batch to the device every step (84 MB
at the GRU recipe). Here the packed ``[sum(T), C]`` features live in device
memory; the host samples trial indices as before (the same RNG stream and
batch composition, so resume and parity stay exact) and each step copies
only the ``[B]`` trial offsets and lengths and the label-side arrays, as one
int32 buffer from pinned memory with ``non_blocking=True``, so the copy does
not wait for the card's queue to drain. The gathered batch equals the host
path's bit for bit (zero rows past each trial's length).

Enabled by ``deviceResidentData: true`` in the trainer's args.
"""

from __future__ import annotations

import numpy as np
import torch

from .batching import Batch
from .dataset import PackedDataset


def assemble_x(features: torch.Tensor, offs: torch.Tensor, x_lens: torch.Tensor,
               t_env: int) -> torch.Tensor:
    """``[B, t_env, C]``: trial ``i``'s rows ``features[offs[i] + t]`` for
    ``t < x_lens[i]`` (lengths already clipped to ``t_env``), zeros past
    them (the JAX package's ``_assemble_x``)."""
    t_idx = torch.arange(t_env, device=features.device)
    valid = t_idx[None, :] < x_lens[:, None]
    rows = torch.where(valid, offs[:, None].long() + t_idx[None, :], 0)
    x = features.index_select(0, rows.reshape(-1)).reshape(*rows.shape, -1)
    return torch.where(valid[..., None], x, 0.0)


class DeviceData:
    """The packed features of one ``PackedDataset`` on ``device``, and the
    assembler of its batches."""

    def __init__(self, ds: PackedDataset, device: torch.device | str):
        if ds.offsets[-1] >= np.iinfo(np.int32).max:
            raise ValueError("deviceResidentData needs fewer than 2**31 rows of "
                             "features; split the dataset")
        self.device = torch.device(device)
        self.offsets = ds.offsets.astype(np.int32)
        self.features = torch.from_numpy(np.ascontiguousarray(ds.features)).to(self.device)

    def assemble(self, batch: Batch) -> tuple[torch.Tensor, ...]:
        """``(x, y, x_lens, y_lens, days)`` on the device for a batch sampled
        with ``materialize_x=False`` (it carries ``idx`` and ``t_env``)."""
        b, u = batch.y.shape
        host = np.concatenate([
            self.offsets[batch.idx], batch.x_lens, batch.y_lens, batch.days,
            batch.y.reshape(-1)]).astype(np.int32)
        packed = torch.from_numpy(host)
        if self.device.type == "cuda":
            packed = packed.pin_memory()
        packed = packed.to(self.device, non_blocking=True)
        offs, x_lens, y_lens, days = packed[: 4 * b].reshape(4, b)
        y = packed[4 * b :].reshape(b, u)
        x = assemble_x(self.features, offs, x_lens, batch.t_env)
        return x, y, x_lens, y_lens, days
