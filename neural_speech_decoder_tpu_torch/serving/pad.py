"""Padding raw trials into a serving envelope, through one pinned buffer.

``InferenceModel.pad_batch`` and ``ExportedModel.pad_batch`` share this.
The JAX package's ``pad_batch`` builds fresh numpy arrays for each request
(84 MB of float32 at B=64, T=1280, C=256) and returns them. Here one host
buffer per envelope is kept (pinned when the device is a card) and only
what must change is written: each trial's bins, and zeros over the bins
that the previous request wrote past that row's new length. The buffer goes
to the device with ``non_blocking=True``; an event recorded after the copy
makes the next request wait for it before writing the buffer again. The
values are those of the JAX package's arrays, bit for bit; they are
returned as tensors on the device (on the CPU, as copies of the buffer).
"""

from __future__ import annotations

import numpy as np
import torch


class Padder:
    """``padder(trials, days=None) -> (x [B, T, C] float32, days [B] int32,
    x_lens [B] int32)`` on ``device`` for an envelope of ``batch_size``
    trials of up to ``t_max`` bins of ``n_channels``. Unused rows are zero
    with length 0 (their ``out_lens`` come back 0 and decode empty); days
    default to 0."""

    def __init__(self, batch_size: int, t_max: int, n_channels: int,
                 device: torch.device | str):
        self.batch_size, self.t_max, self.n_channels = batch_size, t_max, n_channels
        self.device = torch.device(device)
        pin = self.device.type == "cuda"
        self._x = torch.zeros((batch_size, t_max, n_channels), dtype=torch.float32,
                              pin_memory=pin)
        self._days = torch.zeros((batch_size,), dtype=torch.int32, pin_memory=pin)
        self._lens = torch.zeros((batch_size,), dtype=torch.int32, pin_memory=pin)
        self._written = np.zeros((batch_size,), np.int64)  # bins of each row now nonzero
        self._copied: torch.cuda.Event | None = None

    def __call__(self, trials, days=None):
        b, t, c = self.batch_size, self.t_max, self.n_channels
        if len(trials) > b:
            raise ValueError(f"{len(trials)} trials > batch_size {b}")
        trials = [np.asarray(tr, np.float32) for tr in trials]
        for i, tr in enumerate(trials):
            if tr.ndim != 2 or tr.shape[0] > t or tr.shape[1] != c:
                raise ValueError(
                    f"trial {i} shape {tr.shape} exceeds the envelope (t_max={t}, "
                    f"n_channels={c}); re-export with a larger --t-max")
        if self._copied is not None:
            self._copied.synchronize()  # the last request's copy has read the buffer
        x, lens, day_arr = self._x.numpy(), self._lens.numpy(), self._days.numpy()
        for i in range(b):
            n = trials[i].shape[0] if i < len(trials) else 0
            if i < len(trials):
                x[i, :n] = trials[i]
            if self._written[i] > n:
                x[i, n:self._written[i]] = 0.0
            self._written[i] = n
            lens[i] = n
            day_arr[i] = int(days[i]) if days is not None and i < len(trials) else 0
        if self.device.type != "cuda":
            return self._x.clone(), self._days.clone(), self._lens.clone()
        out = tuple(a.to(self.device, non_blocking=True)
                    for a in (self._x, self._days, self._lens))
        self._copied = torch.cuda.Event()
        self._copied.record(torch.cuda.current_stream(self.device))
        return out
