"""Serving-side runner of the exported streaming artifacts (the GRU and the
causal Conformer; ``stream_meta.json``'s ``kind`` picks the protocol).

Port of ``neural_speech_decoder_tpu/serving/streaming.py``. Loads the
programs ``export_streaming*`` write (``stream_prime.pt2``,
``stream_step.pt2``, and ``stream_tail.pt2`` for Conformer artifacts with
``frames_per_chunk > 1``) and drives them with numpy and torch only:
host-side bin buffering, fixed-size dispatch, the flush's zero padding, the
reference CTC length ``(T - k) // s`` (which the live streamers' one-frame
holdback also realizes), the Conformer's real-bin mask and its frame
offset (kept on the device, advanced there), incremental greedy decoding
and the on-device beam. No model, training or streaming module is imported.
Each chunk is one eager call of the loaded program (the live streamers
replay a CUDA graph instead).

Outputs differ by kind (``meta['outputs']``): GRU artifacts emit raw
logits, Conformer artifacts log-probabilities; argmax decoding is the
same, an external scorer must read the field.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.greedy import incremental_greedy
from .export import (
    _BEAM_FINAL,
    _BEAM_INIT,
    _BEAM_META,
    _BEAM_STEP,
    _STREAM_META,
    _STREAM_PRIME,
    _STREAM_STEP,
    _STREAM_TAIL,
    _load,
    _load_weights,
    _read_json,
)


class ExportedStreamer:
    """Fixed-configuration streaming inference from an exported artifact.

    ``feed(raw_bins)`` takes any number of new ``[B, n, C]`` raw bins and
    returns the outputs ``[B, m, K]`` of every frame that became fully
    determined; ``flush()`` realizes the remaining frames with the offline
    zero-padding and truncates the stream to the reference CTC length.
    """

    def __init__(self, art_dir: str):
        path = os.path.join(art_dir, _STREAM_META)
        if not os.path.exists(path):
            raise ValueError(f"not a streaming artifact (no {_STREAM_META}): {art_dir}")
        self.meta = _read_json(art_dir, _STREAM_META)
        if self.meta.get("kind") not in ("gru_stream", "conformer_stream"):
            raise ValueError(f"not a streaming artifact: {art_dir}")
        self._conformer = self.meta["kind"] == "conformer_stream"
        self.device = resolve_device(self.meta["device"], "serving")
        self._prime = _load(art_dir, _STREAM_PRIME)
        self._step = _load(art_dir, _STREAM_STEP)
        self._tail = _load(art_dir, _STREAM_TAIL) if self.meta.get("has_tail") else None
        self._beam = None  # (init, step, final)
        self.beam_meta = None
        if os.path.exists(os.path.join(art_dir, _BEAM_META)):
            self.beam_meta = _read_json(art_dir, _BEAM_META)
            self._beam = tuple(_load(art_dir, name)
                               for name in (_BEAM_INIT, _BEAM_STEP, _BEAM_FINAL))
        # on the device ONCE: host leaves would be copied on every call
        self._weights = _load_weights(art_dir, self.meta["leaf_dtypes"], self.device)
        self.reset()

    def reset(self) -> None:
        m = self.meta
        self._buf = np.zeros((m["batch"], 0, m["n_channels"]), np.float32)
        self._state = None  # the carried device state after priming
        self._t_real = 0  # real raw bins fed so far
        self._pos = 0  # global index of the first buffered bin
        # frames emitted before the next call (the Conformer's positional
        # rows and band), on the device
        self._offset = torch.zeros((), dtype=torch.int64, device=self.device)
        self._emitted = 0  # frames returned to the caller so far
        self._flushed = False
        self._decode_prev = np.full((m["batch"],), -1, np.int64)
        self._beam_state = None  # the carried on-device beam state

    # -- streaming ---------------------------------------------------------
    @torch.inference_mode()
    def _dispatch_one(self, tail: bool = False):
        """Run one prime, step or tail call if the buffer holds its bins;
        returns the outputs on the device, or None."""
        m = self.meta
        priming = self._state is None
        if tail:
            need, frames = m["stride_len"], 1
        else:
            need = m["prime_bins"] if priming else m["chunk_bins"]
            frames = m["frames_per_chunk"]
        if self._buf.shape[1] < need:
            return None
        new = torch.from_numpy(np.ascontiguousarray(self._buf[:, :need])).to(self.device)
        if self._conformer:
            mask = torch.from_numpy(
                ((self._pos + np.arange(need)) < self._t_real).astype(np.float32))
            mask = mask.to(self.device)
            if priming:
                res = self._prime(self._weights, new, mask)
            else:
                fn = self._tail if tail else self._step
                res = fn(self._weights, *self._state, self._offset, new, mask)
            self._offset = self._offset + frames
        elif priming:
            res = self._prime(self._weights, new)
        else:
            res = self._step(self._weights, *self._state, new)
        self._buf = self._buf[:, need:]
        self._pos += need
        *state, out = res
        self._state = tuple(state)
        return out

    def feed(self, raw_bins: np.ndarray) -> np.ndarray:
        """Feed ``[B, n, C]`` new raw bins; returns ``[B, m, K]`` outputs
        (m may be 0), on the host."""
        chunks = self.feed_async(raw_bins)
        if not chunks:
            return np.zeros((self.meta["batch"], 0, self.meta["n_classes"]), np.float32)
        return torch.cat(chunks, dim=1).cpu().numpy()

    def feed_async(self, raw_bins: np.ndarray) -> list[torch.Tensor]:
        """As ``feed``, but returns each dispatch's outputs on the device
        without waiting for them, so that a consumer (``decode_beam``) can
        queue more device work before one readback."""
        if self._flushed:
            raise RuntimeError("stream flushed; call reset()")
        raw_bins = np.asarray(raw_bins, np.float32)
        self._t_real += raw_bins.shape[1]
        self._buf = np.concatenate([self._buf, raw_bins], axis=1)
        chunks = []
        while (out := self._dispatch_one()) is not None:
            chunks.append(out)
        # live emissions never exceed the realizable count (every frame's
        # raw window, the smoother's lookahead included, has arrived): only
        # the flush pads and truncates
        self._emitted += sum(c.shape[1] for c in chunks)
        return chunks

    def flush(self) -> np.ndarray:
        """Zero-pad (the offline right padding) until the reference CTC
        length ``(T - kernel) // stride`` is realized; returns the remaining
        frames. Conformer artifacts with a tail program take it for the
        last partial chunk (the live streamer's one-frame emissions)."""
        if self._flushed:
            raise RuntimeError("stream already flushed; call reset()")
        self._flushed = True
        m = self.meta
        n_f = m["frames_per_chunk"]
        target = max(0, (self._t_real - m["kernel_len"]) // m["stride_len"])
        out = []
        while self._emitted < target:
            priming = self._state is None
            use_tail = (self._tail is not None and not priming
                        and target - self._emitted < n_f)
            if use_tail:
                need = m["stride_len"]
            else:
                need = m["prime_bins"] if priming else m["chunk_bins"]
            short = need - self._buf.shape[1]
            if short > 0:
                self._buf = np.concatenate(
                    [self._buf, np.zeros((m["batch"], short, m["n_channels"]), np.float32)],
                    axis=1)
            logits = self._dispatch_one(tail=use_tail)
            keep = min(logits.shape[1], target - self._emitted)
            if keep > 0:
                out.append(logits[:, :keep])
                self._emitted += keep
        if out:
            return torch.cat(out, dim=1).cpu().numpy()
        return np.zeros((m["batch"], 0, m["n_classes"]), np.float32)

    # -- decoding ----------------------------------------------------------
    def decode_greedy(self, logits) -> list[list[int]]:
        """Incremental CTC greedy decode (argmax -> collapse repeats -> drop
        blanks), the collapse state carried across calls."""
        if isinstance(logits, torch.Tensor):
            logits = logits.float().cpu().numpy()
        return incremental_greedy(logits, self._decode_prev)

    @torch.inference_mode()
    def decode_beam(self, logits):
        """Incremental on-device n-best prefix beam search with the exported
        beam programs (present when the artifact was built with ``--beam`` /
        ``export_beam``). Takes a ``[B, m, K]`` chunk (numpy, or a device
        tensor from ``feed_async``), carries the beam state across calls,
        exactly chunk-boundary-invariant, and returns the current
        ``(prefixes [B, W, max_len], lens, scores)`` best-first, on the
        host. ``reset()`` clears the search."""
        if self._beam is None:
            raise RuntimeError("artifact has no beam programs; export with "
                               "export_beam(art_dir, ...) or nsd-export-torch --beam")
        binit, bstep, bfinal = self._beam
        if self._beam_state is None:
            self._beam_state = binit()
        logits = torch.as_tensor(logits).to(self.device, torch.float32)
        # one frame a call: any chunk length (the flush's too) drives the
        # same program
        for i in range(logits.shape[1]):
            self._beam_state = bstep(*self._beam_state, logits[:, i: i + 1])
        return tuple(a.cpu().numpy() for a in bfinal(*self._beam_state))


def load_exported_streamer(art_dir: str) -> ExportedStreamer:
    return ExportedStreamer(art_dir)
