"""Streaming (chunked) decode of the unidirectional GRU with carried state.

Port of ``neural_speech_decoder_tpu/streaming/engine.py``. ``GRUStreamer``
reproduces the offline unidirectional forward chunk-boundary-invariantly:

- raw bins are buffered until each smoothed bin's receptive field has
  arrived (the smoother's lookahead: 10 bins at 20 taps; ``causal=True``
  drops the future taps and renormalises the past ones, zero lookahead, no
  offline parity);
- the unfold's ``k - s`` smoothed, day-calibrated bins are carried;
- each layer's hidden state is carried;
- one frame is held back, so a flushed stream emits exactly the reference
  CTC length ``(T - k) // s``, one frame fewer than the unfold produces.

Numerics are the JAX streamer's, which differ from the offline forward's in
the compute dtype: smoothing, day affine and Softsign in float32 over a
VALID window, then the cast; layer 0's projection rounded once (the offline
forward rounds it, adds ``b_ih`` and rounds again); each step's gate math in
float32 with the carry rounded to the compute dtype (the scan kernel keeps
it in float32). In float32 the two agree. The weights are cast to the
compute dtype once, at construction (JAX recasts them every call; the bits
are the same).

The steady state runs as one call a chunk (``FastPath``): once a stream
holds exactly the smoother's ``ks - 1`` raw bins and a bin residual in
``[k, k + s * frames_per_chunk)``, every chunk of exactly ``s *
frames_per_chunk`` bins goes through one body that smooths, calibrates,
runs the frames and rolls the carried state in place; on the card that body
is captured once per residual width as a CUDA graph and replayed, where JAX
runs one donated jit call. Any other chunk size demotes to the eager path.
No hand-written kernel lies on this path (JAX's streamer reaches no Pallas
kernel either): its products are ``torch.mm``.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..decoding.ondevice_beam import beam_extend, beam_finalize, beam_init
from ..models.common import _mm_f32
from ..models.gru import GRUConfig
from ..ops.gaussian import gaussian_kernel, same_padding
from ..utils.device import resolve_device
from ..utils.greedy import incremental_greedy


@dataclasses.dataclass
class _Buffers:
    raw: torch.Tensor
    bins: torch.Tensor
    new: torch.Tensor | None = None
    graph: "torch.cuda.CUDAGraph | None" = None
    out: torch.Tensor | None = None


class FastPath:
    """The steady-state chunk step over state kept in fixed buffers.

    ``body(new, raw_ctx, bin_ctx)`` runs one chunk: it reads the new bins,
    the carried ``(raw_ctx, bin_ctx)`` and the streamer's ``fixed`` state
    tensors, writes all of them in place and returns the chunk's output.
    ``promote(raw, bins)`` copies the eager path's state into the buffers of
    its bin-residual width (one set, and one graph, per width, kept across
    the streamer's ``reset``); ``demote`` hands copies back.

    With ``graphs`` (a CUDA device) a width's first step warms the body up
    on a side stream, puts back the state the warm-up moved, captures the
    body as a CUDA graph and replays it; later steps copy the chunk into the
    graph's input buffer and replay. The output is returned as a copy,
    which the next replay does not overwrite. A capture or replay error
    raises. Without ``graphs`` the body runs eagerly on the same buffers.
    """

    def __init__(self, body, fixed: tuple[torch.Tensor, ...], *, graphs: bool):
        self._body = body
        self.fixed = fixed
        self.graphs = graphs
        self.width: int | None = None  # the live state's residual, None: demoted
        self._steps: dict[int, _Buffers] = {}
        self._stream = None
        self.replays = 0  # graph replays (chunks run as one graph)

    @property
    def engaged(self) -> bool:
        return self.width is not None

    def reset(self) -> None:
        """Demote without a copy and zero the fixed state (buffers and
        graphs stay)."""
        self.width = None
        for t in self.fixed:
            t.zero_()

    def promote(self, raw: torch.Tensor, bins: torch.Tensor) -> None:
        w = bins.shape[1]
        buf = self._steps.get(w)
        if buf is None:
            buf = self._steps[w] = _Buffers(raw.clone(memory_format=torch.contiguous_format),
                                            bins.clone(memory_format=torch.contiguous_format))
        else:
            buf.raw.copy_(raw)
            buf.bins.copy_(bins)
        self.width = w

    def live(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The engaged state's ``(raw_ctx, bin_ctx)`` buffers."""
        buf = self._steps[self.width]
        return buf.raw, buf.bins

    def demote(self) -> tuple[torch.Tensor, torch.Tensor]:
        buf = self._steps[self.width]
        self.width = None
        return buf.raw.clone(), buf.bins.clone()

    def step(self, new: torch.Tensor) -> torch.Tensor:
        buf = self._steps[self.width]
        if not self.graphs:
            return self._body(new, buf.raw, buf.bins)
        if buf.graph is None:
            buf.new = new.clone()
            self._capture(buf)
        else:
            buf.new.copy_(new)
        buf.graph.replay()
        self.replays += 1
        return buf.out.clone()

    def _capture(self, buf: _Buffers) -> None:
        state = (buf.raw, buf.bins, *self.fixed)
        saved = [t.clone() for t in state]
        current = torch.cuda.current_stream(buf.new.device)
        if self._stream is None:
            self._stream = torch.cuda.Stream(buf.new.device)
        side = self._stream
        side.wait_stream(current)
        with torch.cuda.stream(side):  # lazy initialisation outside the capture
            self._body(buf.new, buf.raw, buf.bins)
        current.wait_stream(side)
        for t, s in zip(state, saved):
            t.copy_(s)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            buf.out = self._body(buf.new, buf.raw, buf.bins)
        buf.graph = graph


class Streamer:
    """What both streamers share: input checks, raw-bin buffering, the
    smoothing and emission loop with the one-frame holdback, promotion to
    and demotion from the fast path, ``flush`` and the incremental decodes.

    A subclass sets ``cfg``, ``kernel``, ``stride``, ``ks`` (smoothing
    taps), ``pad_left``, ``lookahead``, ``channels``, the dtypes of the raw
    and smoothed buffers, and implements ``_admit`` (new raw bins into the
    smoother's domain), ``_smooth`` (a VALID smoothing window -> bins) and
    ``_emit`` (bins covering n frames -> their outputs, carried state rolled
    in place); ``_emits_logits`` says whether ``decode_beam`` needs a
    log-softmax first.
    """

    _emits_logits = True

    def _setup(self, batch: int, frames_per_chunk: int, graphs: bool,
               fixed: tuple[torch.Tensor, ...]) -> None:
        self.batch = batch
        self.frames_per_chunk = frames_per_chunk
        self._fast_n = self.stride * frames_per_chunk
        self._fast = FastPath(self._fused, fixed,
                              graphs=graphs and self.device.type == "cuda")
        self.reset()

    def reset(self) -> None:
        """Start a new stream: the carried state zeroed, the decodes'
        state cleared. The fast path's buffers and graphs are kept."""
        b, c, dev = self.batch, self.channels, self.device
        # seeded with the smoother's left zero padding
        self._raw = torch.zeros((b, self.pad_left, c), dtype=self._raw_dtype, device=dev)
        self._bins = torch.zeros((b, 0, c), dtype=self._bin_dtype, device=dev)
        self._fast.reset()
        self._flushed = False
        self.emitted = 0  # frames emitted so far (the host's count)
        self._decode_prev = np.full((b,), -1, np.int64)
        self._beam_state = None

    # -- public API -------------------------------------------------------
    def process(self, new_bins) -> np.ndarray:
        """Feed ``[B, n, C]`` new raw bins; returns the outputs ``[B, m, K]``
        of every frame that became fully determined (m may be 0), on the
        host."""
        return self.process_async(new_bins).cpu().numpy()

    def process_async(self, new_bins) -> torch.Tensor:
        """As ``process``, but returns the outputs on the streamer's device
        without waiting for them, so a consumer (``decode_beam``) can chain
        more device work first."""
        if self._flushed:
            raise RuntimeError("stream already flushed; call reset()")
        new = self._input(new_bins)
        if self._fast.engaged:
            if new.shape[1] == self._fast_n:
                self.emitted += self.frames_per_chunk
                return self._fast.step(new)
            self._demote()
        self._raw = torch.cat([self._raw, self._admit(new)], dim=1)
        out = self._drain()
        self._maybe_promote()
        return out

    def flush(self) -> np.ndarray:
        """Apply the offline right-zero-padding to the tail and emit the
        remaining frames (on the host)."""
        if self._flushed:
            raise RuntimeError("stream already flushed; call reset()")
        if self._fast.engaged:
            self._demote()
        self._flushed = True
        if self.lookahead > 0:
            pad = self._raw.new_zeros((self.batch, self.lookahead, self.channels))
            self._raw = torch.cat([self._raw, pad], dim=1)
        return self._drain(final=True).cpu().numpy()

    @property
    def fast_path_engaged(self) -> bool:
        return self._fast.engaged

    def bound(self, weights: dict, fixed: tuple[torch.Tensor, ...]) -> "Streamer":
        """A copy of this streamer whose bodies (``_admit``, ``_smooth``,
        ``_emit``) read ``weights`` (``weight_tree()``'s layout) and the
        fixed state ``fixed`` (``carried_state()``'s tail), which ``_emit``
        rolls in place: what ``serving/export.py`` traces, with both as the
        exported program's inputs. This streamer is left as it was."""
        other = copy.copy(self)
        other._set_weights(weights)
        other._set_fixed(fixed)
        return other

    def carried_state(self) -> tuple[torch.Tensor, ...]:
        """The live carried state: the raw and the smoothed bins, then the
        fixed state (the GRU's hidden states; the Conformer's K/V and conv
        caches and its frame offset)."""
        raw_bins = self._fast.live() if self._fast.engaged else (self._raw, self._bins)
        return (*raw_bins, *self._fast.fixed)

    def decode_greedy(self, outputs) -> list[list[int]]:
        """Incremental greedy CTC decode of newly emitted outputs (argmax ->
        collapse repeats -> drop blank), the collapse state carried across
        calls and cleared by ``reset``. Returns new label ids per stream."""
        if isinstance(outputs, torch.Tensor):
            outputs = outputs.detach().float().cpu().numpy()
        return incremental_greedy(outputs, self._decode_prev)

    def decode_beam(self, outputs, *, beam_width: int = 8, top_k_tokens: int = 8,
                    max_len: int = 512):
        """Incrementally prefix-beam-decode newly emitted outputs on the
        streamer's device, the n-best ``BeamState`` carried across calls: at
        the end of a stream it equals ``prefix_beam_search`` over all the
        outputs. Takes ``process_async``'s tensor as it is. Returns
        ``(prefixes [B, W, max_len], lens [B, W], scores [B, W])``
        best-first."""
        if self._beam_state is None:
            self._beam_state = beam_init(self.batch, beam_width, max_len, device=self.device)
        elif tuple(self._beam_state.prefixes.shape[1:]) != (beam_width, max_len):
            raise ValueError(
                "decode_beam width/max_len changed mid-stream (carried state is "
                f"W={self._beam_state.prefixes.shape[1]}, "
                f"max_len={self._beam_state.prefixes.shape[2]}); call reset() to "
                "start a new search")
        outputs = torch.as_tensor(outputs).to(self.device, torch.float32)
        if outputs.shape[1]:
            log_probs = torch.log_softmax(outputs, dim=-1) if self._emits_logits else outputs
            self._beam_state = beam_extend(self._beam_state, log_probs,
                                           top_k_tokens=top_k_tokens)
        return beam_finalize(self._beam_state)

    # -- internals --------------------------------------------------------
    def _input(self, new_bins) -> torch.Tensor:
        new = torch.as_tensor(new_bins).to(self.device, torch.float32)
        if new.dim() != 3 or new.shape[0] != self.batch or new.shape[2] != self.channels:
            raise ValueError(f"new bins {tuple(new.shape)}: expected [{self.batch}, n, "
                             f"{self.channels}]")
        return new

    def _maybe_promote(self) -> None:
        # the steady residual lies in [k, k + n_f * s) under the one-frame
        # holdback; the fast body does not depend on which
        w0 = self._bins.shape[1]
        if (self._raw.shape[1] == self.ks - 1
                and self.kernel <= w0 < self.kernel + self._fast_n):
            self._fast.promote(self._raw, self._bins)

    def _demote(self) -> None:
        self._raw, self._bins = self._fast.demote()

    def _drain(self, final: bool = False) -> torch.Tensor:
        ks, k, s, n_f = self.ks, self.kernel, self.stride, self.frames_per_chunk
        # 1. smooth every raw bin whose whole window is present
        n_smoothable = self._raw.shape[1] - (ks - 1)
        if n_smoothable > 0:
            window = self._raw[:, : n_smoothable + ks - 1]
            self._bins = torch.cat([self._bins, self._smooth(window)], dim=1)
            self._raw = self._raw[:, n_smoothable:]
        # 2. bins into frames (k a frame, advancing by s). One-frame
        # holdback: a frame is emitted once a further frame is known to
        # exist, and the flush tail stops at k + s, so a stream realizes
        # the reference CTC length (T - k) // s
        out = []
        while self._bins.shape[1] >= k + n_f * s:
            out.append(self._emit(self._bins[:, : k + (n_f - 1) * s]))
            self._bins = self._bins[:, n_f * s:]
        if final:
            while self._bins.shape[1] >= k + s:
                out.append(self._emit(self._bins[:, :k]))
                self._bins = self._bins[:, s:]
        if not out:
            return torch.zeros((self.batch, 0, self.cfg.n_out), device=self.device)
        out = torch.cat(out, dim=1)
        self.emitted += out.shape[1]
        return out

    def _fused(self, new: torch.Tensor, raw_ctx: torch.Tensor,
               bin_ctx: torch.Tensor) -> torch.Tensor:
        """A steady chunk: smooth the new bins, run the frames, roll
        ``(raw_ctx, bin_ctx)`` and the fixed state in place."""
        ks, k, s, n_f = self.ks, self.kernel, self.stride, self.frames_per_chunk
        window = torch.cat([raw_ctx, self._admit(new)], dim=1)
        bins = torch.cat([bin_ctx, self._smooth(window)], dim=1)
        out = self._emit(bins[:, : k + (n_f - 1) * s])
        # positive-index slices: -(ks - 1) would keep the whole window when
        # ks == 1 and grow the state every chunk
        raw_ctx.copy_(window[:, window.shape[1] - (ks - 1):])
        bin_ctx.copy_(bins[:, n_f * s:])
        return out


class GRUStreamer(Streamer):
    """Chunked streaming decoder for the unidirectional GRU.

    Args:
      params: the port's GRU parameter tree (``init_gru_params`` layout).
      cfg: model config; ``bidirectional`` must be False.
      day_idx: recording-day index of the session being streamed.
      batch: number of parallel streams.
      frames_per_chunk: frames a steady chunk emits (``s * frames_per_chunk``
        bins).
      causal: skip the smoother's future taps (zero lookahead, no offline
        parity).
      device: where the stream runs; ``"cuda"`` by default, ``"cpu"`` when
        asked.
      graphs: on a CUDA device, replay each steady chunk as one CUDA graph
        (False runs the same step eagerly, for comparison).

    ``process`` returns float32 logits ``[B, m, n_classes + 1]``.
    """

    def __init__(self, params, cfg: GRUConfig, day_idx: int, *, batch: int = 1,
                 frames_per_chunk: int = 1, causal: bool = False,
                 device: torch.device | str = "cuda", graphs: bool = True):
        if cfg.bidirectional:
            raise ValueError("streaming requires the unidirectional GRU mode "
                             "(bidirectional back-states depend on future input)")
        self.cfg = cfg
        self.causal = causal
        self.device = dev = resolve_device(device, "streaming")
        self.kernel, self.stride = cfg.kernel_len, cfg.stride_len
        self.channels = c = cfg.neural_dim
        if cfg.gaussian_smooth_width <= 0:
            # the offline smoothing is a no-op for sigma <= 0 (Gaussian taps
            # would divide by zero)
            pad_l = pad_r = 0
            taps = np.ones((1,), np.float32)
        else:
            pad_l, pad_r = same_padding(cfg.gaussian_kernel_size)
            taps = gaussian_kernel(cfg.gaussian_kernel_size, cfg.gaussian_smooth_width)
            if causal:
                taps = taps[: pad_l + 1] / taps[: pad_l + 1].sum()
        self.ks = len(taps)
        self.lookahead = 0 if causal else pad_r
        self.pad_left = pad_l
        self._raw_dtype = self._bin_dtype = torch.float32
        self._taps = torch.from_numpy(np.tile(taps, (c, 1))[:, None, :]).to(dev)
        cdt = cfg.compute_dtype
        # the day calibration as one float32 affine; weights in the compute
        # dtype and biases in float32, cast once
        def cast(t, dtype):
            return t.detach().to(dev, dtype).contiguous()

        self._w_day = cast(params["day"]["weight"][day_idx], torch.float32)
        self._b_day = cast(params["day"]["bias"][day_idx], torch.float32)
        self._layers = [(cast(lp["w_ih"][0], cdt), cast(lp["b_ih"][0], torch.float32),
                         cast(lp["w_hh"][0], cdt), cast(lp["b_hh"][0], torch.float32))
                        for lp in params["gru"]["layers"]]
        self._fc = (cast(params["fc"]["weight"], cdt), cast(params["fc"]["bias"], torch.float32))
        self._h = torch.zeros((cfg.num_layers, batch, cfg.hidden_dim), dtype=cdt, device=dev)
        self._setup(batch, frames_per_chunk, graphs, (self._h,))

    def weights(self) -> list[torch.Tensor]:
        """The tensors a chunk reads besides its input and state."""
        return [self._taps, self._w_day, self._b_day, *(t for lt in self._layers for t in lt),
                *self._fc]

    def weight_tree(self) -> dict:
        """The weights the bodies read, as cast at construction, as a tree
        (the taps aside)."""
        return {"w_day": self._w_day, "b_day": self._b_day, "layers": self._layers,
                "fc": self._fc}

    def _set_weights(self, tree: dict) -> None:
        self._w_day, self._b_day = tree["w_day"], tree["b_day"]
        self._layers, self._fc = tree["layers"], tree["fc"]

    def _set_fixed(self, fixed) -> None:
        (self._h,) = fixed

    def _admit(self, new: torch.Tensor) -> torch.Tensor:
        return new

    def _smooth(self, window: torch.Tensor) -> torch.Tensor:
        """``[B, n + ks - 1, C]`` raw bins -> ``[B, n, C]`` smoothed,
        day-calibrated, Softsigned bins, in float32 (a VALID window)."""
        sm = F.conv1d(window.transpose(1, 2), self._taps, groups=self.channels)
        return F.softsign(torch.matmul(sm.transpose(1, 2), self._w_day) + self._b_day)

    def _emit(self, bins: torch.Tensor) -> torch.Tensor:
        """``bins [B, k + (n - 1) s, C]`` covering n frames -> float32
        logits ``[B, n, K]``; every layer's carry advanced in place."""
        cfg, h = self.cfg, self._h
        cdt = cfg.compute_dtype
        b = bins.shape[0]
        n_f = (bins.shape[1] - self.kernel) // self.stride + 1
        # unfold to [B, n, C, k]: the torch layout c*k + j of W_ih's rows
        out = bins.to(cdt).unfold(1, self.kernel, self.stride).reshape(b * n_f, -1)
        for li, (w_ih, b_ih, w_hh, b_hh) in enumerate(self._layers):
            xp = (_mm_f32(out, w_ih) + b_ih).to(cdt).view(b, n_f, -1)
            hh = h[li]
            ys = []
            for t in range(n_f):
                hh = self._cell(xp[:, t], hh, w_hh, b_hh)
                ys.append(hh)
            h[li].copy_(hh)
            out = torch.stack(ys, dim=1).view(b * n_f, -1)
        w_fc, b_fc = self._fc
        return (_mm_f32(out, w_fc) + b_fc).view(b, n_f, -1)

    def _cell(self, x_t, hh, w_hh, b_hh) -> torch.Tensor:
        """One step: float32 gate math, the new carry rounded to the compute
        dtype."""
        hd = self.cfg.hidden_dim
        hp = _mm_f32(hh, w_hh) + b_hh
        xt = x_t.float()
        rz = torch.sigmoid(xt[:, : 2 * hd] + hp[:, : 2 * hd])
        r, z = rz[:, :hd], rz[:, hd:]
        n = torch.tanh(xt[:, 2 * hd:] + r * hp[:, 2 * hd:])
        return ((1 - z) * n + z * hh.float()).to(self.cfg.compute_dtype)
