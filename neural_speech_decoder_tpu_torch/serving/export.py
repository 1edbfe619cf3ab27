"""Ahead-of-time inference export via ``torch.export``.

Port of ``neural_speech_decoder_tpu/serving/export.py``: the eval forward
of a trained run directory, for either model family, is exported once as a
serialized ``ExportedProgram``; a serving process needs only torch, the
artifact and the port's operator library (``ops/kernels/library.py``, which
registers the hand kernels as ``torch.ops.nsd_torch.*``): no model,
training or streaming code.

Artifact layout (``<out_dir>/``), the JAX package's with ``.pt2`` blobs:

- ``model.pt2`` — the exported function ``(weights, x [B, T, C] float32,
  days [B] int32, x_lens [B] int32) -> (log_probs [B, T', K], out_lens
  [B])``, ``weights`` a flat tuple of the parameter leaves;
- ``weights.npz`` — the leaves ``w000…`` in the port's flatten order
  (``models/conformer.py::_flatten``; bfloat16 leaves stored as float32,
  the true dtypes in ``meta['leaf_dtypes']``, the leaves' paths in
  ``meta['leaf_names']``);
- ``meta.json`` — model family, envelope, ``device`` and ``torch_version``
  (where JAX records ``platforms`` and ``jax_version``).

Device note: the kernels' operators pick their implementation when the
program runs, by the tensors' device (the CUDA kernel, or on the CPU the
plain twin), and an export bakes its device into the program's constants
and checks. Export on the device you will serve on, as with JAX: a CUDA
export runs the hand kernels and needs a card (loading it without one
raises), a CPU export runs the plain twins.

The streaming blobs (``stream_prime.pt2``, ``stream_step.pt2``,
``stream_tail.pt2``) are traced from the live streamers' own bodies, and
the beam blobs (``beam_init.pt2``, ``beam_step.pt2``, ``beam_final.pt2``)
from ``decoding/ondevice_beam.py``; ``serving/streaming.py`` drives them.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..utils.device import resolve_device
from .pad import Padder

_BLOB = "model.pt2"
_WEIGHTS = "weights.npz"
_META = "meta.json"
_STREAM_PRIME = "stream_prime.pt2"
_STREAM_STEP = "stream_step.pt2"
_STREAM_TAIL = "stream_tail.pt2"
_STREAM_META = "stream_meta.json"
_BEAM_INIT = "beam_init.pt2"
_BEAM_STEP = "beam_step.pt2"
_BEAM_FINAL = "beam_final.pt2"
_BEAM_META = "beam_meta.json"


class _Program(torch.nn.Module):
    """A function as the module ``torch.export`` takes."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _export(out_dir: str, name: str, fn, args) -> None:
    """Trace ``fn(*args)`` (no grad: the program is for inference) and save
    it as ``out_dir/name``."""
    with torch.no_grad():
        program = torch.export.export(_Program(fn), tuple(args))
    torch.export.save(program, os.path.join(out_dir, name))


def _load(art_dir: str, name: str) -> torch.fx.GraphModule:
    """A saved program, callable (its operators must be registered first:
    this module imports ``ops/kernels/library.py`` through the package).

    The tracer puts an ``_assert_tensor_metadata`` before every ``.to()``,
    re-checking the dtype and device seen at export; the loader drops them
    (a quarter of a streaming step's nodes, each a dispatched call): the
    program's own guards check its inputs' shapes, and its callers here pass
    the dtypes and the device of the export."""
    from ..ops import kernels  # noqa: F401  registers torch.ops.nsd_torch

    program = torch.export.load(os.path.join(art_dir, name)).module()
    for node in list(program.graph.nodes):
        if node.target is torch.ops.aten._assert_tensor_metadata.default:
            program.graph.erase_node(node)
    program.recompile()
    return program


def _flat(params) -> tuple[list[str], list[torch.Tensor]]:
    """The port's flatten order of a tree of tensors: ``(paths, leaves)``."""
    from ..models.conformer import _flatten

    items = _flatten(params)
    return ["/".join(p) for p, _ in items], [t.detach() for _, t in items]


def _tree(names: list[str], leaves) -> dict:
    """``_flat``'s inverse."""
    from ..models.conformer import _unflatten

    return _unflatten((tuple(n.split("/")), t) for n, t in zip(names, leaves))


def _save_weights(out_dir: str, leaves) -> list[str]:
    """Write the leaves (flatten order) to ``weights.npz``; returns the
    true dtype of each (bfloat16 is stored as float32: npz has no bf16)."""
    arrs, dtypes = {}, []
    for i, leaf in enumerate(leaves):
        dtypes.append(str(leaf.dtype).removeprefix("torch."))
        arrs[f"w{i:03d}"] = leaf.detach().cpu().float().numpy() \
            if leaf.dtype == torch.bfloat16 else leaf.detach().cpu().numpy()
    np.savez(os.path.join(out_dir, _WEIGHTS), **arrs)
    return dtypes


def _load_weights(art_dir: str, dtypes: list[str], device) -> tuple[torch.Tensor, ...]:
    """The leaves of ``weights.npz`` on ``device``, once, in their dtypes."""
    npz = np.load(os.path.join(art_dir, _WEIGHTS))
    return tuple(torch.from_numpy(npz[f"w{i:03d}"]).to(device, getattr(torch, dt))
                 for i, dt in enumerate(dtypes))


def _meta(device: torch.device) -> dict:
    return {"device": device.type, "torch_version": torch.__version__}


def _write_json(out_dir: str, name: str, meta: dict) -> None:
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(meta, f, indent=2)


def _read_json(art_dir: str, name: str) -> dict:
    with open(os.path.join(art_dir, name)) as f:
        return json.load(f)


def export_inference(
    model_dir: str,
    out_dir: str,
    *,
    batch_size: int | None = None,
    t_max: int | None = None,
    device: torch.device | str = "cuda",
) -> str:
    """Export the eval forward of a trained run directory as an AOT
    artifact. Shapes are static: one artifact serves one padded
    ``(batch_size, t_max)`` envelope. Defaults come from the run's
    ``args`` (``batchSize``; ``maxTimeSeriesLen`` rounded up to
    ``time_multiple``), as in JAX. The forward is the one
    ``serving/model.py::InferenceModel`` runs."""
    from ..models.api import forward_params
    from ..training.trainer import load_model
    from .model import n_channels

    dev = resolve_device(device, "serving")
    model, args = load_model(model_dir, device=dev)
    b = int(batch_size or args.get("batchSize", 8))
    # the trainer's eval envelope multiple, so that a default export takes
    # batches padded by the run's own pipeline
    tm = int(args.get("time_multiple", 128) or 1)
    t = int(t_max or args.get("maxTimeSeriesLen", 1200))
    t = ((t + tm - 1) // tm) * tm
    cfg = model.cfg
    n_ch = n_channels(cfg)
    names, leaves = _flat(model.params)

    def infer(weights, x, days, x_lens):
        log_probs, out_lens, _ = forward_params(cfg, _tree(names, weights), x, days, x_lens)
        return log_probs, out_lens

    os.makedirs(out_dir, exist_ok=True)
    _export(out_dir, _BLOB, infer, (
        tuple(leaves), torch.zeros((b, t, n_ch), device=dev),
        torch.zeros((b,), dtype=torch.int32, device=dev),
        torch.full((b,), t, dtype=torch.int32, device=dev)))
    meta = {
        "model_type": args.get("model_type", "gru_baseline"),
        "batch_size": b,
        "t_max": t,
        "n_channels": n_ch,
        "n_leaves": len(leaves),
        "leaf_dtypes": _save_weights(out_dir, leaves),
        "leaf_names": names,
        **_meta(dev),
        "outputs": "log_probs [B, T', K] (log-softmax), out_lens [B]",
    }
    _write_json(out_dir, _META, meta)
    return out_dir


class ExportedModel:
    """A loaded AOT artifact: ``model(x, days, x_lens)`` with the weights
    from ``weights.npz``, on the device the artifact was exported for.
    Needs torch and the port's operator library, no model code."""

    def __init__(self, art_dir: str):
        self.meta = _read_json(art_dir, _META)
        self.device = resolve_device(self.meta["device"], "serving")
        self._program = _load(art_dir, _BLOB)
        # on the device ONCE: host leaves would be copied on every call
        self._weights = _load_weights(art_dir, self.meta["leaf_dtypes"], self.device)
        m = self.meta
        self._pad = Padder(m["batch_size"], m["t_max"], m["n_channels"], self.device)

    @torch.inference_mode()
    def __call__(self, x, days, x_lens) -> tuple[torch.Tensor, torch.Tensor]:
        """``x [B, T, C]`` float32, ``days [B]`` int32, ``x_lens [B]`` int32
        (tensors or numpy) -> ``(log_probs [B, T', K], out_lens [B])`` on the
        device. Shapes must be the exported envelope (``meta['batch_size']``,
        ``meta['t_max']``): ``pad_batch`` fits raw trials to it."""
        m = self.meta
        want = (m["batch_size"], m["t_max"], m["n_channels"])
        if tuple(x.shape) != want or tuple(days.shape) != want[:1] \
                or tuple(x_lens.shape) != want[:1]:
            raise ValueError(f"x {tuple(x.shape)}, days {tuple(days.shape)}, x_lens "
                             f"{tuple(x_lens.shape)}: the artifact's envelope is {want}")
        dev = self.device
        return self._program(
            self._weights, torch.as_tensor(x).to(dev, torch.float32),
            torch.as_tensor(days).to(dev, torch.int32),
            torch.as_tensor(x_lens).to(dev, torch.int32))

    def pad_batch(self, trials, days=None):
        """Pad up to ``batch_size`` variable-length trials (``[T_i, C]``
        arrays, ``T_i <= t_max``; ``days`` per trial, default 0) to the
        envelope: ``(x, days, x_lens)`` on the device, ready for
        ``__call__``. Unused rows are zero with length 0, so their
        ``out_lens`` come back 0 and decode empty."""
        return self._pad(trials, days)

    @torch.inference_mode()
    def decode(self, log_probs: torch.Tensor, out_lens: torch.Tensor) -> list[list[int]]:
        """Greedy CTC decode of each row, as lists of label ids."""
        from ..ops.decode import greedy_decode

        tokens, lens = greedy_decode(log_probs, out_lens)
        tokens, lens = tokens.cpu().numpy(), lens.cpu().numpy()
        return [tokens[i, : lens[i]].tolist() for i in range(len(lens))]


def load_exported(art_dir: str) -> ExportedModel:
    return ExportedModel(art_dir)


# -- streaming export --------------------------------------------------------


def export_streaming(
    model_dir: str,
    out_dir: str,
    *,
    day_idx: int = 0,
    batch: int = 1,
    frames_per_chunk: int = 1,
    causal: bool = False,
    device: torch.device | str = "cuda",
) -> str:
    """Export the streaming path of a trained run directory: the GRU
    (``export_streaming_params``; unidirectional) or the causal Conformer
    (``export_streaming_conformer_params``), by the run's model family.
    One artifact serves one ``(batch, frames_per_chunk, day_idx)``
    configuration; ``serving/streaming.py::ExportedStreamer`` drives it."""
    from ..models.conformer import ConformerConfig
    from ..training.trainer import load_model

    model, _args = load_model(model_dir, device=resolve_device(device, "serving"))
    kw = dict(day_idx=day_idx, batch=batch, frames_per_chunk=frames_per_chunk,
              device=device)
    if isinstance(model.cfg, ConformerConfig):
        return export_streaming_conformer_params(model.params, model.cfg, out_dir, **kw)
    return export_streaming_params(model.params, model.cfg, out_dir, causal=causal, **kw)


def export_streaming_params(
    params,
    cfg,
    out_dir: str,
    *,
    day_idx: int = 0,
    batch: int = 1,
    frames_per_chunk: int = 1,
    causal: bool = False,
    device: torch.device | str = "cuda",
) -> str:
    """``export_streaming`` of the GRU from an in-memory ``(params,
    GRUConfig)`` pair (the live ``GRUStreamer``'s inputs). Two programs,
    both traced from the live streamer's bodies (``_smooth``, ``_emit``):

    - ``stream_prime.pt2``: ``(weights, raw0 [B, W, C]) -> (raw_ctx,
      bin_ctx, h, logits [B, F, K])``: the first ``W`` raw bins (the
      smoother's left zero padding added inside), leaving the stream in
      its steady state, the first ``F`` frames emitted;
    - ``stream_step.pt2``: ``(weights, raw_ctx, bin_ctx, h, new [B, n, C])
      -> (raw_ctx', bin_ctx', h', logits [B, F, K])``, ``n = stride * F``.

    The state goes in and comes out: no input is written. The weights are
    the live streamer's (``weight_tree()``: the day's affine and every layer
    cast once to the dtypes the bodies read), so that no call casts them
    again, as the live streamer casts them once at construction."""
    from ..streaming.engine import GRUStreamer

    st = GRUStreamer(params, cfg, day_idx, batch=batch, frames_per_chunk=frames_per_chunk,
                     causal=causal, device=resolve_device(device, "serving"), graphs=False)
    k, s, n_f = st.kernel, st.stride, frames_per_chunk
    ks, pad_l, c = st.ks, st.pad_left, st.channels
    n = s * n_f
    names, leaves = _flat(st.weight_tree())
    h_shape = (cfg.num_layers, batch, cfg.hidden_dim)

    def frames(weights, h, raw_window, bin_ctx):
        tr = st.bound(_tree(names, weights), (h,))
        bins = torch.cat([bin_ctx, tr._smooth(raw_window)], dim=1)
        logits = tr._emit(bins[:, : k + (n_f - 1) * s])
        return (raw_window[:, raw_window.shape[1] - (ks - 1):], bins[:, n:], tr._h, logits)

    def prime(weights, raw0):
        window = torch.cat([raw0.new_zeros((batch, pad_l, c)), raw0], dim=1)
        h0 = torch.zeros(h_shape, dtype=cfg.compute_dtype, device=raw0.device)
        return frames(weights, h0, window, raw0.new_zeros((batch, 0, c)))

    def step(weights, raw_ctx, bin_ctx, h, new):
        return frames(weights, h.clone(), torch.cat([raw_ctx, new], dim=1), bin_ctx)

    state = (torch.zeros(h_shape, dtype=cfg.compute_dtype, device=st.device),)
    return _write_stream(out_dir, st, names, leaves, state, prime, step, kind="gru_stream",
                         day_idx=day_idx, causal=causal,
                         outputs="logits [B, F, K] (pre-softmax)")


def export_streaming_conformer_params(
    params,
    cfg,
    out_dir: str,
    *,
    day_idx: int = 0,
    batch: int = 1,
    frames_per_chunk: int = 1,
    device: torch.device | str = "cuda",
) -> str:
    """``export_streaming`` of the causal Conformer, traced from the live
    ``ConformerStreamer``'s bodies (``_admit``, ``_smooth``, ``_emit``):

    - ``stream_prime.pt2``: ``(weights, raw0 [B, W, C], mask0 [W]) ->
      (raw_ctx, bin_ctx, kv_k, kv_v, conv_ctx, log_probs [B, F, K])``;
    - ``stream_step.pt2``: ``(weights, raw_ctx, bin_ctx, kv_k, kv_v,
      conv_ctx, offset [] int64, new [B, n, C], mask [n]) -> same``;
    - ``stream_tail.pt2`` (``frames_per_chunk > 1``): the same with
      ``stride`` new bins and one frame, for the flush's last frames.

    ``mask`` marks the real raw bins (1.0) against flush padding (0.0): the
    offline forward pads with zeros after the day affine, so padding enters
    the smoother as affined-domain zeros (``streaming/conformer.py``).
    ``offset`` is the count of frames emitted before the call (the
    positional rows and the band). The weights are the live streamer's, cast
    once (as in ``export_streaming_params``)."""
    from ..streaming.conformer import ConformerStreamer

    st = ConformerStreamer(params, cfg, day_idx, batch=batch,
                           frames_per_chunk=frames_per_chunk,
                           device=resolve_device(device, "serving"), graphs=False)
    k, s, n_f = st.kernel, st.stride, frames_per_chunk
    ks, pad_l, c = st.ks, st.pad_left, st.channels
    cdt = cfg.compute_dtype
    names, leaves = _flat(st.weight_tree())
    caches = tuple(t.shape for t in st._caches)

    def frames(weights, fixed, raw_ctx, bin_ctx, new, mask, n_frames):
        tr = st.bound(_tree(names, weights), fixed)
        window = torch.cat([raw_ctx, tr._admit(new) * mask[None, :, None].to(cdt)], dim=1)
        bins = torch.cat([bin_ctx, tr._smooth(window)], dim=1)
        log_probs = tr._emit(bins[:, : k + (n_frames - 1) * s])
        return (window[:, window.shape[1] - (ks - 1):], bins[:, n_frames * s:],
                *tr._caches, log_probs)

    def prime(weights, raw0, mask0):
        zeros = [torch.zeros(shape, dtype=cdt, device=raw0.device) for shape in caches]
        offset = torch.zeros((), dtype=torch.int64, device=raw0.device)
        return frames(weights, (*zeros, offset), raw0.new_zeros((batch, pad_l, c), dtype=cdt),
                      raw0.new_zeros((batch, 0, c), dtype=cdt), raw0, mask0, n_f)

    def stepper(n_frames):
        def step(weights, raw_ctx, bin_ctx, kv_k, kv_v, conv_ctx, offset, new, mask):
            fixed = tuple(t.clone() for t in (kv_k, kv_v, conv_ctx, offset))
            return frames(weights, fixed, raw_ctx, bin_ctx, new, mask, n_frames)
        return step

    state = (*(torch.zeros(shape, dtype=cdt, device=st.device) for shape in caches),
             torch.zeros((), dtype=torch.int64, device=st.device))
    return _write_stream(
        out_dir, st, names, leaves, state, prime, stepper(n_f),
        tail=stepper(1) if n_f > 1 else None, kind="conformer_stream",
        max_pos_len=cfg.max_pos_len,
        # the positional rows are computed from the offset: no length cap
        pe_unbounded=True, day_idx=day_idx, has_tail=n_f > 1,
        outputs="log_probs [B, F, K] (log-softmax)")


def _write_stream(out_dir, st, names, leaves, state, prime, step, *, tail=None,
                  **extra) -> str:
    """Write a streaming artifact at the streamer ``st``'s geometry: the
    ``prime``, ``step`` and (where given) ``tail`` programs, the weights and
    ``stream_meta.json`` (the keys both families share, then ``extra``).

    ``prime`` takes ``(weights, raw0 [B, W, C])``, the others ``(weights,
    raw_ctx, bin_ctx, *state, new [B, n, C])`` (``n`` the chunk's bins, the
    tail's ``stride``), each then a ``mask`` of its new bins for the
    Conformer (``kind`` ``"conformer_stream"``)."""
    dev, batch, c = st.device, st.batch, st.channels
    k, s, ks = st.kernel, st.stride, st.ks
    n = s * st.frames_per_chunk
    # W raw bins leave exactly k smoothed bins after the first F frames:
    # pad_l + W - (ks - 1) == k + n
    w_prime = k + n + (ks - 1) - st.pad_left
    masked = extra["kind"] == "conformer_stream"
    ctx = (torch.zeros((batch, ks - 1, c), dtype=st._raw_dtype, device=dev),
           torch.zeros((batch, k, c), dtype=st._bin_dtype, device=dev), *state)

    def inputs(bins, *before):
        f32 = dict(dtype=torch.float32, device=dev)
        mask = (torch.ones((bins,), **f32),) if masked else ()
        return (tuple(leaves), *before, torch.zeros((batch, bins, c), **f32), *mask)

    os.makedirs(out_dir, exist_ok=True)
    _export(out_dir, _STREAM_PRIME, prime, inputs(w_prime))
    _export(out_dir, _STREAM_STEP, step, inputs(n, *ctx))
    if tail is not None:
        _export(out_dir, _STREAM_TAIL, tail, inputs(s, *ctx))
    meta = {
        "batch": batch,
        "frames_per_chunk": st.frames_per_chunk,
        "chunk_bins": n,
        "prime_bins": w_prime,
        "kernel_len": k,
        "stride_len": s,
        "smooth_taps": ks,
        "n_channels": c,
        "n_classes": st.cfg.n_out,
        **extra,
        "n_leaves": len(leaves),
        "leaf_dtypes": _save_weights(out_dir, leaves),
        "leaf_names": names,
        **_meta(dev),
    }
    _write_json(out_dir, _STREAM_META, meta)
    return out_dir


# -- on-device n-best beam export --------------------------------------------


def export_beam(
    out_dir: str,
    *,
    batch: int,
    n_classes: int,
    beam_width: int = 8,
    top_k_tokens: int = 8,
    max_len: int = 512,
    device: torch.device | str = "cuda",
) -> str:
    """Export the on-device CTC prefix beam search
    (``decoding/ondevice_beam.py``) as three programs beside a streaming
    (or batch) artifact:

    - ``beam_init.pt2``: ``() -> state`` (one live empty prefix a stream);
    - ``beam_step.pt2``: ``(state..., logits [B, 1, K]) -> state``, one
      frame's update; ``log_softmax`` is applied inside (idempotent, so the
      GRU's raw logits and the Conformer's log-probs both feed it as they
      are);
    - ``beam_final.pt2``: ``state -> (prefixes [B, W, L], lens, scores)``
      best-first.

    ``state`` is the five tensors of ``BeamState``; carried across calls it
    is exactly chunk-boundary-invariant."""
    from ..decoding.ondevice_beam import BeamState, beam_extend, beam_finalize, beam_init

    dev = resolve_device(device, "serving")

    def init():
        return tuple(beam_init(batch, beam_width, max_len, device=dev))

    def step(prefixes, lens, last, p_b, p_nb, logits):
        log_probs = torch.log_softmax(logits.float(), dim=-1)
        return tuple(beam_extend(BeamState(prefixes, lens, last, p_b, p_nb), log_probs,
                                 top_k_tokens=top_k_tokens))

    def final(prefixes, lens, last, p_b, p_nb):
        return beam_finalize(BeamState(prefixes, lens, last, p_b, p_nb))

    os.makedirs(out_dir, exist_ok=True)
    state = init()
    _export(out_dir, _BEAM_INIT, init, ())
    _export(out_dir, _BEAM_STEP, step, (*state, torch.zeros((batch, 1, n_classes), device=dev)))
    _export(out_dir, _BEAM_FINAL, final, state)
    meta = {
        "batch": batch,
        "n_classes": n_classes,
        "beam_width": beam_width,
        "top_k_tokens": top_k_tokens,
        "max_len": max_len,
        **_meta(dev),
    }
    _write_json(out_dir, _BEAM_META, meta)
    return out_dir
