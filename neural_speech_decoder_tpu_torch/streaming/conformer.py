"""Chunked streaming decode of the causal Conformer.

Port of ``neural_speech_decoder_tpu/streaming/conformer.py``.
``ConformerConfig(causal=True)`` (banded self-attention with a finite left
context, causal depthwise convs) runs its offline forward incrementally,
chunk-boundary-invariantly:

- the day affine comes first, then the smoothing, so raw bins are held in
  the affined domain and the smoother's edge padding is zeros there (zeros
  before the affine would smooth in the day bias);
- raw bins buffer until each smoothed bin's ``int(4 sigma) + 1`` taps have
  arrived; the strided frontend conv carries its ``k - s`` bin overlap;
- every block carries a K/V cache of exactly ``attn_left_context`` frames
  (the band's width) and the ``conv_kernel - 1`` GLU frames its causal
  depthwise conv needs;
- positional-encoding rows are computed from the frame offset, with no
  length cap (``models/conformer.py::sinusoidal_pos_rows``);
- one frame is held back, so a flushed stream emits ``(T - k) // s``
  frames.

The frame offset lives in a device tensor that the step reads for the
positional rows and the band mask and advances itself, so a steady chunk
captured as a CUDA graph (``engine.FastPath``) stays right on every replay;
the host keeps a mirror (``emitted``). Weights are cast to the compute
dtype once, at construction. The attention is a plain product over cache +
new keys, as JAX's streamer computes it (no Pallas kernel, and so no hand
kernel, lies on this path); its products are ``torch.mm``/``torch.bmm``
with float32 accumulation.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..models.common import _mm_f32
from ..models.conformer import ConformerConfig, _flatten, layer_norm, sinusoidal_pos_rows
from ..ops.gaussian import conformer_kernel_size, gaussian_kernel
from ..utils.device import resolve_device
from .engine import Streamer


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [N, M, K] @ b [N, K, P]`` in their dtype with a float32 result
    (float32 accumulation)."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _lin(p: dict, x: torch.Tensor) -> torch.Tensor:
    """JAX's ``_linear``: the product in x's dtype accumulated in float32,
    the float32 bias added, one rounding to x's dtype."""
    y = _mm_f32(x.reshape(-1, x.shape[-1]), p["w"]) + p["b"]
    return y.to(x.dtype).view(*x.shape[:-1], -1)


class ConformerStreamer(Streamer):
    """Chunked streaming decoder for the causal Conformer.

    Args:
      params: the port's Conformer parameter tree (``init_conformer_params``).
      cfg: model config; ``causal`` must be True, ``qkv_interleaved`` False.
      day_idx: recording-day index of the session being streamed.
      batch: number of parallel streams.
      frames_per_chunk: frames a steady chunk emits (``temporal_stride *
        frames_per_chunk`` bins).
      device, graphs: as ``GRUStreamer``'s.

    ``process`` returns float32 log-probabilities ``[B, m, n_classes + 1]``.
    """

    _emits_logits = False

    def __init__(self, params, cfg: ConformerConfig, day_idx: int, *, batch: int = 1,
                 frames_per_chunk: int = 1, device: torch.device | str = "cuda",
                 graphs: bool = True):
        if not cfg.causal:
            raise ValueError("streaming requires ConformerConfig(causal=True): full "
                             "self-attention depends on future frames")
        if cfg.qkv_interleaved:
            raise ValueError("streaming uses the canonical qkv layout")
        ks = (conformer_kernel_size(cfg.gaussian_smooth_width)
              if cfg.gaussian_smooth_width > 0 else 1)
        if ks % 2 == 0:
            # the offline frontend pads (ks//2, ks//2) = ks in all for an
            # even kernel and emits T + 1 smoothed bins, which a streamer
            # emitting one bin a bin cannot reproduce
            raise ValueError(
                f"gaussian_smooth_width={cfg.gaussian_smooth_width} gives an even "
                f"smoothing kernel ({ks} taps), whose offline padding emits T+1 bins: "
                "unsupported for streaming; pick a width with odd int(4*width)+1")
        self.cfg = cfg
        self.device = dev = resolve_device(device, "streaming")
        self.kernel, self.stride = cfg.temporal_kernel, cfg.temporal_stride
        self.channels = c = cfg.n_channels
        self.ks = ks
        self.pad_left, self.lookahead = ks // 2, ks - 1 - ks // 2
        cdt = self._raw_dtype = self._bin_dtype = cfg.compute_dtype
        taps = (gaussian_kernel(ks, cfg.gaussian_smooth_width) if ks > 1
                else np.ones((1,), np.float32))
        self._taps = torch.from_numpy(taps).to(dev, cdt).expand(c, 1, ks).contiguous()

        def cast(t, dtype):
            return t.detach().to(dev, dtype).contiguous()

        def lin(p):
            return {"w": cast(p["w"], cdt), "b": cast(p["b"], torch.float32)}

        def ln(p):
            return {k: cast(v, torch.float32) for k, v in p.items()}

        def block(bp):
            a, cv = bp["attn"], bp["conv"]
            return {
                "ff1": {"ln": ln(bp["ff1"]["ln"]), "lin1": lin(bp["ff1"]["lin1"]),
                        "lin2": lin(bp["ff1"]["lin2"])},
                "ff2": {"ln": ln(bp["ff2"]["ln"]), "lin1": lin(bp["ff2"]["lin1"]),
                        "lin2": lin(bp["ff2"]["lin2"])},
                "attn": {"ln": ln(a["ln"]),
                         "in": lin({"w": a["in_proj_w"], "b": a["in_proj_b"]}),
                         "out": lin(a["out"])},
                "conv": {"ln": ln(cv["ln"]), "pw1": lin(cv["pw1"]),
                         "dw_w": cast(cv["dw_w"].T[:, None, :], cdt),
                         "dw_b": cast(cv["dw_b"], torch.float32),
                         "ln_conv": ln(cv["ln_conv"]), "pw2": lin(cv["pw2"])},
                "ln_final": ln(bp["ln_final"]),
            }

        self._p = {
            "day_w": cast(params["day"]["weight"][day_idx], cdt),
            "day_b": cast(params["day"]["bias"][day_idx], torch.float32),
            "tconv_w": cast(params["frontend"]["tconv_w"].T[:, None, :], cdt),
            "proj": lin(params["frontend"]["proj"]),
            "front_ln": ln(params["frontend"]["ln"]),
            "bott1": lin(params["bottleneck"]["lin1"]),
            "bott2": lin(params["bottleneck"]["lin2"]),
            "blocks": [block(bp) for bp in params["blocks"]],
            "head1": lin(params["head"]["lin1"]),
            "head_ln": ln(params["head"]["ln"]),
            "head2": lin(params["head"]["lin2"]),
        }
        nl, nh, d = cfg.num_layers, cfg.num_heads, cfg.latent_dim
        lc, kc = cfg.attn_left_context, cfg.conv_kernel
        # lc is both the K/V caches' width and the band's horizon: the
        # cached keys cover exactly the attendable band
        self._caches = (
            torch.zeros((nl, batch, nh, lc, d // nh), dtype=cdt, device=dev),  # K
            torch.zeros((nl, batch, nh, lc, d // nh), dtype=cdt, device=dev),  # V
            torch.zeros((nl, batch, kc - 1, d), dtype=cdt, device=dev),  # conv GLU context
        )
        self._offset = torch.zeros((), dtype=torch.int64, device=dev)  # frames emitted
        sinusoidal_pos_rows(self._offset, 1, d, cdt)  # caches its table before any capture
        self._setup(batch, frames_per_chunk, graphs, (*self._caches, self._offset))

    def weights(self) -> list[torch.Tensor]:
        """The tensors a chunk reads besides its input and state."""
        return [self._taps, *(t for _, t in _flatten(self._p))]

    def weight_tree(self) -> dict:
        """The weights the bodies read, as cast at construction, as a tree
        (the taps aside)."""
        return self._p

    def _set_weights(self, tree: dict) -> None:
        self._p = tree

    def _set_fixed(self, fixed) -> None:
        *caches, self._offset = fixed
        self._caches = tuple(caches)

    def _admit(self, new: torch.Tensor) -> torch.Tensor:
        """Raw bins -> the day-affined domain, in the compute dtype."""
        x = new.to(self.cfg.compute_dtype)
        return _lin({"w": self._p["day_w"], "b": self._p["day_b"]}, x)

    def _smooth(self, window: torch.Tensor) -> torch.Tensor:
        """An affined VALID window ``[B, n + ks - 1, C]`` -> ``[B, n, C]``."""
        return F.conv1d(window.transpose(1, 2), self._taps,
                        groups=self.channels).transpose(1, 2)

    def _ff(self, p, z):
        return _lin(p["lin2"], F.silu(_lin(p["lin1"], layer_norm(p["ln"], z))))

    def _emit(self, bins: torch.Tensor) -> torch.Tensor:
        """``bins [B, k + (n - 1) s, C]`` covering n frames -> float32
        log-probs ``[B, n, K]``; caches and offset advanced in place."""
        cfg, p = self.cfg, self._p
        nh, d = cfg.num_heads, cfg.latent_dim
        dh, lc, kc = d // nh, cfg.attn_left_context, cfg.conv_kernel
        b = bins.shape[0]
        n_f = (bins.shape[1] - self.kernel) // self.stride + 1
        # frontend: depthwise strided conv (VALID) -> projection -> LN
        z = F.conv1d(bins.transpose(1, 2), p["tconv_w"], stride=self.stride,
                     groups=self.channels).transpose(1, 2)
        z = layer_norm(p["front_ln"], _lin(p["proj"], z))
        z = _lin(p["bott2"], F.relu(_lin(p["bott1"], z)))
        offset = self._offset
        z = z + sinusoidal_pos_rows(offset, n_f, d, z.dtype)[None]
        qpos = offset + torch.arange(n_f, device=z.device)[:, None]
        kpos = offset - lc + torch.arange(lc + n_f, device=z.device)[None, :]
        ok = (kpos >= 0) & (kpos <= qpos) & (qpos - kpos <= lc)
        kv_k, kv_v, conv_ctx = self._caches

        def heads(a):  # [B, n, D] -> [B, nh, n, dh]
            return a.reshape(b, n_f, nh, dh).transpose(1, 2)

        for li, bp in enumerate(p["blocks"]):
            z = z + 0.5 * self._ff(bp["ff1"], z)
            # banded attention over the cached and the new keys
            q, kn, vn = _lin(bp["attn"]["in"], layer_norm(bp["attn"]["ln"], z)).split(d, dim=-1)
            keys = torch.cat([kv_k[li], heads(kn)], dim=2)  # [B, nh, lc + n, dh]
            vals = torch.cat([kv_v[li], heads(vn)], dim=2)
            scores = _bmm_f32(heads(q).flatten(0, 1), keys.flatten(0, 1).transpose(1, 2))
            scores = scores.view(b, nh, n_f, lc + n_f) / math.sqrt(dh)
            probs = torch.softmax(torch.where(ok, scores, -1e9), dim=-1).to(z.dtype)
            att = _bmm_f32(probs.flatten(0, 1), vals.flatten(0, 1)).to(z.dtype)
            att = att.view(b, nh, n_f, dh).transpose(1, 2).reshape(b, n_f, d)
            z = z + _lin(bp["attn"]["out"], att)
            # positive-index slices: -lc: would keep the whole buffer when
            # lc == 0 and grow the cache every chunk
            kv_k[li].copy_(keys[:, :, keys.shape[2] - lc:])
            kv_v[li].copy_(vals[:, :, vals.shape[2] - lc:])
            # the causal conv module with its carried GLU context
            cv = bp["conv"]
            a_h, g = _lin(cv["pw1"], layer_norm(cv["ln"], z)).chunk(2, dim=-1)
            full = torch.cat([conv_ctx[li], a_h * torch.sigmoid(g)], dim=1)
            hc = F.conv1d(full.transpose(1, 2), cv["dw_w"], groups=d).transpose(1, 2)
            hc = (hc.float() + cv["dw_b"]).to(z.dtype)
            z = z + _lin(cv["pw2"], F.silu(layer_norm(cv["ln_conv"], hc)))
            conv_ctx[li].copy_(full[:, full.shape[1] - (kc - 1):])
            z = z + 0.5 * self._ff(bp["ff2"], z)
            z = layer_norm(bp["ln_final"], z)
        offset.add_(n_f)
        h = F.gelu(layer_norm(p["head_ln"], _lin(p["head1"], z)), approximate="none")
        logits = _lin(p["head2"], h).float()
        return torch.log_softmax(logits, dim=-1)
