"""Conformer CTC encoder, the second model family.

Port of ``neural_speech_decoder_tpu/models/conformer.py``: per-day affine
-> frontend (9-tap Gaussian smooth, depthwise strided conv k=32/s=4,
projection, layer norm, dropout) -> bottleneck MLP -> SpecAugment (train)
-> sinusoidal positional encoding -> N Conformer blocks (half-step FFs,
multi-head self-attention with the key-padding mask, the conv module,
DropPath) -> deep head, with an InterCTC head at layer N/2 in training.

Parameters keep the JAX package's tree and layouts (``init_conformer_params``),
so weights move between the two as they are (``models/convert.py``).
Every linear layer is ``models/common.py::linear`` (float32 accumulation,
one rounding to the compute dtype); layer norms take their statistics in
float32; the head's log-softmax is float32.

The attention is the TPU kernel's (``ops/kernels/attention.py``, the
``MHSA`` autograd Function): its CUDA kernels on the card in float32 and
bfloat16, its plain version on the CPU or with ``plain=True``. A row whose
every key is masked gives 0 (the JAX package's einsum path, which it takes
off the TPU, gives a uniform row instead), and its dropout is drawn inside
the kernel. ``fused_ffn`` and ``fused_conv`` (off by default, as in the JAX
package) route the FF modules and the conv module through the fused
kernels (``ops/kernels/ffn.py``, ``ops/kernels/conv_module.py``), which
draw their dropout inside from one seed per module call; they run in
float32 and bfloat16 alike (JAX's gate takes them only for bfloat16 on a
TPU), and ``fused_conv`` refuses an even ``conv_kernel``, where JAX's gate
falls back to the unfused module.

Randomness in training (dropout seeds, DropPath, SpecAugment) is drawn from
one ``torch.Generator`` in a fixed order; the JAX package's ``jax.random``
streams cannot be reproduced, so parity tests set the rates to 0.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.day_affine import day_affine, init_day_affine
from ..ops.gaussian import conformer_kernel_size, gaussian_smooth
from ..ops.hashrng import draw_seed, hash_dropout
from ..ops.kernels.attention import mhsa
from ..ops.kernels.conv_module import fused_conv_module
from ..ops.kernels.ffn import fused_ffn
from ..ops.specaugment import spec_augment
from .common import linear, torch_linear_init, uniform_bound, xavier_uniform

Params = dict


@dataclasses.dataclass(frozen=True)
class ConformerConfig:
    n_channels: int = 256
    n_classes: int = 40  # excl. blank
    n_days: int = 24
    frontend_dim: int = 1024
    latent_dim: int = 1024
    autoencoder_hidden_dim: int = 512
    num_layers: int = 8
    num_heads: int = 8
    ff_dim: int = 2048
    dropout: float = 0.3
    temporal_kernel: int = 32
    temporal_stride: int = 4
    gaussian_smooth_width: float = 2.0
    conv_kernel: int = 31
    use_spec_augment: bool = True
    spec_augment_freq_mask: int = 100
    spec_augment_time_mask: int = 40
    drop_path_prob: float = 0.1
    head_dropout: float = 0.3
    max_pos_len: int = 5000
    # the attention kernel; False (the JAX package's einsum path) is not
    # ported
    fused_attention: bool = True
    # the JAX package's opt-in fused FF and conv-module kernels
    fused_ffn: bool = False
    fused_conv: bool = False
    # qkv columns per head, (head, {q,k,v}, dh), instead of ({q,k,v}, head, dh)
    qkv_interleaved: bool = False
    # banded attention (query i sees keys [i - attn_left_context, i]) and
    # causal depthwise convolutions
    causal: bool = False
    attn_left_context: int = 128
    dtype: torch.dtype = torch.float32  # parameter dtype
    compute_dtype: torch.dtype = torch.float32  # activation/matmul dtype

    @property
    def n_out(self) -> int:
        return self.n_classes + 1

    @property
    def use_interctc(self) -> bool:
        return self.num_layers >= 6

    @property
    def interctc_layer(self) -> int:
        return self.num_layers // 2


def check_config(cfg: ConformerConfig) -> None:
    """Raise for the JAX package's options the port does not have, and for
    a fused conv module with an even kernel (its 'same' padding (k//2,
    k-1-k//2) would differ from the unfused module's (k//2, k//2); JAX's
    gate leaves the kernel there, the port refuses)."""
    if cfg.fused_conv and cfg.conv_kernel % 2 == 0:
        raise ValueError(f"fused_conv needs an odd conv_kernel, got {cfg.conv_kernel}")
    if not cfg.fused_attention:
        raise NotImplementedError(
            "fused_attention=False: the port's attention is the kernel's; the "
            "JAX package's einsum path is not ported")
    if cfg.latent_dim % cfg.num_heads:
        raise ValueError(f"latent_dim {cfg.latent_dim} does not split into "
                         f"{cfg.num_heads} heads")


# ----------------------------------------------------------------- params


def _ln(dim, dtype, device):
    return {"scale": torch.ones(dim, dtype=dtype, device=device),
            "bias": torch.zeros(dim, dtype=dtype, device=device)}


def _lin(din, dout, gen, dtype):
    w, b = torch_linear_init(din, dout, gen, dtype)
    return {"w": w, "b": b}


def _block_params(cfg: ConformerConfig, gen: torch.Generator) -> Params:
    d, dt, dev = cfg.latent_dim, cfg.dtype, gen.device

    def ff():
        return {"ln": _ln(d, dt, dev), "lin1": _lin(d, cfg.ff_dim, gen, dt),
                "lin2": _lin(cfg.ff_dim, d, gen, dt)}

    ff1 = ff()
    attn = {
        "ln": _ln(d, dt, dev),
        # torch MHA: xavier in_proj, zero in_proj and out_proj biases
        "in_proj_w": xavier_uniform((d, 3 * d), gen, dt),
        "in_proj_b": torch.zeros(3 * d, dtype=dt, device=dev),
        "out": {"w": torch_linear_init(d, d, gen, dt)[0],
                "b": torch.zeros(d, dtype=dt, device=dev)},
    }
    bound = 1.0 / math.sqrt(cfg.conv_kernel)  # torch depthwise Conv1d init
    conv = {
        "ln": _ln(d, dt, dev),
        "pw1": _lin(d, 2 * d, gen, dt),
        "dw_w": uniform_bound((cfg.conv_kernel, d), bound, gen, dt),
        "dw_b": uniform_bound((d,), bound, gen, dt),
        "ln_conv": _ln(d, dt, dev),
        "pw2": _lin(d, d, gen, dt),
    }
    return {"ff1": ff1, "attn": attn, "conv": conv, "ff2": ff(),
            "ln_final": _ln(d, dt, dev)}


def init_conformer_params(cfg: ConformerConfig, generator: torch.Generator) -> Params:
    """The parameter tree of ``init_conformer_params`` (same keys, shapes and
    distributions), drawn on the generator's device."""
    c, f, d, dt = cfg.n_channels, cfg.frontend_dim, cfg.latent_dim, cfg.dtype
    dev = generator.device
    params = {
        "day": init_day_affine(cfg.n_days, c, dt, dev),
        "frontend": {
            # depthwise strided conv, constant 1/k, no bias
            "tconv_w": torch.full((cfg.temporal_kernel, c),
                                  1.0 / cfg.temporal_kernel, dtype=dt, device=dev),
            "proj": _lin(c, f, generator, dt),
            "ln": _ln(f, dt, dev),
        },
        "bottleneck": {
            "lin1": _lin(f, cfg.autoencoder_hidden_dim, generator, dt),
            "lin2": _lin(cfg.autoencoder_hidden_dim, d, generator, dt),
        },
        "blocks": [_block_params(cfg, generator) for _ in range(cfg.num_layers)],
        "head": {
            "lin1": _lin(d, d, generator, dt),
            "ln": _ln(d, dt, dev),
            "lin2": _lin(d, cfg.n_out, generator, dt),
        },
    }
    if cfg.use_interctc:
        params["inter_out"] = _lin(d, cfg.n_out, generator, dt)
    return params


# ----------------------------------------------------------------- layers


def sinusoidal_pos_encoding(max_len: int, d_model: int) -> np.ndarray:
    """The sinusoidal table ``[max_len, d_model]`` (float32), computed as
    the JAX package computes it."""
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(
        np.arange(0, d_model, 2, dtype=np.float32) * (-math.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div[: d_model // 2])
    return pe


def _cached_unless_exporting(fn):
    """``fn`` behind an ``lru_cache``, except under ``torch.export``: there
    the table is made afresh and becomes the exported program's lifted
    constant, so that the cache never holds a traced tensor."""
    cached = functools.lru_cache(maxsize=16)(fn)

    @functools.wraps(fn)
    def wrapper(*args):
        return fn(*args) if torch.compiler.is_exporting() else cached(*args)

    return wrapper


@_cached_unless_exporting
def _pos_div(d_model: int, device: torch.device) -> torch.Tensor:
    """The encoding's frequencies, computed once a (width, device) as the
    JAX package computes them, so that no call copies them from the host."""
    return torch.from_numpy(np.exp(
        np.arange(0, d_model, 2, dtype=np.float32) * (-math.log(10000.0) / d_model)
    )).to(device)


def sinusoidal_pos_rows(offset, n: int, d_model: int,
                        dtype=torch.float32, device=None) -> torch.Tensor:
    """Rows ``[offset, offset + n)`` of the sinusoidal encoding computed on
    the fly (no length cap), in float32 then cast to ``dtype``. ``offset``
    is an int or a 0-dim tensor (then the rows are made on its device with
    no host copy, so a CUDA graph may capture the call)."""
    if isinstance(offset, torch.Tensor):
        device = offset.device
        base = offset.to(torch.float32)
    else:
        base = float(offset)
    device = torch.device("cpu" if device is None else device)
    if device.type == "cuda" and device.index is None:  # one cache key a card
        device = torch.device("cuda", torch.cuda.current_device())
    div = _pos_div(d_model, device)
    pos = (base + torch.arange(n, dtype=torch.float32, device=device))[:, None]
    pe = torch.zeros((n, d_model), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div[: d_model // 2])
    return pe.to(dtype)


@_cached_unless_exporting
def _pos_table(t: int, d_model: int, dtype: torch.dtype, device: str) -> torch.Tensor:
    """The first t rows of the sinusoidal table on ``device``."""
    return torch.from_numpy(sinusoidal_pos_encoding(t, d_model)).to(device, dtype)


def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Layer norm with float32 statistics, cast back to x's dtype."""
    out = F.layer_norm(x.float(), (x.shape[-1],), p["scale"].float(),
                       p["bias"].float(), eps)
    return out.to(x.dtype)


def _lin_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    return linear(x, p["w"], p["b"])


def _dropout(rng: "_Draws", x: torch.Tensor, rate: float) -> torch.Tensor:
    return hash_dropout(rng.seed(), x, rate) if rng.train and rate > 0 else x


def _drop_path(rng: "_Draws", x: torch.Tensor, prob: float) -> torch.Tensor:
    """Per-sample stochastic depth: a row kept with probability 1 - prob and
    scaled by 1/(1 - prob), else 0."""
    if not rng.train or prob <= 0:
        return x
    keep = torch.rand((x.shape[0],) + (1,) * (x.dim() - 1),
                      generator=rng.generator, device=x.device) < 1.0 - prob
    return torch.where(keep, x / (1.0 - prob), torch.zeros((), dtype=x.dtype,
                                                            device=x.device))


class _Draws:
    """The random draws of one forward, in call order from one generator;
    none in eval."""

    def __init__(self, generator: torch.Generator | None, train: bool):
        if train and generator is None:
            raise ValueError("conformer_forward: train=True needs a generator")
        self.generator, self.train = generator, train

    def seed(self) -> torch.Tensor:
        return draw_seed(self.generator)


def _module_seed(rng, rate, device):
    """One dropout seed for a kernel (attention, fused FF or conv module),
    drawn only when it drops."""
    if rng.train and rate > 0:
        return rng.seed()
    return torch.zeros(1, dtype=torch.int32, device=device)


def _ff_module(p, x, rng, rate, cfg, plain):
    """LN -> Linear(D->F) -> SiLU -> dropout -> Linear(F->D) -> dropout."""
    if cfg.fused_ffn:
        r = rate if rng.train else 0.0
        return fused_ffn(x, p["ln"]["scale"], p["ln"]["bias"], p["lin1"]["w"],
                         p["lin1"]["b"], p["lin2"]["w"], p["lin2"]["b"],
                         _module_seed(rng, r, x.device), rate=r, plain=plain)
    h = F.silu(_lin_apply(p["lin1"], layer_norm(p["ln"], x)))
    h = _dropout(rng, h, rate)
    return _dropout(rng, _lin_apply(p["lin2"], h), rate)


def _attention(p, cfg, x, lens, rng, plain):
    qkv = linear(layer_norm(p["ln"], x), p["in_proj_w"], p["in_proj_b"])
    rate = cfg.dropout if rng.train else 0.0
    seed = _module_seed(rng, rate, x.device)
    out = mhsa(qkv, lens, seed, num_heads=cfg.num_heads, rate=rate,
               left_context=cfg.attn_left_context if cfg.causal else None,
               interleaved=cfg.qkv_interleaved, plain=plain)
    return _lin_apply(p["out"], out)


def _conv_module(p, x, rng, rate, causal, cfg, plain):
    """LN -> pointwise 2x -> GLU -> depthwise conv ('same', or causal
    (k-1, 0)) with a float32 bias -> LN -> SiLU -> pointwise -> dropout,
    plus the residual."""
    if cfg.fused_conv:
        r = rate if rng.train else 0.0
        return x + fused_conv_module(
            x, p["ln"]["scale"], p["ln"]["bias"], p["pw1"]["w"], p["pw1"]["b"],
            p["dw_w"], p["dw_b"], p["ln_conv"]["scale"], p["ln_conv"]["bias"],
            p["pw2"]["w"], p["pw2"]["b"], _module_seed(rng, r, x.device), rate=r,
            causal=causal, plain=plain)
    h = _lin_apply(p["pw1"], layer_norm(p["ln"], x))  # [B, T, 2D]
    a, g = h.chunk(2, dim=-1)
    h = a * torch.sigmoid(g)
    kw, d = p["dw_w"].shape
    pad = (kw - 1, 0) if causal else (kw // 2, kw // 2)
    w = p["dw_w"].T.to(h.dtype)[:, None, :]  # [D, 1, k]
    h = F.conv1d(F.pad(h.transpose(1, 2), pad), w, groups=d).transpose(1, 2)
    h = (h.float() + p["dw_b"].float()).to(a.dtype)
    h = F.silu(layer_norm(p["ln_conv"], h))
    h = _dropout(rng, _lin_apply(p["pw2"], h), rate)
    return x + h


def _block(p, cfg, x, lens, rng, plain):
    ff = _ff_module(p["ff1"], x, rng, cfg.dropout, cfg, plain)
    x = x + _drop_path(rng, 0.5 * ff, cfg.drop_path_prob)
    attn = _dropout(rng, _attention(p["attn"], cfg, x, lens, rng, plain), cfg.dropout)
    x = x + _drop_path(rng, attn, cfg.drop_path_prob)
    x = _conv_module(p["conv"], x, rng, cfg.dropout, cfg.causal, cfg, plain)
    ff = _ff_module(p["ff2"], x, rng, cfg.dropout, cfg, plain)
    x = x + _drop_path(rng, 0.5 * ff, cfg.drop_path_prob)
    return layer_norm(p["ln_final"], x)


def conformer_frontend(params, cfg, x, rng):
    """Gaussian smooth -> depthwise strided conv -> projection, layer norm,
    dropout."""
    if cfg.gaussian_smooth_width > 0:
        ks = conformer_kernel_size(cfg.gaussian_smooth_width)
        x = gaussian_smooth(x, ks, cfg.gaussian_smooth_width,
                            padding=(ks // 2, ks // 2))
    if cfg.temporal_kernel > 0:
        w = params["frontend"]["tconv_w"].T.to(x.dtype)[:, None, :]  # [C, 1, k]
        x = F.conv1d(x.transpose(1, 2), w, stride=cfg.temporal_stride,
                     groups=x.shape[-1]).transpose(1, 2)
    x = _lin_apply(params["frontend"]["proj"], x)
    x = layer_norm(params["frontend"]["ln"], x)
    return _dropout(rng, x, cfg.dropout)


def conformer_output_lengths(cfg: ConformerConfig, x_lens: torch.Tensor,
                             actual_len: int) -> torch.Tensor:
    """``(len - k) / s`` truncated toward zero, clamped to ``[0, actual_len]``,
    int32."""
    x_lens = x_lens.to(torch.int32)
    if cfg.temporal_kernel > 0 and cfg.temporal_stride > 1:
        out = torch.div(x_lens - cfg.temporal_kernel, cfg.temporal_stride,
                        rounding_mode="trunc")
    else:
        out = x_lens
    return out.clamp(0, actual_len).to(torch.int32)


def conformer_forward(
    params: Params,
    cfg: ConformerConfig,
    x: torch.Tensor,
    day_idx: torch.Tensor,
    x_lens: torch.Tensor | None = None,
    *,
    train: bool = False,
    generator: torch.Generator | None = None,
    plain: bool = False,
):
    """``[B, T, C]`` features -> ``(log_probs [B, T', n_out] float32,
    out_lens [B] int32, inter_log_probs or None)``; the InterCTC head's
    log-probs only in training. ``train`` draws dropout, DropPath and
    SpecAugment from ``generator``; ``plain`` runs the kernels' plain
    versions."""
    check_config(cfg)
    rng = _Draws(generator, train)
    x = day_affine(params["day"], x.to(cfg.compute_dtype), day_idx)
    z = conformer_frontend(params, cfg, x, rng)
    bott = params["bottleneck"]
    z = _lin_apply(bott["lin2"], F.relu(_lin_apply(bott["lin1"], z)))
    if cfg.use_spec_augment and train:
        z = spec_augment(z, freq_mask_param=cfg.spec_augment_freq_mask,
                         time_mask_param=cfg.spec_augment_time_mask,
                         generator=generator)
    t = z.shape[1]
    if t > cfg.max_pos_len:
        raise ValueError(f"{t} frames exceed max_pos_len {cfg.max_pos_len}")
    z = z + _pos_table(t, cfg.latent_dim, z.dtype, str(z.device))
    if x_lens is not None:
        out_lens = conformer_output_lengths(cfg, x_lens.to(z.device), t)
    else:
        out_lens = torch.full((x.shape[0],), t, dtype=torch.int32, device=z.device)

    inter_log_probs = None
    for i, bp in enumerate(params["blocks"]):
        z = _block(bp, cfg, z, out_lens, rng, plain)
        if cfg.use_interctc and train and i == cfg.interctc_layer - 1:
            inter = _lin_apply(params["inter_out"], z).float()
            inter_log_probs = torch.log_softmax(inter, dim=-1)

    h = _lin_apply(params["head"]["lin1"], z)
    h = F.gelu(layer_norm(params["head"]["ln"], h), approximate="none")
    h = _dropout(rng, h, cfg.head_dropout)
    logits = _lin_apply(params["head"]["lin2"], h).float()
    return torch.log_softmax(logits, dim=-1), out_lens, inter_log_probs


# ----------------------------------------------------------------- module


def _flatten(tree, path=()):
    if isinstance(tree, dict):
        return [kv for k in tree for kv in _flatten(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _flatten(v, path + (str(i),))]
    return [(path, tree)]


def _unflatten(items):
    tree: dict = {}
    for path, leaf in items:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(tree)


class ConformerDecoder(nn.Module):
    """The Conformer as an ``nn.Module`` holding ``init_conformer_params``'
    tree as trainable parameters (registered under their '/'-joined paths):
    ``module.params`` is that tree of its own parameters, and
    ``module(x, day_idx, x_lens, ...)`` is ``conformer_forward``."""

    def __init__(self, cfg: ConformerConfig, params: Params):
        super().__init__()
        check_config(cfg)
        self.cfg = cfg
        self._paths = []
        for path, leaf in _flatten(params):
            self._paths.append(path)
            self.register_parameter("/".join(path), nn.Parameter(leaf))

    @property
    def params(self) -> Params:
        return _unflatten((p, self.get_parameter("/".join(p))) for p in self._paths)

    @torch.no_grad()
    def load_params(self, params: Params) -> None:
        """Copy a tree of ``init_conformer_params``' layout into this
        module's parameters (on their device and dtype)."""
        theirs = dict(_flatten(params))
        if set(theirs) != set(self._paths):
            raise ValueError("load_params: the tree's leaves differ from the model's")
        for path in self._paths:
            mine = self.get_parameter("/".join(path))
            if mine.shape != theirs[path].shape:
                raise ValueError(f"load_params: {tuple(theirs[path].shape)} for "
                                 f"{'/'.join(path)} of shape {tuple(mine.shape)}")
            mine.copy_(theirs[path])

    def forward(self, x, day_idx, x_lens=None, *, train=False, generator=None,
                plain=False):
        return conformer_forward(self.params, self.cfg, x, day_idx, x_lens,
                                 train=train, generator=generator, plain=plain)
