"""Stacked (bi)GRU CTC decoder: the serving forward and the train forward.

Port of ``neural_speech_decoder_tpu/models/gru.py``: Gaussian smoothing
(20 taps, torch-"same" padding) -> per-day affine -> Softsign -> temporal
unfold (k=32, s=4) fused into layer 0's input projection -> stacked
(bi)GRU -> linear head to ``n_classes + 1`` CTC logits.

Parameters keep the JAX package's layout (``init_gru_params``), so weights
move between the two as they are (``models/convert.py``): per layer
``w_ih [D, in, 3H]``, ``w_hh [D, H, 3H]``, ``b_ih``/``b_hh [D, 3H]``, gate
order r, z, n.

On the serving path (``train=False``) the frontend (when ``sigma > 0``) and
each layer's time scan run the hand-written kernels of ``ops/kernels``,
through their operators (``torch.ops.nsd_torch.fused_frontend`` and
``gru_sequence``, ``ops/kernels/library.py``), so that ``torch.export``
can trace the eval forward (``serving/export.py``).
Training (``train=True``) runs the unfused frontend chain under autograd,
as the JAX package does, each scan through the ``GRUScan`` autograd
Function (gates-storing forward and backward kernels), and inter-layer
dropout. Layer 0's projection is a strided convolution (cuDNN), layers 1+
and the head are cuBLAS products, as the JAX package leaves them to XLA.
With ``use_pallas_matmul`` (off by default, as in the JAX package) layers
1+ take their projection, forward and backward, through the hand-written
product of ``ops/kernels/matmul.py`` (``projection_matmul``) where K and N
are multiples of 128; elsewhere they warn once and keep ``linear``, as the
JAX package's call site does.
``plain=True`` runs the kernels' plain PyTorch versions instead, as the
reference a card run is checked against. ``use_pallas=False`` in the config
(the run's ``use_pallas: false``) runs the plain versions of the time scan
and the serving frontend only, as the JAX package's ``use_pallas`` does.

Precision in bfloat16 compute: the head multiplies the bf16 encoder states
and weights with float32 accumulation and output, as the JAX package does
(``preferred_element_type=float32``). Layers 1+ take their projection
through ``models/common.py::linear``: float32 accumulation, the float32
bias, one rounding to bf16, as JAX. Layer 0's strided convolution rounds
its bf16 output before the float32 bias and after it, as JAX's does.

Under tensor parallelism (``tp``, a ``ModelShard``: the rank holds the
shards of ``parallel/shardings.py``) each layer's input projection is
row-parallel on its contraction rows (layer 0: the rank's channels through
the strided convolution; layers 1+: ``linear`` or the hand-written product
on the rank's rows), the partial sums all-reduced in float32 before the
bias; the head is row-parallel on ``H*D``. The recurrence is not split:
JAX's GSPMD sums ``h @ W_hh`` over the model axis every time step (its
Pallas scan gives way to ``lax.scan`` under a model axis), while the port
gathers ``W_hh`` once a layer and runs the hand-written scan whole on every
model rank, each rank keeping its rows of the kernel's whole ``dW_hh``
(a deliberate difference: one gather a layer instead of a sum a step).
"""

from __future__ import annotations

import dataclasses
import math
import warnings

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.day_affine import day_affine, init_day_affine
from ..ops.gaussian import gaussian_smooth
from ..ops.kernels.frontend import fused_frontend_plain
from ..ops.kernels.gru_scan import gru_cell, gru_scan
from ..ops.kernels.library import fused_frontend
from ..ops.kernels.matmul import projection_kernel_viable, projection_matmul
from ..ops.rows import BatchShard, draw_rows
from ..ops.unfold import unfold_matmul, unfold_output_length
from ..parallel.tensor_parallel import (
    ModelShard,
    gather_from_model,
    reduce_from_model,
    scatter_to_model,
)
from .common import (
    linear,
    orthogonal,
    partial_linear,
    torch_linear_init,
    uniform_bound,
    xavier_uniform,
)

Params = dict

_warned_matmul_fallback = False


@dataclasses.dataclass(frozen=True)
class GRUConfig:
    neural_dim: int = 256
    n_classes: int = 40  # excl. blank; the head outputs n_classes + 1
    hidden_dim: int = 1024
    num_layers: int = 5
    n_days: int = 24
    dropout: float = 0.4  # between layers, training only
    stride_len: int = 4
    kernel_len: int = 32
    gaussian_smooth_width: float = 2.0
    gaussian_kernel_size: int = 20
    bidirectional: bool = True
    dtype: torch.dtype = torch.float32  # parameter dtype
    compute_dtype: torch.dtype = torch.float32  # activation/matmul dtype
    # layers 1+ project through the hand-written product (forward, dX, dW)
    use_pallas_matmul: bool = False
    # False: the time scan and the serving frontend run their plain PyTorch
    # versions (the JAX package's lax.scan twin and unfused chain); None and
    # True keep the kernels. The other kernels are not affected.
    use_pallas: bool | None = None

    @property
    def num_dirs(self) -> int:
        return 2 if self.bidirectional else 1

    @property
    def input_dim(self) -> int:
        return self.neural_dim * self.kernel_len

    @property
    def n_out(self) -> int:
        return self.n_classes + 1


def init_gru_params(cfg: GRUConfig, generator: torch.Generator) -> Params:
    """The full parameter tree, drawn on the generator's device:
    xavier-uniform ``w_ih``, orthogonal ``w_hh`` (orthogonalized as torch's
    ``[3H, H]`` and stored transposed), ``U(-1/sqrt(H), 1/sqrt(H))`` GRU
    biases, torch ``nn.Linear`` init for the head, identity day affines."""
    h = cfg.hidden_dim
    d = cfg.num_dirs
    bound = 1.0 / math.sqrt(h)
    layers = []
    for li in range(cfg.num_layers):
        in_dim = cfg.input_dim if li == 0 else h * d
        w_ih, w_hh, b_ih, b_hh = [], [], [], []
        for _ in range(d):
            w_ih.append(xavier_uniform((in_dim, 3 * h), generator, cfg.dtype))
            w_hh.append(orthogonal((3 * h, h), generator).T.to(cfg.dtype))
            b_ih.append(uniform_bound((3 * h,), bound, generator, cfg.dtype))
            b_hh.append(uniform_bound((3 * h,), bound, generator, cfg.dtype))
        layers.append({
            "w_ih": torch.stack(w_ih),
            "w_hh": torch.stack(w_hh).contiguous(),
            "b_ih": torch.stack(b_ih),
            "b_hh": torch.stack(b_hh),
        })
    fc_w, fc_b = torch_linear_init(h * d, cfg.n_out, generator, cfg.dtype)
    return {
        "day": init_day_affine(
            cfg.n_days, cfg.neural_dim, cfg.dtype, generator.device
        ),
        "gru": {"layers": layers},
        "fc": {"weight": fc_w, "bias": fc_b},
    }


def gru_layer(
    xp: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor, h0: torch.Tensor
) -> torch.Tensor:
    """One (bi)GRU layer stepped in plain PyTorch, as the JAX package's
    ``_gru_layer`` forward: ``xp [L, D, B, 3H]`` with direction 1 already
    time-flipped, ``h0 [D, B, H]`` -> ``[L, D, B, H]`` (direction 1 still
    flipped). The carry is rounded to xp's dtype after every step."""
    h = h0
    ys = []
    for t in range(xp.shape[0]):
        h = gru_cell(xp[t], h, w_hh, b_hh).to(xp.dtype)
        ys.append(h)
    return torch.stack(ys)


def gru_encode(
    params: Params,
    cfg: GRUConfig,
    x: torch.Tensor,
    *,
    train: bool = False,
    generator: torch.Generator | None = None,
    plain: bool = False,
    shard: BatchShard | None = None,
    tp: ModelShard | None = None,
) -> torch.Tensor:
    """The stacked GRU over frontend output ``x [B, T, C]`` ->
    ``[B, L, H*D]`` with ``L = (T - k) // s + 1``. With ``train`` and
    ``cfg.dropout > 0``, every layer's output but the last's is dropped at
    rate p and scaled by 1/(1-p), drawn from ``generator`` (for the global
    batch with a ``shard``, ``ops/rows.py``). With ``tp`` the layers' weights
    are this model rank's shards (``_encode_layer_tp``)."""
    b = x.shape[0]
    h = cfg.hidden_dim
    d = cfg.num_dirs
    cdt = cfg.compute_dtype
    p = cfg.dropout if train else 0.0
    if p > 0 and generator is None:
        raise ValueError("gru_encode: training with dropout needs a generator")
    out = x.to(cdt)
    for li, lp in enumerate(params["gru"]["layers"]):
        # all directions' projections as one product: directions
        # concatenated on the output axis
        w_cat = torch.cat([lp["w_ih"][i] for i in range(d)], dim=-1).to(cdt)
        w_hh = lp["w_hh"]
        if tp is not None:
            xp = _project_tp(cfg, li, out, w_cat, lp["b_ih"], tp, plain)
            # the recurrence runs whole on every model rank: W_hh gathered
            # once a layer, and each rank keeps its rows of the whole dW_hh
            w_hh = gather_from_model(w_hh, 1, tp)
        elif li == 0:
            xp = unfold_matmul(out, w_cat, cfg.kernel_len, cfg.stride_len)
            xp = (xp.float().reshape(b, -1, d, 3 * h) + lp["b_ih"].float()).to(cdt)
        elif _use_matmul_kernel(cfg, li, out.shape[-1], 3 * h * d):
            xp = projection_matmul(out.reshape(-1, out.shape[-1]), w_cat,
                                   lp["b_ih"].reshape(-1).float(), plain=plain)
            xp = xp.reshape(b, -1, d, 3 * h)
        else:
            xp = linear(out, w_cat, lp["b_ih"].reshape(-1)).reshape(b, -1, d, 3 * h)
        xp = xp.permute(1, 2, 0, 3).contiguous()  # [L, D, B, 3H]
        ys = gru_scan(xp, w_hh, lp["b_hh"],  # [L, D, B, H]
                      plain=plain or cfg.use_pallas is False)
        out = ys.permute(2, 0, 1, 3).reshape(b, -1, d * h)
        if p > 0 and li < cfg.num_layers - 1:
            out = dropout(out, p, generator, shard)
    return out


def _project_tp(cfg: GRUConfig, li: int, out: torch.Tensor, w_cat: torch.Tensor,
                b_ih: torch.Tensor, tp: ModelShard, plain: bool) -> torch.Tensor:
    """Layer ``li``'s input projection ``[B, L, D, 3H]`` on this model
    rank's rows of ``w_ih`` (JAX's ``P(None, 'model', None)``): the rank's
    slice of the replicated input (whose gradient is joined over the model
    group), its partial product, the sum over the group, then the bias once
    and the rounding of the single-device projection. Layer 0's rows
    ``c*k + j`` of a contiguous shard are a slice of channels, so the rank
    convolves its channels alone; its partials stay float32 (in bfloat16
    the products of the bf16 operands, exact per term). Layers 1+ take
    ``linear``'s float32 partial, or the hand-written product with
    ``use_pallas_matmul`` (rounded to the compute dtype before the sum, as
    the kernel's output is)."""
    b, h, d, cdt = out.shape[0], cfg.hidden_dim, cfg.num_dirs, cfg.compute_dtype
    xs = scatter_to_model(out, -1, tp)
    if li == 0:
        if cdt != torch.float32:
            xs, w_cat = xs.float(), w_cat.float()
        part = unfold_matmul(xs, w_cat, cfg.kernel_len, cfg.stride_len)
        xp = reduce_from_model(part, tp).to(cdt)
    elif _use_matmul_kernel(cfg, li, xs.shape[-1], w_cat.shape[-1]):
        zero = torch.zeros(w_cat.shape[-1], dtype=torch.float32, device=xs.device)
        part = projection_matmul(xs.reshape(-1, xs.shape[-1]), w_cat, zero, plain=plain)
        xp = reduce_from_model(part.float(), tp).to(cdt).reshape(b, -1, w_cat.shape[-1])
    else:
        xp = reduce_from_model(partial_linear(xs, w_cat), tp)
    xp = xp.float().reshape(b, -1, d, 3 * h) + b_ih.float()
    return xp.to(cdt)


def _use_matmul_kernel(cfg: GRUConfig, li: int, k: int, n: int) -> bool:
    """Layer ``li`` (1+) takes the hand-written projection: the JAX
    package's call-site gate. Layer 0 never does (its projection is the
    strided conv). K or N not a multiple of 128 warns once and keeps
    ``linear``."""
    global _warned_matmul_fallback
    if not cfg.use_pallas_matmul or li == 0:
        return False
    if projection_kernel_viable(k, n):
        return True
    if not _warned_matmul_fallback:
        _warned_matmul_fallback = True
        warnings.warn(
            f"use_pallas_matmul=True but layer-{li} GEMM dims (K={k}, N={n}) are "
            f"not multiples of 128; using linear instead.", stacklevel=3)
    return False


def dropout(x: torch.Tensor, p: float, generator: torch.Generator,
            shard: BatchShard | None = None) -> torch.Tensor:
    """Inverted dropout: each entry kept with probability 1-p and scaled by
    1/(1-p), else 0 (the JAX package's ``jnp.where(keep, x / (1-p), 0)``);
    with a shard, its rows of the global batch's mask."""
    keep = draw_rows(lambda shape: torch.rand(shape, generator=generator,
                                              device=x.device),
                     x.shape, shard) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), 0.0)


def gru_head(params: Params, enc: torch.Tensor,
             tp: ModelShard | None = None) -> torch.Tensor:
    """``enc [B, L, H*D] @ fc.weight + fc.bias`` -> float32 logits: the
    operands in enc's dtype, the product accumulated and kept in float32
    (in bfloat16 compute, a float32 product of the bf16-rounded operands,
    exact per term). With ``tp``, ``fc.weight`` is this model rank's rows
    (JAX's ``P('model', None)``): its slice of enc, the partial logits
    summed over the model group, then the bias."""
    w = params["fc"]["weight"].to(enc.dtype)
    enc = scatter_to_model(enc, -1, tp)
    logits = reduce_from_model(torch.matmul(enc.float(), w.float()), tp)
    return logits + params["fc"]["bias"].float()


def gru_forward(
    params: Params,
    cfg: GRUConfig,
    x: torch.Tensor,
    day_idx: torch.Tensor,
    *,
    train: bool = False,
    generator: torch.Generator | None = None,
    plain: bool = False,
    shard: BatchShard | None = None,
    tp: ModelShard | None = None,
) -> torch.Tensor:
    """``[B, T, C]`` features -> ``[B, L, n_classes+1]`` float32 logits.
    Training takes the unfused frontend chain (autograd reaches the day
    affine) and dropout from ``generator``; inference the fused frontend.
    ``shard``: x holds these rows of a data-parallel global batch; ``tp``:
    params holds this model rank's shards (``parallel/shardings.py``), the
    frontend and every other replicated part computed whole on each rank."""
    x = x.to(cfg.compute_dtype)
    if cfg.gaussian_smooth_width > 0 and not train:
        # fused_frontend: the kernel's operator (ops/kernels/library.py)
        front = (fused_frontend_plain if plain or cfg.use_pallas is False
                 else fused_frontend)
        x = front(
            x, params["day"]["weight"], params["day"]["bias"], day_idx,
            kernel_size=cfg.gaussian_kernel_size,
            sigma=float(cfg.gaussian_smooth_width),
        )
    else:
        # training, or sigma <= 0 (no smoothing: the fused kernel's taps
        # would be 0/0)
        x = gaussian_smooth(
            x, cfg.gaussian_kernel_size, cfg.gaussian_smooth_width
        )
        x = F.softsign(day_affine(params["day"], x, day_idx))
    enc = gru_encode(params, cfg, x, train=train, generator=generator,
                     plain=plain, shard=shard, tp=tp)
    return gru_head(params, enc, tp)


def gru_output_length(cfg: GRUConfig, t: int) -> int:
    return unfold_output_length(t, cfg.kernel_len, cfg.stride_len)


def _leaves(tree) -> list[torch.Tensor]:
    """The tensors of a parameter tree in a fixed order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


class GRUDecoder(nn.Module):
    """The decoder as an ``nn.Module`` holding ``init_gru_params``' tree as
    trainable parameters: ``module.params`` is that tree of its own
    parameters, and ``module(x, day_idx, ...)`` is ``gru_forward``."""

    def __init__(self, cfg: GRUConfig, params: Params):
        super().__init__()
        self.cfg = cfg
        self.tp = None  # set to a ModelShard when params are the rank's shards

        def pdict(tree):
            return nn.ParameterDict(
                {k: nn.Parameter(v) for k, v in tree.items()}
            )

        self.day = pdict(params["day"])
        self.layers = nn.ModuleList(pdict(lp) for lp in params["gru"]["layers"])
        self.fc = pdict(params["fc"])

    @property
    def params(self) -> Params:
        return {
            "day": dict(self.day.items()),
            "gru": {"layers": [dict(lp.items()) for lp in self.layers]},
            "fc": dict(self.fc.items()),
        }

    @torch.no_grad()
    def load_params(self, params: Params) -> None:
        """Copy a parameter tree of ``init_gru_params``' layout into this
        module's parameters (on their device and dtype)."""
        for mine, theirs in zip(_leaves(self.params), _leaves(params), strict=True):
            if mine.shape != theirs.shape:
                raise ValueError(f"load_params: {tuple(theirs.shape)} for a "
                                 f"parameter of shape {tuple(mine.shape)}")
            mine.copy_(theirs)

    def forward(
        self,
        x: torch.Tensor,
        day_idx: torch.Tensor,
        *,
        train: bool = False,
        generator: torch.Generator | None = None,
        plain: bool = False,
        shard: BatchShard | None = None,
    ) -> torch.Tensor:
        return gru_forward(self.params, self.cfg, x, day_idx, train=train,
                           generator=generator, plain=plain, shard=shard, tp=self.tp)
