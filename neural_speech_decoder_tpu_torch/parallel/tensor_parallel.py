"""The collectives of tensor parallelism, as autograd Functions over the
'model' axis.

JAX shards the large weights over its mesh's 'model' axis
(``parallel/shardings.py``) and XLA's GSPMD inserts the collectives the
sharded products need. The port runs one process per device
(``parallel/mesh.py``): each rank of a model group holds its shard of those
weights and calls these itself, Megatron's pair and their two companions:

- ``copy_to_model``: identity forward, all-reduce backward, at the input of
  a column-parallel product (each rank's gradient of the replicated input
  covers its columns only);
- ``reduce_from_model``: all-reduce forward, identity backward, after a
  row-parallel product (each rank holds a partial sum);
- ``gather_from_model``: the ranks' slices along one dimension joined, and
  the backward keeps this rank's slice of the gradient (every model rank
  computed the same whole gradient, so summing would count it ``n_model``
  times);
- ``scatter_to_model``: this rank's slice of a replicated tensor along one
  dimension, and the backward joins the ranks' gradient slices.

A gather is an all-reduce of a zero-padded buffer, which every backend
takes for CUDA and CPU tensors alike (gloo has no all-gather of CUDA
tensors), and which is exact. With no model shard (``None``) each is the
identity.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """Shard ``index`` of ``count`` on the 'model' axis, whose ranks form
    ``group``."""

    index: int
    count: int
    group: Any = None


def _all_reduce(t: torch.Tensor, tp: ModelShard) -> torch.Tensor:
    out = t.contiguous().clone()
    dist.all_reduce(out, group=tp.group)
    return out


def split(t: torch.Tensor, dim: int, tp: ModelShard) -> torch.Tensor:
    """This rank's contiguous slice of ``t`` along ``dim`` (a copy), which
    must divide into ``tp.count`` equal slices."""
    size = t.shape[dim]
    if size % tp.count:
        raise ValueError(f"dimension {dim} of size {size} does not split into "
                         f"{tp.count} model shards")
    per = size // tp.count
    return t.narrow(dim, tp.index * per, per).contiguous()


def join(t: torch.Tensor, dim: int, tp: ModelShard) -> torch.Tensor:
    """Every model rank's ``t`` joined along ``dim`` in rank order, on every
    rank (an all-reduce of the zero-padded whole)."""
    dim = dim % t.dim()
    per = t.shape[dim]
    shape = list(t.shape)
    shape[dim] = per * tp.count
    out = torch.zeros(shape, dtype=t.dtype, device=t.device)
    out.narrow(dim, tp.index * per, per).copy_(t)
    dist.all_reduce(out, group=tp.group)
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.tp), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return _all_reduce(x, tp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        return join(x, dim, tp)

    @staticmethod
    def backward(ctx, g):
        return split(g, ctx.dim, ctx.tp), None, None


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        return split(x, dim, tp)

    @staticmethod
    def backward(ctx, g):
        return join(g.contiguous(), ctx.dim, ctx.tp), None, None


def copy_to_model(x: torch.Tensor, tp: ModelShard | None) -> torch.Tensor:
    """``x`` as it is; its gradient summed over the model group."""
    return x if tp is None else _CopyToModel.apply(x, tp)


def reduce_from_model(x: torch.Tensor, tp: ModelShard | None) -> torch.Tensor:
    """``x`` summed over the model group (in x's dtype); its gradient as it
    is."""
    return x if tp is None else _ReduceFromModel.apply(x, tp)


def gather_from_model(x: torch.Tensor, dim: int, tp: ModelShard | None) -> torch.Tensor:
    """The model ranks' ``x`` joined along ``dim``; the gradient's slice of
    this rank."""
    return x if tp is None else _GatherFromModel.apply(x, dim, tp)


def scatter_to_model(x: torch.Tensor, dim: int, tp: ModelShard | None) -> torch.Tensor:
    """This rank's slice of ``x`` along ``dim``; the gradient joined over
    the model group."""
    return x if tp is None else _ScatterToModel.apply(x, dim, tp)
