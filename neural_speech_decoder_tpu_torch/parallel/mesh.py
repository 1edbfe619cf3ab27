"""The ('data', 'model') mesh, as one process per device over torch.distributed.

Port of ``neural_speech_decoder_tpu/parallel/mesh.py``. JAX builds one
``Mesh`` over every device, ``np.array(devices).reshape(n_data, n_model)``,
and lets XLA insert the collectives from the sharding annotations. Here
each process is one cell of that grid on one device (a card, or the CPU
under gloo): global rank ``r`` sits at ``(d, m) = divmod(r, n_model)``, and
the trainer calls the collectives itself (``parallel/data_parallel.py``,
``parallel/tensor_parallel.py``). A ``Mesh`` is this process's view of the
grid: its coordinates, its device, and three process groups (None where
the axis has one rank and no collective is called): every rank, its data
group (the ranks with its ``m``, for the gradient all-reduce) and its model
group (the ranks with its ``d``, for the tensor-parallel collectives).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..ops.rows import BatchShard
from .tensor_parallel import ModelShard


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's cell ``(d, m)`` of the ``(n_data, n_model)`` grid."""

    n_data: int
    rank: int  # the global rank, d * n_model + m
    device: torch.device
    group: Any = None  # every rank; None: one process, no collective
    n_model: int = 1
    data_group: Any = None  # the ranks with this m; None when n_data is 1
    model_group: Any = None  # the ranks with this d; None when n_model is 1

    @property
    def d(self) -> int:
        """The data coordinate: which rows of the global batch this rank holds."""
        return self.rank // self.n_model

    @property
    def m(self) -> int:
        """The model coordinate: which shard of the sharded parameters."""
        return self.rank % self.n_model

    @property
    def world(self) -> int:
        return self.n_data * self.n_model

    @property
    def distributed(self) -> bool:
        return self.group is not None

    @property
    def primary(self) -> bool:
        """True on the rank that writes checkpoints and logs, (0, 0)."""
        return self.rank == 0

    @property
    def model_shard(self) -> ModelShard | None:
        """This rank's place on the 'model' axis, or None without one."""
        if self.n_model == 1:
            return None
        return ModelShard(self.m, self.n_model, self.model_group)


def default_device() -> torch.device:
    """The card of this process: ``cuda:LOCAL_RANK`` (as ``torchrun`` sets
    it; 0 without it)."""
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def make_mesh(n_data: int | None = None, n_model: int = 1, *,
              device: torch.device | str | None = None, group: Any = None) -> Mesh:
    """The ``(n_data, n_model)`` grid over every rank of the process group
    (``group``, or the default one), or over this process alone when there
    is none. ``n_model`` must divide the group's size, and ``n_data``, when
    given, be the quotient. Every rank of the group must call this, in the
    same order as its other group calls: it makes the data and model
    groups. ``device`` defaults to ``default_device()``."""
    device = torch.device(device) if device is not None else default_device()
    if dist.is_available() and dist.is_initialized():
        group = group if group is not None else dist.group.WORLD
        world, rank = dist.get_world_size(group), dist.get_rank(group)
    elif group is not None:
        raise ValueError("make_mesh: a group was given, but no process group is initialized")
    else:
        world, rank = 1, 0
    if n_model < 1 or world % n_model:
        raise ValueError(
            f"make_mesh: n_model={n_model} does not divide the {world} rank(s) of the "
            f"process group; start n_data * n_model processes, one per device")
    if n_data is not None and n_data * n_model != world:
        raise ValueError(
            f"make_mesh: n_data={n_data} x n_model={n_model}, but the process group has "
            f"{world} rank(s); start one process per device (multihost.initialize, "
            f"torchrun, or train_model's n_data_devices and n_model_devices)")
    n_data = world // n_model
    if world == 1:
        return Mesh(1, 0, device)
    ranks = [dist.get_global_rank(group, i) for i in range(world)]
    grid = np.array(ranks).reshape(n_data, n_model)
    data_group = model_group = None
    if n_model == 1:
        data_group = group
    elif n_data == 1:
        model_group = group
    else:
        # every rank makes every subgroup, in one order (dist.new_group)
        for m in range(n_model):
            g = dist.new_group(grid[:, m].tolist())
            if rank % n_model == m:
                data_group = g
        for d in range(n_data):
            g = dist.new_group(grid[d].tolist())
            if rank // n_model == d:
                model_group = g
    return Mesh(n_data, rank, device, group, n_model, data_group, model_group)


def batch_sharding(mesh: Mesh, n_rows: int) -> slice:
    """This rank's contiguous rows of a ``[n_rows, ...]`` global batch, in
    JAX's order (``P('data')``): data coordinate d holds ``[d * n_rows /
    n_data, (d + 1) * n_rows / n_data)``, every model rank of it the same."""
    if n_rows % mesh.n_data:
        raise ValueError(f"global batch {n_rows} must divide across {mesh.n_data} processes")
    per = n_rows // mesh.n_data
    return slice(mesh.d * per, (mesh.d + 1) * per)


def batch_shard(mesh: Mesh, n_rows: int) -> BatchShard | None:
    """The ``BatchShard`` of this rank's ``n_rows`` rows (what the random
    draws of its train step read), or None when the 'data' axis has one
    rank."""
    if mesh.n_data == 1:
        return None
    return BatchShard(mesh.d * n_rows, mesh.n_data * n_rows, mesh.d, mesh.n_data)


def shard_batch(mesh: Mesh, tree: Any) -> Any:
    """Every array or tensor of a tree of global batches as this rank's rows
    of it, on the mesh's device."""
    if isinstance(tree, dict):
        return {k: shard_batch(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_batch(mesh, v) for v in tree)
    if isinstance(tree, np.ndarray):
        tree = torch.from_numpy(np.ascontiguousarray(tree))
    return tree[batch_sharding(mesh, tree.shape[0])].to(mesh.device)


def replicated(mesh: Mesh, tree: Any) -> Any:
    """Rank 0's values of every tensor of a tree on every rank of the grid
    (broadcast in place; the tensors live on the mesh's device). Returns
    the tree."""
    if mesh.distributed:
        for t in _tensors(tree):
            dist.broadcast(t.data, src=dist.get_global_rank(mesh.group, 0), group=mesh.group)
    return tree


def _tensors(tree: Any) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree]
