"""The ('data', 'model') mesh, as one process per device over torch.distributed.

Port of ``neural_speech_decoder_tpu/parallel/mesh.py``. JAX builds one
``Mesh`` over every device and lets XLA insert the collectives from the
sharding annotations. Here each process is one rank of the 'data' axis on
one device (a card, or the CPU under gloo), and the trainer calls the
collectives itself (``parallel/data_parallel.py``). A ``Mesh`` is this
process's view of that axis: the world size, its rank, its device and the
process group (None when one process trains alone and calls no
collective). The 'model' axis (tensor parallelism, JAX
``parallel/shardings.py``) is the next slice of the port: ``n_model > 1``
raises.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..ops.rows import BatchShard

TP_NOT_PORTED = ("tensor parallelism (n_model_devices > 1: JAX's "
                 "parallel/shardings.py) is not ported yet; it is the next slice of the "
                 "port (ROADMAP queue 1 item 2). Data parallelism (n_data_devices) is")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's rank of the 'data' axis."""

    n_data: int  # the world size
    rank: int
    device: torch.device
    group: Any = None  # the process group; None: one process, no collective

    @property
    def distributed(self) -> bool:
        return self.group is not None

    @property
    def primary(self) -> bool:
        """True on the rank that writes checkpoints and logs."""
        return self.rank == 0


def default_device() -> torch.device:
    """The card of this process: ``cuda:LOCAL_RANK`` (as ``torchrun`` sets
    it; 0 without it)."""
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def make_mesh(n_data: int | None = None, n_model: int = 1, *,
              device: torch.device | str | None = None, group: Any = None) -> Mesh:
    """The 'data' axis over every rank of the process group (``group``, or
    the default one), or over this process alone when there is none.
    ``n_data``, when given, must be the world size. ``device`` defaults to
    ``default_device()``."""
    if n_model > 1:
        raise NotImplementedError(f"n_model={n_model}: {TP_NOT_PORTED}")
    device = torch.device(device) if device is not None else default_device()
    if dist.is_available() and dist.is_initialized():
        group = group if group is not None else dist.group.WORLD
        world, rank = dist.get_world_size(group), dist.get_rank(group)
    elif group is not None:
        raise ValueError("make_mesh: a group was given, but no process group is initialized")
    else:
        world, rank = 1, 0
    if n_data is not None and n_data != world:
        raise ValueError(
            f"make_mesh: n_data={n_data}, but the process group has {world} rank(s); start "
            f"one process per device (multihost.initialize, torchrun, or train_model's "
            f"n_data_devices)")
    return Mesh(world, rank, device, group)


def batch_sharding(mesh: Mesh, n_rows: int) -> slice:
    """This rank's contiguous rows of a ``[n_rows, ...]`` global batch, in
    JAX's order: rank r holds ``[r * n_rows / W, (r + 1) * n_rows / W)``."""
    if n_rows % mesh.n_data:
        raise ValueError(f"global batch {n_rows} must divide across {mesh.n_data} processes")
    per = n_rows // mesh.n_data
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def batch_shard(mesh: Mesh, n_rows: int) -> BatchShard | None:
    """The ``BatchShard`` of this rank's ``n_rows`` rows (what the random
    draws of its train step read), or None without a process group."""
    if not mesh.distributed:
        return None
    return BatchShard(mesh.rank * n_rows, mesh.n_data * n_rows, mesh.rank, mesh.n_data)


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
    """Rank 0's values of every tensor of a tree on every rank (broadcast in
    place; the tensors live on the mesh's device). Returns the tree."""
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
