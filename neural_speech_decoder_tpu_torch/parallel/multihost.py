"""Process-group initialization and the per-process batch rows.

Port of ``neural_speech_decoder_tpu/parallel/multihost.py``. JAX runs one
process per host, each driving its local chips; the port runs one process
per card (or per CPU rank under gloo), on one host or several, the same
program everywhere:

    from neural_speech_decoder_tpu_torch.parallel.multihost import (
        initialize, make_global_mesh)
    initialize()                  # env-driven, as torchrun sets it
    mesh = make_global_mesh(n_model=2)  # the (data, model) grid of ranks
    # train_model(args) then trains over the group: every rank samples the
    # same global batch and keeps its data coordinate's local_rows, and
    # with n_model_devices > 1 its shard of the sharded parameters.

Every rank stages its own rows (``stage_local_batch``), so the JAX
trainer's ``multihost_staging`` switch takes the port's one path.
"""

from __future__ import annotations

import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, batch_sharding, default_device, make_mesh

_ENV = ("MASTER_ADDR", "MASTER_PORT")


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str | None = None,
    device: torch.device | str | None = None,
    timeout_s: float | None = None,
) -> None:
    """``torch.distributed.init_process_group`` with ``torchrun``'s
    environment as the defaults (``MASTER_ADDR``/``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``; the device ``cuda:LOCAL_RANK``), as JAX's defaults come
    from the Cloud TPU environment; explicit arguments for anything else.
    ``coordinator_address`` is ``host:port`` or an init URL
    (``tcp://localhost:29500``). ``backend`` defaults to ``nccl`` for a CUDA
    device and ``gloo`` for the CPU; a group that cannot be made raises."""
    if dist.is_initialized():
        raise RuntimeError("initialize: a process group is initialized already")
    rank = int(os.environ.get("RANK", 0)) if process_id is None else int(process_id)
    world = (int(os.environ.get("WORLD_SIZE", 1)) if num_processes is None
             else int(num_processes))
    if coordinator_address is None:
        missing = [k for k in _ENV if k not in os.environ]
        if missing:
            raise ValueError(f"initialize: no coordinator_address and {missing} unset "
                             f"(torchrun sets them)")
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    device = torch.device(device) if device is not None else default_device()
    backend = backend or default_backend(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kwargs = {} if timeout_s is None else {"timeout": timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method=init_method, world_size=world,
                            rank=rank, **kwargs)


def default_backend(device: torch.device) -> str:
    """``nccl`` for a card, ``gloo`` for the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


def make_global_mesh(n_model: int = 1, *, device: torch.device | str | None = None) -> Mesh:
    """The ('data', 'model') mesh over every rank of the job: ``n_model``
    ranks a model group, the world size over it the 'data' axis."""
    return make_mesh(n_model=n_model, device=device)


def _world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def is_primary() -> bool:
    """True on the process that writes checkpoints and logs (rank 0, or the
    only process)."""
    return _world()[1] == 0


def local_rows(n_rows: int, n_model: int = 1) -> slice:
    """This process's row slice of a ``[n_rows, ...]`` global batch.

    Every process samples the same global batch (the same seeded RNG,
    which keeps single-process parity and exact resume at any world size),
    then keeps the contiguous rows of its data coordinate: with ``n_model``
    ranks a model group, rank ``r`` sits at ``divmod(r, n_model)``, and the
    model ranks of one data coordinate hold the same rows. Requires
    ``n_rows % (world_size / n_model) == 0``."""
    world, rank = _world()
    if world % n_model:
        raise ValueError(f"local_rows: n_model={n_model} does not divide the "
                         f"{world} process(es)")
    return batch_sharding(Mesh(world // n_model, rank, torch.device("cpu"),
                               n_model=n_model), n_rows)


def stage_local_batch(mesh: Mesh, arrays: tuple) -> tuple[torch.Tensor, ...]:
    """This process's rows of the batch (``arrays``, each ``[rows, ...]``)
    as tensors on its device. JAX stitches the processes' rows into one
    global array here; a port rank keeps its own and the collectives see
    the rest."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(mesh.device) for a in arrays)
