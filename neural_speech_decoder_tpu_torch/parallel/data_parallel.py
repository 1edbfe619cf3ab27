"""Data parallelism: the collectives of a train step and the rank processes.

The JAX trainer shards the batch over the mesh's 'data' axis and XLA
inserts the gradient all-reduce (GSPMD). The port runs one process per
device (``parallel/mesh.py``) and calls the collectives itself:

- ``average_gradients``: after the backward, one all-reduce over the data
  group (the ranks that hold the same model shard) of each dtype's
  gradients flattened into one buffer, divided by ``n_data``, so that the
  clip, the watch norms and the optimizer see the global batch's gradient;
- ``mean_metrics``: the step's loss terms averaged to the global value
  over the data group (the model ranks of one data coordinate hold the
  same loss);
- ``agree_max``: the preemption flag over every rank, so that every rank
  stops at the same step;
- ``gather_rows``: every data coordinate's rows (eval outputs) on every
  rank, as JAX's ``process_allgather``; ``gather_values``: every rank's
  values (launch counts). Both are an all-reduce of a zero-padded buffer,
  which every backend takes for CUDA and CPU tensors alike.

``launch`` starts the rank processes (``spawn``), each joining the group on
its device before it runs its function: ``training/trainer.py::
train_model`` uses it when it is asked for several devices and no group
exists, as one JAX process drives every local device; it starts ``n_data
x n_model`` of them. ``resolve_n_data`` is JAX's rule for the size of the
'data' axis beside the 'model' axis.
"""

from __future__ import annotations

import multiprocessing as mp
import multiprocessing.connection
import os
import signal
import socket
import sys
import threading
import time
import traceback
from typing import Any, Callable, Iterable

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh
from .multihost import initialize


def resolve_n_data(args: dict, device: torch.device, world: int | None = None) -> int:
    """The size of the 'data' axis, by the JAX trainer's rule
    (``training/trainer.py:537-555``): the devices available divided by
    ``n_model_devices`` (more model ranks than devices raise ``ValueError``,
    JAX's message), ``n_data_devices`` capped at that, then cut to the
    largest divisor of ``batchSize`` (of ``batchMultiple`` under
    ``tokensPerBatch``, whose step batches are multiples of it). Available
    are the ranks of the process group (``world``); without one, every
    visible card for ``cuda`` (also the default, as JAX's is every device),
    one for an explicit ``cuda:i``, and as many gloo ranks as asked for the
    CPU (``n_data_devices`` times ``n_model_devices``, default 1 each)."""
    n_model = int(args.get("n_model_devices") or 1)
    asked = int(args.get("n_data_devices") or 0)
    if world is not None:
        devices = world
    elif device.type == "cuda":
        devices = torch.cuda.device_count() if device.index is None else 1
    else:
        devices = max(asked, 1) * n_model
    if n_model > devices:
        raise ValueError(f"n_model_devices={n_model} exceeds the {devices} available "
                         f"device(s)")
    avail = devices // n_model
    n_data = min(asked or avail, avail)
    target = (int(args.get("batchMultiple", 64)) if int(args.get("tokensPerBatch", 0)) > 0
              else int(args["batchSize"]))
    return max(d for d in range(1, n_data + 1) if target % d == 0)


def average_gradients(params: Iterable[torch.Tensor], mesh: Mesh) -> None:
    """Replace every parameter's gradient by its mean over the data group:
    one all-reduce (sum) a dtype of the gradients flattened into one
    buffer, then a division by ``n_data``. A parameter without a gradient
    takes part with zeros, so the ranks' buffers always match."""
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=mesh.data_group)
        flat.div_(mesh.n_data)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def mean_metrics(metrics: dict[str, torch.Tensor], mesh: Mesh) -> dict[str, torch.Tensor]:
    """The scalar metrics averaged over the data group (one all-reduce of
    them stacked in float32); no host sync."""
    if not metrics:
        return metrics
    keys = list(metrics)
    stacked = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
    dist.all_reduce(stacked, group=mesh.data_group)
    stacked.div_(mesh.n_data)
    return dict(zip(keys, stacked.unbind()))


def agree_max(flag: bool, mesh: Mesh) -> torch.Tensor:
    """``[1]`` float32 on the mesh's device: 1 if any rank's ``flag`` is
    set, else 0. The value is queued, not read (no host sync)."""
    t = torch.full((1,), float(flag), device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return t


def _gather(t: torch.Tensor, index: int, size: int, group) -> torch.Tensor:
    n = t.shape[0]
    out = torch.zeros((size * n,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    out[index * n:(index + 1) * n] = t
    dist.all_reduce(out, group=group)
    return out


def gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every data coordinate's rows of ``t [n, ...]`` in order, ``[n_data *
    n, ...]`` on every rank (the same n on each)."""
    return _gather(t, mesh.d, mesh.n_data, mesh.data_group)


def gather_values(values: list[float], mesh: Mesh) -> np.ndarray:
    """Every rank's ``values`` (the same count on each) as ``[W, n]``
    float64 on every rank, by global rank."""
    t = torch.tensor(values, dtype=torch.float64).reshape(1, -1).to(mesh.device)
    return _gather(t, mesh.rank, mesh.world, mesh.group).cpu().numpy()


def sync(mesh: Mesh) -> None:
    """Wait until every rank got here."""
    t = torch.ones(1, device=mesh.device)
    dist.all_reduce(t, group=mesh.group)
    t.item()


def check_spawnable_main() -> None:
    """Raise when this program's ``__main__`` was read from standard input
    (``python -``): a ``spawn`` child re-imports the parent's main module by
    its path and cannot read ``<stdin>``, so a pool would restart its
    workers without end and a rank would die at start."""
    main = sys.modules.get("__main__")
    if getattr(main, "__file__", None) == "<stdin>":
        raise RuntimeError(
            "cannot start spawn processes from a program read from <stdin> (python -): "
            "the children cannot re-import it; run it from a file, with python -c, or "
            "with python -m")


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _backend_flags() -> dict:
    """This process's float32 math settings, which a rank takes over."""
    return {"matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_tf32": torch.backends.cudnn.allow_tf32,
            "cudnn_benchmark": torch.backends.cudnn.benchmark,
            "cudnn_deterministic": torch.backends.cudnn.deterministic}


def _rank_main(fn, fn_args, rank, world, address, backend, device, timeout_s, flags,
               conn) -> None:
    torch.backends.cuda.matmul.allow_tf32 = flags["matmul_tf32"]
    torch.backends.cudnn.allow_tf32 = flags["cudnn_tf32"]
    torch.backends.cudnn.benchmark = flags["cudnn_benchmark"]
    torch.backends.cudnn.deterministic = flags["cudnn_deterministic"]
    try:
        initialize(address, world, rank, backend=backend, device=device, timeout_s=timeout_s)
        value = fn(*fn_args)
        conn.send(("ok", value))
    except BaseException:
        conn.send(("error", traceback.format_exc()))
        sys.exit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(
    fn: Callable,
    rank_args: list[tuple],
    *,
    devices: list[torch.device | str],
    backend: str,
    timeout_s: float | None = None,
    grace_s: float = 5.0,
) -> list[Any]:
    """Run ``fn(*rank_args[r])`` in rank process ``r`` of a new group
    (``spawn``; ``backend`` over ``localhost``), on ``devices[r]``, and
    return the results by rank. ``fn`` and its arguments must pickle. The
    ranks take over this process's TF32 and cuDNN settings
    (``torch.backends``), which a spawned process would otherwise reset.
    SIGTERM and SIGUSR1 sent to this process are passed on to the ranks.
    When a rank fails, the others get ``grace_s`` to end, then are killed,
    and this raises with the failed ranks' tracebacks; ``timeout_s`` is the
    group's collective timeout."""
    check_spawnable_main()
    world = len(devices)
    if len(rank_args) != world:
        raise ValueError(f"launch: {len(rank_args)} argument tuples for {world} devices")
    ctx = mp.get_context("spawn")
    address = f"tcp://127.0.0.1:{_free_port()}"
    procs, conns = [], []
    for r in range(world):
        recv, send = ctx.Pipe(duplex=False)
        p = ctx.Process(target=_rank_main, name=f"nsd-rank-{r}",
                        args=(fn, rank_args[r], r, world, address, backend, str(devices[r]),
                              timeout_s, _backend_flags(), send))
        p.start()
        send.close()
        procs.append(p)
        conns.append(recv)

    def forward(signum, frame):
        for p in procs:
            if p.is_alive():
                os.kill(p.pid, signum)

    prev = {}
    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGTERM, signal.SIGUSR1):
            prev[sig] = signal.signal(sig, forward)
    results: list[Any] = [None] * world
    errors: dict[int, str] = {}
    finished = False
    try:
        pending = dict(enumerate(conns))
        while pending and not errors:
            waits = list(pending.values()) + [procs[r].sentinel for r in pending]
            for obj in multiprocessing.connection.wait(waits):
                for r, c in list(pending.items()):
                    if obj is c or (obj == procs[r].sentinel and not c.poll()):
                        try:
                            status, value = c.recv()
                        except EOFError:
                            procs[r].join()
                            status, value = "error", f"exited with code {procs[r].exitcode}"
                        del pending[r]
                        if status == "ok":
                            results[r] = value
                        else:
                            errors[r] = value
        finished = not errors
    finally:
        # every rank returned: let them leave the group; else kill what is
        # left after the grace (a rank may wait in a collective for ever)
        deadline = None if finished else time.monotonic() + grace_s
        for p in procs:
            p.join(None if deadline is None else max(deadline - time.monotonic(), 0.0))
            if p.is_alive():
                p.kill()
                p.join()
        for sig, h in prev.items():
            signal.signal(sig, h)
        for c in conns:
            c.close()
    if errors:
        raise RuntimeError(f"{len(errors)} of {world} rank(s) failed:\n" + "\n".join(
            f"rank {r}:\n{e}" for r, e in sorted(errors.items())))
    return results
