"""The multichip contract: sharded train steps of both model families over
an n-rank ``(data, model)`` grid.

Port of the JAX package's ``dryrun_multichip`` (``__graft_entry__.py``),
with its own copy of the dryrun args. ``dryrun_multichip(n)`` starts ``n``
rank processes (``parallel/data_parallel.py::launch``: gloo on the CPU,
nccl when every rank has a card of its own, else gloo ranks sharing one
card), and each rank runs JAX's stages in turn, each on a new grid of the
same ranks (``parallel/mesh.py::make_mesh``):

1. the GRU over an ``(n/2 x 2)`` grid (``(n x 1)`` for odd n): the batch
   over 'data', the weights' contraction rows over 'model';
2. the Conformer likewise, head-parallel on the interleaved qkv;
3. ``+pallas``: the GRU at ``nUnits=128`` with 16 rows a rank over ``(n x
   1)`` (JAX's batch-mappable kernel stage);
4. ``+pallas``: the Conformer at ``latent_dim=256`` with 2 heads over
   'model', when n is even;
5. the bucketed stage: tokens-constant bucket batch sizes (multiples of
   ``2n``) gathered on the device (``data/device_data.py``) over ``(n x
   1)``, 8 steps, each step's loss within rtol 1e-5 of the same steps on
   one rank (in the same process, without collectives), with at least two
   envelopes engaged.

Each sharded step asserts a finite loss and changed parameters and prints
JAX's ``dryrun_multichip OK [...]: mesh=(DxM) ...`` line. JAX's kernel-mesh
registration and its tile guard have no counterpart: a rank calls its
kernels on its own rows and shards, and on a card a wrapper launches its
kernel or raises, so each rank's launches (by body) per stage, returned to
the caller, show what ran.

One deliberate difference from JAX's args: the Conformer of stage 2 runs
``latent_dim`` 128 (head width 64), not 32 (16): the port's attention is
its kernel (``ops/kernels/attention.py``), which takes head widths 64 and
128, where JAX's stage 2 runs its einsum attention.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..data.batching import (
    batch_rows,
    bucket_batch_sizes,
    choose_envelope,
    length_buckets,
    sample_batch,
)
from ..data.dataset import pack_days
from ..data.device_data import DeviceData
from ..data.synthetic import synthetic_dataset
from ..models.api import build_model, shard_model
from ..ops.kernels import launch_counts
from ..training.optim import make_optimizer
from ..training.trainer import make_train_step, step_generator
from ..utils.device import resolve_device
from . import data_parallel as dp
from .mesh import batch_sharding, make_mesh, replicated
from .multihost import local_rows, stage_local_batch

N_DAYS = 4
BUCKETED_STEPS = 8
BUCKETED_RTOL = 1e-5

_GRU_DRYRUN_ARGS = {
    "model_type": "gru_baseline",
    "nInputFeatures": 32,
    "nClasses": 40,
    "nUnits": 64,
    "nLayers": 2,
    "dropout": 0.1,
    "strideLen": 4,
    "kernelLen": 8,
    "gaussianSmoothWidth": 2.0,
    "bidirectional": True,
    "whiteNoiseSD": 0.2,
    "constantOffsetSD": 0.05,
    "lrStart": 0.02,
    "lrEnd": 0.02,
    "l2_decay": 1e-5,
    "nBatch": 10,
    "seed": 0,
}

_CONFORMER_DRYRUN_ARGS = {
    "model_type": "transformer_ctc",
    "nInputFeatures": 32,
    "nClasses": 40,
    "gaussianSmoothWidth": 2.0,
    "gaussian_smooth_width": 2.0,
    "temporal_kernel": 8,
    "temporal_stride": 4,
    "frontend_dim": 32,
    "latent_dim": 128,  # JAX's 32: the attention kernel's head width is 64 or 128
    "autoencoder_hidden_dim": 24,
    "transformer_num_layers": 2,
    "transformer_n_heads": 2,
    "transformer_dim_ff": 32,
    "transformer_dropout": 0.1,
    "conformer_conv_kernel": 5,
    "drop_path_prob": 0.1,
    "use_spec_augment": True,
    "optimizer": "adamw",
    "label_smoothing": 0.1,
    "warmup_steps": 2,
    "whiteNoiseSD": 0.2,
    "constantOffsetSD": 0.05,
    "lrStart": 1e-3,
    "lrEnd": 1e-3,
    "l2_decay": 1e-5,
    "nBatch": 10,
    "seed": 0,
    # n_model_devices is set a stage, so that the model takes the
    # interleaved qkv layout of the head-parallel sharding
}


def dryrun_multichip(n_devices: int, device: torch.device | str = "cuda", *,
                     timeout_s: float | None = None) -> list[dict]:
    """Run the stages above on ``n_devices`` rank processes and print rank
    0's OK lines. ``device``: ``"cpu"`` (gloo ranks), ``"cuda"`` (a card a
    rank over nccl when there are ``n_devices`` cards, else gloo ranks on
    the current card) or ``"cuda:i"`` (gloo ranks on card i); a CUDA device
    without a card raises. ``timeout_s`` is the group's collective timeout.
    Returns every rank's ``{"rank", "lines", "stages"}``, where each stage
    is ``{"name", "mesh", "loss", "launches"}`` (the rank's launches in
    that stage by wrapper and ``<wrapper>/<body>``; the bucketed stage also
    ``"losses"``, ``"one_rank_losses"`` and ``"one_rank_launches"``). A
    failed stage raises with the ranks' tracebacks."""
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = resolve_device(dev, "dryrun_multichip")
        if torch.device(device).index is None and torch.cuda.device_count() >= n_devices:
            devices, backend = [f"cuda:{r}" for r in range(n_devices)], "nccl"
        else:
            devices, backend = [str(dev)] * n_devices, "gloo"
    else:
        devices, backend = ["cpu"] * n_devices, "gloo"
    results = dp.launch(_rank_stages, [(n_devices, d) for d in devices], devices=devices,
                        backend=backend, timeout_s=timeout_s)
    for line in results[0]["lines"]:
        print(line, flush=True)
    return results


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _launches_since(before: dict) -> dict:
    return {k: n - before.get(k, 0) for k, n in launch_counts().items()
            if n - before.get(k, 0)}


def _rank_stages(n_devices: int, device: str) -> dict:
    """Every stage in this rank of the caller's group (``launch``)."""
    device = torch.device(device)
    n_model = 2 if n_devices % 2 == 0 else 1
    stages = [
        ("", _GRU_DRYRUN_ARGS, n_model, 4),
        ("", _CONFORMER_DRYRUN_ARGS, n_model, 4),
        # the GRU scan and CTC kernels on 16 rows a rank over 'data' alone
        ("+pallas", dict(_GRU_DRYRUN_ARGS, nUnits=128, use_pallas=True,
                         ctc_use_kernel=True), 1, 16),
    ]
    if n_devices % 2 == 0:  # the attention kernel on the rank's heads
        stages.append(("+pallas", dict(_CONFORMER_DRYRUN_ARGS, latent_dim=256,
                                       transformer_n_heads=2, fused_attention="force"), 2, 4))
    out = {"rank": dist.get_rank(), "lines": [], "stages": []}
    for tag, args, m, rows in stages:
        before = launch_counts()
        stage = _family_step(n_devices, args, m, rows, tag, device)
        stage["launches"] = _launches_since(before)
        out["stages"].append(stage)
        out["lines"].append(stage.pop("line"))
    stage = _bucketed(n_devices, device)
    out["lines"].append(stage.pop("line"))
    out["stages"].append(stage)
    return out


def _family_step(n_devices: int, args: dict, n_model: int, rows_per_shard: int, tag: str,
                 device: torch.device) -> dict:
    """One train step of ``args``' model on an ``(n_devices / n_model,
    n_model)`` grid: every rank builds the same model (rank 0's weights
    broadcast), keeps its shards, and steps on its data coordinate's rows of
    a random global batch of ``rows_per_shard`` rows a data coordinate."""
    mesh = make_mesh(n_model=n_model, device=device)
    n_data = mesh.n_data
    args = dict(args, n_model_devices=n_model, n_data_devices=n_data, device=str(device))
    seed = int(args["seed"])
    model = build_model(args, N_DAYS, device, seed)
    replicated(mesh, list(model.parameters()))
    if mesh.model_shard is not None:
        model = shard_model(model, mesh.model_shard)
    optimizer, scheduler = make_optimizer(args, model.parameters())
    train_step = make_train_step(args, model, optimizer, scheduler, mesh)

    b, t, u = rows_per_shard * n_data, 64, 8  # the batch divides over the data axis
    rng = np.random.default_rng(0)
    arrays = (rng.standard_normal((b, t, 32)).astype(np.float32),
              rng.integers(1, 41, size=(b, u)).astype(np.int32),
              np.full((b,), t, dtype=np.int32),
              np.full((b,), u, dtype=np.int32),
              rng.integers(0, N_DAYS, size=(b,)).astype(np.int32))
    rows = local_rows(b, n_model)
    batch = stage_local_batch(mesh, tuple(a[rows] for a in arrays))
    before = [p.detach().clone() for p in model.parameters()]
    metrics = train_step(batch, step_generator(device, seed, 0))
    loss = float(metrics["train/loss"])
    _require(bool(np.isfinite(loss)), f"non-finite loss: {loss}")
    delta = sum(float((p.detach() - q).abs().sum()) for p, q in zip(model.parameters(), before))
    _require(delta > 0, "parameters did not change")
    name = f"{args['model_type']}{tag}"
    return {"name": name, "mesh": (n_data, n_model), "loss": loss,
            "line": f"dryrun_multichip OK [{name}]: mesh=({n_data}x{n_model}) "
                    f"devices={n_devices} loss={loss:.4f}"}


def _bucketed(n_devices: int, device: torch.device) -> dict:
    """Bucketed training over the data axis: the grouped anchor-bucket
    sampler with tokens-constant bucket batch sizes (multiples of ``2n``),
    batches gathered on the device from the packed features, each rank
    stepping on its rows; each step's loss held against the same batches
    on one rank (no collectives), which this rank runs after."""
    raw = synthetic_dataset(seed=2, n_days=N_DAYS, trials_per_day=16, n_channels=32,
                            min_t=24, max_t=96, min_u=2, max_u=6)
    train_ds = pack_days(raw["train"])
    t_max, u_max = choose_envelope(train_ds, time_multiple=16)
    buckets = length_buckets(train_ds, 3, t_max, time_multiple=16)
    multiple = 2 * n_devices  # the bucket batch granularity covers the data axis
    sizes = bucket_batch_sizes(buckets, 16 * t_max, t_max, multiple=multiple)
    _require(all(bk % n_devices == 0 for bk in sizes),
             f"bucket batch sizes {sizes} not shardable over {n_devices} ranks")
    args = dict(_GRU_DRYRUN_ARGS, batchSize=multiple, tokensPerBatch=16 * t_max,
                batchMultiple=multiple, device=str(device))
    seed = int(args["seed"])
    mesh = make_mesh(n_model=1, device=device)
    data = DeviceData(train_ds, device)

    def run(m):
        """The 8 steps from one init, on ``m``'s rows (the whole batch
        without a mesh): the losses, the envelopes, the launches."""
        model = build_model(args, N_DAYS, device, seed)
        if m is not None:
            replicated(m, list(model.parameters()))
        optimizer, scheduler = make_optimizer(args, model.parameters())
        train_step = make_train_step(args, model, optimizer, scheduler, m)
        rng = np.random.default_rng(7)  # the same batches in both runs
        before = launch_counts()
        losses, envs = [], set()
        for i in range(BUCKETED_STEPS):
            batch = sample_batch(train_ds, rng, multiple, t_max, u_max, buckets=buckets,
                                 bucket_sizes=sizes, materialize_x=False)
            envs.add((batch.t_env, len(batch.idx)))
            if m is not None:
                batch = batch_rows(train_ds, batch, batch_sharding(m, len(batch.idx)),
                                   materialize_x=False)
            metrics = train_step(data.assemble(batch), step_generator(device, seed, i))
            losses.append(float(metrics["train/loss"]))
        return losses, envs, _launches_since(before)

    losses, envs, launches = run(mesh)
    one, _, one_launches = run(None)
    for i, (a, b) in enumerate(zip(losses, one)):
        _require(bool(np.isfinite(a)) and abs(a - b) <= BUCKETED_RTOL * abs(b),
                 f"bucketed step {i}: loss {a!r} over {n_devices} ranks, {b!r} on one "
                 f"(rtol {BUCKETED_RTOL:g})")
    _require(len(envs) >= 2, f"only one bucket shape engaged: {envs}")
    name = "gru_baseline+bucketed+device-data"
    return {"name": name, "mesh": (n_devices, 1), "loss": losses[-1], "losses": losses,
            "one_rank_losses": one, "launches": launches, "one_rank_launches": one_launches,
            "line": f"dryrun_multichip OK [{name}]: mesh=({n_devices}x1) "
                    f"shapes={sorted(envs)} loss={losses[-1]:.4f}"}
