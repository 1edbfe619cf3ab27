"""Parallelism on one host or several.

- Data parallelism (``mesh.py``, ``multihost.py``, ``data_parallel.py``):
  the counterparts of the JAX package's ``parallel/mesh.py`` and
  ``parallel/multihost.py`` and of its trainer's multi-device branches, as
  one process per device over ``torch.distributed`` (nccl for cards, gloo
  for the CPU): the 'data' axis, each rank's rows of the global batch, the
  gradient all-reduce, rank-0 writes and an agreed preemption
  (``training/trainer.py``).
- Tensor parallelism (``shardings.py``, ``tensor_parallel.py``): JAX's
  ``parallel/shardings.py`` rules over the 'model' axis of the same grid
  (``mesh.py``: rank r at ``(d, m) = divmod(r, n_model)``), each rank
  holding its shard of the large GRU and Conformer weights and calling the
  collectives that XLA's GSPMD inserts in JAX (``models/gru.py``,
  ``models/conformer.py``).
- The multichip contract (``dryrun.py``): ``dryrun_multichip(n)``, one
  sharded train step of each model family over an n-rank grid and a
  bucketed data-parallel run against one rank (the JAX package's
  ``__graft_entry__.py::dryrun_multichip``).
- Task parallelism (``sweep.py``): hyperparameter sweeps over worker
  processes, each trial pinned to its cards by ``CUDA_VISIBLE_DEVICES``
  and trained data-parallel over them.

``parallel/kernel_mesh.py`` is TPU-only (a Mosaic custom call has no GSPMD
rule, so JAX maps its kernels over the mesh by hand): a port rank calls its
kernels on its own shard, so it has no counterpart.
"""
