"""Parallelism on one host or several.

- Data parallelism (``mesh.py``, ``multihost.py``, ``data_parallel.py``):
  the counterparts of the JAX package's ``parallel/mesh.py`` and
  ``parallel/multihost.py`` and of its trainer's multi-device branches, as
  one process per device over ``torch.distributed`` (nccl for cards, gloo
  for the CPU): the 'data' axis, each rank's rows of the global batch, the
  gradient all-reduce, rank-0 writes and an agreed preemption
  (``training/trainer.py``).
- Task parallelism (``sweep.py``): hyperparameter sweeps over worker
  processes, each trial pinned to its cards by ``CUDA_VISIBLE_DEVICES``
  and trained data-parallel over them.

Tensor parallelism (the 'model' axis: JAX's ``parallel/shardings.py``) is
the next slice of the port, and ``parallel/kernel_mesh.py`` is TPU-only
(a Mosaic custom call has no GSPMD rule), so neither has a counterpart.
"""
