"""Task parallelism on one host: hyperparameter sweeps over worker
processes (``sweep.py``), each trial pinned to its cards by
``CUDA_VISIBLE_DEVICES``. The JAX package's mesh, shardings and multi-host
staging have no counterpart here (the port trains on one device)."""
