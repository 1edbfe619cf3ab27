"""Move GRU decoder weights between the JAX package and the port.

Both keep ``init_gru_params``' tree (``{"day": {...}, "gru": {"layers":
[...]}, "fc": {...}}``) with the same array layouts, so conversion is a
copy of each leaf. The JAX side is given as numpy arrays (what
``jax.tree.map(np.asarray, params)`` returns); nothing here imports jax.
"""

from __future__ import annotations

import numpy as np
import torch

from .gru import GRUDecoder, Params


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def gru_params_from_jax(tree: dict) -> Params:
    """A JAX parameter tree of numpy arrays -> the port's tree of CPU
    tensors (copies; float32 leaves stay float32)."""
    return _map(tree, lambda a: torch.from_numpy(np.array(a, copy=True)))


def gru_params_to_numpy(module: GRUDecoder | Params) -> dict:
    """A ``GRUDecoder`` (or its parameter tree) -> a tree of numpy arrays in
    the JAX package's layout."""
    params = module.params if isinstance(module, GRUDecoder) else module
    return _map(params, lambda t: t.detach().cpu().numpy())
