"""Move decoder weights between the JAX package and the port.

Both keep the JAX package's trees with the same array layouts:
``init_gru_params``' (``{"day": {...}, "gru": {"layers": [...]}, "fc":
{...}}``) and ``init_conformer_params``' (``day``, ``frontend``,
``bottleneck``, ``blocks`` [...], ``head`` and, with InterCTC,
``inter_out``), so conversion is a copy of each leaf. The JAX side is given
as numpy arrays (what ``jax.tree.map(np.asarray, params)`` returns); nothing
here imports jax.
"""

from __future__ import annotations

import numpy as np
import torch

from .conformer import ConformerDecoder
from .gru import GRUDecoder, Params


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def params_from_jax(tree: dict) -> Params:
    """A JAX parameter tree of numpy arrays -> the port's tree of CPU
    tensors (copies; float32 leaves stay float32)."""
    return _map(tree, lambda a: torch.from_numpy(np.array(a, copy=True)))


def params_to_numpy(module: GRUDecoder | ConformerDecoder | Params) -> dict:
    """A decoder module (or its parameter tree) -> a tree of numpy arrays in
    the JAX package's layout."""
    params = module.params if isinstance(module, torch.nn.Module) else module
    return _map(params, lambda t: t.detach().cpu().numpy())


gru_params_from_jax = conformer_params_from_jax = params_from_jax
gru_params_to_numpy = conformer_params_to_numpy = params_to_numpy
