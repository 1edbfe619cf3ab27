"""Random weights drawn on the device from the run's seed.

A family's reference module lists its parameter leaves (``leaf_specs``):
a path in the parameter tree the port's decoders take, a shape and an
initializer. ``draw`` makes them all from one uniform draw on the device
(one call of ``torch.rand`` for the whole model, carved into the leaves),
float32, and returns the tree. The benchmark hands the same tree to the
program and, drawn again after the window, to the reference.
"""

from __future__ import annotations

import math

import torch

from . import seeds


def uniform(*shape, bound: float):
    """A leaf ``U(-bound, bound)``."""
    return {"shape": tuple(shape), "init": "uniform", "bound": float(bound)}


def const(*shape, value: float):
    return {"shape": tuple(shape), "init": "const", "value": float(value)}


def eye_plus(n_days: int, dim: int, bound: float):
    """``n_days`` identity matrices, each plus ``U(-bound, bound)``."""
    return {"shape": (n_days, dim, dim), "init": "eye_plus", "bound": float(bound)}


def linear(din: int, dout: int, zero_bias: bool = False) -> dict:
    """torch ``nn.Linear``'s default: ``w [din, dout]`` and ``b [dout]``
    ``U(-1/sqrt(din), 1/sqrt(din))``."""
    bound = 1.0 / math.sqrt(din)
    return {"w": uniform(din, dout, bound=bound),
            "b": const(dout, value=0.0) if zero_bias else uniform(dout, bound=bound)}


def _leaves(tree, path=()):
    if isinstance(tree, dict) and "init" not in tree:
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _build(tree, made):
    if isinstance(tree, dict) and "init" not in tree:
        return {k: _build(v, made) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_build(v, made) for v in tree]
    return made[id(tree)]


def draw(specs, seed: int, device) -> dict:
    """The tree of ``specs`` with every leaf drawn from ``seed`` on
    ``device`` (float32, contiguous)."""
    leaves = list(_leaves(specs))
    sizes = [math.prod(s["shape"]) for _, s in leaves if s["init"] != "const"]
    gen = torch.Generator(device=device).manual_seed(seeds.derive(seed, "weights"))
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    made, at = {}, 0
    for _, s in leaves:
        shape = s["shape"]
        if s["init"] == "const":
            made[id(s)] = torch.full(shape, s["value"], device=device)
            continue
        n = math.prod(shape)
        t = (flat[at:at + n] * (2.0 * s["bound"]) - s["bound"]).reshape(shape)
        at += n
        if s["init"] == "eye_plus":
            t = t + torch.eye(shape[-1], device=device)
        made[id(s)] = t.contiguous()
    return _build(specs, made)


def leaf_paths(tree, path=()) -> list[tuple[tuple, torch.Tensor]]:
    """``(path, tensor)`` of every leaf of a drawn tree, in tree order."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in leaf_paths(v, path + (k,))]
    if isinstance(tree, list):
        return [kv for i, v in enumerate(tree) for kv in leaf_paths(v, path + (i,))]
    return [(path, tree)]
