"""This rank's rows of a global batch, and the random draws made for them.

Under data parallelism each rank holds the contiguous rows ``[start, start
+ n)`` of a global batch of ``total`` rows (the JAX package's batch
sharding, ``parallel/mesh.py``). JAX draws its noise, dropout and DropPath
for the global array, so a data-parallel step draws what a single-device
step draws. The port does the same: every draw whose shape has the batch
axis is made at the global shape from the step's generator and sliced to
the rank's rows (``draw_rows``), which also keeps the generator's call
order and offsets the same on every rank and at every world size. Draws
without a batch axis (SpecAugment's uniforms, the kernels' dropout seeds)
are made as they are.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class BatchShard:
    """Rows ``[start, start + n)`` of a global batch of ``total`` rows,
    held by shard ``index`` of ``count`` (the rank and the world size)."""

    start: int
    total: int
    index: int = 0
    count: int = 1


def draw_rows(draw: Callable[[tuple], torch.Tensor], shape: tuple,
              shard: BatchShard | None) -> torch.Tensor:
    """``draw(shape)`` for ``shape[0]`` rows of the batch: with a shard,
    ``draw`` at the global batch shape, then the shard's rows of it."""
    shape = tuple(shape)
    if shard is None:
        return draw(shape)
    full = draw((shard.total,) + shape[1:])
    return full[shard.start:shard.start + shape[0]]
