"""Adam with L2 over a list of float32 leaves, updated in place, hand-written
in CUDA (``csrc/adam.cu``).

Replaces ``neural_speech_decoder_tpu/ops/pallas/adam_kernel.py``:
``adam_update`` is ``fused_adam_update``'s update of every leaf
(``adam_leaf`` -> ``_kernel``), in one launch for up to
``nsd_adam_max_leaves()`` leaves of any size (the TPU kernel takes a leaf
only when its size is a multiple of 128).

The update, per element in float32 (``_adam_math``; torch Adam's L2 and eps
outside the sqrt):

    g' = g + l2 p;  m' = b1 m + (1 - b1) g';  v' = b2 v + (1 - b2) g' g'
    p' = p - lr (m' c1) / (sqrt(v' c2) + eps)

with ``c1 = 1 / (1 - b1^t)`` and ``c2 = 1 / (1 - b2^t)`` at the update's
count ``t`` (``adam_scalars``). p, m and v are updated in place, as the JAX
package donates them to its kernel. ``adam_update`` launches the kernel for
CUDA tensors and runs ``adam_update_plain``, the same arithmetic in plain
PyTorch, for CPU tensors; it raises for any other device, a dtype other than
float32, a non-contiguous leaf or leaves on more than one device.
``adam_update.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._build import check, load_library
from .ffn import on_cuda


def adam_scalars(count: int, b1: float, b2: float) -> tuple[float, float]:
    """``(c1, c2)`` of the update after ``count`` earlier ones, in float32
    as ``fused_adam_update`` forms them from ``t = count + 1``."""
    t = np.float32(count + 1)
    one = np.float32(1.0)
    c1 = one / (one - np.float32(b1) ** t)
    c2 = one / (one - np.float32(b2) ** t)
    return float(c1), float(c2)


def adam_leaf_plain(g, p, m, v, *, lr, c1, c2, b1, b2, eps, l2) -> None:
    """One leaf's update in plain PyTorch, in place on p, m, v."""
    g = g + l2 * p
    m.copy_(b1 * m + (1.0 - b1) * g)
    v.copy_(b2 * v + (1.0 - b2) * g * g)
    p.sub_(lr * ((m * c1) / (torch.sqrt(v * c2) + eps)))


def adam_update_plain(grads, params, exp_avgs, exp_avg_sqs, **hyper) -> None:
    """``adam_update`` in plain PyTorch, leaf by leaf (on any device)."""
    for g, p, m, v in zip(grads, params, exp_avgs, exp_avg_sqs, strict=True):
        adam_leaf_plain(g, p, m, v, **hyper)


def _check_leaves(leaves) -> None:
    dev = leaves[0][1].device
    for i, quad in enumerate(leaves):
        shape = quad[1].shape
        for name, t in zip(("grad", "param", "exp_avg", "exp_avg_sq"), quad):
            if (t.dtype != torch.float32 or t.device != dev or t.shape != shape
                    or not t.is_contiguous()):
                raise ValueError(
                    f"adam_update: leaf {i}'s {name} must be a contiguous float32 "
                    f"{tuple(shape)} tensor on {dev}, got {t.dtype} "
                    f"{tuple(t.shape)} on {t.device}")


def adam_update(grads, params, exp_avgs, exp_avg_sqs, *, lr: float, c1: float,
                c2: float, b1: float, b2: float, eps: float, l2: float) -> None:
    """Update every leaf ``(g, p, m, v)`` of the four lists in place (see the
    module docstring); the scalars are passed to the kernel by value."""
    leaves = list(zip(grads, params, exp_avgs, exp_avg_sqs, strict=True))
    if not leaves:
        return
    hyper = dict(lr=lr, c1=c1, c2=c2, b1=b1, b2=b2, eps=eps, l2=l2)
    if not on_cuda("adam_update", params[0]):
        if any(t.device.type != "cpu" for quad in leaves for t in quad):
            raise ValueError("adam_update: leaves on more than one device")
        adam_update_plain(grads, params, exp_avgs, exp_avg_sqs, **hyper)
        return
    _check_leaves(leaves)
    leaves = [quad for quad in leaves if quad[1].numel() > 0]
    lib = load_library()
    cut = lib.nsd_adam_max_leaves()
    scalars = (lr, c1, c2, b1, 1.0 - b1, b2, 1.0 - b2, eps, l2)
    with torch.cuda.device(params[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        for lo in range(0, len(leaves), cut):
            chunk = leaves[lo : lo + cut]
            k = len(chunk)
            ptrs = [(ctypes.c_void_p * k)(*(quad[j].data_ptr() for quad in chunk))
                    for j in range(4)]
            sizes = (ctypes.c_longlong * k)(*(quad[1].numel() for quad in chunk))
            rc = lib.nsd_adam_f32(*ptrs, sizes, k, *scalars, stream)
            check(rc, "adam_update")
            adam_update.launches += 1


adam_update.launches = 0
