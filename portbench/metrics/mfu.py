"""``mfu.train`` / ``mfu.decode``: model FLOPs of every train step or
request in the traced window (``portbench/flops``, no recompute) over the
window's length on the host clock times the card's float32 peak (67
TFLOP/s, TF32 off), in %. The window holds the profiler's overhead, so the
share reads that much below the untraced rate's."""

from portbench.readers import mfu


def read(run):
    return mfu(run)
