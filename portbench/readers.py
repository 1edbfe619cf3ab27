"""The reductions the per-layer metrics share: a span's mean, the device's
idle share, the whole step's share of the card's float32 peak, and a
kernel family's share of its roofline over the port's own kernels of that
family. Each returns None where its run has nothing to read, and the metric
is then left out of the line."""

from __future__ import annotations

import importlib
import re

from .flops import peaks


def family_flops(run):
    """``portbench/flops/<family>.py`` of the run's configuration."""
    return importlib.import_module(f"portbench.flops.{run.config['family']}")


def span_ms(run, name: str):
    times = run.spans.get(name)
    return 1e3 * sum(times) / len(times) if times else None


def idle_share(run):
    tl = run.timeline
    if tl is None or tl.window_s <= 0:
        return None
    return 100.0 * (1.0 - tl.busy_s() / tl.window_s)


def model_flops(run) -> float:
    """The model FLOPs of every unit of the window (a train step counts
    its forward three times: the forward and the backward's two
    products)."""
    fam = family_flops(run)
    b, t = run.mix["batch"], run.mix["t_envelope"]
    train = run.kind == "train"
    total = sum(fam.forward_flops(run.config, b, t, unit_out_lens(run, lens), train)
                for lens in run.lens)
    return total * (3.0 if train else 1.0)


def unit_out_lens(run, lens):
    """A unit's CTC frame counts, ``(len - k) / s`` truncated, at least 0."""
    a = run.config["args"]
    k = a.get("temporal_kernel", a.get("kernelLen"))
    s = a.get("temporal_stride", a.get("strideLen"))
    return [max(int((n - k) / s), 0) for n in lens]


def mfu(run):
    """Model FLOPs over the traced window's host-clock length times the
    float32 peak; the profiler's own cost is in that window, so this reads
    low by the tracing overhead (PERF.md)."""
    tl = run.timeline
    if tl is None or not run.units:
        return None
    return 100.0 * model_flops(run) / (tl.window_s * peaks.PEAK_FLOPS["float32"])


PORT_NAMESPACES = ("nsd", "{anon}")


def kernel_path(name: str) -> list[str]:
    """A demangled kernel name's qualified name, split at ``::``:
    ``void nsd::f32::gemm_f32_kernel<...>(...)`` -> ``["nsd", "f32",
    "gemm_f32_kernel"]``; a source file's anonymous namespace is ``"{anon}"``;
    a library kernel's plain symbol is one part."""
    name = name.removeprefix("void ").replace("(anonymous namespace)", "{anon}")
    return re.split(r"[<(]", name, maxsplit=1)[0].split("::")


def port_kernels(*prefixes: str):
    """A match for the port's own kernels, those in namespace ``nsd`` or in
    a source file's anonymous namespace, whose own name starts with one of
    ``prefixes``. Library kernels never match, whatever their names hold:
    cuBLAS's ``sm80_xmma_gemm_f32f32_...``, cuDNN's
    ``..._implicit_gemm_f32f32_...``, CUTLASS's, PyTorch's ``at::native``."""
    def match(name: str) -> bool:
        path = kernel_path(name)
        return len(path) > 1 and path[0] in PORT_NAMESPACES and path[-1].startswith(prefixes)
    return match



def roofline(run, bound_s: float, match):
    """``bound_s`` (the least time of the family's work over the window)
    over the device time of the kernels ``match`` accepts, in %."""
    if run.timeline is None:
        return None
    t = run.timeline.kernel_time_s(match)
    if t <= 0:
        return None
    return 100.0 * bound_s / t
