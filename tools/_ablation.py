"""What the ablation tools share: one build of the port's CUDA sources for
each variant of a cut macro, and a timer.

A tool names its sources, the macro its sources read (``NSD_*_CUT``: bits of
a kernel that a build leaves out, so that what is left can be timed; such a
build computes wrong numbers) and a table of variants, name -> bits.
``build_variants`` runs one ``nvcc`` for each variant, all started together,
into ``neural_speech_decoder_tpu_torch/_build/<tool>/``, and loads each with
ctypes; ``time_ms`` times a call with CUDA events.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from neural_speech_decoder_tpu_torch.ops.kernels._build import (  # noqa: E402
    BUILD_DIR, CSRC, NVCC_FLAGS, _nvcc)


def build_variants(tool: str, sources: list[str], macro: str, variants: dict[str, int],
                   defines: tuple[str, ...] = ()) -> dict[str, ctypes.CDLL]:
    """``{variant name: the library built with -D<macro>=<bits>}``, each
    build also with ``-D<name>`` for every name of ``defines``."""
    out_dir = BUILD_DIR / tool
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, cut in variants.items():
        so = out_dir / f"lib_cut{cut}.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-shared", f"-D{macro}={cut}", *(f"-D{d}" for d in defines),
               "-o", str(so),
               *(str(CSRC / s) for s in sources)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{tool}: nvcc failed for {name!r}:\n{out[-4000:]}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def time_ms(fn, reps: int) -> float:
    """Mean ms of ``reps`` calls of ``fn`` after one warm-up, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
