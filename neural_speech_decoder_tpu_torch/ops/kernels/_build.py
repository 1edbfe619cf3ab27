"""Build and load the port's hand-written CUDA kernels.

The ``.cu`` sources under ``neural_speech_decoder_tpu_torch/csrc/`` are
compiled with ``nvcc`` for ``sm_90a`` (H100), one ``nvcc`` per source, all
started together, and linked into one shared library with a plain C
interface, at first use, into ``neural_speech_decoder_tpu_torch/_build/``
(git-ignored). The library's name carries a hash of the sources
and flags, so an edited source builds anew and a built one is reused. The
library is loaded with ``ctypes``; every pointer and the stream are passed
as ``c_void_p``, and every entry point returns a ``cudaError_t`` (0 = ok),
except the ``*_workspace`` queries, which return the bytes of scratch a
kernel needs (the wrapper allocates it), and ``nsd_adam_max_leaves``, the
most leaves one Adam launch takes.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_PP = ctypes.POINTER(ctypes.c_void_p)
_SIGNATURES = {
    "nsd_frontend_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                         ctypes.POINTER(ctypes.c_float), _I, _I, _P],
    "nsd_gru_scan_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "nsd_gru_scan_gates_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "nsd_gru_bwd_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _P],
    "nsd_ctc_alpha": [_P, _P, _P, _P, _I, _I, _I, _P],
    "nsd_ctc_beta": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "nsd_ctc_alpha_prefetch": [_P, _P, _P, _P, _I, _I, _I, _P],
    "nsd_ctc_beta_prefetch": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "nsd_attn_fwd_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _I, _P],
    "nsd_attn_bwd_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _F, _F, _F, _I, _P],
    "nsd_attn_dropout_masks": [_P, _P, _I, _I, _F, _P],
    "nsd_ffn_fwd_f32": [_P] * 10 + [_I] * 4 + [_F] * 3 + [_P],
    "nsd_ffn_bwd_f32": [_P] * 16 + [_I] * 4 + [_F] * 3 + [_P],
    "nsd_ffn_dropout_masks": [_P, _P, _P, _I, _I, _I, _I, _F, _P],
    "nsd_conv_fwd_f32": [_P] * 14 + [_I] * 5 + [_F] * 2 + [_P],
    "nsd_conv_bwd_f32": [_P] * 24 + [_I] * 5 + [_F] * 2 + [_P],
    "nsd_ffn_bwd_sm90": [_P] * 16 + [_I] * 6 + [_F] * 3 + [_P],
    "nsd_conv_bwd_sm90": [_P] * 24 + [_I] * 7 + [_F] * 2 + [_P],
    "nsd_ffn_fwd_sm90": [_P] * 10 + [_I] * 4 + [_F] * 3 + [_P],
    "nsd_conv_fwd_sm90": [_P] * 14 + [_I] * 5 + [_F] * 2 + [_P],
    "nsd_adam_max_leaves": [],
    "nsd_adam_f32": [_PP] * 4 + [ctypes.POINTER(ctypes.c_longlong), _I] + [_F] * 9 + [_P],
    "nsd_matmul_f32": [_P] * 5 + [_I] * 4 + [_P],
    "nsd_matmul_sm90_bf16": [_P] * 4 + [_I] * 4 + [_P],
    "nsd_matmul_pipelined_f32": [_P] * 4 + [_I] * 4 + [_P],
    "nsd_gru_scan_persistent_bf16": [_P] * 6 + [_I] * 7 + [_P],
    "nsd_gru_bwd_persistent_bf16": [_P] * 9 + [_I] * 7 + [_P],
    "nsd_gru_dw_bf16": [_P] * 4 + [_I] * 4 + [_P],
    "nsd_device_limits": [ctypes.POINTER(_I)] * 2,
}
for _name in ("frontend", "gru_scan", "gru_scan_gates", "gru_bwd", "attn_fwd",
              "attn_bwd", "ffn_fwd", "ffn_bwd", "conv_fwd", "conv_bwd", "matmul"):
    _SIGNATURES[f"nsd_{_name}_bf16"] = _SIGNATURES[f"nsd_{_name}_f32"]
_SIGNATURES["nsd_frontend_tc_bf16"] = _SIGNATURES["nsd_frontend_f32"]
# workspace sizes in bytes -> long long: (b, t, d, f or k, bf16, bwd), (b, t,
# d, f or k) for the sm90 forwards, (b, t, d, f or k, dW2 splits, dW1 splits)
# for the sm90 backwards, and (kind, rows, cols, red) for the matmul
_SIZES = {"nsd_ffn_workspace": [_I] * 6, "nsd_conv_workspace": [_I] * 6,
          "nsd_ffn_fwd_sm90_workspace": [_I] * 4, "nsd_conv_fwd_sm90_workspace": [_I] * 4,
          "nsd_ffn_bwd_sm90_workspace": [_I] * 6, "nsd_conv_bwd_sm90_workspace": [_I] * 6,
          "nsd_matmul_workspace": [_I] * 4}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        Path(home) / "bin" / "nvcc" if home else None,
        shutil.which("nvcc"),
        Path("/usr/local/cuda/bin/nvcc"),
    ):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_DIR / f"libnsd_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the library for them exists already:
    one ``nvcc -c`` per source, all running at once, then one link. The
    compiler's report (``-Xptxas -v``: registers, shared memory, spills per
    kernel) is kept beside the library as ``<name>.log``."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(Path(work) / f"{src.stem}.o"),
                 str(src)] for src in _sources()]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        outs = [p.communicate()[0] for p in procs]
        link = [nvcc, "-shared", "-o", str(Path(work) / "lib.so"),
                *(c[c.index("-o") + 1] for c in cmds)]
        failed = [(" ".join(c), p.returncode, o)
                  for c, p, o in zip(cmds, procs, outs) if p.returncode]
        log = [" ".join(c) + "\n" + o for c, o in zip(cmds, outs)]
        if not failed:
            proc = subprocess.run(link, capture_output=True, text=True)
            log.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode:
                failed.append((" ".join(link), proc.returncode,
                               proc.stdout + proc.stderr))
        so.with_suffix(".log").write_text("".join(log))
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{c} ({rc}):\n{o}" for c, rc, o in failed))
        # atomic: a concurrent loader sees all or nothing
        os.replace(Path(work) / "lib.so", so)
    return so


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, then load the library once per process."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    for name, argtypes in _SIZES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_longlong
    lib.nsd_error_string.argtypes = [ctypes.c_int]
    lib.nsd_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if rc != 0:
        msg = load_library().nsd_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
