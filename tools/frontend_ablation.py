"""Where the serving frontend's tensor-core body spends its time, on the card.

Builds ``csrc/frontend.cu`` with parts of ``frontend_tc_kernel`` left out
through its ``NSD_FRONTEND_CUT`` bits: the smoothing (the A tile is the input
rows as they are), the product, the Softsign's division, the input loads
(the rows read as zeros), the output stores. A build that leaves a part out
computes wrong numbers; it is timed, never checked. The variants are built
and loaded by ``tools/_ablation.py`` and timed with CUDA events at the
serving path's shapes (B=64, T=1280, C=256, 24 days, 20 taps, bf16), beside
PR 1's FMA body of the unchanged build.

    python tools/frontend_ablation.py
"""

from __future__ import annotations

import ctypes
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from _ablation import build_variants, time_ms  # noqa: E402
from neural_speech_decoder_tpu_torch.ops.gaussian import gaussian_kernel, same_padding  # noqa: E402

# NSD_FRONTEND_CUT bits: 1 smoothing, 2 product, 4 division, 8 input loads, 16 stores
VARIANTS = {
    "as built": 0,
    "no smoothing": 1,
    "no product": 2,
    "no division": 4,
    "no input loads": 8,
    "no stores": 16,
    "no product, no division": 6,
    "no smoothing, no product, no division": 7,
    "only the loads (no smoothing, product, division, stores)": 23,
}


def main() -> int:
    if not torch.cuda.is_available():
        print("frontend_ablation: no CUDA device", file=sys.stderr)
        return 1
    libs = build_variants("frontend_ablation", ["frontend.cu"], "NSD_FRONTEND_CUT", VARIANTS)
    b, t, c, n_days, n_taps = 64, 1280, 256, 24, 20
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((b, t, c), generator=g, device=dev).to(torch.bfloat16)
    w = (torch.eye(c, device=dev) + 0.05 * torch.randn((n_days, c, c), generator=g,
                                                         device=dev)).to(torch.bfloat16)
    bias = 0.1 * torch.randn((n_days, c), generator=g, device=dev)
    day = (torch.arange(b, device=dev) % n_days).to(torch.int32)
    out = torch.empty_like(x)
    taps = gaussian_kernel(n_taps, 2.0)
    taps_c = (ctypes.c_float * n_taps)(*taps.tolist())
    pad_left, _ = same_padding(n_taps)
    P, I = ctypes.c_void_p, ctypes.c_int
    stream = lambda: P(torch.cuda.current_stream().cuda_stream)
    ptr = lambda v: P(v.data_ptr())
    print(f"{torch.cuda.get_device_name(0)}; B={b} T={t} C={c}, {n_taps} taps, bf16")
    for name, lib in libs.items():
        entries = [("tensor cores", lib.nsd_frontend_tc_bf16)]
        if name == "as built":
            entries.append(("PR 1's FMA body", lib.nsd_frontend_bf16))
        for label, fn in entries:
            fn.argtypes = [P] * 5 + [I] * 4 + [ctypes.POINTER(ctypes.c_float), I, I, P]
            call = lambda f=fn: f(ptr(x), ptr(w), ptr(bias), ptr(day), ptr(out), b, t, c,
                                  n_days, taps_c, n_taps, pad_left, stream())
            rc = call()
            if rc:
                raise RuntimeError(f"frontend_ablation: {name!r} returned CUDA error {rc}")
            print(f"{name:58s} {label}: {time_ms(call, 20):.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
