"""Where a step of the port's persistent GRU scan spends its time, on the card.

Builds ``csrc/gru_scan.cu`` and ``csrc/gru_scan_bwd.cu`` with parts of a
step left out through the sources' ``NSD_SCAN_CUT`` bits (``csrc/common.cuh``):
the barrier between steps, the load of the previous state (forward) or dhp
row (backward), the products. A build that leaves a part out computes wrong
numbers; it is timed, never checked. The variants are built and loaded by
``tools/_ablation.py`` and timed with CUDA events at the recipe's shapes
(B=64, L=313, H=1024, D=2), beside the backward's dW_hh contraction alone,
in bfloat16 (the default) or float32.

    python tools/scan_ablation.py [--dtype float32]
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from _ablation import build_variants, time_ms  # noqa: E402
from neural_speech_decoder_tpu_torch.ops.kernels.gru_scan import plan_for  # noqa: E402

# NSD_SCAN_CUT bits: 1 the barrier, 2 the load, 4 the products
VARIANTS = {
    "as built": 0,
    "no barrier": 1,
    "no load": 2,
    "no barrier, no load": 3,
    "no barrier, no load, no mma": 7,
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    dtype = ap.parse_args().dtype
    if not torch.cuda.is_available():
        print("scan_ablation: no CUDA device", file=sys.stderr)
        return 1
    libs = build_variants(f"scan_ablation_{dtype}", ["gru_scan.cu", "gru_scan_bwd.cu"],
                          "NSD_SCAN_CUT", VARIANTS)
    length, d, b, h = 313, 2, 64, 1024
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    dt = getattr(torch, dtype)
    sfx = "bf16" if dtype == "bfloat16" else "f32"
    xp = torch.randn((length, d, b, 3 * h), generator=g, device=dev).to(dt)
    w = (torch.randn((d, h, 3 * h), generator=g, device=dev) / h**0.5).to(dt)
    bias = torch.zeros((d, 3 * h), device=dev)
    ys = torch.empty((length, d, b, h), device=dev, dtype=dt)
    gates = torch.empty((length, d, b, 4 * h), device=dev, dtype=dt)
    dys = torch.randn((length, d, b, h), generator=g, device=dev).to(dt)
    dxp, dhpn = torch.empty_like(xp), torch.empty_like(ys)
    dw = torch.empty((d, h, 3 * h), device=dev)
    db = torch.empty((d, 3 * h), device=dev)
    sync = torch.empty(2, dtype=torch.int32, device=dev)
    plan = plan_for(xp, h, b, d)
    P, I = ctypes.c_void_p, ctypes.c_int
    stream = lambda: P(torch.cuda.current_stream().cuda_stream)
    ptr = lambda t: P(t.data_ptr())
    print(f"{torch.cuda.get_device_name(0)}; {dtype} B={b} L={length} H={h} D={d}; {plan}")
    for name, lib in libs.items():
        scan_fn = getattr(lib, f"nsd_gru_scan_persistent_{sfx}")
        bwd_fn = getattr(lib, f"nsd_gru_bwd_persistent_{sfx}")
        dw_fn = getattr(lib, f"nsd_gru_dw_{sfx}")
        scan_fn.argtypes = [P] * 6 + [I] * 7 + [P]
        bwd_fn.argtypes = [P] * 9 + [I] * 7 + [P]
        dw_fn.argtypes = [P] * 4 + [I] * 4 + [P]
        shape = (length, d, b, h, plan.units, plan.threads)
        fwd = lambda: scan_fn(
            ptr(xp), ptr(w), ptr(bias), ptr(ys), ptr(gates), ptr(sync), *shape,
            plan.smem_fwd, stream())
        bwd = lambda: bwd_fn(
            ptr(gates), ptr(w), ptr(ys), ptr(dys), ptr(dxp), ptr(dhpn), ptr(dw), ptr(db),
            ptr(sync), *shape, plan.smem_bwd, stream())
        contraction = lambda: dw_fn(ptr(ys), ptr(dxp), ptr(dhpn), ptr(dw), length, d, b, h,
                                    stream())
        for fn in (fwd, bwd, contraction):
            rc = fn()
            if rc:
                raise RuntimeError(f"scan_ablation: {name!r} returned CUDA error {rc}")
        t_f, t_b, t_c = time_ms(fwd, 5), time_ms(bwd, 5), time_ms(contraction, 10)
        print(f"{name:30s} forward {t_f:.4f} ms ({t_f / length * 1e3:.2f} us a step); "
              f"backward {t_b:.4f} ms (recurrence {(t_b - t_c) / length * 1e3:.2f} us a "
              f"step, dW contraction {t_c:.4f} ms)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
