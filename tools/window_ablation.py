"""Where the conv module's bf16 window pass spends its time, on the card.

Builds ``csrc/conv_module.cu`` with parts of ``glu_dwconv_wide_kernel`` left
out through its ``NSD_WINDOW_CUT`` bits: the loads of hq and the GLU (the
window is zeros), the staging of the taps, the window sums. A build that
leaves a part out computes wrong numbers; it is timed, never checked. The
variants are built and loaded by ``tools/_ablation.py``. Each runs the sm90
forward (``nsd_conv_fwd_sm90``) at the recipe's shapes (B=64, T'=313,
D=1024, k=31, centred and causal), and the window
kernel's device time a call is read from ``torch.profiler``
(``training/profile.py::device_split``), beside the tile body's
``glu_dwconv_kernel`` in the as-built library.

    python tools/window_ablation.py
"""

from __future__ import annotations

import ctypes
import re
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from _ablation import build_variants  # noqa: E402
from neural_speech_decoder_tpu_torch.training.profile import device_split  # noqa: E402

# NSD_WINDOW_CUT bits: 1 the loads of hq and the GLU, 2 the taps' staging, 4 the sums
VARIANTS = {
    "as built": 0,
    "no hq loads": 1,
    "no taps staging": 2,
    "no loads": 3,
    "no sums": 4,
}


def main() -> int:
    if not torch.cuda.is_available():
        print("window_ablation: no CUDA device", file=sys.stderr)
        return 1
    libs = build_variants("window_ablation", ["conv_module.cu"], "NSD_WINDOW_CUT", VARIANTS)
    b, t, d, kw = 64, 313, 1024, 31
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    r = lambda *s, sc=1.0: sc * torch.randn(s, generator=g, device=dev)  # noqa: E731
    x = r(b, t, d).to(bf)
    params = (1.0 + r(d, sc=0.1), r(d, sc=0.1), r(d, 2 * d, sc=d**-0.5).to(bf),
              r(2 * d, sc=0.1), r(kw, d, sc=kw**-0.5), r(d, sc=0.1), 1.0 + r(d, sc=0.1),
              r(d, sc=0.1), r(d, d, sc=d**-0.5).to(bf), r(d, sc=0.1))
    seed = torch.zeros(1, dtype=torch.int32, device=dev)
    out = torch.empty_like(x)
    P, I, F, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    ptrs = [P(v.data_ptr()) for v in (x, *params, seed, out)]
    stream = lambda: P(torch.cuda.current_stream().cuda_stream)  # noqa: E731
    print(f"{torch.cuda.get_device_name(0)}; B={b} T'={t} D={d} k={kw}")
    for causal in (False, True):
        pad_l = kw - 1 if causal else kw // 2
        for name, lib in libs.items():
            lib.nsd_conv_fwd_sm90.argtypes = [P] * 14 + [I] * 5 + [F] * 2 + [P]
            lib.nsd_conv_fwd_sm90_workspace.argtypes = [I] * 4
            lib.nsd_conv_fwd_sm90_workspace.restype = LL
            lib.nsd_conv_fwd_bf16.argtypes = [P] * 14 + [I] * 5 + [F] * 2 + [P]
            lib.nsd_conv_workspace.argtypes = [I] * 6
            lib.nsd_conv_workspace.restype = LL
            bodies = {"sm90": (lib.nsd_conv_fwd_sm90, lib.nsd_conv_fwd_sm90_workspace(b, t, d, kw))}
            if name == "as built":
                bodies["tile"] = (lib.nsd_conv_fwd_bf16, lib.nsd_conv_workspace(b, t, d, kw, 1, 0))
            for body, (fn, n_ws) in bodies.items():
                ws = torch.empty(n_ws, dtype=torch.uint8, device=dev)

                def call():
                    rc = fn(*ptrs, P(ws.data_ptr()), b, t, d, kw, pad_l, 0.0, 1.0, stream())
                    if rc:
                        raise RuntimeError(f"window_ablation: {name!r} returned CUDA error {rc}")

                rows = [(re.search(r"glu_dwconv\w*", k).group(), ms)
                        for k, _, ms in device_split(call, reps=10) if "glu_dwconv" in k]
                print(f"{'causal ' if causal else 'centred'} {name:16s} {body:4s} " + ", ".join(
                    f"{k} {ms:.4f} ms" for k, ms in rows), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
