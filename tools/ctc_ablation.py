"""Where a frame of the port's CTC recursions spends its time, on the card.

Builds ``csrc/ctc.cu`` with parts of its prefetch and warp bodies left out
through its ``NSD_CTC_CUT`` bits: the lpz loads (a value made from the frame
index instead), the per-frame stores of alpha or beta (only the last
frame's states are stored), the log-adds (``logsum3`` becomes the maximum
of its operands). With loads and stores out, what is left is the
recursion's serial floor: its T dependent frames of exchanges and log-adds.
A build that leaves a part out computes wrong numbers; it is timed, never
checked. The variants are built by ``tools/_ablation.py``, all with the
warp body (``NSD_CTC_WARP``: one warp a row, K = ceil(S/32) states a lane,
no barrier; the library is built without it), and timed with CUDA events
at the train step's shapes (T=313, B=64, U=64, S=129) and at S = 31, 65,
193 and 255, so that a frame's time can be read against the states a lane
or a thread carries. The unchanged build also runs the block body, and
checks that the warp and prefetch bodies give its bits.

    python tools/ctc_ablation.py
"""

from __future__ import annotations

import ctypes
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from _ablation import build_variants, time_ms  # noqa: E402

from neural_speech_decoder_tpu_torch.ops.kernels.ctc import prepare  # noqa: E402

# NSD_CTC_CUT bits: 1 the lpz loads, 2 the per-frame stores, 4 the log-adds
VARIANTS = {
    "as built": 0,
    "no loads": 1,
    "no stores": 2,
    "no loads, no stores (serial floor)": 3,
    "no log-adds": 4,
    "no log-adds, no loads, no stores": 7,
}
SWEEP_U = (15, 32, 64, 96, 127)  # S = 31, 65, 129, 193, 255


def _inputs(t_max, b, u, k=41):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    logits = torch.randn((b, t_max, k), generator=g, device=dev)
    labels = torch.randint(1, k, (b, u), generator=g, device=dev)
    label_lens = torch.full((b,), u, device=dev)  # every state live
    input_lens = torch.full((b,), t_max, device=dev)  # every frame live
    _, lpz, _, skip, s_end, lens = prepare(logits, labels, label_lens, input_lens)
    return lpz, skip, s_end, lens


def main() -> int:
    if not torch.cuda.is_available():
        print("ctc_ablation: no CUDA device", file=sys.stderr)
        return 1
    libs = build_variants("ctc_ablation", ["ctc.cu"], "NSD_CTC_CUT", VARIANTS,
                          defines=("NSD_CTC_WARP",))
    t_max, b = 313, 64
    inputs = {2 * u + 1: _inputs(t_max, b, u) for u in SWEEP_U}
    P, I = ctypes.c_void_p, ctypes.c_int
    stream = lambda: P(torch.cuda.current_stream().cuda_stream)  # noqa: E731
    ptr = lambda t: P(t.data_ptr())  # noqa: E731
    print(f"{torch.cuda.get_device_name(0)}; T={t_max} B={b}, all rows of length T; "
          f"ms a recursion (ns a frame)")
    for name, lib in libs.items():
        for what, n_ptr in (("alpha", 4), ("beta", 5)):
            for suffix in ("", "_prefetch", "_warp"):
                getattr(lib, f"nsd_ctc_{what}{suffix}").argtypes = [P] * n_ptr + [I] * 3 + [P]
        for n_states, (lpz, skip, s_end, lens) in inputs.items():
            args = {"alpha": (ptr(lpz), ptr(skip), ptr(lens)),
                    "beta": (ptr(lpz), ptr(skip), ptr(lens), ptr(s_end))}
            bodies = ["warp", "prefetch"]
            if name == "as built":
                bodies.append("block")  # NSD_CTC_CUT leaves the block body as it is
            times = []
            for what in ("alpha", "beta"):
                outs = {}
                for body in bodies:
                    fn = getattr(lib, f"nsd_ctc_{what}" + ("" if body == "block" else f"_{body}"))
                    out = outs[body] = torch.empty_like(lpz)
                    call = lambda f=fn, w=what, o=out: f(*args[w], ptr(o), t_max, b, n_states,
                                                         stream())
                    rc = call()
                    if rc:
                        raise RuntimeError(f"ctc_ablation: {name!r} {what} {body} returned "
                                           f"CUDA error {rc}")
                    ms = time_ms(call, 50)
                    times.append(f"{what} {body} {ms:.4f} ({ms / t_max * 1e6:.1f})")
                if name == "as built":
                    same = [torch.equal(outs[body], outs["block"]) for body in ("warp", "prefetch")]
                    if not all(same):
                        raise RuntimeError(f"ctc_ablation: {what} at S={n_states}: warp, "
                                           f"prefetch bit-equal to the block body {same}")
            print(f"{name:36s} S={n_states:3d} (K={-(-n_states // 32)}) " + "; ".join(times),
                  flush=True)
        if name == "as built":
            print("as built: the warp and prefetch bodies bit-equal to the block body at every S",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
