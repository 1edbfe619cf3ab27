#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's serving path (``neural_speech_decoder_tpu_torch``) once,
at the full width of ``neural_speech_decoder_tpu/configs/gru_baseline.yaml``
with seeded random weights:

1. Device: requires CUDA, prints the card's name and power limit, the torch
   and CUDA versions, and builds the kernels from ``csrc/``.
2. Kernels: each hand-written kernel against its plain PyTorch version on
   the card at the serving path's shapes, in float32 and bfloat16, with
   the max abs error, the tolerance, and both times.
3. Serving: ``InferenceModel`` answers 3 float32 requests of random
   trials (pad -> forward -> greedy decode); checks finite log-probs, empty
   decodes for padded rows, the kernels' launch counts, and the float32
   logits against the same model run through the plain versions; prints
   the median request latency and sequences per second. Then one request
   in the recipe's bfloat16 compute, with the same checks.

Run from the repository root:  python3 chip_smoke.py
It imports no jax. It exits non-zero without a result when there is no
CUDA device or any check fails; otherwise its last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from neural_speech_decoder_tpu_torch.models.common import orthogonal, uniform_bound
from neural_speech_decoder_tpu_torch.models.gru import GRUConfig, init_gru_params
from neural_speech_decoder_tpu_torch.ops.kernels import _build
from neural_speech_decoder_tpu_torch.ops.kernels.frontend import (
    fused_frontend,
    fused_frontend_plain,
)
from neural_speech_decoder_tpu_torch.ops.kernels.gru_scan import (
    gru_sequence,
    gru_sequence_plain,
)
from neural_speech_decoder_tpu_torch.serving.model import InferenceModel

# The serving path's shapes: B=64 trials in a T=1280 envelope, C=256
# channels, 24 days, H=1024, both directions, L=(1280-32)//4+1=313 frames.
B, T, C, N_DAYS, H, D = 64, 1280, 256, 24, 1024, 2
L = (T - 32) // 4 + 1
N_OUT = 41  # 40 phoneme classes and the CTC blank

# Max abs error allowed between a kernel and its plain version on the same
# inputs. Both accumulate in float32 but in different orders (the plain
# versions sum through cuBLAS/cuDNN), so float32 differs by rounding only.
# In bfloat16 such a difference can flip the rounding of a stored value by
# one bf16 step (2**-8 = 0.0039 just below 1.0; the outputs lie in (-1, 1)),
# and in the scan a flipped h feeds the later steps.
TOL = {
    ("frontend", "float32"): 1e-5,
    ("frontend", "bfloat16"): 1.6e-2,  # four bf16 steps near 1.0
    ("gru_scan", "float32"): 1e-4,  # 313 steps of H=1024-long sums
    ("gru_scan", "bfloat16"): 3e-2,
}
# float32 logits of the full model, kernel path vs plain path: five layers
# of 313-step scans and 6144-wide products over rounding-level differences.
LOGITS_TOL = 2e-3
# bfloat16 logits, kernel path vs plain path: each is a bf16 rounding of
# the same float32 function, so the two may differ by up to the sum of their
# distances from it. The plain bf16 path's distance from the plain float32
# path, measured on the same request, stands for each; the bound is twice it.
BF16_LOGITS_FACTOR = 2.0

SOURCES = {
    "frontend": ("neural_speech_decoder_tpu_torch/csrc/frontend.cu",
                 "neural_speech_decoder_tpu/ops/pallas/frontend_kernel.py:56"),
    "gru_scan": ("neural_speech_decoder_tpu_torch/csrc/gru_scan.cu",
                 "neural_speech_decoder_tpu/ops/pallas/gru_scan.py:58"),
}

failures: list[str] = []


def check(ok: bool, what: str) -> None:
    print(("ok    " if ok else "FAIL  ") + what, flush=True)
    if not ok:
        failures.append(what)


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(name, kernel, plain, reps_kernel, reps_plain) -> dict:
    """Kernel vs plain on the same inputs in float32 and bfloat16; times
    taken in turns (plain, kernel, kernel, plain) in float32."""
    row = {}
    for dtype in ("float32", "bfloat16"):
        with torch.inference_mode():
            err = (kernel(dtype).float() - plain(dtype).float()).abs().max().item()
        torch.cuda.synchronize()
        tol = TOL[(name, dtype)]
        check(err <= tol, f"{name} {dtype}: max abs err {err:.3e} <= {tol:.2g}")
        row.setdefault("max_abs_err", err)
    with torch.inference_mode():
        p1 = time_ms(lambda: plain("float32"), reps_plain)
        k1 = time_ms(lambda: kernel("float32"), reps_kernel)
        k2 = time_ms(lambda: kernel("float32"), reps_kernel)
        p2 = time_ms(lambda: plain("float32"), reps_plain)
        kb = time_ms(lambda: kernel("bfloat16"), reps_kernel)
        pb = time_ms(lambda: plain("bfloat16"), reps_plain)
    row["ms"] = (k1 + k2) / 2
    row["plain_ms"] = (p1 + p2) / 2
    print(f"time  {name} float32: kernel {k1:.4f}/{k2:.4f} ms, plain "
          f"{p1:.4f}/{p2:.4f} ms; bfloat16: kernel {kb:.4f} ms, plain "
          f"{pb:.4f} ms", flush=True)
    return row


def kernel_phase() -> list[dict]:
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((B, T, C), generator=g, device="cuda")
    day_w = (torch.eye(C, device="cuda")
             + 0.05 * torch.randn((N_DAYS, C, C), generator=g, device="cuda"))
    day_b = 0.1 * torch.randn((N_DAYS, C), generator=g, device="cuda")
    # -1 and 24 lie outside the table and must be clipped to 0 and 23
    day = (torch.arange(B, device="cuda") % (N_DAYS + 2) - 1).to(torch.int32)
    xs = {k: x.to(v) for k, v in dt.items()}
    fe = dict(kernel_size=20, sigma=2.0)
    front = compare(
        "frontend",
        lambda d: fused_frontend(xs[d], day_w, day_b, day, **fe),
        lambda d: fused_frontend_plain(xs[d], day_w, day_b, day, **fe),
        reps_kernel=20, reps_plain=20,
    )
    xp = torch.randn((L, D, B, 3 * H), generator=g, device="cuda")
    w_hh = torch.stack([orthogonal((3 * H, H), g).T for _ in range(D)])
    b_hh = uniform_bound((D, 3 * H), 1 / H**0.5, g)
    xps = {k: xp.to(v) for k, v in dt.items()}
    scan = compare(
        "gru_scan",
        lambda d: gru_sequence(xps[d], w_hh, b_hh),
        lambda d: gru_sequence_plain(xps[d], w_hh, b_hh),
        reps_kernel=3, reps_plain=2,
    )
    return [front, scan]


def check_request(tag: str, n: int, log_probs, out_lens, decoded) -> None:
    check(tuple(log_probs.shape) == (B, L, N_OUT)
          and bool(torch.isfinite(log_probs).all()),
          f"{tag} request of {n}: log-probs {tuple(log_probs.shape)} finite")
    check(bool((out_lens[n:] == 0).all())
          and all(r == [] for r in decoded[n:])
          and bool((out_lens[:n] > 0).all()),
          f"{tag} request of {n}: {B - n} padded rows decode empty, "
          f"{n} real rows have frames")


def reset_launches() -> None:
    fused_frontend.launches = 0
    gru_sequence.launches = 0


def read_launches() -> dict:
    return {"frontend": fused_frontend.launches,
            "gru_scan": gru_sequence.launches}


def serving_phase(card: str) -> dict:
    cfg = GRUConfig(
        neural_dim=C, n_classes=N_OUT - 1, hidden_dim=H, num_layers=5, n_days=N_DAYS,
        stride_len=4, kernel_len=32, gaussian_smooth_width=2.0,
        bidirectional=True, compute_dtype=torch.float32,
    )
    params = init_gru_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    model = InferenceModel(params, cfg, "cuda", batch_size=B, t_max=T)
    sizes = [B, 41, B]  # the second request leaves 23 padded rows
    rng = np.random.default_rng(0)
    # Gaussian trials of 400-1200 bins, the recipe's range of trial lengths
    trials = [rng.standard_normal((int(rng.integers(400, 1201)), C),
                                  dtype=np.float32)
              for _ in range(sum(sizes) + B)]
    days = [i % N_DAYS for i in range(len(trials))]

    def request(m, lo, n):
        x, dd, lens = m.pad_batch(trials[lo : lo + n], days[lo : lo + n])
        log_probs, out_lens = m(x, dd, lens)
        return x, dd, log_probs, out_lens, m.decode(log_probs, out_lens)

    request(model, sum(sizes), B)  # warm-up, not counted
    torch.cuda.synchronize()
    reset_launches()
    results, latencies, lo = [], [], 0
    for n in sizes:
        t0 = time.perf_counter()
        results.append(request(model, lo, n))
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
        lo += n
    launches = read_launches()
    check(launches == {"frontend": 3, "gru_scan": 15},
          f"launches over 3 requests {launches} == 1 frontend and "
          f"{cfg.num_layers} scans per request")
    for n, (_, _, log_probs, out_lens, decoded) in zip(sizes, results):
        check_request("float32", n, log_probs, out_lens, decoded)

    x, dd = results[0][0], results[0][1]
    with torch.inference_mode():
        logits = model.module(x, dd)
        logits_plain = model.module(x, dd, plain=True)
    err = (logits - logits_plain).abs().max().item()
    check(err <= LOGITS_TOL,
          f"full-width float32 logits, kernels vs plain: max abs err "
          f"{err:.3e} <= {LOGITS_TOL:.2g}")

    med = statistics.median(latencies)
    seq_s = sum(sizes) / sum(latencies)
    print(f"serving float32 B={B} T={T}, 3-request smoke reading: latencies "
          f"{', '.join(f'{s * 1e3:.2f}' for s in latencies)} ms, median "
          f"{med * 1e3:.2f} ms, {seq_s:.2f} seq/s ({card})", flush=True)

    # The recipe's bfloat16 compute (configs/gru_baseline.yaml) on the same
    # weights, for the second request's trials (23 padded rows).
    model16 = InferenceModel(
        params, dataclasses.replace(cfg, compute_dtype=torch.bfloat16), "cuda",
        batch_size=B, t_max=T,
    )
    lo, n = sizes[0], sizes[1]
    request(model16, lo, n)  # warm-up, not counted
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    x, dd, log_probs, out_lens, decoded = request(model16, lo, n)
    torch.cuda.synchronize()
    latency = time.perf_counter() - t0
    launches16 = read_launches()
    check(launches16 == {"frontend": 1, "gru_scan": cfg.num_layers},
          f"bfloat16 request launches {launches16} == 1 frontend and "
          f"{cfg.num_layers} scans")
    check_request("bfloat16", n, log_probs, out_lens, decoded)
    with torch.inference_mode():
        logits = model16.module(x, dd)
        logits_plain = model16.module(x, dd, plain=True)
        logits_f32 = model.module(x, dd, plain=True)
    err = (logits - logits_plain).abs().max().item()
    dist = (logits_plain - logits_f32).abs().max().item()
    tol = BF16_LOGITS_FACTOR * dist
    check(err <= tol,
          f"full-width bfloat16 logits, kernels vs plain: max abs err "
          f"{err:.3e} <= {tol:.3e} ({BF16_LOGITS_FACTOR:g} x the plain bf16 "
          f"path's distance {dist:.3e} from float32)")
    print(f"serving bfloat16 B={B} T={T}: one request of {n} trials "
          f"{latency * 1e3:.2f} ms ({card})", flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)
    # Full float32 in the plain versions' products and convolutions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    so = _build.build()
    _build.load_library()
    print(f"built {so.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in so.with_suffix(".log").read_text().splitlines():
        if "Used" in line or "spill" in line:
            print("ptxas " + line.strip(), flush=True)

    rows = kernel_phase()
    launches = serving_phase(card)
    out = []
    for name, row in zip(("frontend", "gru_scan"), rows):
        source, replaces = SOURCES[name]
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": launches[name], **row})
    print(json.dumps({"kernels": out}), flush=True)
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
