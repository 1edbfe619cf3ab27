"""Where a serving request's time goes on the card.

Runs ``InferenceModel`` at the full width of the GRU baseline (random
weights from a seed, B=64, T=1280) under ``torch.profiler`` and prints the
device time by kernel, the device's busy share of the request's wall time,
and the wall time of each stage (pad, forward, decode) from host clocks
around ``torch.cuda.synchronize()``.

    python -m neural_speech_decoder_tpu_torch.serving.profile [--dtype bfloat16]

It needs a CUDA device and fails without one.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..models.gru import GRUConfig, init_gru_params
from .model import InferenceModel

B, T = 64, 1280  # the serving envelope of chip_smoke.py


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = GRUConfig(compute_dtype=getattr(torch, args.dtype))
    params = init_gru_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    model = InferenceModel(params, cfg, "cuda", batch_size=B, t_max=T)
    rng = np.random.default_rng(0)
    trials = [rng.standard_normal((int(rng.integers(400, 1201)), cfg.neural_dim),
                                  dtype=np.float32) for _ in range(B)]
    days = [i % cfg.n_days for i in range(B)]

    def request():
        stamps = [time.perf_counter()]
        x, d, lens = model.pad_batch(trials, days)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        log_probs, out_lens = model(x, d, lens)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        model.decode(log_probs, out_lens)
        stamps.append(time.perf_counter())
        return np.diff(stamps) * 1e3

    for _ in range(2):
        request()
    stages = np.median([request() for _ in range(3)], axis=0)
    print(f"{cfg.compute_dtype} B={B} T={T} "
          f"{torch.cuda.get_device_name(0)}: pad {stages[0]:.3f} ms, "
          f"forward {stages[1]:.3f} ms, decode {stages[2]:.3f} ms")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        request()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    print(f"device busy {busy_us / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms wall "
          f"({100 * busy_us / wall_us:.1f}%)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  "
              f"{e.key[:100]}")


if __name__ == "__main__":
    main()
