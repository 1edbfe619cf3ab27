"""Where a serving request's, or a streamed chunk's, time goes on the card.

Runs ``InferenceModel`` at the full width of the GRU baseline (random
weights from a seed, B=64, T=1280) under ``torch.profiler`` and prints the
device time by kernel, the device's busy share of the request's wall time,
and the wall time of each stage (pad, forward, decode) from host clocks
around ``torch.cuda.synchronize()``. ``--matmul`` serves with
``use_pallas_matmul`` (layers 1-4's projections on the hand GEMM, as a
flagged run's artifact does).

With ``--stream gru|conformer`` it profiles instead 50 steady 4-bin chunks
of a streaming cell (``STREAM_GRU`` or ``STREAM_CONFORMER``, B=1, bf16, one
frame a chunk, after 30 warm-up chunks), replayed as CUDA graphs and then
on the eager path, with the same readings a chunk.

    python -m neural_speech_decoder_tpu_torch.serving.profile [--dtype bfloat16] [--matmul]
    python -m neural_speech_decoder_tpu_torch.serving.profile --stream gru

It needs a CUDA device and fails without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..models.conformer import ConformerConfig, init_conformer_params
from ..models.gru import GRUConfig, init_gru_params
from ..streaming.conformer import ConformerStreamer
from ..streaming.engine import GRUStreamer
from .model import InferenceModel

B, T = 64, 1280  # the serving envelope of chip_smoke.py

# The streaming cells, bench_streaming.py's: configs/gru_streaming.yaml's
# widths (C=256, H=1024, 5 unidirectional layers, k=32, s=4, sigma 2, 41
# outputs, 24 days) and configs/conformer.yaml's with causal=True and a
# 128-frame left context; inference, so no dropout.
STREAM_GRU = GRUConfig(bidirectional=False, dropout=0.0)
STREAM_CONFORMER = ConformerConfig(dropout=0.0, drop_path_prob=0.0, head_dropout=0.0,
                                   use_spec_augment=False, causal=True,
                                   attn_left_context=128)
STREAM_CHUNK = 4  # bins a chunk: one frame at s = 4, 80 ms of data at 20 ms bins


def stream_model(kind: str, dtype: torch.dtype, seed: int = 0):
    """``(cfg, params)`` of a streaming cell (``"gru"`` or ``"conformer"``)
    in ``dtype`` compute, weights drawn on the card from ``seed``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if kind == "gru":
        cfg = dataclasses.replace(STREAM_GRU, compute_dtype=dtype)
        return cfg, init_gru_params(cfg, gen)
    cfg = dataclasses.replace(STREAM_CONFORMER, compute_dtype=dtype)
    return cfg, init_conformer_params(cfg, gen)


def make_streamer(kind: str, cfg, params, batch: int, *, day_idx: int = 0,
                  graphs: bool = True):
    """A streamer of the cell on the card, one frame a chunk."""
    cls = GRUStreamer if kind == "gru" else ConformerStreamer
    return cls(params, cfg, day_idx, batch=batch, frames_per_chunk=1, graphs=graphs)


def _print_profile(prof, wall_us: float, n: int) -> None:
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    print(f"device busy {busy_us / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms wall "
          f"({100 * busy_us / wall_us:.1f}%); a unit: busy {busy_us / n / 1e3:.4f} ms, "
          f"wall {wall_us / n / 1e3:.4f} ms")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  "
              f"{e.key[:100]}")


def profile_stream(kind: str) -> None:
    cfg, params = stream_model(kind, torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(1)
    n = 50
    for graphs in (True, False):
        st = make_streamer(kind, cfg, params, 1, graphs=graphs)
        chunks = torch.randn((8, 1, STREAM_CHUNK, st.channels), generator=g, device="cuda")
        for i in range(30):
            st.process_async(chunks[i % 8])
        torch.cuda.synchronize()
        if not st.fast_path_engaged:
            raise SystemExit(f"profile: the {kind} stream's fast path did not engage")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(n):
                st.process_async(chunks[i % 8])
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        print(f"stream {kind} bf16 B=1, {n} steady chunks, "
              f"{'one CUDA graph a chunk' if graphs else 'eager'} "
              f"({torch.cuda.get_device_name(0)}):")
        _print_profile(prof, wall_us, n)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--stream", choices=["gru", "conformer"])
    ap.add_argument("--matmul", action="store_true", help="use_pallas_matmul")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.stream:
        profile_stream(args.stream)
        return
    cfg = GRUConfig(compute_dtype=getattr(torch, args.dtype), use_pallas_matmul=args.matmul)
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
    print(f"{cfg.compute_dtype} B={B} T={T} use_pallas_matmul={cfg.use_pallas_matmul} "
          f"{torch.cuda.get_device_name(0)}: pad {stages[0]:.3f} ms, "
          f"forward {stages[1]:.3f} ms, decode {stages[2]:.3f} ms")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        request()
        wall_us = (time.perf_counter() - t0) * 1e6
    _print_profile(prof, wall_us, 1)


if __name__ == "__main__":
    main()
