"""Where a train step's time goes on the card.

Runs ``make_train_step`` at bench.py's shapes and its ``GRU_ARGS`` (the GRU
baseline at full width) or ``CONFORMER_ARGS`` (the Conformer at full
width: 8 blocks, D=1024, 8 heads, FF 2048, label smoothing, InterCTC,
AdamW), B=64, T=1280, U=64, bfloat16 compute, dropout and noise on, random
weights and batch from a seed, under ``torch.profiler`` and prints the
device time by kernel, the device's busy share of the steps' wall time,
and the host-clock time of each step.

    python -m neural_speech_decoder_tpu_torch.training.profile \
        [--model gru|conformer] [--dtype float32] [--fused]

``--fused`` sets the model's opt-in kernel flags: for the GRU
``fused_optimizer`` and ``use_pallas_matmul`` (Adam and the layer 1-4
projections on their hand-written kernels), for the Conformer ``fused_ffn``
and ``fused_conv`` (the FF and conv modules through their fused kernels).

It needs a CUDA device and fails without one.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..data.batching import Batch
from ..models.api import build_model
from .optim import make_optimizer
from .trainer import batch_tensors, make_train_step, step_generator

# bench.py's GRU_ARGS: the recipe (configs/gru_baseline.yaml) at 24 days
BENCH_ARGS = {
    "model_type": "gru_baseline",
    "nInputFeatures": 256,
    "nClasses": 40,
    "nUnits": 1024,
    "nLayers": 5,
    "dropout": 0.4,
    "strideLen": 4,
    "kernelLen": 32,
    "gaussianSmoothWidth": 2.0,
    "bidirectional": True,
    "whiteNoiseSD": 0.8,
    "constantOffsetSD": 0.2,
    "lrStart": 0.02,
    "lrEnd": 0.02,
    "l2_decay": 1e-5,
    "nBatch": 10000,
    "seed": 0,
    "compute_dtype": "bfloat16",
    "watch_log_freq": 0,
}
# bench.py's CONFORMER_ARGS: the Conformer's defaults (configs/conformer.yaml's
# widths) with its recipe's loss and optimizer
CONFORMER_ARGS = {
    "model_type": "transformer_ctc",
    "nInputFeatures": 256,
    "nClasses": 40,
    "gaussianSmoothWidth": 2.0,
    "whiteNoiseSD": 1.0,
    "constantOffsetSD": 0.2,
    "lrStart": 4e-4,
    "lrEnd": 4e-4,
    "l2_decay": 1e-3,
    "nBatch": 15000,
    "seed": 0,
    "compute_dtype": "bfloat16",
    "watch_log_freq": 0,
    "label_smoothing": 0.1,
    "optimizer": "adamw",
}
N_DAYS = 24
# --fused: each model's opt-in kernel flags
FUSED_FLAGS = {"gru": {"fused_optimizer": True, "use_pallas_matmul": True},
               "conformer": {"fused_ffn": True, "fused_conv": True}}


def bench_batch(
    b: int = 64, t: int = 1280, u: int = 64, c: int = 256, seed: int = 0
) -> Batch:
    """bench.py's random batch: Gaussian features, labels in [1, 40],
    lengths of 400-1280 bins and 20-64 labels, days in [0, 24)."""
    rng = np.random.default_rng(seed)
    return Batch(
        x=rng.standard_normal((b, t, c)).astype(np.float32),
        y=rng.integers(1, 41, size=(b, u)).astype(np.int32),
        x_lens=rng.integers(min(400, max(t // 2, 1)), t + 1, size=(b,)).astype(np.int32),
        y_lens=rng.integers(20, u + 1, size=(b,)).astype(np.int32),
        days=rng.integers(0, N_DAYS, size=(b,)).astype(np.int32),
        weight=np.ones((b,), np.float32),
    )


def device_split(fn, reps: int = 3) -> list[tuple[str, int, float]]:
    """Device time of one call of ``fn`` by kernel: ``(name, launches a
    call, ms a call)``, largest first, from ``torch.profiler`` over ``reps``
    calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return sorted(((e.key, e.count // reps, e.self_device_time_total / 1e3 / reps)
                   for e in events), key=lambda r: -r[2])


# The stages of the fused FF and conv modules' forwards and backwards, by the
# names of their kernels: (stage, substrings of a kernel's name), matched in
# this order
FUSED_STAGES = (
    ("products", ("gemm_sm90", "gemm_wmma", "gemm_fma")),
    ("split_sum", ("split_sum",)),
    ("ln_stats / bf16 copies", ("ln_stats", "ln_apply")),
    ("mask_grad", ("mask_grad",)),
    ("colsum", ("colsum", "sum_parts")),
    ("ln_bwd", ("ln_bwd",)),
    ("glu_dwconv", ("glu_dwconv",)),
    ("dwconv_bwd", ("dwconv_bwd",)),
    ("elementwise passes", ("each8",)),
)


def by_stage(rows, stages=FUSED_STAGES) -> dict[str, float]:
    """``device_split``'s rows summed by stage (ms a call); kernels that
    match no stage under "other"."""
    out: dict[str, float] = {}
    for name, _, ms in rows:
        stage = next((st for st, keys in stages if any(k in name for k in keys)), "other")
        out[stage] = out.get(stage, 0.0) + ms
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="gru", choices=["gru", "conformer"])
    ap.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--fused", action="store_true",
                    help="the model's opt-in kernels: the GRU's fused Adam and "
                         "projection matmul, the Conformer's fused FF and conv")
    args_cli = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    recipe = CONFORMER_ARGS if args_cli.model == "conformer" else BENCH_ARGS
    args = {**recipe, "compute_dtype": args_cli.dtype}
    if args_cli.fused:
        args.update(FUSED_FLAGS[args_cli.model])
    model = build_model(args, N_DAYS, device, seed=0)
    opt, sched = make_optimizer(args, model.parameters())
    step = make_train_step(args, model, opt, sched)
    batch = batch_tensors(bench_batch(), device)

    def run(i):
        t0 = time.perf_counter()
        metrics = step(batch, step_generator(device, 0, i))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, float(metrics["train/loss"])

    for i in range(2):
        run(i)
    walls = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(args_cli.steps):
            walls.append(run(2 + i)[0])
        wall_us = (time.perf_counter() - t0) * 1e6
    print(f"{args_cli.model}{' fused' if args_cli.fused else ''} {args_cli.dtype} "
          f"train step B=64 T=1280 "
          f"{torch.cuda.get_device_name(0)}: step wall "
          f"{', '.join(f'{w:.3f}' for w in walls)} ms (under the profiler)")
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    print(f"device busy {busy_us / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms wall "
          f"over {args_cli.steps} steps ({100 * busy_us / wall_us:.1f}%)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:40]:
        print(f"  {e.self_device_time_total / 1e3 / args_cli.steps:9.3f} ms/step "
              f"{e.count // args_cli.steps:6d}x/step  {e.key[:90]}")


if __name__ == "__main__":
    main()
