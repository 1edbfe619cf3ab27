"""The readings a cell's correctness limits are set from, many seeds in one
process (the set-up's imports and library load once):

    python -m portbench.readings --workload <cell> --mode sound --seeds 1 2 3 ...
    python -m portbench.readings --workload <cell> --mode control --seeds 4 5 6

``sound``: the program as the configuration states it (the lower
readings). ``control``: the program with its own bfloat16 path on every
kernel (``compute_dtype: bfloat16``), the nearest precision below the
configuration's float32, compared with the float32 reference (an upper
reading). ``half`` (training cells): each step fed the first half of its
batch, its loss the mean over those rows (a fault's reading). Each run
is a whole cell run with a short window (``--seconds``); one JSON line a
seed gives the compared numbers. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

MODES = ("sound", "control", "half")


def half_batch(program):
    """``kinds.train.program`` whose step takes the first half of each
    batch's rows."""
    def broken(ctx, params):
        model, opt, step = program(ctx, params)

        def step_half(batch, generator):
            rows = batch[0].shape[0] // 2
            return step(tuple(t[:rows] for t in batch), generator)

        return model, opt, step_half

    return broken


def overrides_for(mode: str) -> dict | None:
    if mode == "control":
        return {"config": {"args": {"compute_dtype": "bfloat16"}}}
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", choices=MODES, default="sound")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness
    from portbench.kinds import train

    if not torch.cuda.is_available():
        print("portbench.readings: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.mode == "half":
        train.program = half_batch(train.program)
    for seed in args.seeds:
        r = harness.run_cell(args.workload, seed, args.seconds, False,
                             started=time.perf_counter(), overrides=overrides_for(args.mode))
        print(json.dumps({"workload": args.workload, "mode": args.mode, "seed": seed,
                          "correct": r["correct"], "attempted": r["attempted"],
                          "checks": {k: v["value"] for k, v in r["checks"].items()}}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
