"""Run one cell of the port's benchmark on the card(s) of this machine.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number that decided ``correct``
beside its limit; the same numbers end standard error. Exits with another
code than 0, printing no result, without enough CUDA devices, or when
``jax``, ``jaxlib``, ``flax`` or the JAX package were loaded by the time the
window closed. Float32 products run without TF32.
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """``time.perf_counter()`` at this process's start (from
    ``/proc/self/stat``), or now where that cannot be read."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return now


STARTED = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "neural_speech_decoder_tpu"}
_CACHE = Path(__file__).resolve().parent / "_cache"


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every kernel cache inside the checkout, at fixed paths
    os.environ["TORCH_EXTENSIONS_DIR"] = str(_CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(_CACHE / "triton")

    import torch

    from portbench import harness

    cell = harness.load_json(harness.HERE / "workloads" / f"{args.workload}.json")
    if not torch.cuda.is_available():
        print("portbench: torch.cuda.is_available() is False; no result", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {torch.cuda.device_count()} CUDA devices, the cell asks for "
              f"{cell['chips']}; no result", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              started=STARTED)
    found = forbidden_modules()
    if found:
        print(f"portbench: the process loaded {found}; no result", file=sys.stderr)
        return 3
    if args.trace:
        result["device"]["power_limit_w"] = power_limit_w()
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def power_limit_w():
    """The card's power limit as ``nvidia-smi`` reads it (None where it
    cannot)."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=20, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


if __name__ == "__main__":
    sys.exit(main())
