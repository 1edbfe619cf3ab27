"""Find a cell's files by name and run it.

``BENCHMARK.json`` at the repository's root names the cells, the
configurations, the end-to-end metrics and the per-layer metrics. A cell
``<cell>`` is ``portbench/workloads/<cell>.json`` (its configuration, its
traffic mix, the chips it needs and the limits of its correctness
numbers); the configuration is ``portbench/configs/<config>.json`` with its
plain reference ``portbench/reference/<family>.py``; the mix is
``portbench/traffic/<mix>.json``, whose ``kind`` picks what the window
drives (``portbench/kinds/<kind>.py``); a per-layer metric ``<name>`` is
read by ``portbench/metrics/<name>.py``, or by the reader of its family,
``portbench/metrics/<name up to its first dot>.py``. Adding any of them adds files and
entries; no file here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path

import torch

from .kinds import Context

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def merged(base: dict, over: dict | None) -> dict:
    """``base`` with ``over``'s keys, dictionaries merged key by key."""
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def load_cell(name: str, overrides: dict | None = None) -> tuple[dict, dict, dict]:
    """``(cell, config, mix)`` of cell ``name``; ``overrides`` (tests and
    the control) merges ``{"config": ..., "mix": ...}`` into them."""
    cell = load_json(HERE / "workloads" / f"{name}.json")
    config = load_json(HERE / "configs" / f"{cell['config']}.json")
    mix = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    overrides = overrides or {}
    return cell, merged(config, overrides.get("config")), merged(mix, overrides.get("mix"))


def metric_reader(name: str):
    """The module of ``portbench/metrics/<name>.py``, or, where there is
    none, of ``portbench/metrics/<family>.py``, ``<family>`` being the name
    up to its first dot: one reader for ``mfu.train`` and ``mfu.decode``,
    which tells the two apart by ``run.kind``."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{name.split('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics._" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, reports: set[str]) -> tuple[list[dict], list[dict]]:
    """The cell's end-to-end metrics (those it reports, or that list it)
    and its per-layer metrics (those that list it, or, without a list,
    whose ``moves`` it reports)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell]) and m["name"] in reports]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, per_layer


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, started: float,
             device: str | torch.device = "cuda", overrides: dict | None = None,
             bench: dict | None = None) -> dict:
    """One run of cell ``name``: the result line's object, ``checks`` last."""
    bench = bench or benchmark()
    cell, config, mix = load_cell(name, overrides)
    device = torch.device(device)
    kind = importlib.import_module(f"portbench.kinds.{mix['kind']}")
    ctx = Context(name, config, mix, int(seed), float(seconds), bool(trace), device, started)
    out = kind.run(ctx)
    for span, times in out.run.spans.items():
        print(f"portbench: {name} span {span} mean {1e3 * sum(times) / len(times):.3f} ms "
              f"of {len(times)}", file=sys.stderr)

    e2e, per_layer = cell_metrics(bench, name, set(out.end_to_end))
    metrics = {}
    if trace:
        for m in per_layer:
            value = metric_reader(m["name"]).read(out.run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(out.end_to_end[m["name"]]), "unit": m["unit"]}
                   for m in e2e}

    limits = cell["limits"]
    checks = {k: {"value": float(v), "limit": float(limits[k])} for k, v in out.checks.items()}
    correct = out.failed == 0 and out.attempted > 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(out.memory_peak_bytes)}
    result = {"correct": bool(correct), "attempted": int(out.attempted),
              "failed": int(out.failed), "metrics": metrics, "device": dev}
    if trace and out.run.timeline is not None:
        tl = out.run.timeline
        dev.update(busy_s=tl.busy_s(), window_s=tl.window_s)
        result["breakdown"] = tl.breakdown()
    result["checks"] = checks
    return result
