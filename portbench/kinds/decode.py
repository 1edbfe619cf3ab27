"""Batch-decoding cells: requests of a batch of trials to the port's
``InferenceModel``, in a closed loop with one client.

Set-up draws the mix's pool of requests (each ``batch`` trials of
stratified lengths, with their days) and the weights from the seed, builds
``InferenceModel`` at the mix's envelope and serves ``warmup_requests``
requests, which warm every shape. In the window the client sends request k
(the pool's ``k % pool``): ``pad_batch`` -> ``__call__`` -> ``decode``, and
sends the next once the decoded ids are on the host; a request's latency
runs from the start of ``pad_batch`` to that point. The requests of
``checked_requests`` indices drawn from the seed among the window's first
``pool`` keep their log-probs, output lengths and decoded ids. After the
window the program is freed and the plain reference runs each of them from
the same trials, zero-padded to the envelope by itself, and the numbers of
``judge.decode_checks`` are compared, the widest over the requests.
"""

from __future__ import annotations

import importlib
import time

import numpy as np
import torch

from .. import generate, judge, seeds, weights
from ..trace import Run, Spans
from . import (Context, Outcome, memory_peak, phase, release, start_profiler, stop_profiler,
               synchronize, window_range)


def program(ctx: Context, params: dict):
    """The port's ``InferenceModel`` for the cell's configuration, on the
    benchmark's weights."""
    from neural_speech_decoder_tpu_torch.models.api import config_from_args
    from neural_speech_decoder_tpu_torch.serving.model import InferenceModel

    cfg = config_from_args(ctx.config["args"], ctx.config["n_days"])
    return InferenceModel(params, cfg, ctx.device, batch_size=ctx.mix["batch"],
                          t_max=ctx.mix["t_envelope"])


def serve(model, request: dict, spans: Spans, sync: bool):
    """One request: ``(log_probs, out_lens, decoded ids)``. ``sync`` (the
    traced run) ends the pad and forward spans with a synchronise."""
    with spans("pad", sync):
        x, days, lens = model.pad_batch(request["trials"], request["days"])
    with spans("forward", sync):
        log_probs, out_lens = model(x, days, lens)
    with spans("decode"):
        decoded = model.decode(log_probs, out_lens)
    return log_probs, out_lens, decoded


def run(ctx: Context) -> Outcome:
    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    fam = importlib.import_module(f"portbench.reference.{cfg['family']}")
    a = cfg["args"]
    t = phase(ctx, "start", ctx.started)
    importlib.import_module("neural_speech_decoder_tpu_torch.serving.model")
    t = phase(ctx, "import", t)
    pool = generate.make_batches(mix, a["nInputFeatures"], a["nClasses"], cfg["n_days"], ctx.seed,
                                  dev)
    t = phase(ctx, "traffic", t)
    requests = [{"trials": generate.trials(b), "days": b["days"]} for b in pool]
    checked = set(seeds.rng(ctx.seed, "sample").choice(
        len(pool), size=mix["checked_requests"], replace=False).tolist())

    model = program(ctx, weights.draw(fam.leaf_specs(cfg), ctx.seed, dev))
    t = phase(ctx, "program", t)
    warm = Spans(False, dev)
    for k in range(mix["warmup_requests"]):
        serve(model, requests[k % len(requests)], warm, False)
    phase(ctx, "warmup", t)

    spans = Spans(ctx.trace, dev)
    prof = start_profiler(ctx)
    synchronize(dev)
    t0 = time.perf_counter()
    setup_s = t0 - ctx.started
    latencies, lens, kept = [], [], {}
    with window_range(ctx):
        while time.perf_counter() - t0 < ctx.seconds:
            k = len(latencies)
            j = k % len(requests)
            ta = time.perf_counter()
            out = serve(model, requests[j], spans, ctx.trace)
            latencies.append(time.perf_counter() - ta)
            lens.append(pool[j]["x_lens"])
            if k in checked:
                kept[k] = (j, *out)
        synchronize(dev)
    window_s = time.perf_counter() - t0
    timeline = stop_profiler(prof)
    peak = memory_peak(dev)
    n = len(latencies)
    failed = sum(len(v[3]) != len(requests[v[0]]["trials"]) for v in kept.values())
    del model
    release(dev)

    t = time.perf_counter()
    checks = _compare(ctx, fam, pool, kept)
    phase(ctx, "reference", t)
    run_rec = Run("decode", cfg, mix, n, lens, dict(spans.times), timeline)
    b = mix["batch"]
    return Outcome({"setup_s": setup_s,
                    "decode_trials_per_s": b * n / window_s if window_s > 0 else 0.0,
                    "decode_p95_ms": float(np.percentile(latencies, 95)) * 1e3 if n else 0.0},
                   n, failed, peak, checks, run_rec)


def _compare(ctx: Context, fam, pool, kept) -> dict[str, float]:
    """The widest of each number over the kept requests (infinite where the
    window kept none)."""
    names = ("lens_mismatch", "decode_mismatch", "logprob_gap", "token_gap")
    if not kept:
        return {k: float("inf") for k in names}
    tree = weights.draw(fam.leaf_specs(ctx.config), ctx.seed, ctx.device)
    worst = dict.fromkeys(names, 0.0)
    with torch.no_grad():
        for j, log_probs, out_lens, decoded in kept.values():
            b = {k: torch.from_numpy(pool[j][k]).to(ctx.device) for k in ("x", "days", "x_lens")}
            lp_r, lens_r = fam.forward(tree, ctx.config, b["x"], b["days"], b["x_lens"])[:2]
            got = judge.decode_checks(log_probs, out_lens, decoded, lp_r, lens_r)
            worst = {k: max(worst[k], got[k]) for k in names}
    return worst
