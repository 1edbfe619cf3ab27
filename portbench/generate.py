"""The one traffic generator: batches of synthetic trials from a mix's
parameters (``portbench/traffic/<mix>.json``) and the run's seed.

A trial is ``[T_i, C]`` float32 Gaussian features (binned spike features
after the reference's block z-scoring) with a recording day and a phoneme
label sequence, as ``training/profile.py::bench_batch`` of the port draws
them: features N(0, 1), labels uniform over ``[1, n_classes]``, days
uniform over ``[0, n_days)``. Three changes from that generator:

- lengths are stratified, not drawn: every batch holds the same 64 trial
  lengths spread evenly over ``[t_min, t_max]`` and the same label lengths
  over ``[u_min, u_max]``, in an order drawn from the seed, so that every
  seed and every batch asks for the same work (the window's rate then does
  not move with the seed);
- the bins past a trial's length are zero, as the port's batcher pads them;
- the features are drawn in one call a batch on the run's device (a
  ``torch.Generator`` seeded from the run's seed), then copied to the host,
  where requests and batches start.

Each batch is ``{"x": [B, T_env, C], "x_lens": [B], "days": [B], "y":
[B, U_env], "y_lens": [B]}`` of numpy arrays; a request's trials are the
rows of ``x`` cut to their lengths (``trials``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import seeds

REQUIRED = ("kind", "batch", "t_min", "t_max", "t_envelope", "pool")


def check_mix(mix: dict) -> None:
    """Raise for a mix file that lacks a parameter or whose lengths do not
    fit their envelopes."""
    missing = [k for k in REQUIRED if k not in mix]
    if missing:
        raise ValueError(f"traffic mix lacks {missing}")
    if not 1 <= mix["t_min"] <= mix["t_max"] <= mix["t_envelope"]:
        raise ValueError(f"traffic mix lengths {mix['t_min']}-{mix['t_max']} do not fit "
                         f"the envelope {mix['t_envelope']}")
    if "u_envelope" in mix and not 1 <= mix["u_min"] <= mix["u_max"] <= mix["u_envelope"]:
        raise ValueError("traffic mix label lengths do not fit their envelope")


def stratified(lo: int, hi: int, n: int) -> np.ndarray:
    """``n`` whole numbers spread evenly over ``[lo, hi]``: the midpoints of
    ``n`` equal bins, ascending."""
    return (lo + np.floor((np.arange(n) + 0.5) * (hi - lo + 1) / n)).astype(np.int32)


def make_batches(mix: dict, n_channels: int, n_classes: int, n_days: int,
                 seed: int, device: torch.device | str = "cpu") -> list[dict]:
    """The mix's pool of ``mix["pool"]`` batches for run ``seed``, the
    features drawn on ``device``."""
    check_mix(mix)
    b, t_env = mix["batch"], mix["t_envelope"]
    lens = stratified(mix["t_min"], mix["t_max"], b)
    u_env = mix.get("u_envelope", 0)
    label_lens = stratified(mix["u_min"], mix["u_max"], b) if u_env else None
    out = []
    for i in range(mix["pool"]):
        rng = seeds.rng(seed, "traffic", i)
        x_lens = rng.permutation(lens).astype(np.int32)
        gen = torch.Generator(device=device).manual_seed(seeds.derive(seed, "traffic", i))
        xt = torch.randn((b, t_env, n_channels), generator=gen, device=device)
        ends = torch.from_numpy(x_lens).to(device)
        pad = torch.arange(t_env, device=device)[None, :] >= ends[:, None]
        x = xt.masked_fill_(pad[..., None], 0.0).cpu().numpy()
        batch = {"x": x, "x_lens": x_lens,
                 "days": rng.integers(0, n_days, size=b).astype(np.int32)}
        if u_env:
            y_lens = rng.permutation(label_lens).astype(np.int32)
            y = rng.integers(1, n_classes + 1, size=(b, u_env)).astype(np.int32)
            y[np.arange(u_env)[None, :] >= y_lens[:, None]] = 0
            batch.update(y=y, y_lens=y_lens)
        out.append(batch)
    return out


def trials(batch: dict) -> list[np.ndarray]:
    """A request's trials: each row of the batch cut to its length (views)."""
    return [batch["x"][i, :n] for i, n in enumerate(batch["x_lens"])]
