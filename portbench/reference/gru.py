"""The GRU baseline in plain PyTorch (the reference's ``GRUDecoder``):
20-tap Gaussian smoothing (padding 9 left, 10 right) -> per-day affine ->
Softsign -> unfold of k bins every s (channel-major frames ``c*k + j``) ->
stacked bidirectional GRU (gates r, z, n; ``n = tanh(x_n + r * (h W_n +
b_hn))``; zero initial state; the backward direction walks all frames from
the last) with dropout between layers in training -> linear head ->
log-softmax; CTC loss over ``(len - k) / s`` frames, torch's "mean".

The parameter tree is the one the port's ``GRUDecoder`` takes: per layer
``w_ih [D, in, 3H]``, ``w_hh [D, H, 3H]``, ``b_ih``/``b_hh [D, 3H]``,
``day.weight [days, C, C]``, ``day.bias [days, C]``, ``fc.weight [D*H,
n_out]``, ``fc.bias``. Weights are drawn as torch's ``nn.GRU`` and
``nn.Linear`` draw theirs, U(-1/sqrt(fan), 1/sqrt(fan)); the day affines as
identity plus U(-1/sqrt(C), 1/sqrt(C)), so that each day's weights differ.
"""

from __future__ import annotations

import math

import torch

from .. import weights as W
from .common import ctc_mean, day_affine, noise, out_lengths, smooth


def sizes(config: dict) -> dict:
    a = config["args"]
    return {"c": a["nInputFeatures"], "h": a["nUnits"], "layers": a["nLayers"],
            "dirs": 2 if a["bidirectional"] else 1, "k": a["kernelLen"],
            "s": a["strideLen"], "n_out": a["nClasses"] + 1, "days": config["n_days"],
            "sigma": a["gaussianSmoothWidth"], "taps": config["gaussian_taps"],
            "dropout": a["dropout"]}


def leaf_specs(config: dict) -> dict:
    z = sizes(config)
    h, d = z["h"], z["dirs"]
    bound = 1.0 / math.sqrt(h)
    layers = []
    for li in range(z["layers"]):
        din = z["c"] * z["k"] if li == 0 else h * d
        layers.append({"w_ih": W.uniform(d, din, 3 * h, bound=bound),
                       "w_hh": W.uniform(d, h, 3 * h, bound=bound),
                       "b_ih": W.uniform(d, 3 * h, bound=bound),
                       "b_hh": W.uniform(d, 3 * h, bound=bound)})
    fc_bound = 1.0 / math.sqrt(h * d)
    return {"day": {"weight": W.eye_plus(z["days"], z["c"], 1.0 / math.sqrt(z["c"])),
                    "bias": W.uniform(z["days"], z["c"], bound=1.0 / math.sqrt(z["c"]))},
            "gru": {"layers": layers},
            "fc": {"weight": W.uniform(h * d, z["n_out"], bound=fc_bound),
                   "bias": W.uniform(z["n_out"], bound=fc_bound)}}


def _layer(xp: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor, reverse: bool):
    """One direction: ``xp [B, L, 3H]`` (input projections with b_ih) ->
    ``[B, L, H]``."""
    b, length, three_h = xp.shape
    hd = three_h // 3
    h = xp.new_zeros((b, hd))
    ys = [None] * length
    for t in (reversed(range(length)) if reverse else range(length)):
        hp = h @ w_hh + b_hh
        x = xp[:, t]
        r = torch.sigmoid(x[:, :hd] + hp[:, :hd])
        z = torch.sigmoid(x[:, hd:2 * hd] + hp[:, hd:2 * hd])
        n = torch.tanh(x[:, 2 * hd:] + r * hp[:, 2 * hd:])
        h = (1.0 - z) * n + z * h
        ys[t] = h
    return torch.stack(ys, dim=1)


def forward(params: dict, config: dict, x: torch.Tensor, days: torch.Tensor,
            x_lens: torch.Tensor, *, train: bool = False,
            generator: torch.Generator | None = None):
    """``(log_probs [B, L, n_out], out_lens [B])``; in training the recipe's
    noise first and the inter-layer dropout, both from ``generator``."""
    z = sizes(config)
    a = config["args"]
    if train:
        x = noise(x, generator, a["whiteNoiseSD"], a["constantOffsetSD"])
    taps = z["taps"]
    x = smooth(x, taps, z["sigma"], ((taps - 1) // 2, taps - 1 - (taps - 1) // 2))
    x = torch.nn.functional.softsign(day_affine(params["day"], x, days))
    b = x.shape[0]
    out = x.unfold(1, z["k"], z["s"]).reshape(b, -1, z["c"] * z["k"])  # [B, L, C*k]
    p = z["dropout"] if train else 0.0
    for li, lp in enumerate(params["gru"]["layers"]):
        ys = [_layer(out @ lp["w_ih"][d] + lp["b_ih"][d], lp["w_hh"][d], lp["b_hh"][d],
                     reverse=d == 1) for d in range(z["dirs"])]
        out = torch.cat(ys, dim=-1)
        if p > 0 and li < z["layers"] - 1:
            keep = torch.rand(out.shape, generator=generator, device=out.device) < 1.0 - p
            out = torch.where(keep, out / (1.0 - p), 0.0)
    logits = out @ params["fc"]["weight"] + params["fc"]["bias"]
    out_lens = out_lengths(x_lens, z["k"], z["s"], logits.shape[1])
    return torch.log_softmax(logits, dim=-1), out_lens


def loss(params: dict, config: dict, batch: dict, generator: torch.Generator):
    """The train step's loss of one batch (device tensors)."""
    lp, out_lens = forward(params, config, batch["x"], batch["days"], batch["x_lens"],
                           train=True, generator=generator)
    return ctc_mean(lp, out_lens, batch["y"], batch["y_lens"])
