"""The Conformer CTC encoder in plain PyTorch (the reference's
``scripts/train_conformer.py`` model): per-day affine -> 9-tap Gaussian
smoothing (padding 4 each side) -> depthwise strided conv (k taps of 1/k,
stride s) -> projection -> layer norm -> dropout -> bottleneck MLP (ReLU) ->
SpecAugment (training) -> sinusoidal positions -> N blocks -> deep head;
in training an InterCTC head after block N/2.

A block: x += DropPath(0.5 FF(x)); x += DropPath(dropout(MHSA(x))); x +=
ConvModule(x); x += DropPath(0.5 FF(x)); x = LN(x). FF: LN -> Linear(D->F)
-> SiLU -> dropout -> Linear(F->D) -> dropout. MHSA: LN -> qkv (columns
q, k, v, each head-major) -> softmax(q k^T / sqrt(dh)) over the keys before
the trial's length -> dropout on the probabilities -> @ v -> out projection.
ConvModule: LN -> Linear(D->2D) -> GLU -> depthwise conv (k taps, 'same')
+ bias -> LN -> SiLU -> Linear(D->D) -> dropout. Head: Linear(D->D) -> LN ->
GELU -> dropout -> Linear(D->n_out) -> log-softmax.

Training loss: ``(1 - w) main + w inter``, where ``main = (1 - s) ctc + s
kl`` (per-sequence CTC averaged over the batch; the KL to the uniform
distribution summed over every frame and class, over the frame count) and
``inter`` the InterCTC head's averaged CTC; AdamW with warmup and cosine,
gradients clipped to norm 1.

Randomness, in the order one ``torch.Generator`` is asked: the noise
(white, offset), then a dropout seed for the frontend, SpecAugment's eight
uniforms, per block the FF seed, DropPath's row draws, the attention seed,
the attention output's seed, DropPath, the conv module's seed, the second FF
seed, DropPath; the head's seed last. A seed is ``randint(0, 2**31 - 1)``;
each dropout keeps where the hash of ``(seed, salt, row, col)``
(``hashrng.py``) lies at or above the rate: the frontend's, the attention
output's and the head's over the flattened rows (salt 0); the attention's
probabilities with salt ``b*H + h``, row the query, col the key; the FF's
hidden with salt ``b`` and its output with salt ``B + b``, the conv
module's output with salt ``b``, row the frame.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import weights as W
from . import hashrng
from .common import ctc_mean, ctc_per_seq, day_affine, layer_norm, noise, out_lengths, smooth


def sizes(config: dict) -> dict:
    a, r = config["args"], config["reference"]
    return {"c": a["nInputFeatures"], "f": a["frontend_dim"], "d": a["latent_dim"],
            "ae": a["autoencoder_hidden_dim"], "blocks": a["transformer_num_layers"],
            "heads": a["transformer_n_heads"], "ff": a["transformer_dim_ff"],
            "drop": a["transformer_dropout"], "k": a["temporal_kernel"],
            "s": a["temporal_stride"], "sigma": a["gaussian_smooth_width"],
            "conv_k": a["conformer_conv_kernel"], "drop_path": a["drop_path_prob"],
            "freq_mask": a["spec_augment_freq_mask"], "time_mask": a["spec_augment_time_mask"],
            "n_out": a["nClasses"] + 1, "days": config["n_days"],
            "head_drop": r["head_dropout"], "eps": r["layer_norm_eps"],
            "inter_at": a["transformer_num_layers"] // 2 if r["interctc"] else 0}


def leaf_specs(config: dict) -> dict:
    z = sizes(config)
    c, f, d = z["c"], z["f"], z["d"]

    def ln(n):
        return {"scale": W.const(n, value=1.0), "bias": W.const(n, value=0.0)}

    def ff():
        return {"ln": ln(d), "lin1": W.linear(d, z["ff"]), "lin2": W.linear(z["ff"], d)}

    def block():
        xav = math.sqrt(6.0 / (d + 3 * d))
        cb = 1.0 / math.sqrt(z["conv_k"])
        return {"ff1": ff(),
                "attn": {"ln": ln(d), "in_proj_w": W.uniform(d, 3 * d, bound=xav),
                         "in_proj_b": W.const(3 * d, value=0.0),
                         "out": W.linear(d, d, zero_bias=True)},
                "conv": {"ln": ln(d), "pw1": W.linear(d, 2 * d),
                         "dw_w": W.uniform(z["conv_k"], d, bound=cb),
                         "dw_b": W.uniform(d, bound=cb), "ln_conv": ln(d),
                         "pw2": W.linear(d, d)},
                "ff2": ff(), "ln_final": ln(d)}

    tree = {
        "day": {"weight": W.eye_plus(z["days"], c, 1.0 / math.sqrt(c)),
                "bias": W.uniform(z["days"], c, bound=1.0 / math.sqrt(c))},
        "frontend": {"tconv_w": W.const(z["k"], c, value=1.0 / z["k"]),
                     "proj": W.linear(c, f), "ln": ln(f)},
        "bottleneck": {"lin1": W.linear(f, z["ae"]), "lin2": W.linear(z["ae"], d)},
        "blocks": [block() for _ in range(z["blocks"])],
        "head": {"lin1": W.linear(d, d), "ln": ln(d), "lin2": W.linear(d, z["n_out"])},
    }
    if z["inter_at"]:
        tree["inter_out"] = W.linear(d, z["n_out"])
    return tree


def positions(t: int, d: int, device) -> torch.Tensor:
    """The sinusoidal table ``[t, d]``: sin on even columns, cos on odd."""
    pos = np.arange(t, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float32) * (-math.log(10000.0) / d))
    pe = np.zeros((t, d), dtype=np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div[: d // 2])
    return torch.from_numpy(pe).to(device)


class _Draws:
    """The forward's random draws, in call order; none in eval."""

    def __init__(self, gen: torch.Generator | None, train: bool):
        self.gen, self.train = gen, train

    def seed(self) -> torch.Tensor:
        return torch.randint(0, 2**31 - 1, (1,), generator=self.gen,
                             device=self.gen.device, dtype=torch.int32)

    def dropout(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        """Dropout of x over its flattened rows, from a fresh seed."""
        if not self.train or rate <= 0:
            return x
        n = x.shape[-1]
        keep = hashrng.keep_rows(self.seed(), x.numel() // n, n, rate, x.device)
        return torch.where(keep.reshape(x.shape), x * (1.0 / (1.0 - rate)), 0.0)

    def drop_path(self, x: torch.Tensor, prob: float) -> torch.Tensor:
        if not self.train or prob <= 0:
            return x
        keep = torch.rand((x.shape[0], 1, 1), generator=self.gen, device=x.device) < 1.0 - prob
        return torch.where(keep, x * (1.0 / (1.0 - prob)), 0.0)


def _lin(p, x):
    return x @ p["w"] + p["b"]


def _ff(p, x, rng: _Draws, z):
    b, t, d = x.shape
    h = F.silu(_lin(p["lin1"], layer_norm(p["ln"], x, z["eps"])))
    if not (rng.train and z["drop"] > 0):
        return _lin(p["lin2"], h)
    seed = rng.seed()
    inv = 1.0 / (1.0 - z["drop"])
    h = torch.where(hashrng.keep_by_salt(seed, 0, b, t, h.shape[-1], z["drop"], x.device),
                    h * inv, 0.0)
    o = _lin(p["lin2"], h)
    return torch.where(hashrng.keep_by_salt(seed, b, b, t, d, z["drop"], x.device), o * inv, 0.0)


def _attention(p, x, out_lens, rng: _Draws, z):
    b, t, d = x.shape
    nh = z["heads"]
    dh = d // nh
    qkv = _lin({"w": p["in_proj_w"], "b": p["in_proj_b"]}, layer_norm(p["ln"], x, z["eps"]))
    q, k, v = (qkv.reshape(b, t, 3, nh, dh)[:, :, i].transpose(1, 2) for i in range(3))
    scores = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(dh))
    masked = torch.arange(t, device=x.device)[None, :] >= out_lens[:, None]
    probs = torch.softmax(scores.masked_fill(masked[:, None, None, :], -1e9), dim=-1)
    if rng.train and z["drop"] > 0:
        keep = hashrng.keep_by_salt(rng.seed(), 0, b * nh, t, t, z["drop"], x.device)
        probs = torch.where(keep.reshape(b, nh, t, t), probs * (1.0 / (1.0 - z["drop"])), 0.0)
    out = (probs @ v).transpose(1, 2).reshape(b, t, d)
    return _lin(p["out"], out)


def _conv(p, x, rng: _Draws, z):
    b, t, d = x.shape
    seed = rng.seed() if rng.train and z["drop"] > 0 else None
    a, g = _lin(p["pw1"], layer_norm(p["ln"], x, z["eps"])).chunk(2, dim=-1)
    h = a * torch.sigmoid(g)
    kw = p["dw_w"].shape[0]
    h = F.conv1d(F.pad(h.transpose(1, 2), (kw // 2, kw // 2)), p["dw_w"].T[:, None, :],
                 groups=d).transpose(1, 2) + p["dw_b"]
    o = _lin(p["pw2"], F.silu(layer_norm(p["ln_conv"], h, z["eps"])))
    if seed is not None:
        o = torch.where(hashrng.keep_by_salt(seed, 0, b, t, d, z["drop"], x.device),
                        o * (1.0 / (1.0 - z["drop"])), 0.0)
    return x + o


def _block(p, x, out_lens, rng: _Draws, z):
    x = x + rng.drop_path(0.5 * _ff(p["ff1"], x, rng, z), z["drop_path"])
    attn = _attention(p["attn"], x, out_lens, rng, z)
    x = x + rng.drop_path(rng.dropout(attn, z["drop"]), z["drop_path"])
    x = _conv(p["conv"], x, rng, z)
    x = x + rng.drop_path(0.5 * _ff(p["ff2"], x, rng, z), z["drop_path"])
    return layer_norm(p["ln_final"], x, z["eps"])


def _spec_augment(x: torch.Tensor, gen: torch.Generator, z) -> torch.Tensor:
    """Two feature masks, then two time masks, shared over the batch: mask
    i spans ``int(u_i0 * param)`` (at most the size) from ``int(u_i1 *
    (size - width))``."""
    _, t, f = x.shape
    u = torch.rand((4, 2), generator=gen, device=x.device)

    def span(i, size, param):
        width = (u[i, 0] * param).to(torch.int32).clamp(max=size)
        start = (u[i, 1] * (size - width)).to(torch.int32)
        idx = torch.arange(size, device=x.device)
        return (idx >= start) & (idx < start + width)

    freq = span(0, f, z["freq_mask"]) | span(1, f, z["freq_mask"])
    time = span(2, t, z["time_mask"]) | span(3, t, z["time_mask"])
    return torch.where(time[None, :, None] | freq[None, None, :], 0.0, x)


def forward(params: dict, config: dict, x: torch.Tensor, days: torch.Tensor,
            x_lens: torch.Tensor, *, train: bool = False,
            generator: torch.Generator | None = None):
    """``(log_probs [B, T', n_out], out_lens [B], inter_log_probs or
    None)``; in training the recipe's noise first, then every draw above
    from ``generator``."""
    z = sizes(config)
    a = config["args"]
    if train:
        x = noise(x, generator, a["whiteNoiseSD"], a["constantOffsetSD"])
    rng = _Draws(generator, train)
    x = day_affine(params["day"], x, days)
    taps = int(4 * z["sigma"]) + 1
    x = smooth(x, taps, z["sigma"], (taps // 2, taps // 2))
    fe = params["frontend"]
    x = F.conv1d(x.transpose(1, 2), fe["tconv_w"].T[:, None, :], stride=z["s"],
                 groups=z["c"]).transpose(1, 2)
    x = rng.dropout(layer_norm(fe["ln"], _lin(fe["proj"], x), z["eps"]), z["drop"])
    bt = params["bottleneck"]
    x = _lin(bt["lin2"], F.relu(_lin(bt["lin1"], x)))
    if train:
        x = _spec_augment(x, generator, z)
    t = x.shape[1]
    x = x + positions(t, z["d"], x.device)
    out_lens = out_lengths(x_lens, z["k"], z["s"], t)
    inter = None
    for i, bp in enumerate(params["blocks"]):
        x = _block(bp, x, out_lens, rng, z)
        if train and z["inter_at"] and i == z["inter_at"] - 1:
            inter = torch.log_softmax(_lin(params["inter_out"], x), dim=-1)
    hd = params["head"]
    h = F.gelu(layer_norm(hd["ln"], _lin(hd["lin1"], x), z["eps"]))
    h = rng.dropout(h, z["head_drop"])
    return torch.log_softmax(_lin(hd["lin2"], h), dim=-1), out_lens, inter


def loss(params: dict, config: dict, batch: dict, generator: torch.Generator):
    """The train step's loss of one batch (device tensors)."""
    lp, out_lens, inter = forward(params, config, batch["x"], batch["days"], batch["x_lens"],
                                  train=True, generator=generator)
    a = config["args"]
    s, w = a["label_smoothing"], a["interctc_weight"]
    y, y_lens = batch["y"], batch["y_lens"]

    def ctc(log_probs):
        if s > 0:
            return ctc_per_seq(log_probs, out_lens, y, y_lens).mean()
        return ctc_mean(log_probs, out_lens, y, y_lens)

    main = ctc(lp)
    if s > 0:
        k = lp.shape[-1]
        kl = ((1.0 / k) * (-math.log(k) - lp)).sum() / lp.shape[1]
        main = (1.0 - s) * main + s * kl
    if inter is None:
        return main
    return (1.0 - w) * main + w * ctc(inter)
