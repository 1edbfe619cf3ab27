"""Pieces both families' references share: the Gaussian smoothing, the
per-day affine, the layer norm, the noise, the CTC losses and the two
optimizers with their schedules, in plain float32 PyTorch."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_taps(n_taps: int, sigma: float) -> np.ndarray:
    """Normalized Gaussian taps centred on the kernel, float32."""
    x = np.arange(n_taps, dtype=np.float64) - (n_taps - 1) / 2.0
    k = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


def smooth(x: torch.Tensor, n_taps: int, sigma: float, pad: tuple[int, int]) -> torch.Tensor:
    """Depthwise smoothing along time of ``x [B, T, C]``, zero-padded by
    ``pad`` (left, right)."""
    c = x.shape[-1]
    taps = torch.from_numpy(gaussian_taps(n_taps, sigma)).to(x.device)
    y = F.conv1d(F.pad(x.transpose(1, 2), pad), taps.expand(c, 1, n_taps), groups=c)
    return y.transpose(1, 2)


def day_affine(p: dict, x: torch.Tensor, days: torch.Tensor) -> torch.Tensor:
    """``x [B, T, C] @ weight[day] + bias[day]`` per trial."""
    idx = days.long()
    return torch.bmm(x, p["weight"][idx]) + p["bias"][idx][:, None, :]


def layer_norm(p: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), p["scale"], p["bias"], eps)


def noise(x: torch.Tensor, gen: torch.Generator, white_sd: float, offset_sd: float):
    """The recipe's augmentation: white noise, then a constant offset per
    trial and channel, drawn in that order."""
    if white_sd > 0:
        x = x + torch.randn(x.shape, generator=gen, device=x.device) * white_sd
    if offset_sd > 0:
        b, _, c = x.shape
        x = x + torch.randn((b, 1, c), generator=gen, device=x.device) * offset_sd
    return x


def out_lengths(x_lens: torch.Tensor, kernel: int, stride: int, frames: int) -> torch.Tensor:
    """The CTC input lengths ``(len - k) / s`` truncated toward zero,
    clamped to ``[0, frames]``."""
    diff = x_lens.long() - kernel
    return torch.div(diff, stride, rounding_mode="trunc").clamp(0, frames)


def ctc_per_seq(log_probs, out_lens, y, y_lens) -> torch.Tensor:
    """Per-sequence CTC loss (blank 0, infeasible rows zeroed), ``[B]``."""
    return F.ctc_loss(log_probs.transpose(0, 1), y.long(), out_lens.long(), y_lens.long(),
                      blank=0, reduction="none", zero_infinity=True)


def ctc_mean(log_probs, out_lens, y, y_lens) -> torch.Tensor:
    """torch's "mean": each loss over its target length, averaged."""
    per = ctc_per_seq(log_probs, out_lens, y, y_lens)
    return (per / y_lens.clamp_min(1).to(per.dtype)).mean()


def lr_at(opt: dict, count: int) -> float:
    """The learning rate of update ``count`` (0-based)."""
    lr0 = float(opt["lr"])
    if opt["schedule"] == "linear":
        frac = min(count, opt["total_steps"]) / max(opt["total_steps"], 1)
        return lr0 * (1.0 + (opt["lr_end"] / lr0 - 1.0) * frac)
    if opt["schedule"] == "warmup_cosine":
        warm, total = opt["warmup_steps"], opt["total_steps"]
        if count < warm:
            return lr0 * (count + 1.0) / max(1, warm)
        progress = (count - warm) / max(1, total - warm)
        return lr0 * 0.5 * (1.0 + math.cos(math.pi * progress))
    raise ValueError(f"unknown schedule {opt['schedule']!r}")


class Adam:
    """Adam as the recipes run it, one update a call on float32 leaves:
    ``"l2"`` adds ``weight_decay * p`` to the gradient before the moments
    (the GRU's), ``"decoupled"`` shrinks ``p`` by ``lr * weight_decay``
    first (AdamW, the Conformer's); the bias-corrected step is ``lr * m_hat
    / (sqrt(v_hat) + eps)``. With ``clip`` the gradients are first scaled
    to a global norm of at most ``clip``. ``seen`` holds, after each update,
    the gradient the moments took (``m_1 / (1 - beta1)`` after the first)."""

    def __init__(self, params: list[torch.Tensor], opt: dict):
        self.params, self.opt = params, opt
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.count = 0
        self.seen: list[torch.Tensor] = []

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor]) -> None:
        o = self.opt
        b1, b2 = o["betas"]
        wd, eps = o["weight_decay"], o["eps"]
        if o.get("clip"):
            total = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
            scale = torch.clamp(o["clip"] / (total + 1e-6), max=1.0)
            grads = [g * scale for g in grads]
        lr = lr_at(o, self.count)
        self.count += 1
        c1, c2 = 1.0 - b1 ** self.count, 1.0 - b2 ** self.count
        self.seen = []
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            if o["decay"] == "l2":
                g = g + wd * p
            else:
                p.mul_(1.0 - lr * wd)
            self.seen.append(g)
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            p.sub_(lr * (m / c1) / ((v / c2).sqrt() + eps))
