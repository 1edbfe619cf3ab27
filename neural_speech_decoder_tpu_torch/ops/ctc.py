"""CTC loss with the reference's semantics.

Port of ``neural_speech_decoder_tpu/ops/ctc.py``: torch's
``CTCLoss(blank=0, zero_infinity=True)`` semantics on top of the port's CTC
kernels (``ops/kernels/ctc.py``, which launch on the card and run their
plain versions on the CPU):

- ``zero_infinity`` zeroes the loss and the gradient of rows where no
  alignment exists, decided by the exact condition ``T >= U + repeats``
  (``ctc_feasible``);
- the reductions are torch's: "mean" divides each row's loss by its target
  length before averaging over the batch; "sum"; "none".
"""

from __future__ import annotations

import torch

from .kernels.ctc import NEG_INF, ctc_loss_kernel


def ctc_feasible(
    labels: torch.Tensor, label_lens: torch.Tensor, input_lens: torch.Tensor
) -> torch.Tensor:
    """True where a CTC alignment exists: T >= U + #(consecutive repeats)."""
    u = labels.shape[1]
    label_lens = label_lens.to(labels.device)
    valid = torch.arange(u, device=labels.device)[None, :] < label_lens[:, None]
    rep = (labels[:, 1:] == labels[:, :-1]) & valid[:, 1:] & valid[:, :-1]
    n_rep = rep.sum(dim=1)
    return input_lens.to(labels.device) >= label_lens + n_rep


def ctc_loss(
    log_probs: torch.Tensor,
    input_lens: torch.Tensor,
    labels: torch.Tensor,
    label_lens: torch.Tensor,
    *,
    blank_id: int = 0,
    reduction: str = "mean",
    zero_infinity: bool = True,
    plain: bool = False,
) -> torch.Tensor:
    """CTC negative log-likelihood.

    ``log_probs [B, T, K]`` log-probabilities (or logits: log_softmax is
    idempotent), ``input_lens [B]`` valid frames, ``labels [B, U]`` (0 =
    blank/pad), ``label_lens [B]``. Without ``zero_infinity`` an infeasible
    row's loss is ``inf``. ``plain`` runs the recursions' plain versions.
    Returns a float32 scalar for "mean"/"sum", ``[B]`` for "none".
    """
    if blank_id != 0:
        raise ValueError(f"ctc_loss: blank_id must be 0, got {blank_id}")
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"unknown reduction: {reduction}")
    dev = log_probs.device
    input_lens, labels, label_lens = (
        t.to(dev) for t in (input_lens, labels, label_lens))
    per_seq = ctc_loss_kernel(log_probs, input_lens, labels, label_lens,
                              plain=plain)
    if zero_infinity:
        ok = ctc_feasible(labels, label_lens, input_lens)
        per_seq = torch.where(ok, per_seq, 0.0)
    else:
        per_seq = torch.where(per_seq >= -NEG_INF, torch.inf, per_seq)
    if reduction == "none":
        return per_seq
    if reduction == "sum":
        return per_seq.sum()
    return (per_seq / label_lens.clamp_min(1).to(per_seq.dtype)).mean()
