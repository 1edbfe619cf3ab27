"""The numbers that decide ``correct``: what the program produced on the
timed path against what the plain reference works out from the same
inputs. Each number is compared with its cell's limit
(``portbench/workloads/<cell>.json``), which was set between the sound
program's readings over many seeds and the lower-precision control's.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def loss_gap(prog: list[float], ref: list[float]) -> float:
    """The widest relative gap of a step's loss."""
    return max(abs(p - r) / abs(r) for p, r in zip(prog, ref, strict=True))


def worst_leaf(prog: np.ndarray, ref: np.ndarray, keep: np.ndarray | None = None) -> float:
    """The widest gap between the program's and the reference's norm of a
    leaf, over the larger of the reference's norm of that leaf and of the
    median leaf (some gradients are all but zero)."""
    prog, ref = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    if prog.shape != ref.shape:
        raise ValueError(f"{prog.shape} leaves against the reference's {ref.shape}")
    scale = np.maximum(ref, np.median(ref))
    gaps = np.abs(prog - ref) / scale
    if keep is not None:
        gaps = gaps[keep]
    return float(gaps.max()) if gaps.size else math.inf


def moved(ref_grads: np.ndarray) -> np.ndarray:
    """The leaves whose first gradient in the reference is at least a
    thousandth of the median leaf's: the others move by round-off alone."""
    ref_grads = np.asarray(ref_grads, np.float64)
    return ref_grads >= 1e-3 * np.median(ref_grads)


def collapse(ids: np.ndarray) -> list[int]:
    """The greedy CTC collapse of a frame path: repeats merged, blanks (0)
    dropped."""
    out, prev = [], -1
    for i in ids.tolist():
        if i != prev and i != 0:
            out.append(i)
        prev = i
    return out


def decode_checks(lp_p: torch.Tensor, lens_p: torch.Tensor, decoded_p: list[list[int]],
                  lp_r: torch.Tensor, lens_r: torch.Tensor) -> dict[str, float]:
    """One request's numbers: rows whose output length differs; the widest
    log-prob gap over each row's valid frames; the widest gap by which the
    reference's log-prob of the program's chosen token lies below the
    reference's best; rows whose decoded ids are not the collapse of the
    program's own per-frame choices."""
    lp_p = lp_p.float()
    lens_p = lens_p.long().cpu()
    lens_r = lens_r.long().cpu()
    frames = lp_r.shape[1]
    valid = (torch.arange(frames)[None, :] < lens_r[:, None]).to(lp_r.device)
    choice = lp_p.argmax(dim=-1)
    gap = ((lp_p - lp_r).abs().amax(dim=-1) * valid).amax()
    token = ((lp_r.amax(dim=-1) - lp_r.gather(-1, choice[..., None])[..., 0]) * valid).amax()
    choice = choice.cpu().numpy()
    bad_decode = sum(decoded_p[i] != collapse(choice[i, :int(lens_p[i])])
                     for i in range(len(decoded_p)))
    return {"lens_mismatch": float((lens_p != lens_r).sum()),
            "decode_mismatch": float(bad_decode),
            "logprob_gap": float(gap), "token_gap": float(token)}
