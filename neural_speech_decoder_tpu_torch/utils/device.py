"""The device an entry point of the port runs on."""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str, what: str) -> torch.device:
    """``device`` as a ``torch.device`` with its index; a CUDA device on a
    machine without one raises (there is no CPU fallback: the caller asks
    for ``"cpu"``). ``what`` names the caller in the error."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{what} on {device!r}: no CUDA device "
                               "(pass device='cpu' to run on the CPU)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
