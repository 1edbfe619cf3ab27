"""The model interface of the trainer and the serving path.

Port of the GRU branch of ``neural_speech_decoder_tpu/training/trainer.py::
build_model``: a run's ``args`` become a ``GRUConfig`` and a ``GRUDecoder``
with fresh weights, and ``forward`` returns log-probabilities with the CTC
output lengths, in train or eval mode.
"""

from __future__ import annotations

import torch

from ..ops.unfold import ctc_input_lengths
from .gru import GRUConfig, GRUDecoder, init_gru_params

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def config_from_args(args: dict, n_days: int) -> GRUConfig:
    """The ``GRUConfig`` that ``build_model`` makes from a run's ``args``."""
    return GRUConfig(
        neural_dim=args["nInputFeatures"],
        n_classes=args["nClasses"],
        hidden_dim=args["nUnits"],
        num_layers=args["nLayers"],
        n_days=n_days,
        dropout=args["dropout"],
        stride_len=args["strideLen"],
        kernel_len=args["kernelLen"],
        gaussian_smooth_width=args["gaussianSmoothWidth"],
        bidirectional=args["bidirectional"],
        compute_dtype=_DTYPES[str(args.get("compute_dtype", "float32"))],
    )


def build_model(
    args: dict, n_days: int, device: torch.device | str, seed: int = 0
) -> GRUDecoder:
    """The decoder a run's ``args`` describe, with weights drawn on
    ``device`` from ``seed``. The port has the GRU baseline only."""
    model_type = args.get("model_type", "gru_baseline")
    if model_type != "gru_baseline":
        raise NotImplementedError(
            f"model_type {model_type!r}: the port has the GRU baseline only")
    cfg = config_from_args(args, n_days)
    gen = torch.Generator(device=device).manual_seed(seed)
    return GRUDecoder(cfg, init_gru_params(cfg, gen))


def forward(
    model: GRUDecoder,
    x: torch.Tensor,
    day_idx: torch.Tensor,
    x_lens: torch.Tensor,
    *,
    train: bool = False,
    generator: torch.Generator | None = None,
    plain: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(log_probs [B, L, n_classes+1], out_lens [B])``: log-softmax of the
    logits, and the reference's CTC input lengths clipped to ``[0, L]``.
    ``train`` runs the training forward with dropout from ``generator``."""
    logits = model(x, day_idx, train=train, generator=generator, plain=plain)
    cfg = model.cfg
    out_lens = ctc_input_lengths(x_lens, cfg.kernel_len, cfg.stride_len)
    out_lens = out_lens.to(logits.device).clamp(0, logits.shape[1])
    return torch.log_softmax(logits, dim=-1), out_lens
