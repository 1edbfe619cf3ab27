"""Import reference PyTorch checkpoints into the port's parameter trees.

Port of ``neural_speech_decoder_tpu/models/torch_import.py``: a state dict
in the reference implementation's layout (its ``modelWeights`` file), given
as numpy arrays or CPU tensors, becomes a tree of float32 CPU tensors in
the JAX package's layout, which ``GRUDecoder`` / ``ConformerDecoder
.load_params`` take as it is (``models/convert.py``).

Layout rules:
  * torch Linear / GRU weights are ``[out, in]``; the trees' are ``[in, out]``;
  * GRU gate order r, z, n is shared; per-direction tensors (the
    ``_reverse`` keys) stack on a leading axis;
  * the GRU's dead ``inpLayer{i}`` parameters (never used in the reference
    forward) are ignored;
  * the day bias ``[nDays, 1, D]`` squeezes to ``[nDays, D]``;
  * depthwise convolution weights ``[C, 1, k]`` become ``[k, C]``.

Layer 0's ``weight_ih_l0`` is ``[3H, C*k]`` over ``nn.Unfold``'s feature
order ``c*k + j``, the order of the port's unfold (``ops/unfold.py``): it is
transposed, never permuted.

``load_checkpoint`` goes from a file written by ``torch_export.main`` (or
the reference's own ``torch.save`` of a state dict) to a model on a device.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..utils.device import resolve_device
from .api import Decoder, build_model, config_from_args
from .conformer import ConformerConfig
from .gru import GRUConfig


def _t(x) -> torch.Tensor:
    """A float32 CPU tensor of its own (a copy) from an array or tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32, copy=True)
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _w(x) -> torch.Tensor:
    """A torch ``[out, in]`` weight as ``[in, out]``."""
    return _t(x).T.contiguous()


def import_gru_state_dict(sd: Mapping, cfg: GRUConfig) -> dict:
    """Reference ``GRUDecoder`` state dict -> ``init_gru_params``' tree."""
    layers = []
    for li in range(cfg.num_layers):
        sfx = [f"l{li}", f"l{li}_reverse"][: cfg.num_dirs]
        layers.append({
            "w_ih": torch.stack([_w(sd[f"gru_decoder.weight_ih_{s}"]) for s in sfx]),
            "w_hh": torch.stack([_w(sd[f"gru_decoder.weight_hh_{s}"]) for s in sfx]),
            "b_ih": torch.stack([_t(sd[f"gru_decoder.bias_ih_{s}"]) for s in sfx]),
            "b_hh": torch.stack([_t(sd[f"gru_decoder.bias_hh_{s}"]) for s in sfx]),
        })
    return {
        "day": {"weight": _t(sd["dayWeights"]),
                "bias": _t(sd["dayBias"])[:, 0, :].contiguous()},
        "gru": {"layers": layers},
        "fc": {"weight": _w(sd["fc_decoder_out.weight"]),
               "bias": _t(sd["fc_decoder_out.bias"])},
    }


def _lin(sd, prefix: str) -> dict:
    return {"w": _w(sd[f"{prefix}.weight"]), "b": _t(sd[f"{prefix}.bias"])}


def _ln(sd, prefix: str) -> dict:
    return {"scale": _t(sd[f"{prefix}.weight"]), "bias": _t(sd[f"{prefix}.bias"])}


def _depthwise(x) -> torch.Tensor:
    """``[C, 1, k]`` -> ``[k, C]``."""
    return _t(x)[:, 0, :].T.contiguous()


def import_conformer_state_dict(sd: Mapping, cfg: ConformerConfig) -> dict:
    """Reference ``NeuralTransformerCTCModel`` state dict ->
    ``init_conformer_params``' tree."""
    blocks = []
    for i in range(cfg.num_layers):
        p = f"conformer_layers.{i}"
        blocks.append({
            "ff1": {"ln": _ln(sd, f"{p}.ff1.0"), "lin1": _lin(sd, f"{p}.ff1.1"),
                    "lin2": _lin(sd, f"{p}.ff1.4")},
            "attn": {"ln": _ln(sd, f"{p}.ln_attn"),
                     "in_proj_w": _w(sd[f"{p}.attn.in_proj_weight"]),
                     "in_proj_b": _t(sd[f"{p}.attn.in_proj_bias"]),
                     "out": _lin(sd, f"{p}.attn.out_proj")},
            "conv": {"ln": _ln(sd, f"{p}.conv_module.ln"),
                     "pw1": _lin(sd, f"{p}.conv_module.pw_conv1"),
                     "dw_w": _depthwise(sd[f"{p}.conv_module.dw_conv.weight"]),
                     "dw_b": _t(sd[f"{p}.conv_module.dw_conv.bias"]),
                     "ln_conv": _ln(sd, f"{p}.conv_module.ln_conv"),
                     "pw2": _lin(sd, f"{p}.conv_module.pw_conv2")},
            "ff2": {"ln": _ln(sd, f"{p}.ff2.0"), "lin1": _lin(sd, f"{p}.ff2.1"),
                    "lin2": _lin(sd, f"{p}.ff2.4")},
            "ln_final": _ln(sd, f"{p}.ln_final"),
        })
    params = {
        "day": {"weight": _t(sd["day_linear.day_weights"]),
                "bias": _t(sd["day_linear.day_bias"])[:, 0, :].contiguous()},
        "frontend": {"tconv_w": _depthwise(sd["frontend.temporal_conv.weight"]),
                     "proj": _lin(sd, "frontend.proj"),
                     "ln": _ln(sd, "frontend.ln")},
        "bottleneck": {"lin1": _lin(sd, "encoder.net.0"),
                       "lin2": _lin(sd, "encoder.net.2")},
        "blocks": blocks,
        "head": {"lin1": _lin(sd, "output.0"), "ln": _ln(sd, "output.1"),
                 "lin2": _lin(sd, "output.4")},
    }
    if cfg.use_interctc:
        params["inter_out"] = _lin(sd, "inter_output")
    return params


def import_state_dict(sd: Mapping, cfg: GRUConfig | ConformerConfig) -> dict:
    """Either family's reference state dict -> the port's tree."""
    if isinstance(cfg, ConformerConfig):
        return import_conformer_state_dict(sd, cfg)
    return import_gru_state_dict(sd, cfg)


def load_checkpoint(path: str, args: dict, device: torch.device | str = "cuda") -> Decoder:
    """A reference-layout state dict saved with ``torch.save`` -> a model of
    the family and widths of the run ``args`` on ``device`` (default
    ``"cuda"``), its day count read from the file's day weights."""
    dev = resolve_device(device, "load_checkpoint")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    day_key = ("day_linear.day_weights" if args.get("model_type") == "transformer_ctc"
               else "dayWeights")
    n_days = int(sd[day_key].shape[0])
    model = build_model(args, n_days, dev, int(args.get("seed", 0)))
    model.load_params(import_state_dict(sd, config_from_args(args, n_days)))
    return model
