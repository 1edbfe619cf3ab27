"""Export the port's parameter trees to reference PyTorch state dicts.

Port of ``neural_speech_decoder_tpu/models/torch_export.py`` and of
``scripts/export_checkpoint.py`` (``main``): a model trained by the port
becomes a state dict in the reference implementation's ``modelWeights``
layout, which the reference's ``loadModel`` loads with ``strict=True``.
The values are contiguous float32 CPU tensors.

Layout rules, the exact inverses of ``torch_import``:
  * the trees' ``[in, out]`` Linear / GRU weights transpose to torch's
    ``[out, in]`` (layer 0's over ``nn.Unfold``'s feature order ``c*k + j``,
    which the port's unfold shares: no permutation);
  * per-direction GRU tensors unstack into ``_reverse``-suffixed keys;
  * the day bias ``[nDays, D]`` unsqueezes to ``[nDays, 1, D]``;
  * the reference GRU's dead ``inpLayer{i}`` Linears (never used in its
    forward, absent from the tree) are synthesized as identity / zero so
    that strict loading succeeds;
  * the ``gaussianSmoother.weight`` buffer ``[C, 1, k]`` is regenerated from
    the config's sigma and tap count (``ops/gaussian.py::gaussian_kernel``);
  * depthwise ``[k, C]`` weights become ``[C, 1, k]``; the Conformer's
    strided depthwise convolution has no bias.

Command line (the port's ``scripts/export_checkpoint.py``)::

    python -m neural_speech_decoder_tpu_torch.models.torch_export RUN_DIR OUT \\
        [--nInputLayers N] [--device cpu|cuda]

loads the run's best-CER state with ``training/trainer.py::load_model`` on
``--device`` (default ``cuda``), exports it and ``torch.save``s the state
dict; ``models/torch_import.py::load_checkpoint`` reads it back.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops.gaussian import gaussian_kernel
from .conformer import ConformerConfig
from .gru import GRUConfig


def _f(x: torch.Tensor) -> torch.Tensor:
    """A contiguous float32 CPU copy."""
    return x.detach().to("cpu", torch.float32, copy=True).contiguous()


def _wt(x: torch.Tensor) -> torch.Tensor:
    """An ``[in, out]`` weight as torch's ``[out, in]``."""
    return _f(x).T.contiguous()


def export_gru_state_dict(params: dict, cfg: GRUConfig) -> dict[str, torch.Tensor]:
    """``init_gru_params``' tree -> reference ``GRUDecoder`` state dict."""
    c = cfg.neural_dim
    sd = {
        "dayWeights": _f(params["day"]["weight"]),
        "dayBias": _f(params["day"]["bias"])[:, None, :].contiguous(),
        "fc_decoder_out.weight": _wt(params["fc"]["weight"]),
        "fc_decoder_out.bias": _f(params["fc"]["bias"]),
    }
    taps = torch.from_numpy(gaussian_kernel(cfg.gaussian_kernel_size,
                                            cfg.gaussian_smooth_width))
    sd["gaussianSmoother.weight"] = taps[None, None, :].repeat(c, 1, 1)
    for li, lp in enumerate(params["gru"]["layers"]):
        for di, sfx in enumerate([f"l{li}", f"l{li}_reverse"][: cfg.num_dirs]):
            sd[f"gru_decoder.weight_ih_{sfx}"] = _wt(lp["w_ih"][di])
            sd[f"gru_decoder.weight_hh_{sfx}"] = _wt(lp["w_hh"][di])
            sd[f"gru_decoder.bias_ih_{sfx}"] = _f(lp["b_ih"][di])
            sd[f"gru_decoder.bias_hh_{sfx}"] = _f(lp["b_hh"][di])
    for day in range(cfg.n_days):
        sd[f"inpLayer{day}.weight"] = torch.eye(c, dtype=torch.float32)
        sd[f"inpLayer{day}.bias"] = torch.zeros(c, dtype=torch.float32)
    return sd


def _exp_lin(sd: dict, prefix: str, p: dict) -> None:
    sd[f"{prefix}.weight"] = _wt(p["w"])
    sd[f"{prefix}.bias"] = _f(p["b"])


def _exp_ln(sd: dict, prefix: str, p: dict) -> None:
    sd[f"{prefix}.weight"] = _f(p["scale"])
    sd[f"{prefix}.bias"] = _f(p["bias"])


def _depthwise(x: torch.Tensor) -> torch.Tensor:
    """``[k, C]`` -> ``[C, 1, k]``."""
    return _f(x).T[:, None, :].contiguous()


def export_conformer_state_dict(params: dict, cfg: ConformerConfig) -> dict[str, torch.Tensor]:
    """``init_conformer_params``' tree -> reference
    ``NeuralTransformerCTCModel`` state dict. Requires the canonical qkv
    layout: a ``qkv_interleaved`` config raises ``ValueError``."""
    if cfg.qkv_interleaved:
        raise ValueError(
            "export requires the canonical qkv layout; de-interleave the "
            "attention params first (the JAX package's parallel/shardings.py)")
    sd = {
        "day_linear.day_weights": _f(params["day"]["weight"]),
        "day_linear.day_bias": _f(params["day"]["bias"])[:, None, :].contiguous(),
        "frontend.temporal_conv.weight": _depthwise(params["frontend"]["tconv_w"]),
    }
    _exp_lin(sd, "frontend.proj", params["frontend"]["proj"])
    _exp_ln(sd, "frontend.ln", params["frontend"]["ln"])
    _exp_lin(sd, "encoder.net.0", params["bottleneck"]["lin1"])
    _exp_lin(sd, "encoder.net.2", params["bottleneck"]["lin2"])
    for i, bp in enumerate(params["blocks"]):
        p = f"conformer_layers.{i}"
        _exp_ln(sd, f"{p}.ff1.0", bp["ff1"]["ln"])
        _exp_lin(sd, f"{p}.ff1.1", bp["ff1"]["lin1"])
        _exp_lin(sd, f"{p}.ff1.4", bp["ff1"]["lin2"])
        _exp_ln(sd, f"{p}.ln_attn", bp["attn"]["ln"])
        sd[f"{p}.attn.in_proj_weight"] = _wt(bp["attn"]["in_proj_w"])
        sd[f"{p}.attn.in_proj_bias"] = _f(bp["attn"]["in_proj_b"])
        _exp_lin(sd, f"{p}.attn.out_proj", bp["attn"]["out"])
        _exp_ln(sd, f"{p}.conv_module.ln", bp["conv"]["ln"])
        _exp_lin(sd, f"{p}.conv_module.pw_conv1", bp["conv"]["pw1"])
        sd[f"{p}.conv_module.dw_conv.weight"] = _depthwise(bp["conv"]["dw_w"])
        sd[f"{p}.conv_module.dw_conv.bias"] = _f(bp["conv"]["dw_b"])
        _exp_ln(sd, f"{p}.conv_module.ln_conv", bp["conv"]["ln_conv"])
        _exp_lin(sd, f"{p}.conv_module.pw_conv2", bp["conv"]["pw2"])
        _exp_ln(sd, f"{p}.ff2.0", bp["ff2"]["ln"])
        _exp_lin(sd, f"{p}.ff2.1", bp["ff2"]["lin1"])
        _exp_lin(sd, f"{p}.ff2.4", bp["ff2"]["lin2"])
        _exp_ln(sd, f"{p}.ln_final", bp["ln_final"])
    _exp_lin(sd, "output.0", params["head"]["lin1"])
    _exp_ln(sd, "output.1", params["head"]["ln"])
    _exp_lin(sd, "output.4", params["head"]["lin2"])
    if cfg.use_interctc and "inter_out" in params:
        _exp_lin(sd, "inter_output", params["inter_out"])
    return sd


def export_state_dict(params: dict, cfg: GRUConfig | ConformerConfig) -> dict[str, torch.Tensor]:
    """Either family's tree -> its reference state dict."""
    if isinstance(cfg, ConformerConfig):
        return export_conformer_state_dict(params, cfg)
    return export_gru_state_dict(params, cfg)


def main(argv: list[str] | None = None) -> str:
    """Export a run directory's best-CER state (else its last) to a
    reference-layout state dict file; returns the output path."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_dir", help="the port's run directory")
    ap.add_argument("out", help="output path of the torch state dict")
    ap.add_argument("--nInputLayers", type=int, default=None,
                    help="day-count override (the reference loadModel's arg)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where load_model rebuilds the model (default cuda)")
    args = ap.parse_args(argv)
    from ..training.trainer import load_model

    model, margs = load_model(args.run_dir, args.nInputLayers, device=args.device)
    sd = export_state_dict(model.params, model.cfg)
    # CPU tensors: the file records no CUDA device (load with map_location)
    torch.save(sd, args.out)
    family = margs.get("model_type", "gru_baseline")
    n = sum(int(np.prod(v.shape)) for v in sd.values())
    print(f"exported {family} checkpoint ({len(sd)} tensors, {n:,} values) -> {args.out}")
    return args.out


if __name__ == "__main__":
    main()
