"""The model interface of the trainer and the serving path.

Port of ``neural_speech_decoder_tpu/training/trainer.py::build_model``: a
run's ``args`` become a ``GRUConfig`` and a ``GRUDecoder``
(``model_type: gru_baseline``, the default) or a ``ConformerConfig`` and a
``ConformerDecoder`` (``model_type: transformer_ctc``) with fresh weights,
and ``forward`` returns log-probabilities with the CTC output lengths (and
the Conformer's InterCTC log-probabilities in training), in train or eval
mode.
"""

from __future__ import annotations

import torch

from ..ops.rows import BatchShard
from ..ops.unfold import ctc_input_lengths
from ..parallel.shardings import check_shardable, shard_params
from ..parallel.tensor_parallel import ModelShard
from .conformer import (
    ConformerConfig,
    ConformerDecoder,
    conformer_forward,
    init_conformer_params,
)
from .gru import GRUConfig, GRUDecoder, gru_forward, init_gru_params

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
Decoder = GRUDecoder | ConformerDecoder


def config_from_args(args: dict, n_days: int) -> GRUConfig | ConformerConfig:
    """The config that ``build_model`` makes from a run's ``args``."""
    cdt = _DTYPES[str(args.get("compute_dtype", "float32"))]
    model_type = args.get("model_type", "gru_baseline")
    if model_type == "transformer_ctc":
        return ConformerConfig(
            n_channels=args["nInputFeatures"],
            n_classes=args["nClasses"],
            n_days=n_days,
            frontend_dim=args.get("frontend_dim", 1024),
            latent_dim=args.get("latent_dim", 1024),
            autoencoder_hidden_dim=args.get("autoencoder_hidden_dim", 512),
            num_layers=args.get("transformer_num_layers", 8),
            num_heads=args.get("transformer_n_heads", 8),
            ff_dim=args.get("transformer_dim_ff", 2048),
            dropout=args.get("transformer_dropout", 0.3),
            temporal_kernel=args.get("temporal_kernel", 32),
            temporal_stride=args.get("temporal_stride", 4),
            gaussian_smooth_width=args.get("gaussian_smooth_width", 2.0),
            conv_kernel=args.get("conformer_conv_kernel", 31),
            use_spec_augment=args.get("use_spec_augment", True),
            spec_augment_freq_mask=args.get("spec_augment_freq_mask", 100),
            spec_augment_time_mask=args.get("spec_augment_time_mask", 40),
            drop_path_prob=args.get("drop_path_prob", 0.1),
            compute_dtype=cdt,
            fused_attention=bool(args.get("fused_attention", True)),
            fused_ffn=bool(args.get("fused_ffn", False)),
            fused_conv=bool(args.get("fused_conv", False)),
            causal=args.get("causal", False),
            attn_left_context=args.get("attn_left_context", 128),
            # tensor parallelism reads whole heads in the interleaved layout
            # (parallel/shardings.py), so it is the default there, as in JAX
            qkv_interleaved=bool(args.get(
                "qkv_interleaved", int(args.get("n_model_devices") or 1) > 1)),
        )
    if model_type != "gru_baseline":
        raise NotImplementedError(f"model_type {model_type!r}")
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
        compute_dtype=cdt,
        use_pallas_matmul=bool(args.get("use_pallas_matmul") or False),
        use_pallas=None if args.get("use_pallas") is None else bool(args["use_pallas"]),
    )


def model_type_of(cfg: GRUConfig | ConformerConfig) -> str:
    """The ``model_type`` arg of a config's family."""
    return "transformer_ctc" if isinstance(cfg, ConformerConfig) else "gru_baseline"


def shard_model(model: Decoder, tp: ModelShard, *, interleave: bool = True) -> Decoder:
    """A decoder on ``model``'s device and config that holds this model
    rank's shards of ``model``'s whole parameters (``parallel/
    shardings.py``'s rules; for the Conformer, after the qkv interleave when
    ``interleave``, as JAX's trainer shards a fresh init) and runs its
    forward with the model group's collectives (``model.tp``). Raises
    ``ValueError`` for a config whose sharded dimensions do not divide."""
    cfg = model.cfg
    check_shardable(cfg, tp.count)
    with torch.no_grad():
        whole = _detached(model.params)
        heads = cfg.num_heads if interleave and isinstance(cfg, ConformerConfig) else None
        params = shard_params(whole, tp, model_type_of(cfg), num_heads=heads)
        out = type(model)(cfg, _detached(params, clone=True))
    out.tp = tp
    return out


def _detached(tree, clone: bool = False):
    if isinstance(tree, dict):
        return {k: _detached(v, clone) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_detached(v, clone) for v in tree]
    t = tree.detach()
    return t.clone() if clone else t


def build_model(
    args: dict, n_days: int, device: torch.device | str, seed: int = 0
) -> Decoder:
    """The decoder a run's ``args`` describe, with weights drawn on
    ``device`` from ``seed``."""
    cfg = config_from_args(args, n_days)
    gen = torch.Generator(device=device).manual_seed(seed)
    if isinstance(cfg, ConformerConfig):
        return ConformerDecoder(cfg, init_conformer_params(cfg, gen))
    return GRUDecoder(cfg, init_gru_params(cfg, gen))


def forward(
    model: Decoder,
    x: torch.Tensor,
    day_idx: torch.Tensor,
    x_lens: torch.Tensor,
    *,
    train: bool = False,
    generator: torch.Generator | None = None,
    plain: bool = False,
    shard: BatchShard | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """``(log_probs [B, L, n_classes+1], out_lens [B], inter_log_probs)``:
    float32 log-probabilities, the CTC input lengths clipped to ``[0, L]``,
    and the Conformer's InterCTC log-probabilities in training (else
    None). ``train`` runs the training forward with its randomness from
    ``generator``; ``plain`` the kernels' plain versions; ``shard`` says
    which rows of a data-parallel global batch x holds (``ops/rows.py``).
    A model sharded for tensor parallelism (``model.tp``) runs its rank's
    share, with the model group's collectives."""
    return forward_params(model.cfg, model.params, x, day_idx, x_lens, train=train,
                          generator=generator, plain=plain, shard=shard,
                          tp=getattr(model, "tp", None))


def forward_params(
    cfg: GRUConfig | ConformerConfig,
    params: dict,
    x: torch.Tensor,
    day_idx: torch.Tensor,
    x_lens: torch.Tensor,
    *,
    train: bool = False,
    generator: torch.Generator | None = None,
    plain: bool = False,
    shard: BatchShard | None = None,
    tp: ModelShard | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """``forward`` of the decoder ``cfg`` describes, on the parameter tree
    ``params`` (what ``serving/export.py`` traces, with the tree's leaves
    as the exported program's inputs); ``tp``: params holds this model
    rank's shards."""
    if isinstance(cfg, ConformerConfig):
        return conformer_forward(params, cfg, x, day_idx, x_lens, train=train,
                                 generator=generator, plain=plain, shard=shard, tp=tp)
    logits = gru_forward(params, cfg, x, day_idx, train=train, generator=generator,
                         plain=plain, shard=shard, tp=tp)
    out_lens = ctc_input_lengths(x_lens, cfg.kernel_len, cfg.stride_len)
    out_lens = out_lens.to(logits.device).clamp(0, logits.shape[1])
    return torch.log_softmax(logits, dim=-1), out_lens, None
