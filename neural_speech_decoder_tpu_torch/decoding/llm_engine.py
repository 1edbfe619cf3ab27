"""Reference-scale causal-LM rescoring engine (OPT-6.7B class on one H100).

The port's counterpart of ``neural_speech_decoder_tpu/decoding/llm_engine.py``.
The reference's rescoring pass is OPT-6.7B loaded in 8-bit through
torch + bitsandbytes on a large GPU (``eval_competition.py:84-86``).
``decoding/torch_lm.py`` proves the scoring math, but its loader
materializes the whole checkpoint as a float32 ``transformers`` model
first — fine at 85M parameters, a wall at 6.7B. This module is the
reference-scale path, and it needs neither ``transformers``,
``tokenizers``, ``safetensors`` nor ``ml_dtypes``:

  * **Streamed loading** (``stream_load_hf``): the checkpoint is read
    tensor by tensor (``.safetensors`` — single or sharded index — read by
    this module's own reader over ``np.memmap``; torch ``.bin`` with
    ``mmap=True``) and each tensor is cast with torch (round to nearest
    even) to the target dtype at once, written straight into preallocated
    stacked ``[L, ...]`` tensors. ``load_tensors`` is the same mapping from
    HF tensor names to engine leaves over any ``(name, array)`` stream
    (``bigram_opt.py`` feeds it a constructed model without the disk).
  * **int8 weight-only quantization** (``quantize_int8``): per-output-
    channel symmetric scales on every block matmul weight, in torch on the
    leaves' device (host or card), bit for bit the JAX package's numpy
    quantizer. Dequantized in eager torch as
    ``q.to(cdt) * s`` per product (a bf16 copy of the layer weight per
    batch: correct, and slower than bf16 weights).
  * **No tensor parallelism yet**: a ``mesh`` raises ``NotImplementedError``.

Engine parameter layout (head-major):

  blocks (stacked ``[L, ...]``):
    ln1_g/ln1_b/ln2_g/ln2_b [D]
    wqkv [D, 3, D]  bqkv [3, D]     (axis 1 = q/k/v)
    wo   [D, D]     bo   [D]
    wfc  [D, F]     bfc  [F]
    wproj[F, D]     bproj[D]
  top: wte [V, W], wpe [P, D], lnf_g/lnf_b [D], optional win [W, D] /
  wout [D, W] for OPT's split word/hidden dims (350m-style).

int8 leaves replace a float weight ``w`` with ``w_q`` (int8) + ``w_s``
(float32 per-output-channel scale, broadcastable against the product).
The engine's qkv rounds unlike ``torch_lm``'s: a float32-accumulated
product, a float32 bias, then one cast to the compute dtype.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from ..utils.device import resolve_device
from .torch_lm import (
    DTYPES,
    _act,
    _layer_norm,
    attend,
    attention_mask,
    make_batched_scorer,
    to_device,
    token_logprob_sum,
)

__all__ = [
    "EngineSpec",
    "OPT_SIZES",
    "opt_spec",
    "opt_tensor_plan",
    "stream_load_hf",
    "load_tensors",
    "from_lm",
    "quantize_int8",
    "synth_params",
    "synth_params_on_device",
    "engine_forward_logits",
    "engine_sentence_logprobs",
    "llm_shardings",
    "shard_params",
    "load_tokenizer",
    "engine_scorer",
]


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """Architecture of an OPT-family decoder (``eval_competition.py:84``)."""

    n_layer: int
    d_model: int
    ffn_dim: int
    n_head: int
    vocab: int = 50272
    n_positions: int = 2048
    word_dim: int | None = None  # != d_model only for the 350m-style split
    activation: str = "relu"
    pos_offset: int = 2  # OPTLearnedPositionalEmbedding offset
    ln_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head

    @property
    def w_dim(self) -> int:
        return self.word_dim or self.d_model

    @property
    def n_params(self) -> int:
        d, f, v = self.d_model, self.ffn_dim, self.vocab
        per_layer = 4 * d * d + 2 * d * f + 3 * d + d + f + d + 4 * d
        return self.n_layer * per_layer + v * self.w_dim + (
            self.n_positions + self.pos_offset
        ) * d + 2 * d


# OPT model family dims (Zhang et al. 2022, table 1) — the reference uses
# the 6.7b row (``scripts/eval_competition.py:84-86``).
OPT_SIZES: dict[str, tuple[int, int, int, int, int | None]] = {
    "125m": (12, 768, 3072, 12, None),
    "350m": (24, 1024, 4096, 16, 512),
    "1.3b": (24, 2048, 8192, 32, None),
    "2.7b": (32, 2560, 10240, 32, None),
    "6.7b": (32, 4096, 16384, 32, None),
    "13b": (40, 5120, 20480, 40, None),
}


def opt_spec(size: str) -> EngineSpec:
    l, d, f, h, w = OPT_SIZES[size]
    return EngineSpec(n_layer=l, d_model=d, ffn_dim=f, n_head=h, word_dim=w)


def opt_tensor_plan(spec: EngineSpec) -> list[tuple[str, tuple[int, ...]]]:
    """``(name, shape)`` of every tensor of an ``OPTForCausalLM`` checkpoint
    of ``spec``, in HF order (nn.Linear weights ``[out, in]``)."""
    d, f, w = spec.d_model, spec.ffn_dim, spec.w_dim
    plan = [("model.decoder.embed_tokens.weight", (spec.vocab, w)),
            ("model.decoder.embed_positions.weight", (spec.n_positions + spec.pos_offset, d))]
    if spec.word_dim is not None:
        plan += [("model.decoder.project_in.weight", (d, w)),
                 ("model.decoder.project_out.weight", (w, d))]
    plan += [("model.decoder.final_layer_norm.weight", (d,)),
             ("model.decoder.final_layer_norm.bias", (d,))]
    for i in range(spec.n_layer):
        p = f"model.decoder.layers.{i}."
        for proj in ("k_proj", "v_proj", "q_proj", "out_proj"):
            plan += [(p + f"self_attn.{proj}.weight", (d, d)),
                     (p + f"self_attn.{proj}.bias", (d,))]
        plan += [(p + "self_attn_layer_norm.weight", (d,)),
                 (p + "self_attn_layer_norm.bias", (d,)),
                 (p + "fc1.weight", (f, d)), (p + "fc1.bias", (f,)),
                 (p + "fc2.weight", (d, f)), (p + "fc2.bias", (d,)),
                 (p + "final_layer_norm.weight", (d,)),
                 (p + "final_layer_norm.bias", (d,))]
    return plan


# ---------------------------------------------------------------------------
# Streamed checkpoint loading
# ---------------------------------------------------------------------------


def _weight_files(path: str) -> list[str]:
    """Checkpoint weight files in load order (single or sharded-index)."""
    for idx_name in ("model.safetensors.index.json", "pytorch_model.bin.index.json"):
        idx = os.path.join(path, idx_name)
        if os.path.exists(idx):
            with open(idx) as f:
                names = sorted(set(json.load(f)["weight_map"].values()))
            return [os.path.join(path, n) for n in names]
    for name in ("model.safetensors", "pytorch_model.bin"):
        p = os.path.join(path, name)
        if os.path.exists(p):
            return [p]
    raise FileNotFoundError(f"no weight files found under {path}")


# safetensors dtype codes -> (numpy dtype to read the bytes as, torch view)
_ST_DTYPES = {
    "F64": (np.float64, None), "F32": (np.float32, None), "F16": (np.float16, None),
    "BF16": (np.int16, torch.bfloat16), "I64": (np.int64, None),
    "I32": (np.int32, None), "I16": (np.int16, None), "I8": (np.int8, None),
    "U8": (np.uint8, None), "BOOL": (np.bool_, None),
}


def read_safetensors(file: str) -> Iterator[tuple[str, torch.Tensor]]:
    """Yield ``(name, tensor)`` from a ``.safetensors`` file, one at a time:
    an 8-byte little-endian header length, a JSON header of dtypes, shapes
    and byte offsets, then the data, read through ``np.memmap`` (BF16 as
    int16 bits viewed as ``torch.bfloat16``)."""
    with open(file, "rb") as f:
        (n,) = np.frombuffer(f.read(8), "<u8")
        header = json.loads(f.read(int(n)))
    base = 8 + int(n)
    mm = np.memmap(file, dtype=np.uint8, mode="r")
    for name, info in header.items():
        if name == "__metadata__":
            continue
        np_dt, view = _ST_DTYPES[info["dtype"]]
        lo, hi = info["data_offsets"]
        arr = mm[base + lo: base + hi].view(np.dtype(np_dt).newbyteorder("<"))
        t = torch.from_numpy(np.array(arr.reshape(info["shape"]), copy=True))
        yield name, t.view(view) if view is not None else t


def _iter_tensors(file: str) -> Iterator[tuple[str, torch.Tensor]]:
    """Yield ``(name, tensor)`` one tensor at a time (no whole-model
    materialization): safetensors through ``read_safetensors``, torch
    ``.bin`` files with ``mmap=True``."""
    if file.endswith(".safetensors"):
        yield from read_safetensors(file)
        return
    try:
        sd = torch.load(file, map_location="cpu", mmap=True, weights_only=True)
    except TypeError:  # older torch: no mmap kwarg
        sd = torch.load(file, map_location="cpu", weights_only=True)
    for name, t in sd.items():
        yield name, t.detach()


def _spec_from_config(path: str) -> EngineSpec:
    with open(os.path.join(path, "config.json")) as f:
        cfg = json.load(f)
    if cfg.get("model_type") != "opt":
        raise NotImplementedError(
            "stream_load_hf covers the OPT family (the reference's "
            "rescorer, eval_competition.py:84); use "
            "torch_lm.load_causal_lm for GPT-2-class checkpoints"
        )
    if not cfg.get("do_layer_norm_before", True):
        raise NotImplementedError("post-LN OPT variants are not supported")
    d = cfg["hidden_size"]
    w = cfg.get("word_embed_proj_dim", d)
    return EngineSpec(
        n_layer=cfg["num_hidden_layers"],
        d_model=d,
        ffn_dim=cfg["ffn_dim"],
        n_head=cfg["num_attention_heads"],
        vocab=cfg["vocab_size"],
        n_positions=cfg["max_position_embeddings"],
        word_dim=None if w == d else w,
        activation=cfg.get("activation_function", "relu"),
    )


def _engine_shapes(spec: EngineSpec) -> dict:
    """Shape of every float leaf of the engine tree."""
    l, d, f = spec.n_layer, spec.d_model, spec.ffn_dim
    out = {
        "wte": (spec.vocab, spec.w_dim), "wpe": (spec.n_positions + spec.pos_offset, d),
        "lnf_g": (d,), "lnf_b": (d,),
        "blocks": {
            "ln1_g": (l, d), "ln1_b": (l, d), "ln2_g": (l, d), "ln2_b": (l, d),
            "wqkv": (l, d, 3, d), "bqkv": (l, 3, d), "wo": (l, d, d), "bo": (l, d),
            "wfc": (l, d, f), "bfc": (l, f), "wproj": (l, f, d), "bproj": (l, d),
        },
    }
    if spec.word_dim is not None:
        out["win"] = (spec.w_dim, d)
        out["wout"] = (d, spec.w_dim)
    return out


_QUANT_LEAVES = ("wqkv", "wo", "wfc", "wproj")


def _quant_shapes(spec: EngineSpec) -> dict:
    """``name -> (q shape, scale shape)`` of the int8 block leaves."""
    l, d, f = spec.n_layer, spec.d_model, spec.ffn_dim
    return {"wqkv": ((l, d, 3, d), (l, 3, 1, d)), "wo": ((l, d, d), (l, 1, d)),
            "wfc": ((l, d, f), (l, 1, f)), "wproj": ((l, f, d), (l, 1, d))}


def _alloc(shapes, dtype, device="cpu"):
    if isinstance(shapes, dict):
        return {k: _alloc(v, dtype, device) for k, v in shapes.items()}
    return torch.empty(shapes, dtype=dtype, device=device)


def stream_load_hf(path: str, param_dtype: str = "bfloat16", quantize: bool = False):
    """Load an OPT-family HF checkpoint into the engine layout, one tensor
    at a time, casting to ``param_dtype`` at read time.

    Returns ``(params, spec)``: a tree of CPU tensors. With
    ``quantize=True`` the four block matmul weights are int8-quantized
    *in the stream*: each layer's slice is staged in ``param_dtype`` and
    quantized the moment its source tensors have all arrived, so the
    full-precision ``[L, ...]`` stacks are never materialized; bit-identical
    to ``quantize_int8(stream_load_hf(path)[0])``.
    """
    spec = _spec_from_config(path)
    tensors = (nt for file in _weight_files(path) for nt in _iter_tensors(file))
    return load_tensors(spec, tensors, param_dtype, quantize, where=path), spec


def load_tensors(spec: EngineSpec, tensors: Iterable[tuple[str, object]],
                 param_dtype: str = "bfloat16", quantize: bool = False,
                 where: str = "the tensor stream") -> dict:
    """The engine tree of ``spec`` from ``(HF name, array or tensor)``
    pairs, each cast to ``param_dtype`` as it arrives (``stream_load_hf``'s
    mapping; also fed by ``bigram_opt.engine_params`` without the disk)."""
    dtype = DTYPES[param_dtype]
    shapes = _engine_shapes(spec)
    if quantize:
        for name in _QUANT_LEAVES:
            del shapes["blocks"][name]
    params = _alloc(shapes, dtype)
    blocks = params["blocks"]
    staging: dict = {}
    pending = {}  # (leaf, layer) -> writes still expected
    if quantize:
        for name, (q_shape, s_shape) in _quant_shapes(spec).items():
            blocks[name + "_q"] = torch.empty(q_shape, dtype=torch.int8)
            blocks[name + "_s"] = torch.empty(s_shape, dtype=torch.float32)

    def _stage(name: str, li: int):
        """Per-layer staging slice for a quantized leaf (lazy-alloc)."""
        key = (name, li)
        if key not in staging:
            staging[key] = torch.empty(blocks[name + "_q"].shape[1:], dtype=dtype)
            pending[key] = 3 if name == "wqkv" else 1
        return staging[key]

    def _maybe_quantize(name: str, li: int):
        key = (name, li)
        pending[key] -= 1
        if pending[key]:
            return
        w = staging.pop(key)
        del pending[key]
        if name == "wqkv":  # [D,3,D] -> in axis next to out (see quantize_int8)
            q, s = _quant_leaf(w.movedim(0, 1))
            q = q.movedim(0, 1)
        else:
            q, s = _quant_leaf(w)
        blocks[name + "_q"][li] = q
        blocks[name + "_s"][li] = s

    qkv_slot = {"q_proj": 0, "k_proj": 1, "v_proj": 2}
    top_map = {
        "model.decoder.embed_tokens.weight": "wte",
        "model.decoder.embed_positions.weight": "wpe",
        "model.decoder.final_layer_norm.weight": "lnf_g",
        "model.decoder.final_layer_norm.bias": "lnf_b",
        "model.decoder.project_in.weight": "win",
        "model.decoder.project_out.weight": "wout",
    }
    leaf_map = {
        "self_attn_layer_norm.weight": "ln1_g",
        "self_attn_layer_norm.bias": "ln1_b",
        "final_layer_norm.weight": "ln2_g",
        "final_layer_norm.bias": "ln2_b",
        "self_attn.out_proj.weight": "wo",
        "self_attn.out_proj.bias": "bo",
        "fc1.weight": "wfc", "fc1.bias": "bfc",
        "fc2.weight": "wproj", "fc2.bias": "bproj",
    }
    n_written = 0
    for name, arr in tensors:
        # Normalize checkpoint-prefix variants to OPTForCausalLM's
        # "model.decoder.*": OPTModel saves "decoder.*", a bare OPTDecoder
        # saves "layers.*"/"embed_tokens.*".
        if name == "lm_head.weight":  # tied to wte
            continue
        if name.startswith("decoder."):
            name = "model." + name
        elif not name.startswith("model."):
            name = "model.decoder." + name
        a = torch.as_tensor(arr)  # cast to dtype by the copy into its slot
        if name in top_map:
            dst = top_map[name]
            params[dst][...] = a.T if dst in ("win", "wout") else a
            n_written += 1
            continue
        if not name.startswith("model.decoder.layers."):
            continue
        li_s, leaf = name[len("model.decoder.layers."):].split(".", 1)
        li = int(li_s)
        proj = leaf.split(".")[1] if leaf.startswith("self_attn.") else ""
        if proj in qkv_slot:
            slot = qkv_slot[proj]
            if leaf.endswith(".weight"):
                if quantize:
                    _stage("wqkv", li)[:, slot, :] = a.T
                    _maybe_quantize("wqkv", li)
                else:
                    blocks["wqkv"][li, :, slot, :] = a.T
            else:
                blocks["bqkv"][li, slot, :] = a
        else:
            dst = leaf_map[leaf]
            # nn.Linear stores [out, in]; engine matmuls are x @ W
            if quantize and dst in _QUANT_LEAVES:
                _stage(dst, li)[...] = a.T
                _maybe_quantize(dst, li)
            else:
                blocks[dst][li] = a.T if dst in ("wo", "wfc", "wproj") else a
        n_written += 1
    # Completeness check: params start as torch.empty — a naming mismatch
    # that silently skipped tensors would otherwise score with
    # uninitialized memory.
    expected = spec.n_layer * 16 + 4 + (2 if spec.word_dim else 0)
    if n_written != expected:
        raise ValueError(
            f"checkpoint at {where} filled {n_written}/{expected} engine "
            f"tensors — unrecognized parameter naming scheme"
        )
    if staging:  # a (leaf, layer) never saw all its source tensors
        raise ValueError(
            f"checkpoint at {where} left {sorted(staging)} staged but "
            f"never completed — duplicate/missing qkv tensors?"
        )
    return params


def from_lm(params: dict, spec_like) -> tuple[dict, EngineSpec]:
    """Convert a ``torch_lm.load_causal_lm`` tree (fused ``[D, 3D]`` qkv)
    into the engine's head-major layout — the bridge used by tests to pin
    the two forwards against each other."""
    b = {k: torch.as_tensor(v) for k, v in params["blocks"].items()}
    l, d, _ = b["wo"].shape
    out_blocks = dict(b)
    out_blocks["wqkv"] = b["wqkv"].reshape(l, d, 3, d)
    out_blocks["bqkv"] = b["bqkv"].reshape(l, 3, d)
    out = {k: torch.as_tensor(v) for k, v in params.items() if k != "blocks"}
    out["blocks"] = out_blocks
    spec = EngineSpec(
        n_layer=l,
        d_model=d,
        ffn_dim=out_blocks["wfc"].shape[-1],
        n_head=spec_like.n_head,
        vocab=out["wte"].shape[0],
        n_positions=spec_like.n_positions,
        word_dim=out["wte"].shape[1] if "win" in out else None,
        activation=spec_like.activation,
        pos_offset=spec_like.pos_offset,
        ln_eps=spec_like.ln_eps,
    )
    return out, spec


# ---------------------------------------------------------------------------
# int8 weight-only quantization (reference runs OPT in 8-bit)
# ---------------------------------------------------------------------------


def _quant_leaf(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 on ``w``'s device. ``w``:
    [..., in, out]-ish with the *output* (channel) axis last; the scale
    broadcasts over all others. The arithmetic of the JAX package's numpy
    ``_quant_leaf`` (float32 ``amax / 127``, ``w / s`` rounded half to even,
    clipped to [-127, 127]), bit for bit.

    Processes leading-axis chunks with in-place float32 ops (a whole-leaf
    expression chain at 6.7B allocates several multi-GB temporaries per
    op); the reduction axis (-2) is inside each chunk, so chunking the
    leading axis is exact."""
    if w.dim() < 2:  # pragma: no cover - engine weights are all >=2D
        raise ValueError("quantization expects >=2D weights")
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    scale = torch.empty(w.shape[:-2] + (1,) + w.shape[-1:], dtype=torch.float32,
                        device=w.device)
    if w.dim() == 2:  # leading axis IS the reduction axis — never split it
        step = w.shape[0]
    else:
        step = max(1, int(2**28) // max(math.prod(w.shape[1:]), 1))
    for i in range(0, w.shape[0], step):
        # copy=True: the in-place ops below must not write into the
        # caller's float32 leaf
        w32 = w[i : i + step].to(torch.float32, copy=True)
        amax = w32.abs().amax(dim=-2, keepdim=True)
        s = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
        w32.div_(s).round_().clamp_(-127, 127)
        q[i : i + step] = w32.to(torch.int8)
        scale[i : i + step] = s
    return q, scale


def quantize_int8(params: dict) -> dict:
    """Replace every block matmul weight with ``(w_q int8, w_s float32)``,
    on the leaves' device.

    Embeddings / norms / biases stay in the float dtype: they are small,
    and the float32 logit head needs full-precision wte.
    """
    out = {k: v for k, v in params.items() if k != "blocks"}
    blocks = dict(params["blocks"])
    for name in _QUANT_LEAVES:
        w = torch.as_tensor(blocks.pop(name))
        # wqkv is [L, D, 3, D]: in axis is 1, out is (2,3) — move in next
        # to out so the shared helper's axis convention holds.
        if name == "wqkv":
            q, s = _quant_leaf(w.movedim(1, 2))
            q = q.movedim(2, 1).contiguous()  # s: [L, 3, 1, D] — broadcasts on out
        else:
            q, s = _quant_leaf(w)
        blocks[name + "_q"] = q
        blocks[name + "_s"] = s
    out["blocks"] = blocks
    return out


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _deq(p: dict, name: str, cdt):
    """A block weight in the compute dtype, int8 leaves dequantized as
    ``q.to(cdt) * s.to(cdt)``."""
    if name + "_q" in p:
        s = p[name + "_s"]
        if name == "wqkv":  # scale stored [3, 1, D] against [D, 3, D]
            s = s.movedim(0, 1)
        return p[name + "_q"].to(cdt) * s.to(cdt)
    return p[name].to(cdt)


def _mm_f32(a, b):
    """``a @ b`` summed in float32 over exact products of the operands."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32).reshape(
            *a.shape[:-1], b.shape[-1])
    return a.float() @ b.float()


def engine_forward_logits(params, spec: EngineSpec, ids, mask, compute_dtype, head=None):
    """[B, T] ids/mask -> [B, T, V] float32 logits (causal + padding mask).

    ``head``: the float32 copy of ``wte`` the tied head reads (``engine_scorer``
    makes it once); by default cast here."""
    b, t = ids.shape
    cdt = compute_dtype
    x = params["wte"][ids].to(cdt)
    if "win" in params:
        x = x @ params["win"].to(cdt)
    x = x + params["wpe"][spec.pos_offset: spec.pos_offset + t].to(cdt)
    n_head, dh, d = spec.n_head, spec.head_dim, spec.d_model
    ok = attention_mask(mask, t)
    x = x.to(cdt)
    blocks = params["blocks"]
    for li in range(spec.n_layer):
        p = {k: v[li] for k, v in blocks.items()}
        h = _layer_norm(x, p["ln1_g"], p["ln1_b"], spec.ln_eps).to(cdt)
        qkv = (_mm_f32(h, _deq(p, "wqkv", cdt).reshape(d, 3 * d))
               + p["bqkv"].float().reshape(3 * d)).to(cdt)
        q, k, v = (z.reshape(b, t, n_head, dh).transpose(1, 2)
                   for z in qkv.split(d, dim=-1))
        ctx = attend(q, k, v, ok, cdt).transpose(1, 2).reshape(b, t, d)
        x = x + ctx @ _deq(p, "wo", cdt) + p["bo"].to(cdt)
        h = _layer_norm(x, p["ln2_g"], p["ln2_b"], spec.ln_eps).to(cdt)
        h = _act(h @ _deq(p, "wfc", cdt) + p["bfc"].to(cdt), spec.activation)
        x = x + h @ _deq(p, "wproj", cdt) + p["bproj"].to(cdt)
    x = _layer_norm(x, params["lnf_g"], params["lnf_b"], spec.ln_eps)
    if "wout" in params:
        x = x @ params["wout"].float()
    return x @ (params["wte"].float() if head is None else head).T


@torch.no_grad()
def engine_sentence_logprobs(params, spec, ids, mask, compute_dtype=torch.bfloat16,
                             head=None):
    """Per-row ``sum_t log P(tok_t | tok_<t)`` over non-pad tokens —
    ``rescore.hf_causal_scorer`` semantics."""
    logits = engine_forward_logits(params, spec, ids, mask, compute_dtype, head)
    return token_logprob_sum(logits, ids, mask)


# ---------------------------------------------------------------------------
# Synthetic parameters (benchmarking without a 13 GB checkpoint)
# ---------------------------------------------------------------------------


def synth_params(spec: EngineSpec, seed: int = 0, dtype="bfloat16") -> dict:
    """Host-side random engine params (GPT-style 0.02 init, numpy draws)
    for small-scale tests; for 6.7B-class runs use
    ``synth_params_on_device``."""
    rng = np.random.default_rng(seed)
    tdt = DTYPES[dtype]

    def make(name, shape):
        if name.startswith("ln") and name.endswith("_g"):
            return torch.ones(shape, dtype=tdt)
        if name.startswith("ln") or name.startswith("b"):
            return torch.zeros(shape, dtype=tdt)
        return torch.from_numpy(rng.standard_normal(shape, np.float32) * 0.02).to(tdt)

    shapes = _engine_shapes(spec)
    out = {k: make(k, v) for k, v in shapes.items() if k != "blocks"}
    out["blocks"] = {k: make(k, v) for k, v in shapes["blocks"].items()}
    return out


def synth_params_on_device(spec: EngineSpec, seed: int = 0, dtype=torch.bfloat16,
                           shardings=None, quantize: bool = False,
                           device: str = "cuda") -> dict:
    """The whole engine tree drawn on ``device`` from one seeded
    ``torch.Generator``, each leaf directly in its dtype (no float32
    temporary, so peak memory is the tree's size): float leaves normal x
    0.02, int8 leaves uniform in [-127, 127] with constant scales
    ``4 * 0.02 / 127`` (matched to the float init), layer-norm gains 1.
    Shapes and dtypes are the JAX package's ``_synth_shapes``; the draws
    are the port's own."""
    if shardings is not None:
        raise NotImplementedError("sharded engine parameters (tensor parallelism) "
                                  "are not ported yet")
    dev = resolve_device(device, "synth_params_on_device")
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(shape):
        return torch.empty(shape, dtype=dtype, device=dev).normal_(0.0, 0.02, generator=gen)

    shapes = _engine_shapes(spec)
    out = {k: normal(v) for k, v in shapes.items() if k != "blocks"}
    blocks = {}
    quant = _quant_shapes(spec) if quantize else {}
    for name, shape in shapes["blocks"].items():
        if name in quant:
            q_shape, s_shape = quant[name]
            blocks[name + "_q"] = torch.randint(-127, 128, q_shape, dtype=torch.int8,
                                                device=dev, generator=gen)
            blocks[name + "_s"] = torch.full(s_shape, 4 * 0.02 / 127.0,
                                             dtype=torch.float32, device=dev)
        else:
            blocks[name] = normal(shape)
    # norms want gain 1 for a numerically sane forward
    for g in ("ln1_g", "ln2_g"):
        blocks[g].fill_(1.0)
    out["lnf_g"].fill_(1.0)
    out["blocks"] = blocks
    return out


# ---------------------------------------------------------------------------
# Tensor parallelism: not ported yet
# ---------------------------------------------------------------------------


def llm_shardings(spec: EngineSpec, mesh, axis: str = "model") -> dict:
    """Tensor-parallel layouts over a device mesh: not ported yet."""
    raise NotImplementedError("tensor-parallel rescoring over a mesh is not ported "
                              "yet; score on one device (mesh=None)")


def shard_params(params: dict, spec: EngineSpec, mesh, axis: str = "model"):
    """Tensor-parallel placement over a device mesh: not ported yet."""
    return llm_shardings(spec, mesh, axis)


# ---------------------------------------------------------------------------
# Tokenizer and scorer
# ---------------------------------------------------------------------------


class WordLevelTokenizer:
    """A ``tokenizer.json`` of the WordLevel kind read in plain Python: the
    vocabulary, the ``Whitespace`` pre-tokenizer (``\\w+|[^\\w\\s]+``) and a
    ``TemplateProcessing`` post-processor's special-token prefix — the kind
    ``bigram_opt.build_wordlevel_tokenizer`` writes. Called like a HF
    tokenizer: ``tok(sentences, padding=True)`` pads on the right."""

    _SPLIT = re.compile(r"\w+|[^\w\s]+")

    def __init__(self, path: str):
        with open(os.path.join(path, "tokenizer.json")) as f:
            spec = json.load(f)
        model = spec.get("model") or {}
        pre = spec.get("pre_tokenizer") or {}
        post = spec.get("post_processor")
        if (model.get("type") != "WordLevel" or pre.get("type") != "Whitespace"
                or spec.get("normalizer") is not None
                or (post is not None and post.get("type") != "TemplateProcessing")):
            raise NotImplementedError(
                f"{path}: only WordLevel tokenizers with a Whitespace pre-tokenizer "
                "are read without transformers; install transformers for this one")
        self.vocab = model["vocab"]
        self.unk_id = self.vocab[model["unk_token"]]
        self.prefix, self.suffix = [], []
        if post is not None:
            special = post["special_tokens"]
            items = post["single"]
            seq = [i for i, it in enumerate(items) if "Sequence" in it]
            if len(seq) != 1:
                raise NotImplementedError(f"{path}: template {items} unsupported")
            for it in items[: seq[0]]:
                self.prefix += special[it["SpecialToken"]["id"]]["ids"]
            for it in items[seq[0] + 1:]:
                self.suffix += special[it["SpecialToken"]["id"]]["ids"]
        cfg_path = os.path.join(path, "tokenizer_config.json")
        cfg = json.load(open(cfg_path)) if os.path.exists(cfg_path) else {}
        pad = cfg.get("pad_token") or cfg.get("eos_token")
        if isinstance(pad, dict):
            pad = pad.get("content")
        if pad not in self.vocab:
            raise NotImplementedError(f"{path}: no pad or eos token in the vocabulary")
        self.pad_id = self.vocab[pad]

    def encode(self, text: str) -> list[int]:
        words = self._SPLIT.findall(text)
        return self.prefix + [self.vocab.get(w, self.unk_id) for w in words] + self.suffix

    def __call__(self, sentences, padding=True):
        ids = [self.encode(s) for s in sentences]
        t = max(len(r) for r in ids) if padding else None
        return {
            "input_ids": [r + [self.pad_id] * (t - len(r)) if padding else r for r in ids],
            "attention_mask": [[1] * len(r) + [0] * ((t - len(r)) if padding else 0)
                               for r in ids],
        }


def load_tokenizer(path: str) -> Callable:
    """The checkpoint's tokenizer: ``transformers.AutoTokenizer`` when it
    imports (pad = eos when the tokenizer has none), else the plain
    ``WordLevelTokenizer`` (which raises for any other kind)."""
    try:
        from transformers import AutoTokenizer
    except ImportError:
        return WordLevelTokenizer(path)
    tok = AutoTokenizer.from_pretrained(path)
    if tok.pad_token is None:
        tok.pad_token = tok.eos_token
    return tok


def engine_scorer(
    model_path: str,
    batch_size: int = 16,
    compute_dtype: str = "bfloat16",
    param_dtype: str = "bfloat16",
    quantize: bool = False,
    mesh=None,
    length_multiple: int = 16,
    device: str = "cuda",
):
    """Reference-scale scorer (``rescore.hf_causal_scorer`` contract):
    streamed loading in ``param_dtype`` (never float32-materialized),
    optional int8 weights, the forward on ``device`` (the card by default;
    raises without one). A ``mesh`` raises ``NotImplementedError``."""
    if mesh is not None:
        raise NotImplementedError("tensor-parallel rescoring over a mesh is not ported "
                                  "yet; score on one device (mesh=None)")
    dev = resolve_device(device, "engine_scorer")
    _spec_from_config(model_path)  # an unsupported checkpoint raises before any load
    tok = load_tokenizer(model_path)
    params, spec = stream_load_hf(model_path, param_dtype, quantize=quantize)
    return params_scorer(params, spec, tok, batch_size=batch_size,
                         compute_dtype=compute_dtype, length_multiple=length_multiple,
                         device=dev)


def params_scorer(params, spec: EngineSpec, tok: Callable, *, batch_size: int = 16,
                  compute_dtype: str = "bfloat16", length_multiple: int = 16,
                  device="cuda"):
    """``engine_scorer`` on an engine tree already built (``synth_params_on_device``,
    ``load_tensors``): moved to ``device``, the float32 head copied once."""
    dev = resolve_device(device, "params_scorer")
    params = to_device(params, dev)
    head = params["wte"].float()  # read by every batch's tied head
    cdt = DTYPES[compute_dtype]

    def score_batch(ids, mask):
        return engine_sentence_logprobs(params, spec, torch.from_numpy(ids).to(dev),
                                        torch.from_numpy(mask).to(dev), cdt, head)

    return make_batched_scorer(tok, spec.n_positions, score_batch, batch_size,
                               length_multiple)
