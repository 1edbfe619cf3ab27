"""Causal-LM rescoring on the card: the n-best LLM pass as a PyTorch forward.

The port's counterpart of ``neural_speech_decoder_tpu/decoding/jax_lm.py``.
The reference rescores its n-best lists with OPT-6.7B loaded through
torch + bitsandbytes on a GPU (``eval_competition.py:84-86,125-137``).
Here a local HuggingFace GPT-2- or OPT-family checkpoint is converted once
into a plain tree of stacked layer weights (``transformers`` only *reads*
the weights, and is imported at call time), and the transformer stack runs
as a loop over the layer axis, with sentences scored in fixed
``(batch, length)`` buckets.

The forward keeps the JAX package's rounding points exactly: layer norms in
float32 (``rsqrt(var + eps)``); each projection ``h @ W`` in the compute
dtype plus its bias in the compute dtype; attention scores accumulated in
float32 and divided by sqrt(dh); padded keys at -1e30 (not -inf, so a row
whose keys are all masked stays finite); probabilities cast to the compute
dtype before the context product; the tied head in float32. Attention is
two products and a softmax (not ``scaled_dot_product_attention``), which is
what keeps those points. Positions are the static slice
``wpe[pos_offset : pos_offset + t]``. Scoring semantics match
``rescore.hf_causal_scorer``: per-sentence ``sum_t log P(tok_t | tok_<t)``
with no extra BOS beyond what the checkpoint's tokenizer inserts.
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import resolve_device

__all__ = ["LMSpec", "load_causal_lm", "sentence_logprobs", "make_batched_scorer",
           "torch_causal_scorer", "to_device"]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


@dataclass(frozen=True)
class LMSpec:
    """Architecture knobs shared by the GPT-2 and OPT decoder families."""

    n_head: int
    n_positions: int
    activation: str  # "gelu_new" (GPT-2) | "relu" / "gelu" (OPT)
    pos_offset: int  # OPT's learned positions start at index 2
    ln_eps: float


def _np(t) -> np.ndarray:
    return t.detach().cpu().to(torch.float32).numpy()


def _gpt2_params(sd, cfg) -> dict:
    """GPT-2: Conv1D weights are stored [in, out] — used as ``x @ W`` as-is."""
    blocks = []
    for i in range(cfg.n_layer):
        p = f"transformer.h.{i}."
        blocks.append({
            "ln1_g": _np(sd[p + "ln_1.weight"]), "ln1_b": _np(sd[p + "ln_1.bias"]),
            "wqkv": _np(sd[p + "attn.c_attn.weight"]),
            "bqkv": _np(sd[p + "attn.c_attn.bias"]),
            "wo": _np(sd[p + "attn.c_proj.weight"]), "bo": _np(sd[p + "attn.c_proj.bias"]),
            "ln2_g": _np(sd[p + "ln_2.weight"]), "ln2_b": _np(sd[p + "ln_2.bias"]),
            "wfc": _np(sd[p + "mlp.c_fc.weight"]), "bfc": _np(sd[p + "mlp.c_fc.bias"]),
            "wproj": _np(sd[p + "mlp.c_proj.weight"]),
            "bproj": _np(sd[p + "mlp.c_proj.bias"]),
        })
    return {
        "wte": _np(sd["transformer.wte.weight"]), "wpe": _np(sd["transformer.wpe.weight"]),
        "blocks": blocks,
        "lnf_g": _np(sd["transformer.ln_f.weight"]), "lnf_b": _np(sd["transformer.ln_f.bias"]),
    }


def _opt_params(sd, cfg) -> dict:
    """OPT: nn.Linear weights are [out, in] — transposed once here so the
    forward is a uniform ``x @ W`` for both families; q/k/v are packed into
    one [D, 3D] product (GPT-2's fused c_attn layout)."""
    if not cfg.do_layer_norm_before:
        raise NotImplementedError("OPT variants with post-LN are not supported")
    blocks = []
    for i in range(cfg.num_hidden_layers):
        p = f"model.decoder.layers.{i}."
        w = {k: _np(sd[p + f"self_attn.{k}_proj.weight"]).T for k in "qkv"}
        b = {k: _np(sd[p + f"self_attn.{k}_proj.bias"]) for k in "qkv"}
        blocks.append({
            "ln1_g": _np(sd[p + "self_attn_layer_norm.weight"]),
            "ln1_b": _np(sd[p + "self_attn_layer_norm.bias"]),
            "wqkv": np.concatenate([w["q"], w["k"], w["v"]], axis=1),
            "bqkv": np.concatenate([b["q"], b["k"], b["v"]]),
            "wo": _np(sd[p + "self_attn.out_proj.weight"]).T,
            "bo": _np(sd[p + "self_attn.out_proj.bias"]),
            "ln2_g": _np(sd[p + "final_layer_norm.weight"]),
            "ln2_b": _np(sd[p + "final_layer_norm.bias"]),
            "wfc": _np(sd[p + "fc1.weight"]).T, "bfc": _np(sd[p + "fc1.bias"]),
            "wproj": _np(sd[p + "fc2.weight"]).T, "bproj": _np(sd[p + "fc2.bias"]),
        })
    out = {
        "wte": _np(sd["model.decoder.embed_tokens.weight"]),
        "wpe": _np(sd["model.decoder.embed_positions.weight"]),
        "blocks": blocks,
        "lnf_g": _np(sd["model.decoder.final_layer_norm.weight"]),
        "lnf_b": _np(sd["model.decoder.final_layer_norm.bias"]),
    }
    # OPT-350m-style word/hidden dim split: project_in after the embedding,
    # project_out before the tied LM head (both bias-free Linears).
    if cfg.word_embed_proj_dim != cfg.hidden_size:
        out["win"] = _np(sd["model.decoder.project_in.weight"]).T
        out["wout"] = _np(sd["model.decoder.project_out.weight"]).T
    return out


def load_causal_lm(model_path: str):
    """Read a local HF checkpoint (GPT-2 or OPT family) into a numpy tree.

    Returns ``(params, spec, tokenizer)``; every layer leaf is stacked along
    a leading layer axis. ``transformers`` reads the checkpoint and the
    tokenizer; ``to_device`` puts the tree on the card."""
    from transformers import AutoConfig, AutoModelForCausalLM, AutoTokenizer

    cfg = AutoConfig.from_pretrained(model_path)
    tok = AutoTokenizer.from_pretrained(model_path)
    if tok.pad_token is None:
        tok.pad_token = tok.eos_token
    model = AutoModelForCausalLM.from_pretrained(model_path)
    sd = model.state_dict()
    if cfg.model_type == "gpt2":
        raw = _gpt2_params(sd, cfg)
        spec = LMSpec(n_head=cfg.n_head, n_positions=cfg.n_positions,
                      activation=cfg.activation_function, pos_offset=0,
                      ln_eps=cfg.layer_norm_epsilon)
    elif cfg.model_type == "opt":
        raw = _opt_params(sd, cfg)
        spec = LMSpec(n_head=cfg.num_attention_heads,
                      n_positions=cfg.max_position_embeddings,
                      activation=cfg.activation_function,
                      pos_offset=2,  # OPTLearnedPositionalEmbedding offset
                      ln_eps=1e-5)
    else:
        raise NotImplementedError(f"unsupported model_type {cfg.model_type!r} (gpt2/opt)")
    del model, sd
    blocks = raw.pop("blocks")
    params = {**raw, "blocks": {k: np.stack([b[k] for b in blocks]) for k in blocks[0]}}
    return params, spec, tok


def to_device(tree, device):
    """The numpy (or torch) tree as torch tensors on ``device``, dtypes kept."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return torch.as_tensor(tree).to(device)


def _layer_norm(x, g, b, eps):
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def _act(x, name):
    if name == "gelu_new":
        return F.gelu(x, approximate="tanh")
    if name == "gelu":
        return F.gelu(x)
    if name == "relu":
        return F.relu(x)
    raise NotImplementedError(name)


def attention_mask(mask: torch.Tensor, t: int) -> torch.Tensor:
    """[B, 1, Tq, Tk] causal and key-padding mask."""
    causal = torch.tril(torch.ones((t, t), dtype=torch.bool, device=mask.device))
    return (causal[None, :, :] & (mask > 0)[:, None, :])[:, None]


def attend(q, k, v, ok, cdt):
    """``q, k, v`` [B, H, T, dh] in the compute dtype: scores summed in
    float32 over exact products, padded keys at -1e30, probabilities cast
    to the compute dtype before the context product."""
    dh = q.shape[-1]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(dh)
    scores = torch.where(ok, scores, torch.tensor(-1e30, device=scores.device))
    probs = torch.softmax(scores, dim=-1).to(cdt)
    return torch.matmul(probs, v)


def _forward_logits(params, spec: LMSpec, ids, mask, compute_dtype):
    """[B, T] ids/mask -> [B, T, V] float32 logits. Causal + padding mask."""
    cdt = compute_dtype
    b, t = ids.shape
    x = params["wte"].to(cdt)[ids]
    if "win" in params:  # OPT word/hidden dim split (project_in)
        x = x @ params["win"].to(cdt)
    x = x + params["wpe"][spec.pos_offset: spec.pos_offset + t].to(cdt)
    n_head = spec.n_head
    d = x.shape[-1]
    dh = d // n_head
    ok = attention_mask(mask, t)
    x = x.to(cdt)
    blocks = params["blocks"]
    for li in range(blocks["wqkv"].shape[0]):
        p = {k: v[li] for k, v in blocks.items()}
        h = _layer_norm(x, p["ln1_g"], p["ln1_b"], spec.ln_eps).to(cdt)
        qkv = h @ p["wqkv"].to(cdt) + p["bqkv"].to(cdt)
        q, k, v = (z.reshape(b, t, n_head, dh).transpose(1, 2)
                   for z in qkv.split(d, dim=-1))
        ctx = attend(q, k, v, ok, cdt).transpose(1, 2).reshape(b, t, d)
        x = x + ctx @ p["wo"].to(cdt) + p["bo"].to(cdt)
        h = _layer_norm(x, p["ln2_g"], p["ln2_b"], spec.ln_eps).to(cdt)
        h = _act(h @ p["wfc"].to(cdt) + p["bfc"].to(cdt), spec.activation)
        x = x + h @ p["wproj"].to(cdt) + p["bproj"].to(cdt)
    x = _layer_norm(x, params["lnf_g"], params["lnf_b"], spec.ln_eps)
    if "wout" in params:  # project_out back to the word-embedding dim
        x = x @ params["wout"].float()
    # tied LM head in float32 (logits feed a log-softmax)
    return x @ params["wte"].float().T


def token_logprob_sum(logits, ids, mask):
    """Per-row ``sum_t log P(tok_t | tok_<t)`` over valid (non-pad) tokens."""
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    tok_lp = torch.gather(logp, -1, ids[:, 1:, None].long())[..., 0]
    return torch.sum(tok_lp * mask[:, 1:], dim=-1)


@torch.no_grad()
def sentence_logprobs(params, spec: LMSpec, ids, mask, compute_dtype=torch.float32):
    """Per-row ``sum_t log P(tok_t | tok_<t)`` over valid (non-pad) tokens."""
    logits = _forward_logits(params, spec, ids, mask, compute_dtype)
    return token_logprob_sum(logits, ids, mask)


def make_batched_scorer(
    tok: Callable,
    n_positions: int,
    score_batch: Callable,
    batch_size: int = 16,
    length_multiple: int = 16,
):
    """Shared host loop for sentence scorers: tokenize, pad into static
    ``(batch_size, T_bucket)`` shapes (``T`` rounded up to
    ``length_multiple`` from ``max(t, 2)``), truncate-with-warning past the
    position table, call ``score_batch(ids, mask) -> [batch_size]
    logprobs`` (numpy int32 inputs; a tensor or array out).

    ``tok(sentences, padding=True)`` returns ``input_ids`` and
    ``attention_mask`` (a HF tokenizer, ``llm_engine.load_tokenizer``, or
    any function with that contract). Used by ``torch_causal_scorer`` and
    ``llm_engine.engine_scorer`` — one copy of the bucketing/truncation
    semantics.
    """

    def score(sentences: Sequence[str]) -> list[float]:
        out: list[float] = []
        for i in range(0, len(sentences), batch_size):
            chunk = [s if s else " " for s in sentences[i : i + batch_size]]
            enc = tok(chunk, padding=True)
            ids = np.asarray(enc["input_ids"], np.int32)
            mask = np.asarray(enc["attention_mask"], np.int32)
            t = ids.shape[1]
            t_pad = min(-(-max(t, 2) // length_multiple) * length_multiple, n_positions)
            if t > t_pad:  # sentence longer than the position table
                # hf_causal_scorer (pinned as interchangeable) would fail
                # loudly here; truncating silently would return prefix-only
                # logprobs. Warn so the divergence is visible.
                warnings.warn(
                    f"sentence batch length {t} exceeds the checkpoint's "
                    f"position table ({n_positions}); scoring only "
                    f"the first {t_pad} tokens of over-long sentences",
                    stacklevel=2,
                )
                ids, mask = ids[:, :t_pad], mask[:, :t_pad]
            n = ids.shape[0]
            ids = np.pad(ids, ((0, batch_size - n), (0, t_pad - ids.shape[1])))
            mask = np.pad(mask, ((0, batch_size - n), (0, t_pad - mask.shape[1])))
            res = torch.as_tensor(score_batch(ids, mask)).float().cpu().numpy()
            out.extend(res[:n].tolist())
        return out

    return score


def torch_causal_scorer(
    model_path: str,
    batch_size: int = 16,
    compute_dtype: str = "bfloat16",
    length_multiple: int = 16,
    device: str = "cuda",
):
    """Drop-in replacement for ``rescore.hf_causal_scorer`` running this
    module's forward on ``device`` (the card by default; raises without
    one). Sentences are tokenized on host and padded into static
    ``(batch_size, T_bucket)`` shapes.

    Length limit: sentences longer than the checkpoint's position table
    (``spec.n_positions``) are truncated to it, with a warning — the
    returned logprob then covers only that prefix.
    """
    dev = resolve_device(device, "torch_causal_scorer")
    params, spec, tok = load_causal_lm(model_path)
    params = to_device(params, dev)
    cdt = DTYPES[compute_dtype]

    def score_batch(ids, mask):
        return sentence_logprobs(params, spec, torch.from_numpy(ids).to(dev),
                                 torch.from_numpy(mask).to(dev), cdt)

    return make_batched_scorer(tok, spec.n_positions, score_batch, batch_size,
                               length_multiple)
