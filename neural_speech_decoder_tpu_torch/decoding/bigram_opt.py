"""Construct an OPT-layout checkpoint whose weights EXACTLY implement a
bigram language model over a word-level vocabulary.

Why this exists: the reference rescoring pass loads trained OPT-6.7B
weights from the HuggingFace hub (``eval_competition.py:84-86``); this
environment has no model egress, so a *trained* rescorer cannot exist here
— but a *correct* one can. This module builds genuine full-size OPT
weights (same tensor names/shapes/dtypes as ``facebook/opt-6.7b``, same
FLOPs at inference) that realize

    log P(w_t | w_<t) = bigram log P(w_t | w_{t-1})

exactly (up to a per-context temperature), so the competition pipeline's
LLM-rescoring leg can demonstrate a real WER improvement over the WFST
top-1 on a constructed-ambiguity corpus while exercising the *identical*
production path: an on-disk checkpoint (``write_checkpoint``: config.json +
``pytorch_model.bin``) → ``stream_load_hf`` → optional int8 → the engine's
forward on the card. ``engine_params`` builds the same engine tree in
memory through the loader's own name mapping, so a 6.7B-shaped bigram
model never has to go through the disk.

The port's counterpart of ``neural_speech_decoder_tpu/decoding/bigram_opt.py``:
the construction is the same numpy code; the tokenizer files are written
with ``json`` (no ``tokenizers`` package).

The construction (all LayerNorms are γ=1/β=0 so they reduce to known
per-vector scalings; see ``_tensor_value`` for the algebra):

  * positional embeddings are zero; every attention ``out_proj`` and every
    FFN ``fc2`` is zero EXCEPT the last layer's — so layers 0..L-2 are
    exact identities on the residual stream (their matmuls still run at
    full size: benchmark-honest FLOPs);
  * token embeddings carry three blocks: a one-hot *context* slot (scale
    ``s_g``), a one-hot *target* slot (scale ``t_o``), and a mean-balance
    coordinate so LayerNorm is a pure scaling;
  * the last layer's FFN implements an arbitrary linear map via the ReLU
    pair trick ``fc2 · relu(fc1 · x)`` with ``fc1 = [I; -I]``,
    ``fc2 = [A, -A]`` ⇒ the FFN adds exactly ``A·x`` to the residual.
    ``A`` is chosen so the residual after the last layer becomes
    ``eps·e_u + w_u`` where ``w_u`` holds the (zero-mean) centred bigram
    log-prob row of context ``u`` in the target block;
  * tied logits ``h @ wte.T`` then read those rows back against each
    target's one-hot slot: ``logit[v] ∝ logP(v|u) - mean_v logP(v|u)``.
    Out-of-corpus tokens have embeddings orthogonal to everything ⇒
    logit exactly 0, far below in-corpus logits (the row shift keeps
    in-corpus logits positive), i.e. heavily penalized — the desired LM
    behavior for words outside the demo corpus.

Because the final LayerNorm divides by ``||h_u||``, each context row
would get its own temperature; the construction removes that exactly by
padding every ``w_u`` to a COMMON norm in two reserved dims (one norm
filler + its mean balance — legal because the linear map's action on each
context basis direction is free). The realized model is then precisely
the λ-sharpened bigram ``P'(v|u) ∝ P(v|u)^λ`` with one global
``λ = √d·t_o·β/H`` — a proper LM, rank-equivalent to the true bigram at
every position. Verified end to end (artifact on disk → stream_load →
engine logprobs vs the analytic sharpened-LM oracle, bf16 and int8) in
the JAX package's ``tests/test_bigram_opt.py`` and, for this copy, in
``tests/test_torch_port_llm.py``.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .llm_engine import EngineSpec, load_tensors, opt_tensor_plan

# Special-token ids, OPT-convention-compatible (</s> = 2 is OPT's bos/eos).
BOS_ID = 2
PAD_ID = 1
UNK_ID = 3
FIRST_WORD_ID = 4


def build_wordlevel_tokenizer(vocab_words: list[str], out_dir: str) -> None:
    """Write a local word-level HF tokenizer (no network, no ``tokenizers``
    package): ids 0-3 are specials (OPT-style ``</s>``=2 bos), words follow
    in the given order. The post-processor prepends ``</s>`` exactly like
    the OPT tokenizer, so ``engine_scorer``'s first scored position is
    P(w_1 | BOS). The ``tokenizer.json`` is the one ``tokenizers`` saves for
    ``WordLevel`` + ``Whitespace`` + ``TemplateProcessing``."""
    vocab = {"<s>": 0, "<pad>": PAD_ID, "</s>": BOS_ID, "<unk>": UNK_ID}
    for i, w in enumerate(vocab_words):
        vocab[w] = FIRST_WORD_ID + i
    bos = {"SpecialToken": {"id": "</s>", "type_id": 0}}

    def seq(name):
        return {"Sequence": {"id": name, "type_id": 0}}

    spec = {
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": [],
        "normalizer": None, "pre_tokenizer": {"type": "Whitespace"},
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [bos, seq("A")],
            "pair": [bos, seq("A"), bos, seq("B")],
            "special_tokens": {"</s>": {"id": "</s>", "ids": [BOS_ID], "tokens": ["</s>"]}},
        },
        "decoder": None,
        "model": {"type": "WordLevel", "vocab": vocab, "unk_token": "<unk>"},
    }
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "tokenizer.json"), "w") as f:
        json.dump(spec, f, indent=2, ensure_ascii=False)
    with open(os.path.join(out_dir, "tokenizer_config.json"), "w") as f:
        json.dump(
            {
                "tokenizer_class": "PreTrainedTokenizerFast",
                "bos_token": "</s>",
                "eos_token": "</s>",
                "pad_token": "<pad>",
                "unk_token": "<unk>",
                "model_max_length": 2048,
            },
            f, indent=2,
        )


def engine_params(builder: "BigramOptBuilder", param_dtype: str = "bfloat16",
                  quantize: bool = False) -> dict:
    """The engine tree of ``builder``'s model, made in memory: every tensor
    of ``opt_tensor_plan`` from ``tensor_fn`` through ``load_tensors`` (the
    name mapping ``stream_load_hf`` uses)."""
    plan = opt_tensor_plan(builder.spec)
    return load_tensors(builder.spec, ((n, builder.tensor_fn(n, s)) for n, s in plan),
                        param_dtype, quantize, where="BigramOptBuilder")


def write_checkpoint(spec: EngineSpec, out_dir: str, tensor_fn) -> None:
    """Write an OPT checkpoint of ``spec`` that ``stream_load_hf`` (and
    ``transformers``) read: ``config.json`` and one ``pytorch_model.bin`` of
    float16 tensors, each ``tensor_fn(name, shape)``."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump({
            "model_type": "opt", "architectures": ["OPTForCausalLM"],
            "hidden_size": spec.d_model, "ffn_dim": spec.ffn_dim,
            "num_hidden_layers": spec.n_layer, "num_attention_heads": spec.n_head,
            "vocab_size": spec.vocab, "max_position_embeddings": spec.n_positions,
            "word_embed_proj_dim": spec.w_dim, "do_layer_norm_before": True,
            "activation_function": spec.activation, "torch_dtype": "float16",
            "pad_token_id": PAD_ID, "bos_token_id": BOS_ID, "eos_token_id": BOS_ID,
        }, f, indent=2)
    sd = {}
    for name, shape in opt_tensor_plan(spec):
        arr = np.ascontiguousarray(tensor_fn(name, shape), np.float16)
        assert tuple(arr.shape) == tuple(shape), (name, arr.shape, shape)
        sd[name] = torch.from_numpy(arr)
    torch.save(sd, os.path.join(out_dir, "pytorch_model.bin"))


class BigramOptBuilder:
    """Per-tensor weight generator for ``write_checkpoint`` and
    ``engine_params``.

    Args:
      spec: EngineSpec of the target OPT size.
      logp: ``[K+1, K]`` float64 — row 0 is the BOS-context distribution,
        row 1+u the distribution after corpus word u; rows are log-probs
        (normalized over the K corpus words).
      token_ids: ``[K]`` vocab ids of the corpus words (order matches
        logp columns); contexts are the same words plus BOS_ID.
    """

    def __init__(self, spec, logp: np.ndarray, token_ids: np.ndarray,
                 *, s_g: float = 1.0, beta: float = 1.0,
                 eps_id: float = 0.01, target_lambda: float = 1.0,
                 oov_penalty: float = 20.0):
        k = logp.shape[1]
        assert logp.shape[0] == k + 1 and len(token_ids) == k
        d = spec.d_model
        # dim budget: contexts (K+1) + targets (K) + embedding mean-fix +
        # 2 OOV dims + norm filler + OOV-penalty carrier + mean balance
        assert 2 * k + 7 <= d, f"corpus size {k} too large for d={d}"
        self.spec = spec
        self.k = k
        self.token_ids = np.asarray(token_ids)
        self.s_g, self.beta, self.eps_id = s_g, beta, eps_id
        # dim layout
        self.g0 = 0                    # context block: [g0, g0+k+1)
        self.o0 = k + 1                # target block: [o0, o0+k)
        self.mu = 2 * k + 1            # embedding mean-balance dim
        self.nu = (2 * k + 2, 2 * k + 3)  # OOV zero-mean pair
        self.rho = 2 * k + 4           # norm filler dim
        self.pi = 2 * k + 5            # OOV-penalty carrier dim
        self.rho2 = 2 * k + 6          # residual mean-balance dim
        # centred rows (zero-sum over the target block)
        self.q = beta * (logp - logp.mean(axis=1, keepdims=True))
        norms2 = np.sum(self.q**2, axis=1)
        m = float(norms2.max())
        # Every context's residual carries a CONSTANT p0 in dim pi; every
        # OOV token's embedding has -c in pi (+c in nu[0] for zero mean),
        # so OOV logits are exactly -oov_penalty for every context:
        #   kappa * p0 * c = oov_penalty,  kappa = sqrt(d)/H,  c = p0.
        # Norm filler rho pads ||residual|| to the common H (so the final
        # LayerNorm applies ONE global temperature); solving the coupled
        # constraints: H^2 = 1.02*(m + 1) + 1.5*p0^2, p0^2 = P0*H/sqrt(d)
        # -> quadratic in H.
        p0h = 1.5 * 1.02 * oov_penalty / np.sqrt(d)
        h = (p0h + np.sqrt(p0h**2 + 4 * 1.02 * (m + 1))) / 2.0
        self.h_norm = float(h)
        self.p0 = float(np.sqrt(oov_penalty * h / np.sqrt(d)))
        self.oov_c = self.p0
        # fill solves ||q||^2 + fill^2 + p0^2 + (fill+p0)^2 = H^2
        disc = 2.0 * (h * h - norms2 - self.p0**2) - self.p0**2
        assert np.all(disc >= 0), "norm budget infeasible; raise h margin"
        self.fill = (-self.p0 + np.sqrt(disc)) / 2.0
        # realized logits: kappa * t_o * q[v]; t_o sets the global
        # temperature exactly (lambda=1 -> the TRUE bigram, re-normalized
        # over corpus + the exp(-oov_penalty) OOV mass)
        self.t_o = float(target_lambda * h / (np.sqrt(d) * beta))
        self.target_lambda = target_lambda
        self.oov_penalty = oov_penalty

    # -- embeddings ---------------------------------------------------------
    def wte(self) -> np.ndarray:
        if getattr(self, "_wte", None) is not None:
            return self._wte
        d, k = self.spec.w_dim, self.k
        assert self.spec.word_dim is None, "350m-style split not supported"
        e = np.zeros((self.spec.vocab, d), np.float32)
        # OOV/pad/unk/<s>: zero-mean vector whose only overlap with the
        # residual stream is the constant-p0 penalty dim pi -> logit is
        # exactly -oov_penalty for every context.
        e[:, self.nu[0]] = self.oov_c
        e[:, self.pi] = -self.oov_c
        ids = self.token_ids
        e[ids] = 0.0
        e[ids, self.g0 + 1 + np.arange(k)] = self.s_g
        e[ids, self.o0 + np.arange(k)] = self.t_o
        e[ids, self.mu] = -(self.s_g + self.t_o)
        e[BOS_ID] = 0.0
        e[BOS_ID, self.g0] = self.s_g
        e[BOS_ID, self.mu] = -self.s_g
        self._wte = e
        return e

    # -- the last-layer linear map A ---------------------------------------
    def _ln_scale(self, vec: np.ndarray) -> float:
        """LayerNorm (γ=1, β=0) of a zero-mean vector is a pure scaling by
        this factor (includes the ε the engine uses)."""
        d = self.spec.d_model
        var = float(vec @ vec) / d
        return 1.0 / np.sqrt(var + self.spec.ln_eps)

    def a_matrix(self) -> np.ndarray:
        """A with columns only on context dims: for context u,
        ``A · LN(e_u) = w_u - (1 - eps_id)·e_u`` ⇒ residual becomes
        ``eps_id·e_u + w_u``. Non-context inputs (OOV dims, target dims)
        map to 0 ⇒ OOV contexts pass through untouched (finite LN, uniform
        in-corpus logits)."""
        if getattr(self, "_a", None) is not None:
            return self._a
        d, k = self.spec.d_model, self.k
        emb = self.wte()
        a = np.zeros((d, d), np.float32)
        for row in range(k + 1):  # 0 = BOS context, 1+u = word u
            tok = BOS_ID if row == 0 else int(self.token_ids[row - 1])
            e_u = emb[tok]
            c_u = self._ln_scale(e_u)
            w_u = np.zeros(d, np.float32)
            w_u[self.o0 : self.o0 + k] = self.q[row]
            w_u[self.rho] = self.fill[row]
            w_u[self.pi] = self.p0
            w_u[self.rho2] = -(self.fill[row] + self.p0)
            col = (w_u - (1.0 - self.eps_id) * e_u) / (c_u * self.s_g)
            a[:, self.g0 + row] = col
        self._a = a
        return a

    # -- tensor_fn for the checkpoint writer --------------------------------
    def tensor_fn(self, name: str, shape) -> np.ndarray | None:
        """Value for each OPT tensor; None -> writer default (used for
        nothing here: we pin every tensor so the model is exactly the
        construction)."""
        last = f"model.decoder.layers.{self.spec.n_layer - 1}."
        if name == "model.decoder.embed_tokens.weight":
            return self.wte().astype(np.float16)
        if name == "model.decoder.embed_positions.weight":
            return np.zeros(shape, np.float16)
        if name.endswith("norm.weight"):
            return np.ones(shape, np.float16)
        if name.endswith(".bias") or name.endswith("norm.bias"):
            return np.zeros(shape, np.float16)
        if name == last + "fc1.weight":  # [f, d] = [I; -I; 0]
            f, d = shape
            m = np.zeros(shape, np.float16)
            m[:d] = np.eye(d, dtype=np.float16)
            m[d : 2 * d] = -np.eye(d, dtype=np.float16)
            return m
        if name == last + "fc2.weight":  # [d, f] = [A, -A, 0]
            d, f = shape
            a = self.a_matrix().astype(np.float16)
            m = np.zeros(shape, np.float16)
            m[:, :d] = a
            m[:, d : 2 * d] = -a
            return m
        # everything else (all attention projections, other FFNs) is zero —
        # identity layers; matmuls still run at full size.
        return np.zeros(shape, np.float16)

    # -- analytic oracle ----------------------------------------------------
    def expected_logits(self, context_token: int) -> np.ndarray:
        """fp64 oracle of the final logits row for a given context token —
        what the construction should produce before dtype rounding."""
        emb = self.wte().astype(np.float64)
        e_u = emb[context_token]
        ln1 = e_u * self._ln_scale(e_u)
        h = e_u + self.a_matrix().astype(np.float64) @ ln1
        h_ln = (h - h.mean()) / np.sqrt(h @ h / len(h) - h.mean() ** 2
                                        + self.spec.ln_eps)
        return emb @ h_ln

    def oracle_logp(self) -> np.ndarray:
        """``[K+1, K]`` analytic ``log P'(v|u)`` of the REALIZED model
        (the λ-sharpened bigram, OOV mass included) — what the engine
        should reproduce up to dtype rounding."""
        rows = []
        for row in range(self.k + 1):
            tok = BOS_ID if row == 0 else int(self.token_ids[row - 1])
            lg = self.expected_logits(tok)
            lse = np.logaddexp.reduce(lg)
            rows.append((lg - lse)[self.token_ids])
        return np.stack(rows)
