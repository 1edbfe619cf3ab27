"""Parameter sharding rules for tensor parallelism over the 'model' axis.

Port of ``neural_speech_decoder_tpu/parallel/shardings.py``. JAX gives each
leaf a ``PartitionSpec`` and XLA moves the pieces; here each rank of a
model group holds its contiguous slice of a sharded leaf along one
dimension (``shard_params``) and joins them back for a checkpoint
(``gather_params``). The rules (JAX's, by leaf):

- GRU (``gru_param_shardings``): every layer's ``w_ih [D, in, 3H]`` and
  ``w_hh [D, H, 3H]`` on their contraction rows (dim 1, ``P(None, 'model',
  None)``), ``fc.weight [H*D, C+1]`` on its input rows (dim 0);
- Conformer (``conformer_param_shardings``): each FF's ``lin1`` column-
  parallel (``w`` dim 1, ``b`` dim 0) and ``lin2.w`` row-parallel (dim 0),
  the attention's ``in_proj_w`` / ``in_proj_b`` on their columns after the
  qkv interleave (whole heads a rank) and ``out.w`` on its rows;
- everything else replicated.

A leaf whose sharded dimension does not divide by ``n_model`` raises
``ValueError``, as does a head count that does not (JAX's ``shard_params``
raises for the heads; GSPMD pads other uneven shards, which the port's
hand-called collectives do not). The GRU's layer-0 rows also split on
channel boundaries (row ``c*k + j``), so the channel count must divide.

``interleave_attention_params`` / ``deinterleave_attention_params`` are
JAX's relayout of the qkv projection, on the port's tree.
"""

from __future__ import annotations

from typing import Any

import torch

from .mesh import Mesh
from .tensor_parallel import ModelShard, join, split

CONFORMER = "transformer_ctc"


def _map(tree: Any, fn, path: tuple = ()) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn, path + (str(i),)) for i, v in enumerate(tree)]
    return fn(path, tree)


def named_leaves(tree: Any) -> list[tuple[tuple, Any]]:
    """``(path, leaf)`` for every leaf of a tree, in its order."""
    out: list = []
    _map(tree, lambda path, t: out.append((path, t)))
    return out


def leaf_dim(path: tuple, model_type: str) -> int | None:
    """The dimension a leaf at ``path`` (its keys, list indices as strings)
    is sharded on, or None for a replicated leaf."""
    if model_type == CONFORMER:
        if len(path) == 5 and path[0] == "blocks" and path[2] in ("ff1", "ff2"):
            return {("lin1", "w"): 1, ("lin1", "b"): 0, ("lin2", "w"): 0}.get(path[3:])
        if len(path) >= 4 and path[0] == "blocks" and path[2] == "attn":
            return {("in_proj_w",): 1, ("in_proj_b",): 0, ("out", "w"): 0}.get(path[3:])
        return None
    if path[:2] == ("gru", "layers") and path[-1] in ("w_ih", "w_hh"):
        return 1
    return 0 if path == ("fc", "weight") else None


def check_shardable(cfg, n_model: int) -> None:
    """Raise ``ValueError`` when a config's sharded dimensions do not divide
    over ``n_model`` ranks (``cfg``: a ``GRUConfig`` or ``ConformerConfig``)."""
    if n_model == 1:
        return
    if hasattr(cfg, "num_heads"):
        if cfg.num_heads % n_model:
            raise ValueError(
                f"num_heads={cfg.num_heads} not divisible by the 'model' mesh axis "
                f"({n_model}); heads would split across shards")
        if cfg.ff_dim % n_model:
            raise ValueError(f"transformer_dim_ff={cfg.ff_dim} does not split over "
                             f"{n_model} model ranks")
        if cfg.fused_ffn:
            raise ValueError(
                "fused_ffn under tensor parallelism: the fused FF kernel needs the whole "
                "FF weights, which the 'model' axis shards; run the unfused FF "
                "(fused_ffn: false)")
        if not cfg.qkv_interleaved:
            raise ValueError("tensor parallelism needs qkv_interleaved (the default "
                             "with n_model_devices > 1): whole heads a rank")
        return
    for name, size in (("nInputFeatures", cfg.neural_dim), ("nUnits", cfg.hidden_dim)):
        if size % n_model:
            raise ValueError(f"{name}={size} does not split over {n_model} model ranks")


def _relayout_qkv(t: torch.Tensor, num_heads: int, interleave: bool) -> torch.Tensor:
    """``in_proj_w [D, 3D]`` or ``in_proj_b [3D]`` (or a moment of one)
    with its last axis permuted from ({q,k,v}, head, dh) to (head, {q,k,v},
    dh) (``interleave``) or back."""
    lead = t.shape[:-1]
    n3 = t.shape[-1]
    dh = n3 // (3 * num_heads)
    src = (3, num_heads, dh) if interleave else (num_heads, 3, dh)
    return (t.reshape(*lead, *src).transpose(-3, -2).reshape(*lead, n3).contiguous())


def relayout_leaf(path: tuple, t: torch.Tensor, num_heads: int,
                  interleave: bool) -> torch.Tensor:
    """A Conformer leaf at ``path`` (or a moment of it) in the other qkv
    layout: relaid out if it is a block's ``in_proj_w``/``in_proj_b``,
    else as it is."""
    if len(path) == 4 and path[0] == "blocks" and path[2] == "attn" and \
            path[3] in ("in_proj_w", "in_proj_b"):
        return _relayout_qkv(t, num_heads, interleave)
    return t


def relayout_attention(tree: Any, num_heads: int, interleave: bool) -> Any:
    """A Conformer parameter tree with every block's ``in_proj_w`` /
    ``in_proj_b`` relaid out; the other leaves as they are."""
    return _map(tree, lambda path, t: relayout_leaf(path, t, num_heads, interleave))


def interleave_attention_params(params: Any, num_heads: int) -> Any:
    """Permute in_proj columns from torch's ({q,k,v}, head, dh) order to the
    per-head-interleaved (head, {q,k,v}, dh) order that
    ``ConformerConfig.qkv_interleaved`` forwards read: a pure column
    permutation (the logits are bit-identical) that makes each model
    shard's columns exactly its heads' q, k and v."""
    return relayout_attention(params, num_heads, True)


def deinterleave_attention_params(params: Any, num_heads: int) -> Any:
    """Inverse of ``interleave_attention_params`` (back to torch order)."""
    return relayout_attention(params, num_heads, False)


def model_shard_of(mesh: Mesh | ModelShard | None) -> ModelShard | None:
    """The 'model' axis place of a ``Mesh`` (None with one model rank), or
    the ``ModelShard`` itself."""
    return mesh.model_shard if isinstance(mesh, Mesh) else mesh


def shard_params(params: Any, mesh: Mesh | ModelShard | None, model_type: str,
                 num_heads: int | None = None) -> Any:
    """This rank's slices of whole ``params`` by the rules above. For the
    Conformer, ``num_heads`` first applies the qkv interleave (as JAX's
    ``shard_params`` does when the trainer passes it); leave it None for
    params in that layout already (a tensor-parallel checkpoint). With one
    model rank the tree is returned as it is."""
    tp = model_shard_of(mesh)
    if tp is None:
        return params
    if model_type == CONFORMER and num_heads is not None:
        if num_heads % tp.count:
            raise ValueError(
                f"num_heads={num_heads} not divisible by the 'model' mesh axis "
                f"({tp.count}); heads would split across shards")
        params = interleave_attention_params(params, num_heads)

    def fn(path, t):
        dim = leaf_dim(path, model_type)
        return t if dim is None else split(t, dim, tp)

    return _map(params, fn)


def gather_params(params: Any, mesh: Mesh | ModelShard | None, model_type: str) -> Any:
    """Whole params from the model group's shards (a collective: every rank
    of the group calls it), in the layout they were sharded in, detached.
    With one model rank the tree is returned as it is."""
    tp = model_shard_of(mesh)
    if tp is None:
        return params

    def fn(path, t):
        dim = leaf_dim(path, model_type)
        return t.detach() if dim is None else join(t.detach(), dim, tp)

    return _map(params, fn)
