"""Tensor parallelism for the transformer (Megatron over the 'model'
axis).

Port of vq_vae_transformer_arc_welding_tpu/parallel/sharding.py
(`transformer_tp_rules`, `shard_params`). JAX places each leaf by a
PartitionSpec and XLA partitions the computation; a rank of the port
holds its shard of each split weight and runs its part of the block,
with the two collectives Megatron names f and g:

- `c_attn` is split by heads: rank r keeps heads [r h/w, (r+1) h/w)
  of q, of k and of v (JAX's `P(None, 'model')` cuts the 3C columns
  contiguously and leaves the rest to XLA, which a rank cannot do);
- `c_fc` is split by its columns (outputs), each `c_proj` (the
  attention's and the MLP's) by its rows (inputs, JAX's
  `P('model', None)`), so each sublayer ends in one all-reduce of the
  partial products, and `c_proj`'s bias is added once, after it;
- everything else (LayerNorms, embeddings, heads) is replicated.

f (`copy_to`) is the identity forward and sums the gradients over the
group backward; g (`reduce_from`) sums forward and passes the gradient
through. The replicated parameters then get the same gradient on every
rank. The block itself is the dense model's (TransformerDecoder.
block_body, ops/attention.causal_self_attention), which calls f and g
where `model.tp` is set; attention dropout there draws the whole
layer's mask and keeps the rank's heads, so a TP step drops what the
dense step drops.

The rules return the placement by JAX's leaf names ('c_attn_w', ...):
'heads', 'column', 'row', or None for replicated.
"""
from __future__ import annotations

import re

import torch

from .mesh import Mesh, all_gather, all_reduce_


def transformer_tp_rules(path_key: str) -> str | None:
    """The placement of a transformer parameter by its JAX leaf name."""
    if path_key in ("c_attn_w", "c_attn_b"):
        return "heads"
    if path_key in ("c_fc_w", "c_fc_b"):
        return "column"
    if path_key == "c_proj_w":
        return "row"
    return None


_LEAF = re.compile(r".*\.(c_attn|c_fc|c_proj)\.(weight|bias)$")


def leaf_name(name: str) -> str | None:
    """A port parameter name's JAX leaf name:
    'transformer.h.0.attn.c_attn.weight' -> 'c_attn_w'."""
    m = _LEAF.match(name)
    return None if m is None else f"{m[1]}_{m[2][0]}"


class TensorParallel:
    """A model's TP group: this rank's index and the number of ways."""

    def __init__(self, group, index: int, ways: int, rules):
        self.group, self.index, self.ways, self.rules = (group, index, ways,
                                                         rules)

    def copy_to(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's f, at a sublayer's input."""
        return _CopyTo.apply(x, self.group)

    def reduce_from(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's g, on a sublayer's partial products."""
        return _ReduceFrom.apply(x, self.group)

    def placement(self, name: str) -> str | None:
        key = leaf_name(name)
        return None if key is None else self.rules(key)

    # -- a dense tensor <-> this rank's shard ------------------------------

    def shard(self, name: str, t: torch.Tensor) -> torch.Tensor:
        how, i, w = self.placement(name), self.index, self.ways
        if how is None:
            return t
        if how == "heads":          # (3C, ...) -> 3 x (C/w, ...)
            c = t.shape[0] // 3
            return torch.cat([z.chunk(w, 0)[i] for z in t.split(c, 0)], 0)
        if how == "column":
            return t.chunk(w, 0)[i]
        return t.chunk(w, 1)[i]     # row: torch (out, in) -> split in

    def dense(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The dense tensor from every rank's shard (collective)."""
        how = self.placement(name)
        if how is None:
            return t
        if how == "row":
            return all_gather(t, self.group, dim=1)
        full = all_gather(t, self.group, dim=0)
        if how == "column":
            return full
        parts = full.chunk(self.ways, 0)            # per rank: q_r, k_r, v_r
        return torch.cat([torch.cat([p.chunk(3, 0)[j] for p in parts], 0)
                          for j in range(3)], 0)


def shard_params(model, mesh: Mesh, rules=transformer_tp_rules,
                 axis: str = "model"):
    """Cut `model`'s split weights to this rank's shards, in place, and
    set `model.tp`, which the block body reads. Returns the model.
    Raises ValueError where the heads do not divide the ways."""
    ways = mesh.shape[axis]
    if model.n_head % ways:
        raise ValueError(f"n_head {model.n_head} is not a multiple of the "
                         f"{ways} tensor-parallel ways")
    if model.d_model * 4 % ways:
        raise ValueError(f"the MLP width {4 * model.d_model} is not a "
                         f"multiple of {ways}")
    tp = TensorParallel(mesh.group(axis), mesh.axis_index(axis), ways, rules)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if tp.placement(name) is not None:
                p.data = tp.shard(name, p.data).clone()
    model.tp = tp
    return model


def dense_state_dict(model) -> dict:
    """The model's state_dict with every shard gathered to the dense
    tensor (collective over the TP group where the model is sharded)."""
    tp = getattr(model, "tp", None)
    sd = model.state_dict()
    if tp is None:
        return sd
    return {k: tp.dense(k, v) for k, v in sd.items()}


class _CopyTo(torch.autograd.Function):
    """Megatron's f: identity forward, gradient summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    """Megatron's g: partial products summed forward, gradient passed."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None
