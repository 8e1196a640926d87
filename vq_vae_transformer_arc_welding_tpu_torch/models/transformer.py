"""minGPT-style causal transformer decoder over latent tokens, eval mode.

Port of vq_vae_transformer_arc_welding_tpu/models/transformer.py
(`sinusoidal_pe`, `TransformerDecoder`: `embed`, the block body,
`backbone`, `heads`, `apply`). Attribute paths are the reference keys
read by vq_vae_transformer_arc_welding_tpu/train/torch_import.py:139-169
(`embedding.latent_embedding.weight`, `transformer.h.{i}.ln_1.*`,
`transformer.h.{i}.attn.c_attn.*`, `class_head.linear_1.weight`, ...).
Linear weights are in torch's (out, in) layout, so `x @ W.t()`.
Sampling (`generate`, `generate_kv`), dropout and the losses are not
ported yet.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..ops.activations import gelu, new_gelu
from ..ops.attention import causal_attention_core, merge_heads, split_heads
from ..ops.norm import layer_norm
from .base import Node, Params, assign
from .initializers import gpt2_embedding, gpt2_linear


def sinusoidal_pe(max_len: int, d_model: int) -> np.ndarray:
    """Fixed sin/cos table (reference model/embedding.py:6-24), float32."""
    pe = np.zeros((max_len, d_model), np.float32)
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                 * -(math.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe


def linear(x: torch.Tensor, p: nn.Module) -> torch.Tensor:
    """x @ W.t() (+ b) for a Params holder in torch Linear layout."""
    y = x @ p.weight.t()
    return y + p.bias if hasattr(p, "bias") else y


class Block(nn.Module):
    """Pre-LN block: ln_1 -> attn -> residual -> ln_2 -> tanh-GELU MLP."""

    def __init__(self, d: int, device=None):
        super().__init__()

        def ln():
            return Params(device, weight=(d,), bias=(d,))

        self.ln_1 = ln()
        self.attn = Node(
            c_attn=Params(device, weight=(3 * d, d), bias=(3 * d,)),
            c_proj=Params(device, weight=(d, d), bias=(d,)))
        self.ln_2 = ln()
        self.mlp = Node(
            c_fc=Params(device, weight=(4 * d, d), bias=(4 * d,)),
            c_proj=Params(device, weight=(d, 4 * d), bias=(d,)))


class TransformerDecoder(nn.Module):
    """hparams mirror the JAX TransformerDecoder constructor."""

    def __init__(self, d_model: int = 64, n_classes: int = 131,
                 seq_len: int = 100, n_blocks: int = 2, n_head: int = 6,
                 res_dropout: float = 0.1, att_dropout: float = 0.0,
                 learning_rate: float = 1e-3, class_h_bias: bool = False,
                 class_h_dropout: bool = False, pe_max_len: int = 512, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        if d_model % n_head:
            raise ValueError(f"d_model {d_model} is not a multiple of "
                             f"n_head {n_head}")
        pe_max_len = max(pe_max_len, seq_len)
        self.d_model = d_model
        self.n_classes = n_classes
        self.seq_len = seq_len
        self.n_blocks = n_blocks
        self.n_head = n_head
        self.class_h_bias = class_h_bias
        self.hparams = dict(d_model=d_model, n_classes=n_classes,
                            seq_len=seq_len, n_blocks=n_blocks, n_head=n_head,
                            res_dropout=res_dropout, att_dropout=att_dropout,
                            learning_rate=learning_rate,
                            class_h_bias=class_h_bias,
                            class_h_dropout=class_h_dropout)
        d = d_model
        pos = Node()
        pos.register_buffer("pe", torch.as_tensor(
            sinusoidal_pe(pe_max_len, d), device=device)[None])
        self.embedding = Node(
            latent_embedding=Params(device, weight=(n_classes, d)),
            positional_embedding=pos)
        self.transformer = Node(
            h=nn.ModuleList(Block(d, device) for _ in range(n_blocks)),
            ln_f=Params(device, weight=(d,), bias=(d,)))
        self.lm_head = Params(device, weight=(n_classes, d))
        l1 = dict(weight=(1, d))
        l2 = dict(weight=(2, seq_len))
        if class_h_bias:
            l1["bias"], l2["bias"] = (1,), (2,)
        self.class_head = Node(linear_1=Params(device, **l1),
                               linear_2=Params(device, **l2))
        if generator is not None:
            self.init_weights(generator)

    @property
    def blocks(self) -> nn.ModuleList:
        return self.transformer.h

    @property
    def pe(self) -> torch.Tensor:
        """(pe_max_len, d_model) positional table."""
        return self.embedding.positional_embedding.pe[0]

    def init_weights(self, gen: torch.Generator) -> None:
        """GPT-2 init: N(0, 0.02) weights, residual projections scaled by
        1/sqrt(2 n_blocks), zero biases, unit LayerNorms."""
        d = self.d_model
        proj_std = 0.02 / math.sqrt(2 * self.n_blocks)

        def put(p, w_b):
            assign(p.weight, w_b[0])
            if hasattr(p, "bias"):
                assign(p.bias, w_b[1])

        def unit(ln):
            assign(ln.weight, torch.ones(d)), assign(ln.bias, torch.zeros(d))

        for blk in self.blocks:
            put(blk.attn.c_attn, gpt2_linear(gen, d, 3 * d))
            put(blk.attn.c_proj, gpt2_linear(gen, d, d, std=proj_std))
            put(blk.mlp.c_fc, gpt2_linear(gen, d, 4 * d))
            put(blk.mlp.c_proj, gpt2_linear(gen, 4 * d, d, std=proj_std))
            unit(blk.ln_1), unit(blk.ln_2)
        unit(self.transformer.ln_f)
        put(self.lm_head, gpt2_linear(gen, d, self.n_classes))
        put(self.class_head.linear_1, gpt2_linear(gen, d, 1))
        put(self.class_head.linear_2, gpt2_linear(gen, self.seq_len, 2))
        assign(self.embedding.latent_embedding.weight,
               gpt2_embedding(gen, self.n_classes, d))

    # -- forward --------------------------------------------------------

    def embed(self, x_ids: torch.Tensor) -> torch.Tensor:
        """Token embedding + positional encoding, (B, T, d_model)."""
        t = x_ids.shape[1]
        return (self.embedding.latent_embedding.weight[x_ids.long()]
                + self.pe[None, :t])

    def block_body(self, x: torch.Tensor, blk: Block) -> torch.Tensor:
        h = layer_norm(x, blk.ln_1.weight, blk.ln_1.bias)
        q, k, v = linear(h, blk.attn.c_attn).split(self.d_model, dim=-1)
        q, k, v = (split_heads(z, self.n_head) for z in (q, k, v))
        y = merge_heads(causal_attention_core(q, k, v))
        x = x + linear(y, blk.attn.c_proj)
        h = layer_norm(x, blk.ln_2.weight, blk.ln_2.bias)
        h = new_gelu(linear(h, blk.mlp.c_fc))
        return x + linear(h, blk.mlp.c_proj)

    def backbone(self, x_ids: torch.Tensor) -> torch.Tensor:
        x = self.embed(x_ids)
        for blk in self.blocks:
            x = self.block_body(x, blk)
        ln_f = self.transformer.ln_f
        return layer_norm(x, ln_f.weight, ln_f.bias)

    def heads(self, x: torch.Tensor, *, generate: bool = True) -> torch.Tensor:
        """lm_head logits (B, T, n_classes), or the class head's two-stage
        d -> 1, exact GELU, seq_len -> 2 logits (B, 2)."""
        if generate:
            return x @ self.lm_head.weight.t()
        h = gelu(linear(x, self.class_head.linear_1).squeeze(-1))
        return linear(h, self.class_head.linear_2)

    def apply(self, x_ids: torch.Tensor, *, generate: bool = True):
        return self.heads(self.backbone(x_ids), generate=generate)

    forward = apply
