"""Causal multi-head self-attention.

Port of vq_vae_transformer_arc_welding_tpu/ops/attention.py
(`split_heads`, `merge_heads`, `causal_attention_core`,
`causal_self_attention`): fused qkv projection, 1/sqrt(d) scaling, -inf
causal mask, f32 softmax, output projection. `impl='pallas'` (the JAX
package's name for the option) runs the core as one fused kernel,
ops/fused_attn.flash_causal_attention; `'xla'` is the plain core, which
calibration, the plain int8 chain, `_prefill` and the cached decode
step also use.

At train time the attention probabilities and the projected output take
dropout (`attn_dropout_p`, `resid_dropout_p`), drawn from the caller's
generator in that order. The fused kernel has no dropout, so an
`impl='pallas'` layer with `attn_dropout_p > 0` at train time runs the
plain core: the JAX function's own rule (ops/attention.py:68-76 there).

A tensor-parallel layer (parallel/sharding.py) holds its rank's heads
of q, k and v and its rows of the output projection: Megatron's f and g
(`tp.copy_to`, `tp.reduce_from`) wrap it, the projection's bias is added
once after g, and the probabilities' dropout draws the whole layer's
mask and keeps the rank's heads (`parts`), so a rank drops what one
process holding every head drops.

Linear weights are in torch's (out, in) layout. With a bf16 input the
projections are bf16 and the core runs in f32, as in the JAX package:
the plain core on q, k and v widened to f32, the fused kernel on the
bf16 q, k and v as they are (it widens them itself).
"""
from __future__ import annotations

import math

import torch

from ..utils.random import dropout


def split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    """(B, T, C) -> (B, H, T, C/H)."""
    b, t, c = x.shape
    return x.reshape(b, t, n_head, c // n_head).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, D) -> (B, T, H*D)."""
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


def causal_attention_core(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, attn_dropout_p: float = 0.0,
                          train: bool = False,
                          generator: torch.Generator | None = None,
                          parts: tuple = ()) -> torch.Tensor:
    """q, k, v: (B, H, T, D). Returns (B, H, T, D). parts: the
    dropout's (utils/random.dropout)."""
    d, t = q.shape[-1], q.shape[2]
    att = (q @ k.transpose(-1, -2)) / math.sqrt(d)
    causal = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    att = torch.softmax(att.masked_fill(~causal, float("-inf")), dim=-1)
    if train and attn_dropout_p > 0.0:
        att = dropout(att, attn_dropout_p, train, generator, parts=parts)
    return att @ v


def causal_self_attention(x: torch.Tensor, attn, *, n_head: int,
                          attn_dropout_p: float = 0.0,
                          resid_dropout_p: float = 0.1, train: bool = False,
                          generator: torch.Generator | None = None,
                          impl: str = "xla", tp=None) -> torch.Tensor:
    """Full attention layer: qkv projection -> core -> output projection
    -> residual dropout (at train time).

    attn: a holder of `c_attn` and `c_proj` (weight (out, in) and bias),
    as a transformer Block's `attn`. impl: 'xla' (the plain core) or
    'pallas' (the fused kernel; the plain core where attention dropout
    is on). tp: the layer's tensor-parallel group, or None (module
    docstring). x: (B, T, C) -> (B, T, C)."""
    if impl not in ("xla", "pallas"):
        raise ValueError(f"attention impl {impl!r}: 'xla' or 'pallas'")
    parts = ()
    if tp is not None:
        x = tp.copy_to(x)
        n_head, parts = n_head // tp.ways, ((1, tp.index, tp.ways),)
    qkv = x @ attn.c_attn.weight.t() + attn.c_attn.bias
    q, k, v = (split_heads(z, n_head) for z in qkv.chunk(3, dim=-1))
    if impl == "pallas" and not (train and attn_dropout_p > 0.0):
        # the fused kernel takes the stream's type (f32 or bf16), scores
        # and softmax in f32, and returns that type
        from .fused_attn import flash_causal_attention
        y = flash_causal_attention(q, k, v)
    else:
        if x.dtype != torch.float32:
            # a bf16 stream (the transformer's compute_dtype): the
            # projections follow it, the scores and the softmax stay f32
            q, k, v = q.float(), k.float(), v.float()
        y = causal_attention_core(q, k, v, attn_dropout_p=attn_dropout_p,
                                  train=train, generator=generator,
                                  parts=parts)
    y = merge_heads(y).to(x.dtype) @ attn.c_proj.weight.t()
    if tp is not None:
        y = tp.reduce_from(y)
    return dropout(y + attn.c_proj.bias, resid_dropout_p, train, generator)
