"""Causal multi-head attention core, without dropout (serving only).

Port of vq_vae_transformer_arc_welding_tpu/ops/attention.py
(`split_heads`, `merge_heads`, `causal_attention_core`): 1/sqrt(d)
scaling, -inf causal mask, f32 softmax. Calibration and the plain int8
chain use it.
"""
from __future__ import annotations

import math

import torch


def split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    """(B, T, C) -> (B, H, T, C/H)."""
    b, t, c = x.shape
    return x.reshape(b, t, n_head, c // n_head).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, D) -> (B, T, H*D)."""
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


def causal_attention_core(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """q, k, v: (B, H, T, D). Returns (B, H, T, D)."""
    d, t = q.shape[-1], q.shape[2]
    att = (q @ k.transpose(-1, -2)) / math.sqrt(d)
    causal = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    att = att.masked_fill(~causal, float("-inf"))
    return torch.softmax(att, dim=-1) @ v
