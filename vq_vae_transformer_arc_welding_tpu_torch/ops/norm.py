"""LayerNorm and eval-mode BatchNorm, written out as in the JAX package.

Port of vq_vae_transformer_arc_welding_tpu/ops/norm.py. The expressions
follow the JAX op order, `(x - mean) / sqrt(var + eps) * scale + bias`
with the biased variance, instead of `F.layer_norm`: its fused rsqrt
rounds differently, which moves values across the int8 quantization
boundaries that the int8 path keeps bit-comparable.
"""
from __future__ import annotations

import torch


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """torch.nn.LayerNorm over the last axis, JAX op order."""
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * scale + bias


def batch_norm_apply(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     mean: torch.Tensor, var: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """torch.nn.BatchNorm1d in eval mode, channels last: running stats."""
    return (x - mean) / torch.sqrt(var + eps) * scale + bias
