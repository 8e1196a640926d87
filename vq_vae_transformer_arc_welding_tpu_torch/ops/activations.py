"""The two GELU flavours of the reference.

Port of vq_vae_transformer_arc_welding_tpu/ops/activations.py: tanh
`new_gelu` in the transformer MLP, exact-erf `gelu` in the conv stacks
and the class head.
"""
import math

import torch
import torch.nn.functional as F


def new_gelu(x: torch.Tensor) -> torch.Tensor:
    """GPT-2 tanh-approximate GELU, with the JAX package's `x*x*x`."""
    return 0.5 * x * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (x + 0.044715 * x * x * x)))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, torch.nn.GELU's default."""
    return F.gelu(x)
