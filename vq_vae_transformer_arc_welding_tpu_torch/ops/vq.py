"""Nearest-code search and lookup of the classic VQ bottleneck.

Port of vq_vae_transformer_arc_welding_tpu/ops/vq.py (`nearest_codes`,
`vq_lookup`): f32 distances by the z^2 + e^2 - 2 z.e expansion and the
first index among equal minima (torch.argmin, like jnp.argmin, returns
the lowest one), so ids stay bit-comparable on identical weights.
"""
from __future__ import annotations

import torch


def nearest_codes(z_flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """z_flat: (N, D) f32; codebook: (K, D). Returns (N,) int32 ids."""
    z = z_flat.float()
    cb = codebook.float()
    d = ((z ** 2).sum(dim=1, keepdim=True) + (cb ** 2).sum(dim=1)
         - 2.0 * (z @ cb.t()))
    return torch.argmin(d, dim=1).to(torch.int32)


def vq_lookup(indices: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Codebook vectors of `indices`, shape indices.shape + (D,)."""
    return codebook[indices.long()]
