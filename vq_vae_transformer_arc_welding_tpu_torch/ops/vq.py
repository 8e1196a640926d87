"""The classic vector-quantization bottleneck: nearest-code search,
lookup, and the straight-through quantizer of the training forward.

Port of vq_vae_transformer_arc_welding_tpu/ops/vq.py (`VQOutput`,
`nearest_codes`, `vq_lookup`, `vq_quantize`): f32 distances by the
z^2 + e^2 - 2 z.e expansion and the first index among equal minima
(torch.argmin, like jnp.argmin, returns the lowest one), so ids stay
bit-comparable on identical weights; the commitment loss with the
reference's detaches, the straight-through estimator, and the
perplexity of the batch's code histogram.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class VQOutput(NamedTuple):
    loss: torch.Tensor        # scalar codebook + commitment loss
    z_q: torch.Tensor         # straight-through quantized latents, z's shape
    perplexity: torch.Tensor  # scalar exp(entropy of the code usage)
    indices: torch.Tensor     # int32 ids, z's shape without the last axis


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


def vq_quantize(z: torch.Tensor, codebook: torch.Tensor, beta: float = 0.25,
                *, nearest_fn=None) -> VQOutput:
    """Classic VQ forward. z: (..., D); codebook: (K, D).

    loss = mean((sg(z_q) - z)^2) + beta * mean((z_q - sg(z))^2), z_q's
    output is z + sg(z_q - z). `nearest_fn` (z_flat, codebook) -> ids
    swaps the search (the fused kernel of ops/fused_vq.py); it is given
    detached operands, so the ids carry no gradient, and the loss's
    gradient reaches the codebook through the lookup."""
    k = codebook.shape[0]
    z_flat = z.reshape(-1, z.shape[-1])
    find = nearest_fn if nearest_fn is not None else nearest_codes
    idx = find(z_flat.detach(), codebook.detach())
    z_q = vq_lookup(idx, codebook).reshape(z.shape)
    loss = (((z_q.detach() - z) ** 2).mean()
            + beta * ((z_q - z.detach()) ** 2).mean())
    z_q_st = z + (z_q - z).detach()
    with torch.no_grad():
        counts = torch.bincount(idx.long(), minlength=k).float()
        e_mean = counts / idx.shape[0]
        perplexity = torch.exp(-(e_mean * torch.log(e_mean + 1e-10)).sum())
    return VQOutput(loss, z_q_st, perplexity, idx.reshape(z.shape[:-1]))
