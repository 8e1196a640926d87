"""TS2Vec's hierarchical contrastive loss.

Port of vq_vae_transformer_arc_welding_tpu/ts2vec/losses.py
(`instance_contrastive_loss`, `temporal_contrastive_loss`,
`hierarchical_contrastive_loss`; the reference's model/ts2vec/
losses.py): instance and temporal contrastive terms, alternated with a
max-pool halving of time until one step remains. The diagonal of the
similarity is dropped by the reference's shifted tril + triu sum.
"""
from __future__ import annotations

import torch


def _off_diagonal_logits(sim: torch.Tensor) -> torch.Tensor:
    """(..., N, N) similarity -> (..., N, N-1) without the diagonal."""
    return (torch.tril(sim, diagonal=-1)[..., :, :-1]
            + torch.triu(sim, diagonal=1)[..., :, 1:])


def instance_contrastive_loss(z1: torch.Tensor, z2: torch.Tensor):
    b = z1.shape[0]
    if b == 1:
        return z1.new_zeros(())
    z = torch.cat([z1, z2], dim=0).transpose(0, 1)       # (T, 2B, C)
    logits = -torch.log_softmax(_off_diagonal_logits(z @ z.transpose(1, 2)),
                                dim=-1)
    i = torch.arange(b, device=z1.device)
    return (logits[:, i, b + i - 1].mean() + logits[:, b + i, i].mean()) / 2


def temporal_contrastive_loss(z1: torch.Tensor, z2: torch.Tensor):
    t = z1.shape[1]
    if t == 1:
        return z1.new_zeros(())
    z = torch.cat([z1, z2], dim=1)                        # (B, 2T, C)
    logits = -torch.log_softmax(_off_diagonal_logits(z @ z.transpose(1, 2)),
                                dim=-1)
    i = torch.arange(t, device=z1.device)
    return (logits[:, i, t + i - 1].mean() + logits[:, t + i, i].mean()) / 2


def _max_pool_halve(z: torch.Tensor) -> torch.Tensor:
    """max_pool1d(k=2) over time: stride 2, the odd tail dropped."""
    t2 = z.shape[1] // 2
    return z[:, :2 * t2].reshape(z.shape[0], t2, 2, z.shape[-1]).amax(dim=2)


def hierarchical_contrastive_loss(z1: torch.Tensor, z2: torch.Tensor,
                                  alpha: float = 0.5,
                                  temporal_unit: int = 0) -> torch.Tensor:
    loss = z1.new_zeros(())
    d = 0
    while z1.shape[1] > 1:
        if alpha != 0:
            loss = loss + alpha * instance_contrastive_loss(z1, z2)
        if d >= temporal_unit and 1 - alpha != 0:
            loss = loss + (1 - alpha) * temporal_contrastive_loss(z1, z2)
        d += 1
        z1, z2 = _max_pool_halve(z1), _max_pool_halve(z2)
    if z1.shape[1] == 1:
        if alpha != 0:
            loss = loss + alpha * instance_contrastive_loss(z1, z2)
        d += 1
    return loss / d
