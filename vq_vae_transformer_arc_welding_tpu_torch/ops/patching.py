"""Patch embedding as a matmul over channel-concatenated patches.

Port of vq_vae_transformer_arc_welding_tpu/ops/patching.py (`patchify`,
`patch_embed`). The strided Conv1d of the reference is a dense layer
over non-overlapping patches; it stays a matmul here, not
`nn.Conv1d`, so that cuDNN and its default TF32 stay off the path.
"""
from __future__ import annotations

import torch


def patchify(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, T, C) cycles -> (B, T*C/patch, patch): all samples of channel
    0, then channel 1, cut into patches."""
    b, t, c = x.shape
    flat = x.transpose(1, 2).reshape(b, t * c)
    return flat.reshape(b, (t * c) // patch_size, patch_size)


def patch_embed(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                patch_size: int) -> torch.Tensor:
    """kernel: (patch, hidden), the torch weight (H, 1, patch) transposed.
    Returns (B, n_patches, hidden)."""
    return patchify(x, patch_size) @ kernel + bias
