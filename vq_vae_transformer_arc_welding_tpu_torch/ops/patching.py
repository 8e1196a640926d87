"""Patch embedding and its inverse as matmuls over non-overlapping patches.

Port of vq_vae_transformer_arc_welding_tpu/ops/patching.py (`patchify`,
`patch_embed`, `conv_transpose_stride_eq_kernel`, `INVERSE_PATCH_PLANS`,
`patch_embed_inverse`). The strided Conv1d of the reference is a dense
layer over non-overlapping patches, and its inverse, two
ConvTranspose1d stages whose kernel equals their stride, two more; they
stay matmuls here, not `nn.Conv1d`, so that cuDNN and its default TF32
stay off the path.

`compute_dtype` (bf16 training): the matmuls' inputs rounded to bf16,
their sums in f32 (ops/precision.matmul_f32), as the JAX package casts
them; in the inverse only the first stage's input is rounded, its
second stage takes the f32 GELU output against the rounded kernel, as
the JAX einsum promotes the pair to f32.
"""
from __future__ import annotations

import torch

from .activations import gelu
from .norm import batch_norm_apply, batch_norm_train
from .precision import matmul_f32

# the two ConvTranspose1d stages' kernel sizes (= strides) per patch
# size (reference model/vq_vae_patch_embedd.py:24-47)
INVERSE_PATCH_PLANS = {25: (5, 5), 10: (2, 5), 50: (10, 5)}


def patchify(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, T, C) cycles -> (B, T*C/patch, patch): all samples of channel
    0, then channel 1, cut into patches."""
    b, t, c = x.shape
    flat = x.transpose(1, 2).reshape(b, t * c)
    return flat.reshape(b, (t * c) // patch_size, patch_size)


def patch_embed(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                patch_size: int, compute_dtype=None) -> torch.Tensor:
    """kernel: (patch, hidden), the torch weight (H, 1, patch) transposed.
    Returns (B, n_patches, hidden)."""
    return matmul_f32(patchify(x, patch_size), kernel, compute_dtype) + bias


def conv_transpose_stride_eq_kernel(x: torch.Tensor, kernel: torch.Tensor,
                                    bias: torch.Tensor,
                                    compute_dtype=None) -> torch.Tensor:
    """ConvTranspose1d with kernel_size == stride: each input position
    writes its own k outputs, out[b, l*k + m, o] = sum_i x[b, l, i] *
    w[i, o, m] + bias[o]. x: (B, L, I); kernel: (I, O, k), torch's
    ConvTranspose1d layout. Returns (B, L*k, O)."""
    b, length, _ = x.shape
    i, o, k = kernel.shape
    y = matmul_f32(x, kernel.permute(0, 2, 1).reshape(i, k * o),
                   compute_dtype)
    return y.reshape(b, length * k, o) + bias


def patch_embed_inverse(x: torch.Tensor, params: dict, state: tuple, *,
                        patch_size: int, input_dim: int, train: bool,
                        momentum: float = 0.1, eps: float = 1e-5,
                        compute_dtype=None):
    """Two-stage ConvTranspose upsample with BatchNorm and GELU between
    the stages, then (B, T, input_dim).

    params: ct1_kernel (H, H, k1), ct1_bias, bn_scale, bn_bias,
    ct2_kernel (H, 1, k2), ct2_bias. state: the BN's (running_mean,
    running_var). Returns (y, new state): in train mode the BN
    normalizes by the batch and the state moves (`batch_norm_train`);
    in eval it normalizes by the state, which comes back as it was. The
    final reshape interleaves the flat 400-sample signal into (200, 2)
    consecutive pairs, as the reference's does."""
    if patch_size not in INVERSE_PATCH_PLANS:
        raise NotImplementedError(f"Patch size not implemented: {patch_size}")
    h = conv_transpose_stride_eq_kernel(x, params["ct1_kernel"],
                                        params["ct1_bias"], compute_dtype)
    if train:
        h, state = batch_norm_train(h, params["bn_scale"], params["bn_bias"],
                                    *state, momentum=momentum, eps=eps)
    else:
        h = batch_norm_apply(h, params["bn_scale"], params["bn_bias"],
                             *state, eps=eps)
    ct2 = params["ct2_kernel"]
    if compute_dtype is not None:
        ct2 = ct2.to(compute_dtype).float()
    h = conv_transpose_stride_eq_kernel(gelu(h), ct2, params["ct2_bias"])
    return h.reshape(h.shape[0], -1, input_dim), state
