"""1-D convolution primitives of the VQ-VAE, channels last.

Port of vq_vae_transformer_arc_welding_tpu/ops/conv.py
(`center_tap_dense`, `conv1d_same`, `conv_transpose_block`).

- `center_tap_dense`: the encoder's shared conv as a dense layer. A
  k=3, pad=1 conv applied to length-1 positions only ever sees zero
  padding on its side taps, so it is exactly an affine map by the
  kernel's center tap.
- `conv1d_same`: the decoder's real k=3, pad=1 conv over the patch
  sequence, written as one (B*L, k*I) @ (k*I, O) matmul (the JAX
  package's `conv1d_same_im2col`, which is also the same function as
  its `conv1d_same` up to rounding). A matmul follows
  `torch.backends.cuda.matmul.allow_tf32`, off by default, so the
  decoder trains in f32 under torch's defaults; `F.conv1d` would go to
  cuDNN, whose `allow_tf32` is on by default. The JAX package's
  `conv_impl` option has no counterpart here.

Layouts: activations (B, L, C); conv kernels in torch's (O, I, k).

`compute_dtype` (bf16 training, the JAX package's `_cast_conv`): the
matmul's inputs rounded to bf16 and its products summed in f32
(ops/precision.matmul_f32); for the k=3 conv that is the im2col operand,
whose columns are x's values, rounded once each. The bias adds stay f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .precision import matmul_f32


def center_tap_dense(x: torch.Tensor, kernel: torch.Tensor,
                     bias: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """x: (B, P, I); kernel: (O, I, k) torch layout, odd k. Returns (B, P, O)."""
    k = kernel.shape[-1]
    return matmul_f32(x, kernel[:, :, k // 2].t(), compute_dtype) + bias


def conv1d_same(x: torch.Tensor, kernel: torch.Tensor,
                bias: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """Conv1d, stride 1, symmetric 'same' padding for odd k, as one im2col
    matmul: the k shifted copies of x concatenated tap-major along the
    features, times the kernel laid out (k*I, O).
    x: (B, L, I); kernel: (O, I, k). Returns (B, L, O)."""
    o, i, k = kernel.shape
    pad = (k - 1) // 2
    length = x.shape[1]
    xp = F.pad(x, (0, 0, pad, pad))
    xcat = torch.cat([xp[:, t:t + length] for t in range(k)], dim=-1)
    w = kernel.permute(2, 1, 0).reshape(k * i, o)
    return matmul_f32(xcat, w, compute_dtype) + bias


def conv_transpose_block(x: torch.Tensor, kernel: torch.Tensor,
                         bias: torch.Tensor) -> torch.Tensor:
    """The JAX package's alias of
    ops/patching.conv_transpose_stride_eq_kernel."""
    from .patching import conv_transpose_stride_eq_kernel
    return conv_transpose_stride_eq_kernel(x, kernel, bias)
