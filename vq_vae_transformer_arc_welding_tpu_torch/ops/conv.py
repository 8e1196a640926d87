"""The encoder's shared per-position conv as a dense layer.

Port of vq_vae_transformer_arc_welding_tpu/ops/conv.py::center_tap_dense.
A k=3, pad=1 conv applied to length-1 positions only ever sees zero
padding on its side taps, so it is exactly an affine map by the
kernel's center tap.
"""
from __future__ import annotations

import torch


def center_tap_dense(x: torch.Tensor, kernel: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """x: (B, P, I); kernel: (O, I, k) torch layout, odd k. Returns (B, P, O)."""
    k = kernel.shape[-1]
    return x @ kernel[:, :, k // 2].t() + bias
