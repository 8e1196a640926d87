"""Fused causal attention in f32: no score tensor in device memory.

Port of vq_vae_transformer_arc_welding_tpu/ops/pallas_attn.py
(`flash_causal_attention`, the pallas_call at :73, kernel #9). The
kernel is `csrc/flash_attn.cu` (`flash_attention_f32`);
`flash_causal_attention_reference` is its plain PyTorch version, the
core of ops/attention.py, which writes and re-reads the (B, H, T, T)
scores.

What the TPU shaped and this port drops: the padding of T to a multiple
of 8 and the GROUP = 4 (batch, head) pairs per program. The CUDA kernel
takes any T, masks the ragged edge itself, and runs one block per
128-query tile (laid from the end of T), head and batch: the tile of
csrc/attention_tc.cuh, with P@V in split TF32 on the tensor cores. It
takes any head width up to 128 (C = H * D a multiple of 64): 64 on the
tile's 64 instantiation, another on 32, 64 or 128 with the columns past
D zero in shared memory; wider heads raise.

The kernel reads q, k and v through their strides, so the views that
`split_heads` cuts out of a packed (B, T, 3C) qkv are read in place; the
output is laid out (B, T, H, D) and returned as its (B, H, T, D) view,
which `merge_heads` reshapes without a copy.

`flash_causal_attention` is a `torch.autograd.Function`: the forward is
the kernel, given detached operands, and the backward recomputes the
attention through the plain core on the saved q, k, v and
differentiates that, as the JAX `custom_vjp` does. The training forward
reaches it with q, k and v that need gradients: views of one qkv, read
in place. The kernel has no dropout; ops/attention.py takes the plain
core where attention dropout is on.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises. Nothing falls back.
"""
from __future__ import annotations

import math

import torch

from .. import kernels
from .attention import causal_attention_core

_KERNEL = "flash_attention_f32"

flash_causal_attention_reference = causal_attention_core


def _strided_ok(z: torch.Tensor, like: torch.Tensor) -> bool:
    """The kernel reads q, k and v through one set of strides, each
    head's row of D floats contiguous."""
    return z.stride() == like.stride() and z.stride(3) == 1


def flash_attention_forward(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor) -> torch.Tensor:
    """q, k, v (B, H, T, D) f32 -> (B, H, T, D) f32, without autograd:
    the kernel on CUDA, the plain core on the CPU."""
    if q.device.type == "cpu":
        return flash_causal_attention_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"{_KERNEL}: no kernel for device {q.device}")
    b, h, t, d = q.shape
    dev = q.device
    kernels.require_heads(_KERNEL, h * d, h)
    for name, z in (("q", q), ("k", k), ("v", v)):
        if (z.dtype != torch.float32 or tuple(z.shape) != (b, h, t, d)
                or z.device != dev):
            raise ValueError(f"{_KERNEL}: {name} must be f32 {(b, h, t, d)} "
                             f"on {dev}, got {z.dtype} {tuple(z.shape)} on "
                             f"{z.device}")
    if not all(_strided_ok(z, q) for z in (q, k, v)):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty((b, t, h, d), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out.transpose(1, 2)
    lib = kernels.library()
    kernels.launches[_KERNEL] += 1
    sb, sh, st, _ = q.stride()
    err = lib.flash_attention_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, t,
        d, sb, sh, st, t * h * d, d, h * d, 1.0 / math.sqrt(d),
        kernels.stream_ptr(dev))
    kernels.check(err, _KERNEL)
    return out.transpose(1, 2)


class _FlashCausalAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return flash_attention_forward(q.detach(), k.detach(), v.detach())

    @staticmethod
    def backward(ctx, grad):
        saved = [z.detach().requires_grad_(True) for z in ctx.saved_tensors]
        with torch.enable_grad():
            out = causal_attention_core(*saved)
        return torch.autograd.grad(out, saved, grad)


def flash_causal_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor) -> torch.Tensor:
    """q, k, v: (B, H, T, D) -> (B, H, T, D). No dropout."""
    return _FlashCausalAttention.apply(q, k, v)
