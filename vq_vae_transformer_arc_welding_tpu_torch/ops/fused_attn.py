"""Fused causal attention in f32: no score tensor in device memory.

Port of vq_vae_transformer_arc_welding_tpu/ops/pallas_attn.py
(`flash_causal_attention`, the pallas_call at :73, kernel #9). The
kernel is `csrc/flash_attn.cu` (`flash_attention_f32`, and
`flash_attention_bf16` on bf16 q, k and v);
`flash_causal_attention_reference` is its plain PyTorch version, the
core of ops/attention.py on f32 operands, which writes and re-reads the
(B, H, T, T) scores.

Operand types: as the JAX kernel, f32 or bf16 q, k and v (all three of
one type), the arithmetic in f32 and the output in q's type. The bf16
kernel has a tile of its own (csrc/attention_bf16.cuh): Q K^T and P@V
as bf16 tensor-core products with f32 sums (P in three bf16 terms, kept
in registers), the softmax in f32, the output rounded to bf16 to
nearest even; the plain version widens q, k and v, runs the f32 core
and rounds its output the same way.

What the TPU shaped and this port drops: the padding of T to a multiple
of 8 and the GROUP = 4 (batch, head) pairs per program. The CUDA kernel
takes any T, masks the ragged edge itself, and runs one block per
query tile (laid from the end of T), head and batch: on f32 operands
the tile of csrc/attention_tc.cuh (128 queries, P@V in split TF32 on
the tensor cores), on bf16 ones that of csrc/attention_bf16.cuh (64
queries). On f32 operands it takes any head width up to
`kernels.MAX_WIDTH` (the columns past D zero in shared memory where the
tile is wider; a head past 128 on the tile's wide form, a block for
each 128 output columns in clusters of `kernels.wide_cluster(D)` that
form the scores once); on bf16 ones any C = H * D up to
`kernels.MAX_WIDTH` in any heads, a head past 128 on the bf16 tile's
wide form likewise. Other shapes raise. `kernels.last_cluster(name)`
reads back the cluster size of the last launch.

The kernel reads q, k and v through their strides, so the views that
`split_heads` cuts out of a packed (B, T, 3C) qkv are read in place; the
output is laid out (B, T, H, D) and returned as its (B, H, T, D) view,
which `merge_heads` reshapes without a copy.

`flash_causal_attention` is a `torch.autograd.Function`: the forward is
the kernel, given detached operands, and the backward recomputes the
attention through the plain version on the saved q, k, v (bf16 ones
widened) and differentiates that, as the JAX `custom_vjp` does; the
gradients come back in the operands' type. The training forward
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

_KERNELS = {torch.float32: "flash_attention_f32",
            torch.bfloat16: "flash_attention_bf16"}
_KERNEL = _KERNELS[torch.float32]


def flash_causal_attention_reference(q: torch.Tensor, k: torch.Tensor,
                                     v: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version: the f32 core on q, k and v widened to
    f32, the output in q's type."""
    if q.dtype == torch.float32:
        return causal_attention_core(q, k, v)
    return causal_attention_core(q.float(), k.float(),
                                 v.float()).to(q.dtype)


def _strided_ok(z: torch.Tensor, like: torch.Tensor) -> bool:
    """The kernel reads q, k and v through one set of strides, each
    head's row of D floats contiguous."""
    return z.stride() == like.stride() and z.stride(3) == 1


def flash_attention_forward(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor) -> torch.Tensor:
    """q, k, v (B, H, T, D), all f32 or all bf16 -> (B, H, T, D) in
    their type, without autograd: the kernel on CUDA, the plain version
    on the CPU."""
    if q.device.type == "cpu":
        return flash_causal_attention_reference(q, k, v)
    name = _KERNELS.get(q.dtype, _KERNEL)
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    b, h, t, d = q.shape
    dev = q.device
    kernels.require_heads(name, h * d, h,
                          **({} if q.dtype == torch.bfloat16
                             else dict(max_c=None,
                                       max_head=kernels.MAX_WIDTH)))
    for what, z in (("q", q), ("k", k), ("v", v)):
        if (z.dtype not in _KERNELS or z.dtype != q.dtype
                or tuple(z.shape) != (b, h, t, d) or z.device != dev):
            raise ValueError(f"{name}: {what} must be f32 or bf16 as q, "
                             f"{(b, h, t, d)} on {dev}, got {z.dtype} "
                             f"{tuple(z.shape)} on {z.device}")
    if not all(_strided_ok(z, q) for z in (q, k, v)):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out.transpose(1, 2)
    lib = kernels.library()
    kernels.launches[name] += 1
    sb, sh, st, _ = q.stride()
    err = getattr(lib, name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, t,
        d, sb, sh, st, t * h * d, d, h * d, 1.0 / math.sqrt(d),
        kernels.stream_ptr(dev))
    kernels.check(err, name)
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
            out = flash_causal_attention_reference(*saved)
        return torch.autograd.grad(out, saved, grad)


def flash_causal_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor) -> torch.Tensor:
    """q, k, v: (B, H, T, D) -> (B, H, T, D). No dropout."""
    return _FlashCausalAttention.apply(q, k, v)
