"""Products on narrow inputs with their sums in f32: bf16 training.

Port of the JAX package's mixed-precision product,
`jnp.dot(a.astype(cd), w.astype(cd), preferred_element_type=jnp.float32)`
(models/vqvae_patch.py `_cast_conv`, models/mlp.py `apply`): both inputs
are rounded to the compute dtype, each product is exact in f32 and the
sums are f32, into an f32 result. A plain bf16 `@` would round its sums
to bf16, which is another function.

`matmul_f32` is differentiable: the casts carry the gradients back to
the f32 master weights, and the backward's two products take the
incoming gradient rounded to the compute dtype with f32 sums, each
rounded once to the operand's dtype. On the card the products are one
cuBLAS call each on the bf16 tensor cores (`torch.mm(..., out_dtype=
torch.float32)`); on the CPU the narrow operands are widened first,
which gives the same sums.
"""
from __future__ import annotations

import torch


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N), both of one narrow type, summed in f32 into f32."""
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _MatmulF32(torch.autograd.Function):

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return mm_f32(a, b)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        g = grad.to(a.dtype)
        ga = (mm_f32(g, b.t()).to(a.dtype) if ctx.needs_input_grad[0]
              else None)
        gb = (mm_f32(a.t(), g).to(b.dtype) if ctx.needs_input_grad[1]
              else None)
        return ga, gb


def matmul_f32(x: torch.Tensor, w: torch.Tensor,
               compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """x (..., K) @ w (K, N) into (..., N) f32. compute_dtype None: the
    plain f32 product; torch.bfloat16: x and w rounded to bf16, the
    products summed in f32."""
    if compute_dtype is None:
        return x @ w
    a = x.reshape(-1, x.shape[-1]).to(compute_dtype)
    out = _MatmulF32.apply(a, w.to(compute_dtype))
    return out.reshape(*x.shape[:-1], w.shape[-1])


def check_compute_dtype(compute_dtype) -> None:
    if compute_dtype not in (None, torch.bfloat16):
        raise ValueError(f"compute_dtype {compute_dtype}: None (f32) or "
                         f"torch.bfloat16")
