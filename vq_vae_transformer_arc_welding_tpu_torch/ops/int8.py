"""int8 activation quantization and exact int8 x int8 products.

The primitives that models/quantized.py and the fused ops share. Counterparts: `_q8` and `_idot` of
vq_vae_transformer_arc_welding_tpu/ops/pallas_block_quant.py, and the
quantize step and int8 product inside `qdot` of
vq_vae_transformer_arc_welding_tpu/models/quantized.py. Rounding is
half to even (torch.round, like jnp.round) and clipped to +-127.
"""
from __future__ import annotations

import torch

# exact-f32 bound for an int8 product: |sum| <= K * 127^2 must stay
# below 2^24, the last integer every f32 represents
_F32_EXACT = 1 << 24
# torch._int_mm takes more than 16 rows; fewer are padded up to this
_INT_MM_ROWS = 32


def quantize_act(x: torch.Tensor, scale) -> torch.Tensor:
    """round-half-even(x * scale) clipped to +-127, int8."""
    return torch.clamp(torch.round(x * scale), -127, 127).to(torch.int8)


def int8_matmul(a8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """(..., K) int8 @ (N, K)^T int8 -> (..., N) int32, exact.

    CPU: an int32 product. CUDA: torch._int_mm where K and N are
    multiples of 8; it wants more than 16 rows, so the one to 16 rows of
    a decode step (a token per stream) are padded with zero rows and the
    padding cut off again. Otherwise an f32 product, exact while
    K * 127^2 < 2^24 (the class head: l1 has N=1, l2 K=321; lm_head:
    N=258), which needs TF32 off as the serving pipeline sets it."""
    k = a8.shape[-1]
    n = w8.shape[0]
    a2 = a8.reshape(-1, k)
    if a8.device.type == "cpu":
        out = a2.to(torch.int32) @ w8.to(torch.int32).t()
    elif k % 8 == 0 and n % 8 == 0:
        m = a2.shape[0]
        if m <= 16:
            a2 = torch.nn.functional.pad(a2, (0, 0, 0, _INT_MM_ROWS - m))
        out = torch._int_mm(a2, w8.t())[:m]
    elif k * 127 * 127 < _F32_EXACT:
        if torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("exact f32 int8 product needs "
                               "torch.backends.cuda.matmul.allow_tf32=False")
        out = (a2.float() @ w8.float().t()).to(torch.int32)
    else:
        raise ValueError(f"no exact int8 product for ({a2.shape[0]}, {k}) x "
                         f"({k}, {n}) on {a8.device}")
    return out.reshape(*a8.shape[:-1], n)


def int8_bmm(a8: torch.Tensor, b8: torch.Tensor) -> torch.Tensor:
    """(..., M, K) int8 @ (..., K, N) int8 -> (..., M, N) int32, exact:
    the score and P@V products of the int8 attention. CPU: an int32
    product. CUDA: an f32 product, exact while K * 127^2 < 2^24 (64-wide
    heads, T up to 1040), which needs TF32 off."""
    k = a8.shape[-1]
    if a8.device.type == "cpu":
        return a8.to(torch.int32) @ b8.to(torch.int32)
    if k * 127 * 127 >= _F32_EXACT:
        raise ValueError(f"no exact batched int8 product with K={k} on "
                         f"{a8.device}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("exact f32 int8 product needs "
                           "torch.backends.cuda.matmul.allow_tf32=False")
    return (a8.float() @ b8.float()).to(torch.int32)
