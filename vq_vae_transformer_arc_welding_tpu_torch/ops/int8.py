"""int8 activation quantization and exact int8 x int8 products.

The primitives that models/quantized.py and ops/fused_block_quant.py
share. Counterparts: `_q8` and `_idot` of
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


def quantize_act(x: torch.Tensor, scale) -> torch.Tensor:
    """round-half-even(x * scale) clipped to +-127, int8."""
    return torch.clamp(torch.round(x * scale), -127, 127).to(torch.int8)


def int8_matmul(a8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """(..., K) int8 @ (N, K)^T int8 -> (..., N) int32, exact.

    CPU: an int32 product. CUDA: torch._int_mm where its shape rules
    hold (more than 16 rows, K and N multiples of 8); otherwise an f32
    product, exact while K * 127^2 < 2^24 (the class head: l1 has N=1,
    l2 K=321), which needs TF32 off as the serving pipeline sets it."""
    k = a8.shape[-1]
    n = w8.shape[0]
    a2 = a8.reshape(-1, k)
    if a8.device.type == "cpu":
        out = a2.to(torch.int32) @ w8.to(torch.int32).t()
    elif a2.shape[0] > 16 and k % 8 == 0 and n % 8 == 0:
        out = torch._int_mm(a2, w8.t())
    elif k * 127 * 127 < _F32_EXACT:
        if torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("exact f32 int8 product needs "
                               "torch.backends.cuda.matmul.allow_tf32=False")
        out = (a2.float() @ w8.float().t()).to(torch.int32)
    else:
        raise ValueError(f"no exact int8 product for ({a2.shape[0]}, {k}) x "
                         f"({k}, {n}) on {a8.device}")
    return out.reshape(*a8.shape[:-1], n)
