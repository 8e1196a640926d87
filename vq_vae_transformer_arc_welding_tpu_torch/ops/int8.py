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
# below 2^24, the last integer every f32 represents; so an f32 product
# of at most F32_EXACT_K terms is exact
F32_EXACT_K = ((1 << 24) - 1) // (127 * 127)        # 1,040
# torch._int_mm takes more than 16 rows, and K and N in multiples of 8;
# fewer rows are padded up to this
_INT_MM_ROWS = 32


def quantize_act(x: torch.Tensor, scale) -> torch.Tensor:
    """round-half-even(x * scale) clipped to +-127, int8."""
    return torch.clamp(torch.round(x * scale), -127, 127).to(torch.int8)


def int_mm_operands(a2: torch.Tensor, w8: torch.Tensor):
    """(a, w) that torch._int_mm takes for a2 (M, K) @ w8 (N, K)^T:
    K and N padded with zeros to multiples of 8 and M to more than 16
    rows, both contiguous. A zero adds an exact 0, so rows :M and
    columns :N of a @ w^T are the product."""
    m, k = a2.shape
    n = w8.shape[0]
    pad_k = -k % 8
    pad_m = _INT_MM_ROWS - m if m <= 16 else 0
    if pad_k or pad_m:
        a2 = torch.nn.functional.pad(a2, (0, pad_k, 0, pad_m))
    if pad_k or n % 8:
        w8 = torch.nn.functional.pad(w8, (0, pad_k, 0, -n % 8))
    return a2.contiguous(), w8.contiguous()


def k_pieces(k: int) -> list:
    """K cut into slices of at most F32_EXACT_K terms: each slice's f32
    product of int8 operands is exact, and so is their int32 sum."""
    return [slice(i, min(i + F32_EXACT_K, k))
            for i in range(0, max(k, 1), F32_EXACT_K)]


def int8_matmul(a8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """(..., K) int8 @ (N, K)^T int8 -> (..., N) int32, exact at every
    K and N.

    CPU: an int32 product. CUDA: torch._int_mm on `int_mm_operands`
    (zero-padded up to its shape rules: the class head's l1 has N=1,
    l2 K=T, lm_head N=K_vq+2), its rows and columns past the product's
    cut off again."""
    k = a8.shape[-1]
    n = w8.shape[0]
    a2 = a8.reshape(-1, k)
    if a8.device.type == "cpu":
        out = a2.to(torch.int32) @ w8.to(torch.int32).t()
    else:
        a_p, w_p = int_mm_operands(a2, w8)
        out = torch._int_mm(a_p, w_p.t())[:a2.shape[0], :n]
    return out.reshape(*a8.shape[:-1], n)


def int8_bmm(a8: torch.Tensor, b8: torch.Tensor) -> torch.Tensor:
    """(..., M, K) int8 @ (..., K, N) int8 -> (..., M, N) int32, exact:
    the score and P@V products of the int8 attention. CPU: an int32
    product. CUDA: an f32 product for each of `k_pieces(K)` (exact
    there), summed in int32; needs TF32 off."""
    if a8.device.type == "cpu":
        return a8.to(torch.int32) @ b8.to(torch.int32)
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("exact f32 int8 product needs "
                           "torch.backends.cuda.matmul.allow_tf32=False")
    out = None
    for part in k_pieces(a8.shape[-1]):
        p = (a8[..., part].float() @ b8[..., part, :].float()).to(torch.int32)
        out = p if out is None else out + p
    return out
