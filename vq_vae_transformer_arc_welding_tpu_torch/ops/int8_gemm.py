"""The int8 GEMM of the calibrated-int8 kernels, on its own.

Kernels #2, #6, #8 and #10 (`csrc/attn_block_quant.cu`,
`csrc/block_quant.cu`, `csrc/mlp_quant.cu`, `csrc/attn_quant.cu`) run
their int8 products through one GEMM, `csrc/int8_gemm_sm90.cuh`
(wgmma fed by TMA, a persistent tile walk). Its stage in the JAX
kernels is `_idot(a8, w8).astype(float32) * scale + bias` of
vq_vae_transformer_arc_welding_tpu/ops/pallas_block_quant.py (:59,
:163, :168, :192, :194), followed by the residual add or by the tanh
GELU and q8 of the MLP's intermediate. The C entry `int8_gemm`
(`csrc/int8_gemm.cu`) launches the GEMM alone. Serving reaches it
through this wrapper on the 'attn' and 'attn8' paths (and their '-bf16'
variants): `models/quantized.py::_mlp_int8_gemm` runs the int8 MLP after
kernel #2 as two calls, c_fc with the GELU+q8 epilogue and m_proj with
the residual. The card tests and chip_smoke.py hold it against
`int8_gemm_reference` bit for bit and time it at each shape.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises. Nothing falls back.
"""
from __future__ import annotations

import torch

from .. import kernels
from .activations import new_gelu
from .int8 import int8_matmul, quantize_act

_KERNEL = "int8_gemm"


def int8_gemm_reference(a8, w8, cs, cb, resid=None, qscale=None):
    """The plain stage. a8 (M, K), w8 (N, K) int8; cs, cb (N,) f32.
    y = float(a8 @ w8^T) * cs + cb, one rounding per operation; then
    f32 y (+ resid (M, N)), or, with qscale, int8 q8(new_gelu(y),
    qscale)."""
    y = int8_matmul(a8, w8).float() * cs + cb
    if qscale is not None:
        return quantize_act(new_gelu(y), qscale)
    return y if resid is None else resid + y


def int8_gemm(a8, w8, cs, cb, resid=None, qscale=None) -> torch.Tensor:
    """Operand-level entry: the kernel on CUDA, the plain version on the
    CPU. N and K must be multiples of 64; resid and qscale exclude each
    other."""
    if a8.device.type == "cpu":
        return int8_gemm_reference(a8, w8, cs, cb, resid, qscale)
    if a8.device.type != "cuda":
        raise ValueError(f"{_KERNEL}: no kernel for device {a8.device}")
    if resid is not None and qscale is not None:
        raise ValueError(f"{_KERNEL}: a residual or a GELU+q8 epilogue, "
                         f"not both")
    if a8.dim() != 2 or w8.dim() != 2:
        raise ValueError(f"{_KERNEL}: a8 and w8 must be 2-d")
    m, k = a8.shape
    n = w8.shape[0]
    if n % 64 or k % 64:
        raise ValueError(f"{_KERNEL}: N={n}, K={k} must be multiples of 64")
    dev = a8.device
    kernels.require(a8, "a8", torch.int8, (m, k), dev)
    kernels.require(w8, "w8", torch.int8, (n, k), dev)
    kernels.require(cs, "cs", torch.float32, (n,), dev)
    kernels.require(cb, "cb", torch.float32, (n,), dev)
    if resid is not None:
        kernels.require(resid, "resid", torch.float32, (m, n), dev)
    if qscale is not None:
        kernels.require(qscale, "qscale", torch.float32, (), dev)
    out = torch.empty((m, n), device=dev, dtype=torch.float32
                      if qscale is None else torch.int8)
    if m == 0:
        return out
    lib = kernels.library()
    kernels.launches[_KERNEL] += 1
    err = lib.int8_gemm(
        a8.data_ptr(), w8.data_ptr(), cs.data_ptr(), cb.data_ptr(),
        None if resid is None else resid.data_ptr(),
        None if qscale is None else qscale.data_ptr(), out.data_ptr(), m, n,
        k, kernels.stream_ptr(dev))
    kernels.check(err, _KERNEL)
    return out
