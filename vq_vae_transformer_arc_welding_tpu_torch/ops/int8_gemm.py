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
variants), `classify` with its in-path saturation monitor included:
`models/quantized.py::_mlp_int8_gemm` runs the int8 MLP after kernel #2
as two calls, c_fc with the GELU+q8 epilogue and m_proj with the
residual. With `clip_rows` the GELU+q8 epilogue also counts, per row,
the values that the quantization clips (`|new_gelu(y) * qscale| >
127.5`, the criterion of JAX's `_row_clip_frac` on the m_proj input),
so the monitor needs no f32 copy of that input. The card tests and
chip_smoke.py hold it against `int8_gemm_reference` bit for bit, counts
included, and time it at each shape.

Shapes: any M, N, K. The kernel reads a8 and w8, and writes the int8
output, in rows `kernels.pitch16` of their width bytes apart (a tensor
map's pitch): a8 and w8 laid out so are read in place (the h8 and g8
that the kernels return, a packed block's "block_weights"), others are
copied into such rows per call, and the int8 output comes back in them
(`kernels.empty_pitched`). Where N and K are multiples of 64 the GEMM
runs as it always has; otherwise its GENERAL form
(csrc/int8_gemm_sm90.cuh), the same arithmetic.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises. Nothing falls back.
"""
from __future__ import annotations

import torch

from .. import kernels
from .activations import new_gelu
from .int8 import int8_matmul, quantize_act

_KERNEL = "int8_gemm"


def int8_gemm_reference(a8, w8, cs, cb, resid=None, qscale=None,
                        clip_rows=None):
    """The plain stage. a8 (M, K), w8 (N, K) int8; cs, cb (N,) f32.
    y = float(a8 @ w8^T) * cs + cb, one rounding per operation; then
    f32 y (+ resid (M, N)), or, with qscale, int8 q8(new_gelu(y),
    qscale), and with clip_rows (M,) int32 each row's count of
    |new_gelu(y)| * qscale > 127.5 added to it in place."""
    y = int8_matmul(a8, w8).float() * cs + cb
    if qscale is not None:
        g = new_gelu(y)
        if clip_rows is not None:
            clip_rows += ((g.abs() * qscale) > 127.5).sum(
                -1, dtype=torch.int32)
        return quantize_act(g, qscale)
    return y if resid is None else resid + y


def int8_gemm(a8, w8, cs, cb, resid=None, qscale=None,
              clip_rows=None) -> torch.Tensor:
    """Operand-level entry: the kernel on CUDA, the plain version on the
    CPU. Any N, K >= 1; resid and qscale exclude each other; clip_rows
    (M,) int32, to which the counts are added, goes with qscale."""
    if a8.device.type == "cpu":
        return int8_gemm_reference(a8, w8, cs, cb, resid, qscale, clip_rows)
    if a8.device.type != "cuda":
        raise ValueError(f"{_KERNEL}: no kernel for device {a8.device}")
    if resid is not None and qscale is not None:
        raise ValueError(f"{_KERNEL}: a residual or a GELU+q8 epilogue, "
                         f"not both")
    if clip_rows is not None and qscale is None:
        raise ValueError(f"{_KERNEL}: clip_rows counts the GELU+q8 "
                         f"epilogue's clips; it needs qscale")
    if a8.dim() != 2 or w8.dim() != 2:
        raise ValueError(f"{_KERNEL}: a8 and w8 must be 2-d")
    m, k = a8.shape
    n = w8.shape[0]
    if n < 1 or k < 1:
        raise ValueError(f"{_KERNEL}: N={n}, K={k} must be at least 1")
    dev = a8.device
    a8 = kernels.pitched(a8, "a8", (m, k), dev)
    w8 = kernels.pitched(w8, "w8", (n, k), dev)
    kernels.require(cs, "cs", torch.float32, (n,), dev)
    kernels.require(cb, "cb", torch.float32, (n,), dev)
    if resid is not None:
        kernels.require(resid, "resid", torch.float32, (m, n), dev)
    if qscale is not None:
        kernels.require(qscale, "qscale", torch.float32, (), dev)
    if clip_rows is not None:
        kernels.require(clip_rows, "clip_rows", torch.int32, (m,), dev)
    out = (torch.empty((m, n), device=dev, dtype=torch.float32)
           if qscale is None else kernels.empty_pitched((m, n), dev))
    if m == 0:
        return out
    lib = kernels.library()
    kernels.launches[_KERNEL] += 1
    err = lib.int8_gemm(
        a8.data_ptr(), w8.data_ptr(), cs.data_ptr(), cb.data_ptr(),
        None if resid is None else resid.data_ptr(),
        None if qscale is None else qscale.data_ptr(),
        None if clip_rows is None else clip_rows.data_ptr(), out.data_ptr(),
        m, n, k, kernels.stream_ptr(dev))
    kernels.check(err, _KERNEL)
    return out
