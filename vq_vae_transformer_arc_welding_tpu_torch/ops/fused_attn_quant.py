"""Causal attention with an int8 output, for the calibrated-int8 path.

Port of vq_vae_transformer_arc_welding_tpu/ops/pallas_attn_quant.py:
`fused_causal_attention_quant` (the pallas_call at :214, kernel #11)
and `fused_qkv_attention_quant` (the pallas_call at :164, kernel #10).
The kernels are `csrc/attn_quant.cu` (`causal_attention_quant`,
`qkv_attention_quant`); `causal_attention_quant_reference` and
`qkv_attention_quant_reference` are their plain PyTorch versions.

`attention_core_reference` is the plain attention of every fused
int8 kernel (here and in ops/fused_block_quant.py), in the Pallas
kernels' op order: 1/sqrt(d) scale, -inf causal mask, p = exp(s -
row max), the row sum applied after P@V. Its `int8_attn` form is
pallas_block_quant.py::_attn_core(int8_attn=True).

`block_rows` (#10) is validated as in JAX (a multiple of 8) and changes
nothing else: the TPU kernel tiled its scores by causal row blocks to
skip fully masked columns, which gives the same values; the CUDA
kernel walks each query tile's keys only up to its causal limit.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises. Nothing falls back.

Weights are in the port's (out, in) layout: w_qkv is (3C, C). Widths:
any C from 1 to `kernels.MAX_WIDTH` in any number of heads (heads past
128 on the f32 attention's wide tile); y8 comes back in the kernels'
int8 rows (`kernels.empty_pitched`).
"""
from __future__ import annotations

import math

import torch

from .. import kernels
from .attention import merge_heads, split_heads
from .int8 import int8_bmm, int8_matmul, quantize_act

_CAUSAL = "causal_attention_quant"
_QKV = "qkv_attention_quant"


def _scale127(z: torch.Tensor) -> torch.Tensor:
    """127 / max(absmax over each head's rows and columns, 1e-6), as a
    true f32 division (a Python float over a tensor would multiply by a
    reciprocal)."""
    am = z.abs().amax(dim=(-1, -2), keepdim=True).clamp(min=1e-6)
    return torch.full_like(am, 127.0) / am


def sm_scale(c: int, n_head: int) -> float:
    """The attention's score scale, 1 / sqrt(head width)."""
    return 1.0 / math.sqrt(c // n_head)


def attention_core_reference(qkv: torch.Tensor, n_head: int, *,
                             int8_attn: bool = False) -> torch.Tensor:
    """(B, T, 3C) f32 qkv -> (B, T, C) f32 causal attention output.

    int8_attn: q, k, v quantized per (batch, head) with 127 / absmax;
    scores float(q8 @ k8^T) * (sm_scale / (sq * sk)); p = exp(s - max)
    and its row sum l unquantized; output float(q8(p, 127) @ v8) /
    (127 * sv) / l. The integer products are exact."""
    b, t, c3 = qkv.shape
    c = c3 // 3
    scale = sm_scale(c, n_head)
    q, k, v = (split_heads(z, n_head) for z in qkv.split(c, dim=-1))
    if int8_attn:
        sq, sk, sv = _scale127(q), _scale127(k), _scale127(v)
        s = int8_bmm(quantize_act(q, sq),
                     quantize_act(k, sk).transpose(-1, -2)).float()
        s = s * (torch.full_like(sq, scale) / (sq * sk))
    else:
        s = (q @ k.transpose(-1, -2)) * scale
    causal = torch.ones(t, t, dtype=torch.bool, device=qkv.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    if int8_attn:
        o = int8_bmm(quantize_act(p, 127.0),
                     quantize_act(v, sv)).float() / (127.0 * sv)
    else:
        o = p @ v
    return merge_heads(o / l)


def causal_attention_quant_reference(qkv, y_scale, *, n_head: int):
    """Plain version of #11: q8(attention(qkv), y_scale), int8."""
    return quantize_act(attention_core_reference(qkv, n_head), y_scale)


def qkv_attention_quant_reference(h, w_qkv, scales, v3c, *, n_head: int,
                                  block_rows: int | None = None):
    """Plain version of #10. h (B, T, C) f32; scales [x_scale,
    y_scale]; v3c rows [deq, bias]. Returns y8 (B, T, C) int8.
    block_rows changes nothing (see the module docstring)."""
    qkv = int8_matmul(quantize_act(h, scales[0]), w_qkv).float() * v3c[0] \
        + v3c[1]
    return causal_attention_quant_reference(qkv, scales[1], n_head=n_head)


def fused_causal_attention_quant(qkv: torch.Tensor, y_scale, *,
                                 n_head: int) -> torch.Tensor:
    """qkv (B, T, 3C) f32, the fused projection output (bias added);
    y_scale () or (1,) f32, the proj matmul's calibrated scale. Returns
    (B, T, C) int8. The kernel (#11) on CUDA, the plain version on the
    CPU."""
    if qkv.device.type == "cpu":
        return causal_attention_quant_reference(qkv, y_scale, n_head=n_head)
    if qkv.device.type != "cuda":
        raise ValueError(f"{_CAUSAL}: no kernel for device {qkv.device}")
    b, t, c3 = qkv.shape
    c = c3 // 3
    dev = qkv.device
    kernels.require_heads(_CAUSAL, c, n_head)
    kernels.require(qkv, "qkv", torch.float32, (b, t, 3 * c), dev)
    y_scale = y_scale.reshape(())
    kernels.require(y_scale, "y_scale", torch.float32, (), dev)
    y8 = kernels.empty_pitched((b, t, c), dev)
    if b * t == 0:
        return y8
    lib = kernels.library()
    kernels.launches[_CAUSAL] += 1
    err = lib.causal_attention_quant(
        qkv.data_ptr(), y_scale.data_ptr(), y8.data_ptr(), b, t, c, n_head,
        sm_scale(c, n_head), kernels.stream_ptr(dev))
    kernels.check(err, _CAUSAL)
    return y8


def qkv_attention_quant(h, w_qkv, scales, v3c, *, n_head: int,
                        block_rows: int | None = None) -> torch.Tensor:
    """Operand-level entry of #10: the kernel on CUDA, the plain version
    on the CPU. scales (2,) [x_scale, y_scale]; v3c (2, 3C) [deq,
    bias], as a packed block holds them (`scales[:2]`, `v3c`)."""
    if block_rows is not None and block_rows % 8:
        raise ValueError("block_rows must be a multiple of 8 (sublane)")
    if h.device.type == "cpu":
        return qkv_attention_quant_reference(h, w_qkv, scales, v3c,
                                             n_head=n_head,
                                             block_rows=block_rows)
    if h.device.type != "cuda":
        raise ValueError(f"{_QKV}: no kernel for device {h.device}")
    b, t, c = h.shape
    dev = h.device
    kernels.require_heads(_QKV, c, n_head)
    kernels.require(h, "h", torch.float32, (b, t, c), dev)
    w_qkv = kernels.pitched(w_qkv, "w_qkv", (3 * c, c), dev)
    kernels.require(scales, "scales", torch.float32, (2,), dev)
    kernels.require(v3c, "v3c", torch.float32, (2, 3 * c), dev)
    y8 = kernels.empty_pitched((b, t, c), dev)
    if b * t == 0:
        return y8
    h8 = kernels.empty_pitched((b, t, c), dev)
    qkv = torch.empty((b, t, 3 * c), dtype=torch.float32, device=dev)
    lib = kernels.library()
    kernels.launches[_QKV] += 1
    err = lib.qkv_attention_quant(
        h.data_ptr(), w_qkv.data_ptr(), scales.data_ptr(), v3c.data_ptr(),
        h8.data_ptr(), qkv.data_ptr(), y8.data_ptr(), b, t, c, n_head,
        sm_scale(c, n_head), kernels.stream_ptr(dev))
    kernels.check(err, _QKV)
    return y8


def fused_qkv_attention_quant(h, w_qkv_int8, deq, bias, x_scale, y_scale, *,
                              n_head: int, block_rows: int | None = None):
    """The JAX function's signature, with w_qkv_int8 in the port's
    (3C, C) layout: q8(h, x_scale) -> int8 qkv -> deq, bias -> causal
    attention -> q8(., y_scale). Returns (B, T, C) int8."""
    scales = torch.stack([torch.as_tensor(s, dtype=torch.float32,
                                          device=h.device).reshape(())
                          for s in (x_scale, y_scale)])
    v3c = torch.stack([deq.reshape(-1), bias.reshape(-1)]).float()
    return qkv_attention_quant(h, w_qkv_int8, scales, v3c, n_head=n_head,
                               block_rows=block_rows)
