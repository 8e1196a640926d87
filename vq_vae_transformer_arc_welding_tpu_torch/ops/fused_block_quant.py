"""The attention half of a calibrated-int8 transformer block, fused.

Port of vq_vae_transformer_arc_welding_tpu/ops/pallas_block_quant.py
(`_block_operands` and `fused_attn_block_quant`, the pallas_call at
:255, `int8_attn=False` only). The kernel is `csrc/attn_block_quant.cu`
(`attn_block_quant`, a sequence of five launches);
`fused_attn_block_quant_reference` is its plain PyTorch version, with
the Pallas kernel's op order: the softmax denominator is applied after
the P@V product.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises. Nothing falls back.

Operands are packed once per calibrated block (`pack_block`, called by
`quantize_transformer` and `bridge.qparams_from_jax`), not per call.

The 'attn8' (int8 scores) and 'full' (MLP inside) variants are not
ported yet.
"""
from __future__ import annotations

import math

import torch

from .. import kernels
from .attention import merge_heads, split_heads
from .int8 import int8_matmul, quantize_act
from .norm import layer_norm

_KERNEL = "attn_block_quant"
_QLINEARS = ("c_attn", "c_proj", "c_fc", "m_proj")


def _block_operands(blk: dict) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Pack one quantized block into the kernel's operands:
    scales (4,) [s_attn, s_proj, s_fc, s_mproj]; vc (6, C) rows
    [ln1 scale, ln1 bias, ln2 scale, ln2 bias, c_proj dequant, c_proj
    bias]; v3c (2, 3C) rows [c_attn dequant, c_attn bias]."""
    ca, cp, fc, mp = (blk[name] for name in _QLINEARS)
    for q, name in zip((ca, cp, fc, mp), _QLINEARS):
        if q.act_scale is None:
            raise ValueError(f"fused block path needs calibrated act "
                             f"scales ({name})")
    scales = torch.stack([q.act_scale.reshape(()).float()
                          for q in (ca, cp, fc, mp)])
    vc = torch.stack([blk["ln1_scale"], blk["ln1_bias"], blk["ln2_scale"],
                      blk["ln2_bias"], cp.scale / cp.act_scale, cp.bias])
    v3c = torch.stack([ca.scale / ca.act_scale, ca.bias])
    return scales.contiguous(), vc.float().contiguous(), v3c.contiguous()


def pack_block(blk: dict) -> dict:
    """`blk` with its kernel operands, `_block_operands(blk)`, under
    "attn_operands", so that serving packs them once and not per call.
    A block without calibrated act scales (dynamic int8) is returned as
    it is; the fused path refuses it."""
    if any(blk[name].act_scale is None for name in _QLINEARS):
        return blk
    return {**blk, "attn_operands": _block_operands(blk)}


def fused_attn_block_quant_reference(x, w_qkv, w_proj, scales, vc, v3c, *,
                                     n_head: int):
    """Plain PyTorch version of the kernel. x: (B, T, C) f32; w_qkv
    (3C, C), w_proj (C, C) int8 in (out, in) layout; operands as
    `_block_operands` packs them. Returns (x_mid f32, h8 int8)."""
    b, t, c = x.shape
    sm_scale = 1.0 / math.sqrt(c // n_head)
    h8 = quantize_act(layer_norm(x, vc[0], vc[1]), scales[0])
    qkv = int8_matmul(h8, w_qkv).float() * v3c[0] + v3c[1]
    q, k, v = (split_heads(z, n_head) for z in qkv.split(c, dim=-1))
    s = (q @ k.transpose(-1, -2)) * sm_scale
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    y = merge_heads((p @ v) / p.sum(dim=-1, keepdim=True))
    y8 = quantize_act(y, scales[1])
    x_mid = x + (int8_matmul(y8, w_proj).float() * vc[4] + vc[5])
    return x_mid, quantize_act(layer_norm(x_mid, vc[2], vc[3]), scales[2])


def attn_block_quant(x, w_qkv, w_proj, scales, vc, v3c, *, n_head: int):
    """Operand-level entry: the kernel on CUDA, the plain version on CPU."""
    if x.device.type == "cpu":
        return fused_attn_block_quant_reference(x, w_qkv, w_proj, scales, vc,
                                                v3c, n_head=n_head)
    if x.device.type != "cuda":
        raise ValueError(f"{_KERNEL}: no kernel for device {x.device}")
    b, t, c = x.shape
    dev = x.device
    lib = kernels.library()
    hd = lib.attn_block_quant_head_dim()
    if c % 64 or c > 1024 or c != n_head * hd:
        raise ValueError(f"{_KERNEL}: C={c} with {n_head} heads not "
                         f"supported: C a multiple of 64 up to 1024, head "
                         f"width {hd}")
    kernels.require(x, "x", torch.float32, (b, t, c), dev)
    kernels.require(w_qkv, "w_qkv", torch.int8, (3 * c, c), dev)
    kernels.require(w_proj, "w_proj", torch.int8, (c, c), dev)
    kernels.require(scales, "scales", torch.float32, (4,), dev)
    kernels.require(vc, "vc", torch.float32, (6, c), dev)
    kernels.require(v3c, "v3c", torch.float32, (2, 3 * c), dev)
    x_mid = torch.empty_like(x)
    h8 = torch.empty((b, t, c), dtype=torch.int8, device=dev)
    if b * t == 0:
        return x_mid, h8
    h8a = torch.empty_like(h8)
    y8 = torch.empty_like(h8)
    qkv = torch.empty((b, t, 3 * c), dtype=torch.float32, device=dev)
    kernels.launches[_KERNEL] += 1
    err = lib.attn_block_quant(
        x.data_ptr(), w_qkv.data_ptr(), w_proj.data_ptr(), scales.data_ptr(),
        vc.data_ptr(), v3c.data_ptr(), h8a.data_ptr(), qkv.data_ptr(),
        y8.data_ptr(), x_mid.data_ptr(), h8.data_ptr(), b, t, c, n_head,
        1.0 / math.sqrt(c // n_head), kernels.stream_ptr(dev))
    kernels.check(err, _KERNEL)
    return x_mid, h8


def fused_attn_block_quant(x: torch.Tensor, blk: dict, *, n_head: int):
    """ln1 + int8 qkv + attention + int8 c_proj + residual + ln2 + int8
    quantize for one calibrated block (an entry of
    quantize_transformer(model, act_absmax)["blocks"], packed by
    `pack_block`). x: (B, T, C) f32. Returns (x_mid f32 (B, T, C), h8
    int8 (B, T, C)): the post-attention residual stream and the
    quantized ln2 output for c_fc."""
    if "attn_operands" not in blk:
        raise ValueError("fused block path needs calibrated act scales: a "
                         "block from quantize_transformer(model, "
                         "act_absmax) or bridge.qparams_from_jax")
    scales, vc, v3c = blk["attn_operands"]
    return attn_block_quant(x, blk["c_attn"].w_int8, blk["c_proj"].w_int8,
                            scales, vc, v3c, n_head=n_head)
