"""The calibrated-int8 transformer MLP, fused.

Port of vq_vae_transformer_arc_welding_tpu/ops/pallas_mlp_quant.py
(`fused_mlp_quant`, the pallas_call at :67, kernel #8). The kernel is
`csrc/mlp_quant.cu` (`mlp_quant`); `mlp_quant_reference` is its plain
PyTorch version:

    h8  = q8(h, s_fc)
    g8  = q8(new_gelu(int32(h8 @ Wfc^T) * (fc.scale / s_fc) + b_fc), s_mp)
    out = int32(g8 @ Wmp^T) * (mp.scale / s_mp) + b_mp     (no residual)

`mlp_from_h8_reference` is the MLP from its quantized input, shared
with the plain version of the whole-block kernel (#6), whose CUDA
version runs the same two GEMMs (`csrc/int8_block.cu::launch_mlp`).

Dispatch: a CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises. Nothing falls back.

Operands: scales (2,) [s_fc, s_mp]; v4c (2, 4C) rows [fc.scale / s_fc,
fc.bias]; vmp (2, C) rows [mp.scale / s_mp, mp.bias]. A packed block
holds them (ops/fused_block_quant.py: `scales[2:]`, `v4c`, `vc[6:]`),
so serving packs nothing per call. Weights are in the port's (out, in)
layout: w_fc (4C, C), w_mp (C, 4C); any C, the kernel reading them in
rows `kernels.pitch16` of their width bytes apart (a packed block's
"block_weights"; another layout is copied into such rows per call).
"""
from __future__ import annotations

import torch

from .. import kernels
from .activations import new_gelu
from .int8 import int8_matmul, quantize_act

_KERNEL = "mlp_quant"


def fc_gelu_q8_reference(h8, w_fc, v4c, s_mp):
    """The MLP's int8 intermediate g8: c_fc, dequant + bias, tanh GELU,
    q8 with s_mp (the c_fc GEMM's epilogue in the kernels)."""
    mid = int8_matmul(h8, w_fc).float() * v4c[0] + v4c[1]
    return quantize_act(new_gelu(mid), s_mp)


def mlp_from_h8_reference(h8, w_fc, w_mp, s_mp, v4c, vmp):
    """The int8 MLP from its int8 input h8: g8, then m_proj, dequant +
    bias. f32 out, no residual."""
    g8 = fc_gelu_q8_reference(h8, w_fc, v4c, s_mp)
    return int8_matmul(g8, w_mp).float() * vmp[0] + vmp[1]


def mlp_quant_reference(h, w_fc, w_mp, scales, v4c, vmp):
    """Plain version of the kernel. h (B, T, C) f32 -> (B, T, C) f32."""
    return mlp_from_h8_reference(quantize_act(h, scales[0]), w_fc, w_mp,
                                 scales[1], v4c, vmp)


def mlp_quant(h, w_fc, w_mp, scales, v4c, vmp, *,
              scratch: dict | None = None) -> torch.Tensor:
    """Operand-level entry: the kernel on CUDA, the plain version on
    the CPU. scratch: a dict that receives the kernel's int8
    intermediates, "h8" and "g8", to check them (CUDA only)."""
    if h.device.type == "cpu":
        return mlp_quant_reference(h, w_fc, w_mp, scales, v4c, vmp)
    if h.device.type != "cuda":
        raise ValueError(f"{_KERNEL}: no kernel for device {h.device}")
    b, t, c = h.shape
    c4 = w_fc.shape[0]
    dev = h.device
    kernels.require_heads(_KERNEL, c, 1)
    kernels.require(h, "h", torch.float32, (b, t, c), dev)
    w_fc = kernels.pitched(w_fc, "w_fc", (c4, c), dev)
    w_mp = kernels.pitched(w_mp, "w_mp", (c, c4), dev)
    kernels.require(scales, "scales", torch.float32, (2,), dev)
    kernels.require(v4c, "v4c", torch.float32, (2, c4), dev)
    kernels.require(vmp, "vmp", torch.float32, (2, c), dev)
    out = torch.empty_like(h)
    if b * t == 0:
        return out
    h8 = kernels.empty_pitched((b, t, c), dev)
    g8 = kernels.empty_pitched((b, t, c4), dev)
    if scratch is not None:
        scratch.update(h8=h8, g8=g8)
    lib = kernels.library()
    kernels.launches[_KERNEL] += 1
    err = lib.mlp_quant(h.data_ptr(), w_fc.data_ptr(), w_mp.data_ptr(),
                        scales.data_ptr(), v4c.data_ptr(), vmp.data_ptr(),
                        h8.data_ptr(), g8.data_ptr(), out.data_ptr(), b * t,
                        c, c4, kernels.stream_ptr(dev))
    kernels.check(err, _KERNEL)
    return out


def fused_mlp_quant(h, fc_w8, fc_scale, fc_bias, fc_act_scale, mp_w8,
                    mp_scale, mp_bias, mp_act_scale) -> torch.Tensor:
    """The JAX function's signature, with the weights in the port's
    (out, in) layout: h (B, T, C) f32 post-LN activations -> the MLP
    output (B, T, C) f32 (the residual add stays outside)."""
    s_fc, s_mp = (torch.as_tensor(s, dtype=torch.float32,
                                  device=h.device).reshape(())
                  for s in (fc_act_scale, mp_act_scale))
    return mlp_quant(h, fc_w8, mp_w8, torch.stack([s_fc, s_mp]),
                     torch.stack([fc_scale / s_fc, fc_bias]).float(),
                     torch.stack([mp_scale / s_mp, mp_bias]).float())
