"""The eval-mode encoder resblock chain as one kernel per group of blocks.

Port of vq_vae_transformer_arc_welding_tpu/ops/pallas_encoder.py
(`_pack_encoder` as `pack_encoder`, `encode_indices_fused` and
`fused_encoder_eval`, the pallas_call at :311). The kernel is
`csrc/encoder_chain.cu` (`encoder_chain_f32`, hidden 512, the bench
model's width); `fused_encoder_eval_reference` is its plain PyTorch
version.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises. Nothing falls back.

The weights are packed once (`pack_encoder`, at pipeline
construction) and passed to `encode_indices_fused`, not repacked per
request.

GELU: the kernel uses the exact erf (`erff`), like the plain version
and the JAX package's XLA encoder. The Pallas kernel's Abramowitz &
Stegun erf was a workaround for Mosaic and is not carried over.

Group size: `encode_indices_fused` keeps the JAX rule, as many blocks
per call as fit 8 MB of f32 weights, i.e. 4 at hidden 512, so the port
makes the same calls as the reference. On Hopper the weights come from
L2 whatever the group, so the group size only sets how often the
(N, C) residual stream crosses device memory between calls.
"""
from __future__ import annotations

import torch

from .. import kernels
from .activations import gelu
from .norm import batch_norm_apply

_KERNEL = "encoder_chain_f32"
_KERNEL_WIDTH = 512


def _center_tap(kernel: torch.Tensor) -> torch.Tensor:
    return kernel[:, :, kernel.shape[-1] // 2]


def pack_encoder(model) -> tuple[torch.Tensor, torch.Tensor]:
    """Stack every resblock's center-tap weights, transposed to (in, out),
    as (2n, C, C), and its vector rows [b1, bn1 mean, var, scale, bias,
    b2, bn2 mean, var, scale, bias] as (10n, C); BN rows are zeros when
    the model has no BatchNorm."""
    ws, vs = [], []
    c = model.hidden_dim
    zero = torch.zeros(c, device=model.codebook.device)
    for blk in model.resblocks:
        conv1, bn1, conv2, bn2 = (blk.block[i] for i in (1, 2, 4, 5))
        ws += [_center_tap(conv1.weight).t(), _center_tap(conv2.weight).t()]
        for conv, bn in ((conv1, bn1), (conv2, bn2)):
            if model.batch_norm:
                vs += [conv.bias, bn.running_mean, bn.running_var, bn.weight,
                       bn.bias]
            else:
                vs += [conv.bias, zero, zero, zero, zero]
    return torch.stack(ws).contiguous(), torch.stack(vs).contiguous()


def fused_encoder_eval_reference(x: torch.Tensor, weights: torch.Tensor,
                                 vecs: torch.Tensor, *,
                                 use_bn: bool) -> torch.Tensor:
    """Plain PyTorch version of the kernel. x: (N, C) f32; weights
    (2n, C, C) in (in, out) layout; vecs (10n, C). Returns (N, C)."""
    for i in range(weights.shape[0] // 2):
        v = vecs[10 * i:10 * (i + 1)]
        c = gelu(x) @ weights[2 * i] + v[0]
        if use_bn:
            c = batch_norm_apply(c, v[3], v[4], v[1], v[2])
        c = gelu(c) @ weights[2 * i + 1] + v[5]
        if use_bn:
            c = batch_norm_apply(c, v[8], v[9], v[6], v[7])
        x = x + c
    return x


def fused_encoder_eval(x: torch.Tensor, weights: torch.Tensor,
                       vecs: torch.Tensor, *, use_bn: bool) -> torch.Tensor:
    """n = weights.shape[0] // 2 eval resblocks on (N, C) f32 rows."""
    if x.device.type == "cpu":
        return fused_encoder_eval_reference(x, weights, vecs, use_bn=use_bn)
    if x.device.type != "cuda":
        raise ValueError(f"{_KERNEL}: no kernel for device {x.device}")
    n, c = x.shape
    nb = weights.shape[0] // 2
    if c != _KERNEL_WIDTH or weights.shape[0] != 2 * nb or nb < 1:
        raise ValueError(f"{_KERNEL}: hidden {c} / {weights.shape[0]} "
                         f"matrices not supported (hidden "
                         f"{_KERNEL_WIDTH}, an even count)")
    kernels.require(x, "x", torch.float32, (n, c), x.device)
    kernels.require(weights, "weights", torch.float32, (2 * nb, c, c),
                    x.device)
    kernels.require(vecs, "vecs", torch.float32, (10 * nb, c), x.device)
    out = torch.empty_like(x)
    if n == 0:
        return out
    lib = kernels.library()
    kernels.launches[_KERNEL] += 1
    err = lib.encoder_chain_f32(x.data_ptr(), weights.data_ptr(),
                                vecs.data_ptr(), out.data_ptr(), n, c, nb,
                                int(use_bn), kernels.stream_ptr(x.device))
    kernels.check(err, _KERNEL)
    return out


def group_size_for(hidden: int) -> int:
    """Resblocks per call: as many as fit 8 MB of f32 weights (the JAX rule)."""
    return max(1, (8 << 20) // (2 * hidden * hidden * 4))


def encode_indices_fused(model, packed: tuple[torch.Tensor, torch.Tensor],
                         x: torch.Tensor) -> torch.Tensor:
    """VQVAEPatch.encode_indices with the resblock chain on the fused
    kernel, `group_size_for(hidden)` blocks per call; patch-embed,
    sep_conv and the nearest-code argmin stay plain PyTorch. packed:
    `pack_encoder(model)`. x: (B, seq_len, input_dim) -> (B,
    enc_out_len) int32."""
    group_size = group_size_for(model.hidden_dim)
    h = model.patch_embed_out(x)
    b, p, c = h.shape
    weights, vecs = packed
    flat = h.reshape(b * p, c)
    nb = model.n_resblocks
    for s0 in range(0, nb, group_size):
        s1 = min(s0 + group_size, nb)
        flat = fused_encoder_eval(flat, weights[2 * s0:2 * s1],
                                  vecs[10 * s0:10 * s1],
                                  use_bn=model.batch_norm)
    return model.nearest(model.sep_conv(flat.reshape(b, p, c)))
