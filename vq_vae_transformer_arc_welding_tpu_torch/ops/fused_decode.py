"""One token of KV-cached sampling through a block, as one kernel call.

Port of vq_vae_transformer_arc_welding_tpu/ops/pallas_decode.py:
`fused_decode_attn` (the pallas_call at :149, kernel #12), a block's
attention half against (B, H, T, D) caches, and `fused_block_decode`
(the pallas_call at :371, kernel #13), the whole block against (B, T, C)
time-major caches. The kernels are `csrc/decode.cu` (`decode_attn_f32`,
`block_decode_f32`); `fused_decode_attn_reference` and
`fused_block_decode_reference` are their plain PyTorch versions.

    h = LN1(x); q, k, v = h Wqkv + b; row `pos` of K and V written;
    y = softmax(q K[:pos+1]^T / sqrt(D)) V[:pos+1], per head;
    x_mid = x + y Wproj + b                                      (#12)
    x_out = x_mid + new_gelu(LN2(x_mid) Wfc + b) Wmp + b         (#13)

`blk` is a transformer Block of this package (models/transformer.py),
its weights f32 in torch's (out, in) layout. `pos` is a Python int, known
on the host: nothing here waits for the device.

The caches are updated IN PLACE and returned: only row `pos` is
written, every other row stays bit for bit as it was, and only rows
0..pos are read.

What the TPU shaped and this port drops:
- `DECODE_CHUNK = 128` and the ValueError for a cache length that is no
  multiple of it were DMA tiling; any T is taken here.
- The token row padded to 8 rows, and the 8-row write-back window of
  #13. In the JAX kernel that window returns V rows pos+1 ..
  8*(pos//8)+7 as zeros and leaves K rows there as they were; rows
  beyond `pos` are never read before their own step writes them, so
  only rows <= pos compare between the two packages.
- The bias folded into the product through a ones column: the bias is
  added after the sum, which moves the last bits.
- The kernels may contract a product and a sum into one FMA: the JAX
  package's contract for these kernels is a tolerance, not bits (as
  for the encoder kernels, whose ids must equal the plain encoder's but
  for near-ties).

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises. Nothing falls back. For the card's times see
PERF.md.
"""
from __future__ import annotations

import math

import torch

from .. import kernels
from .activations import new_gelu
from .attention import merge_heads, split_heads
from .norm import layer_norm

_ATTN = "decode_attn_f32"
_BLOCK = "block_decode_f32"


def _dense(x: torch.Tensor, p) -> torch.Tensor:
    return x @ p.weight.t() + p.bias


def _attend(q, k_rows, v_rows):
    """q (B, H, 1, D) against k_rows, v_rows (B, H, P, D): all P valid."""
    att = (q @ k_rows.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    return torch.softmax(att, dim=-1) @ v_rows


def fused_decode_attn_reference(x, blk, kc, vc, pos: int, *, n_head: int):
    """Plain version of #12. x (B, 1, C); kc, vc (B, H, T, D), row `pos`
    written in place. Returns (x_mid (B, 1, C), kc, vc)."""
    c = x.shape[-1]
    h = layer_norm(x, blk.ln_1.weight, blk.ln_1.bias)
    q, k, v = (split_heads(z, n_head)
               for z in _dense(h, blk.attn.c_attn).split(c, dim=-1))
    kc[:, :, pos] = k[:, :, 0]
    vc[:, :, pos] = v[:, :, 0]
    y = merge_heads(_attend(q, kc[:, :, :pos + 1], vc[:, :, :pos + 1]))
    return x + _dense(y, blk.attn.c_proj), kc, vc


def fused_block_decode_reference(x, blk, kc, vc, pos: int, *, n_head: int):
    """Plain version of #13. x (B, 1, C); kc, vc (B, T, C) time-major,
    row `pos` written in place. Returns (x_out (B, 1, C), kc, vc)."""
    b, _, c = x.shape
    h = layer_norm(x, blk.ln_1.weight, blk.ln_1.bias)
    q, k, v = _dense(h, blk.attn.c_attn).split(c, dim=-1)
    kc[:, pos] = k[:, 0]
    vc[:, pos] = v[:, 0]
    y = merge_heads(_attend(split_heads(q, n_head),
                            split_heads(kc[:, :pos + 1], n_head),
                            split_heads(vc[:, :pos + 1], n_head)))
    x_mid = x + _dense(y, blk.attn.c_proj)
    h = layer_norm(x_mid, blk.ln_2.weight, blk.ln_2.bias)
    return (x_mid + _dense(new_gelu(_dense(h, blk.mlp.c_fc)),
                           blk.mlp.c_proj), kc, vc)


def _checked(name, x, blk, kc, vc, cache_shape, pos, n_head, mlp: bool):
    """Raise unless the kernel takes these operands; the pointers of the
    block's weights in the C entry's order."""
    b, one, c = x.shape
    dev = x.device
    kernels.require_heads(name, c, n_head)
    if one != 1:
        raise ValueError(f"{name}: x must be (B, 1, C), got {tuple(x.shape)}")
    t = cache_shape[2] if len(cache_shape) == 4 else cache_shape[1]
    if not isinstance(pos, int) or not 0 <= pos < t:
        raise ValueError(f"{name}: pos must be an int in [0, {t}), got "
                         f"{pos!r}")
    kernels.require(x, "x", torch.float32, (b, 1, c), dev)
    kernels.require(kc, "kc", torch.float32, cache_shape, dev)
    kernels.require(vc, "vc", torch.float32, cache_shape, dev)
    c4 = blk.mlp.c_fc.weight.shape[0]
    operands = [("ln_1.weight", blk.ln_1.weight, (c,)),
                ("ln_1.bias", blk.ln_1.bias, (c,)),
                ("c_attn.weight", blk.attn.c_attn.weight, (3 * c, c)),
                ("c_attn.bias", blk.attn.c_attn.bias, (3 * c,)),
                ("attn.c_proj.weight", blk.attn.c_proj.weight, (c, c)),
                ("attn.c_proj.bias", blk.attn.c_proj.bias, (c,))]
    if mlp:
        operands += [("ln_2.weight", blk.ln_2.weight, (c,)),
                     ("ln_2.bias", blk.ln_2.bias, (c,)),
                     ("c_fc.weight", blk.mlp.c_fc.weight, (c4, c)),
                     ("c_fc.bias", blk.mlp.c_fc.bias, (c4,)),
                     ("mlp.c_proj.weight", blk.mlp.c_proj.weight, (c, c4)),
                     ("mlp.c_proj.bias", blk.mlp.c_proj.bias, (c,))]
    for label, p, shape in operands:
        kernels.require(p, label, torch.float32, shape, dev)
        if p.data_ptr() % 16:
            raise ValueError(f"{name}: {label} is not 16-byte aligned")
    return [p.data_ptr() for _, p, _ in operands], c4


def fused_decode_attn(x, blk, kc, vc, pos: int, *, n_head: int):
    """One block's attention half for a single decode token (#12).

    x: (B, 1, C) f32 residual stream entering the block. blk: a
    transformer Block. kc/vc: (B, H, T, D) f32 caches, row `pos`
    written in place. pos: int. Returns (x_mid (B, 1, C), kc, vc)."""
    if x.device.type == "cpu":
        return fused_decode_attn_reference(x, blk, kc, vc, pos,
                                           n_head=n_head)
    if x.device.type != "cuda":
        raise ValueError(f"{_ATTN}: no kernel for device {x.device}")
    b, _, c = x.shape
    t = kc.shape[2]
    ptrs, _ = _checked(_ATTN, x, blk, kc, vc, (b, n_head, t, c // n_head),
                       pos, n_head, mlp=False)
    scratch = torch.empty((2, b, c), dtype=torch.float32, device=x.device)
    x_mid = torch.empty_like(x)
    lib = kernels.library()
    kernels.launches[_ATTN] += 1
    err = lib.decode_attn_f32(
        x.data_ptr(), *ptrs, kc.data_ptr(), vc.data_ptr(),
        scratch.data_ptr(), x_mid.data_ptr(), b, t, c, n_head, pos,
        1.0 / math.sqrt(c // n_head), kernels.stream_ptr(x.device))
    kernels.check(err, _ATTN)
    return x_mid, kc, vc


def fused_block_decode(x, blk, kc, vc, pos: int, *, n_head: int):
    """One whole transformer block for a single decode token (#13).

    x: (B, 1, C) f32 residual stream entering the block. blk: a
    transformer Block. kc/vc: (B, T, C) f32 caches, time-major with the
    heads packed along C, any T; row `pos` written in place. pos: int.
    Returns (x_out (B, 1, C), kc, vc). Same function as the block body
    of TransformerDecoder._token_step."""
    if x.device.type == "cpu":
        return fused_block_decode_reference(x, blk, kc, vc, pos,
                                            n_head=n_head)
    if x.device.type != "cuda":
        raise ValueError(f"{_BLOCK}: no kernel for device {x.device}")
    b, _, c = x.shape
    t = kc.shape[1]
    ptrs, c4 = _checked(_BLOCK, x, blk, kc, vc, (b, t, c), pos, n_head,
                        mlp=True)
    scratch = torch.empty((b, 3 * c + c4), dtype=torch.float32,
                          device=x.device)
    out = torch.empty_like(x)
    lib = kernels.library()
    kernels.launches[_BLOCK] += 1
    err = lib.block_decode_f32(
        x.data_ptr(), *ptrs, kc.data_ptr(), vc.data_ptr(),
        scratch.data_ptr(), out.data_ptr(), b, t, c, c4, n_head, pos,
        1.0 / math.sqrt(c // n_head), kernels.stream_ptr(x.device))
    kernels.check(err, _BLOCK)
    return out, kc, vc
