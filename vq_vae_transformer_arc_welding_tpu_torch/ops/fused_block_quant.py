"""Whole-block fusion for the calibrated-int8 transformer.

Port of vq_vae_transformer_arc_welding_tpu/ops/pallas_block_quant.py:
`_block_operands`, `fused_attn_block_quant` (the pallas_call at :255,
kernel #2) and `fused_block_quant` (the pallas_call at :307, kernel
#6), each with both values of `int8_attn`. The kernels are
`csrc/attn_block_quant.cu` (`attn_block_quant`) and
`csrc/block_quant.cu` (`block_quant`), sequences of launches built in
`csrc/int8_block.cu`; `fused_attn_block_quant_reference` and
`fused_block_quant_reference` are their plain PyTorch versions, with
the Pallas kernels' op order (ops/fused_attn_quant.py::
attention_core_reference: the softmax denominator is applied after the
P@V product).

`attn_batched` is not ported: it chose how Mosaic lowers the same math
(per-head loop or head-batched dots) and was bit-identical to the
loop, so it has no counterpart here.

#2's last launch, LayerNorm and q8 of x_mid (`csrc/ln_q8.cuh`), also
counts each row's h8 entries at +-127 where `rail_rows` is given: the
numerator of the in-path saturation monitor's site on h8 (JAX's
`_row_clip_frac_prequant`), which `fused_attn_block_quant_reference`
counts from its own h8.

With `int8_attn` the kernels run the attention in two launches
(`csrc/attention_int8.cuh`): a per-head quantizing pass, whose plain
version is `quantize_heads_reference` (the int8 operands in the
kernel's layout, `T_TILE`, `v_key_order`), and the attention on the s8
tensor cores, whose plain version is `attention_core_reference`.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises. Nothing falls back.

Operands are packed once per calibrated block (`pack_block`, called by
`quantize_transformer` and `bridge.qparams_from_jax`), not per call,
with the full-block rows: the attention half reads `vc[:6]`, the MLP
`vc[6:]` and `v4c`; and the four int8 weights as the kernels read int8
matrices, rows `kernels.pitch16` of their width bytes apart (the
weights themselves where C is a multiple of 16).

Widths: any C from 1 to `kernels.MAX_WIDTH` in any number of heads,
both values of `int8_attn` (a head past `kernels.MAX_HEAD_DIM` on the
attentions' wide forms). The kernels' int8 intermediates and the h8
that #2 returns lie in such rows too (`kernels.empty_pitched`).
"""
from __future__ import annotations

import torch

from .. import kernels
from .attention import split_heads
from .fused_attn_quant import _scale127, attention_core_reference, sm_scale
from .fused_mlp_quant import mlp_from_h8_reference
from .int8 import int8_matmul, quantize_act
from .norm import layer_norm

_ATTN = "attn_block_quant"
_FULL = "block_quant"
_LN = "ln_q8"
_QLINEARS = ("c_attn", "c_proj", "c_fc", "m_proj")
T_TILE = 64         # the int8 attention's query and key tiles, and T's
                    # padding in qkv8


def _block_operands(blk: dict, full: bool = False):
    """Pack one quantized block into the kernels' operands, as JAX
    does: scales (4,) [s_attn, s_proj, s_fc, s_mproj]; vc (6, C) rows
    [ln1 scale, ln1 bias, ln2 scale, ln2 bias, c_proj dequant, c_proj
    bias], (8, C) with [m_proj dequant, m_proj bias] when `full`; v3c
    (2, 3C) [c_attn dequant, c_attn bias]; v4c (2, 4C) [c_fc dequant,
    c_fc bias] when `full`, else None."""
    ca, cp, fc, mp = (blk[name] for name in _QLINEARS)
    for q, name in zip((ca, cp, fc, mp), _QLINEARS):
        if q.act_scale is None:
            raise ValueError(f"fused block path needs calibrated act "
                             f"scales ({name})")
    scales = torch.stack([q.act_scale.reshape(()).float()
                          for q in (ca, cp, fc, mp)])
    rows = [blk["ln1_scale"], blk["ln1_bias"], blk["ln2_scale"],
            blk["ln2_bias"], cp.scale / cp.act_scale, cp.bias]
    if full:
        rows += [mp.scale / mp.act_scale, mp.bias]
    vc = torch.stack(rows).float().contiguous()
    v3c = torch.stack([ca.scale / ca.act_scale, ca.bias]).contiguous()
    v4c = (torch.stack([fc.scale / fc.act_scale, fc.bias]).contiguous()
           if full else None)
    return scales.contiguous(), vc, v3c, v4c


def pack_block(blk: dict) -> dict:
    """`blk` with its kernel operands, `_block_operands(blk, full=True)`,
    under "block_operands", and its int8 weights (c_attn, c_proj, c_fc,
    m_proj) in the kernels' rows (`kernels.pitched`) under
    "block_weights", so that serving packs them once and not per call.
    A block without calibrated act scales (dynamic int8) is returned as
    it is; the fused paths refuse it."""
    if any(blk[name].act_scale is None for name in _QLINEARS):
        return blk
    weights = []
    for name in _QLINEARS:
        w = blk[name].w_int8
        weights.append(kernels.pitched(w, name, w.shape, w.device))
    return {**blk, "block_operands": _block_operands(blk, full=True),
            "block_weights": tuple(weights)}


def packed_operands(blk: dict):
    """The block's packed (scales, vc, v3c, v4c); raises for a block
    without calibrated act scales."""
    if "block_operands" not in blk:
        raise ValueError("fused block path needs calibrated act scales: a "
                         "block from quantize_transformer(model, "
                         "act_absmax) or bridge.qparams_from_jax")
    return blk["block_operands"]


def packed_weights(blk: dict):
    """The block's int8 weights (w_qkv, w_proj, w_fc, w_mp) in the
    kernels' rows, as `pack_block` laid them out."""
    packed_operands(blk)
    return blk["block_weights"]


def ln_q8_reference(x, scale, bias, qscale, rail_rows=None):
    """Plain version of #2's LayerNorm+q8 rows: q8(LN(x) * scale +
    bias, qscale), int8; rail_rows (x's leading shape) int32 overwritten
    with each row's count of outputs at +-127."""
    h8 = quantize_act(layer_norm(x, scale, bias), qscale)
    if rail_rows is not None:
        rail_rows.copy_((h8.to(torch.int32).abs() >= 127).sum(
            -1, dtype=torch.int32))
    return h8


def fused_attn_block_quant_reference(x, w_qkv, w_proj, scales, vc, v3c, *,
                                     n_head: int, int8_attn: bool = False,
                                     rail_rows=None):
    """Plain version of kernel #2. x: (B, T, C) f32; w_qkv (3C, C),
    w_proj (C, C) int8 in (out, in) layout; operands as
    `_block_operands` packs them. Returns (x_mid f32, h8 int8).
    rail_rows (B, T) int32: overwritten with each row's count of h8 at
    +-127."""
    h8a = ln_q8_reference(x, vc[0], vc[1], scales[0])
    qkv = int8_matmul(h8a, w_qkv).float() * v3c[0] + v3c[1]
    y = attention_core_reference(qkv, n_head, int8_attn=int8_attn)
    y8 = quantize_act(y, scales[1])
    x_mid = x + (int8_matmul(y8, w_proj).float() * vc[4] + vc[5])
    return x_mid, ln_q8_reference(x_mid, vc[2], vc[3], scales[2], rail_rows)


def fused_block_quant_reference(x, w_qkv, w_proj, w_fc, w_mp, scales, vc,
                                v3c, v4c, *, n_head: int,
                                int8_attn: bool = False):
    """Plain version of kernel #6: kernel #2's plain version, then the
    int8 MLP and its residual. vc (8, C). Returns the next residual
    stream (B, T, C) f32."""
    x_mid, h8 = fused_attn_block_quant_reference(
        x, w_qkv, w_proj, scales, vc, v3c, n_head=n_head, int8_attn=int8_attn)
    return x_mid + mlp_from_h8_reference(h8, w_fc, w_mp, scales[3], v4c,
                                         vc[6:])


def padded_t(t: int) -> int:
    """T rounded up to the int8 attention's tile, the rows of qkv8."""
    return -(-t // T_TILE) * T_TILE


def v_key_order() -> torch.Tensor:
    """The key at each of the 32 positions of a 32-key group of v8 in
    qkv8 (`key_of` in csrc/attention_int8.cuh): position 4 tg + i holds
    key 8 (i // 2) + 2 tg + i % 2, and the same 16 further on, so that
    a thread's scores in mma's accumulator layout (keys 2 tg, 2 tg + 1
    of each 8-key block) are its A fragment of P as they stand."""
    p = torch.arange(32)
    return 16 * (p // 16) + 8 * (p % 4 // 2) + 2 * (p % 16 // 4) + p % 2


def qkv8_head_width(c: int, n_head: int) -> int:
    """The width of a head's rows in qkv8 (attention_int8.cuh::
    head_width): the head width C / n_head padded with zeros to the int8
    attention's tile (32, 64 or 128), and past 128 to a multiple of 32,
    the s8 products' k step."""
    hd = c // n_head
    if hd <= kernels.MAX_HEAD_DIM:
        return kernels.padded_head_width(hd)
    return -(-hd // 32) * 32


def quantize_heads_reference(qkv: torch.Tensor, n_head: int):
    """Plain version of the int8 attention's quantizing pass
    (`head_quant_kernel`). qkv (B, T, 3C) f32, heads of width hd = C /
    n_head. Returns (qkv8, head_scales): qkv8 (B, n_head, 3, T_pad * HD)
    int8, HD = `qkv8_head_width(C, n_head)`, holds per (batch, head) q8
    [row][e], k8 [key][e] and v8 transposed, [e][key position] with the
    keys of every 32-key group in `v_key_order()`, each q8(x, 127 /
    max(absmax, 1e-6)) and zero past T and from column (v8: row) hd on;
    head_scales (B, 3, n_head) f32 those scales."""
    b, t, c3 = qkv.shape
    c = c3 // 3
    hd, width = c // n_head, qkv8_head_width(c, n_head)
    tp = padded_t(t)
    z = torch.stack([split_heads(part, n_head)
                     for part in qkv.split(c, dim=-1)], dim=2)
    scales = _scale127(z)                          # (B, n_head, 3, 1, 1)
    z8 = torch.zeros((b, n_head, 3, tp, width), dtype=torch.int8,
                     device=qkv.device)
    z8[..., :t, :hd] = quantize_act(z, scales)
    v8 = z8[:, :, 2].transpose(-1, -2).reshape(b, n_head, width,
                                                tp // 32, 32)
    z8[:, :, 2] = v8[..., v_key_order().to(qkv.device)].reshape(
        b, n_head, tp, width)
    return (z8.reshape(b, n_head, 3, tp * width),
            scales.reshape(b, n_head, 3).transpose(1, 2).contiguous())


def _attn_scratch(b, t, c, n_head, int8_attn, dev):
    """h8a, y8 (B, T, C) int8 in the kernels' rows, qkv (B, T, 3C) f32,
    and the int8 attention's per-head scales (B, 3, n_head) f32 and int8
    operands qkv8 (B, n_head, 3, T_pad * HD) (`quantize_heads_reference`)."""
    h8a = kernels.empty_pitched((b, t, c), dev)
    y8 = kernels.empty_pitched((b, t, c), dev)
    qkv = torch.empty((b, t, 3 * c), dtype=torch.float32, device=dev)
    head_scales = torch.empty((b, 3, n_head) if int8_attn else (1,),
                              dtype=torch.float32, device=dev)
    qkv8 = torch.empty((b, n_head, 3,
                        padded_t(t) * qkv8_head_width(c, n_head))
                       if int8_attn else (1,), dtype=torch.int8, device=dev)
    return h8a, y8, qkv, head_scales, qkv8


def _count(name: str, int8_attn: bool) -> None:
    kernels.launches[kernels.VARIANTS[name] if int8_attn else name] += 1


def ln_q8(x, scale, bias, qscale, rail_rows=None):
    """#2's LayerNorm+q8 rows alone (csrc/ln_q8.cuh), the first and last
    launch of #2: the kernel on CUDA (its int8 rows as
    `kernels.empty_pitched` lays them), the plain version on the CPU.
    x (..., C) f32 with C up to `kernels.MAX_WIDTH`; scale, bias (C,)
    f32; qscale () f32; rail_rows as the plain version's."""
    if x.device.type == "cpu":
        return ln_q8_reference(x, scale, bias, qscale, rail_rows)
    if x.device.type != "cuda":
        raise ValueError(f"{_LN}: no kernel for device {x.device}")
    c = x.shape[-1]
    rows = x.numel() // max(c, 1)
    dev = x.device
    kernels.require_heads(_LN, c, 1)
    kernels.require(x, "x", torch.float32, tuple(x.shape), dev)
    kernels.require(scale, "scale", torch.float32, (c,), dev)
    kernels.require(bias, "bias", torch.float32, (c,), dev)
    kernels.require(qscale, "qscale", torch.float32, (), dev)
    if rail_rows is not None:
        kernels.require(rail_rows, "rail_rows", torch.int32,
                        tuple(x.shape[:-1]), dev)
    out = kernels.empty_pitched(tuple(x.shape), dev)
    if rows == 0:
        return out
    lib = kernels.library()
    kernels.launches[_LN] += 1
    err = lib.ln_q8(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                    qscale.data_ptr(), out.data_ptr(),
                    None if rail_rows is None else rail_rows.data_ptr(),
                    rows, c, kernels.stream_ptr(dev))
    kernels.check(err, _LN)
    return out


def attn_block_quant(x, w_qkv, w_proj, scales, vc, v3c, *, n_head: int,
                     int8_attn: bool = False, scratch: dict | None = None,
                     rail_rows=None):
    """Operand-level entry of #2: the kernel on CUDA, the plain version
    on the CPU. scratch: a dict that receives the kernel's
    intermediates, "h8a", "qkv", "y8", "head_scales" and "qkv8", to
    check them stage by stage (CUDA only). rail_rows (B, T) int32:
    overwritten with each row's count of h8 at +-127. On CUDA, h8 comes
    back in the kernels' rows (`kernels.empty_pitched`)."""
    if x.device.type == "cpu":
        return fused_attn_block_quant_reference(
            x, w_qkv, w_proj, scales, vc, v3c, n_head=n_head,
            int8_attn=int8_attn, rail_rows=rail_rows)
    if x.device.type != "cuda":
        raise ValueError(f"{_ATTN}: no kernel for device {x.device}")
    b, t, c = x.shape
    dev = x.device
    kernels.require_heads(_ATTN, c, n_head)
    kernels.require(x, "x", torch.float32, (b, t, c), dev)
    w_qkv = kernels.pitched(w_qkv, "w_qkv", (3 * c, c), dev)
    w_proj = kernels.pitched(w_proj, "w_proj", (c, c), dev)
    kernels.require(scales, "scales", torch.float32, (4,), dev)
    kernels.require(vc, "vc", torch.float32, (6, c), dev)
    kernels.require(v3c, "v3c", torch.float32, (2, 3 * c), dev)
    if rail_rows is not None:
        kernels.require(rail_rows, "rail_rows", torch.int32, (b, t), dev)
    x_mid = torch.empty_like(x)
    h8 = kernels.empty_pitched((b, t, c), dev)
    if b * t == 0:
        return x_mid, h8
    h8a, y8, qkv, head_scales, qkv8 = _attn_scratch(b, t, c, n_head,
                                                    int8_attn, dev)
    if scratch is not None:
        scratch.update(h8a=h8a, qkv=qkv, y8=y8, head_scales=head_scales,
                       qkv8=qkv8)
    lib = kernels.library()
    _count(_ATTN, int8_attn)
    err = lib.attn_block_quant(
        x.data_ptr(), w_qkv.data_ptr(), w_proj.data_ptr(), scales.data_ptr(),
        vc.data_ptr(), v3c.data_ptr(), h8a.data_ptr(), qkv.data_ptr(),
        y8.data_ptr(), head_scales.data_ptr(), qkv8.data_ptr(),
        x_mid.data_ptr(), h8.data_ptr(),
        None if rail_rows is None else rail_rows.data_ptr(), b, t, c, n_head,
        sm_scale(c, n_head), int(int8_attn), kernels.stream_ptr(dev))
    kernels.check(err, _ATTN)
    return x_mid, h8


def block_quant(x, w_qkv, w_proj, w_fc, w_mp, scales, vc, v3c, v4c, *,
                n_head: int, int8_attn: bool = False,
                scratch: dict | None = None):
    """Operand-level entry of #6: the kernel on CUDA, the plain version
    on the CPU. scratch: as for attn_block_quant, plus "x_mid", "h8"
    and "g8" (CUDA only)."""
    if x.device.type == "cpu":
        return fused_block_quant_reference(
            x, w_qkv, w_proj, w_fc, w_mp, scales, vc, v3c, v4c,
            n_head=n_head, int8_attn=int8_attn)
    if x.device.type != "cuda":
        raise ValueError(f"{_FULL}: no kernel for device {x.device}")
    b, t, c = x.shape
    c4 = w_fc.shape[0]
    dev = x.device
    kernels.require_heads(_FULL, c, n_head)
    kernels.require(x, "x", torch.float32, (b, t, c), dev)
    w_qkv = kernels.pitched(w_qkv, "w_qkv", (3 * c, c), dev)
    w_proj = kernels.pitched(w_proj, "w_proj", (c, c), dev)
    w_fc = kernels.pitched(w_fc, "w_fc", (c4, c), dev)
    w_mp = kernels.pitched(w_mp, "w_mp", (c, c4), dev)
    kernels.require(scales, "scales", torch.float32, (4,), dev)
    kernels.require(vc, "vc", torch.float32, (8, c), dev)
    kernels.require(v3c, "v3c", torch.float32, (2, 3 * c), dev)
    kernels.require(v4c, "v4c", torch.float32, (2, c4), dev)
    out = torch.empty_like(x)
    if b * t == 0:
        return out
    h8a, y8, qkv, head_scales, qkv8 = _attn_scratch(b, t, c, n_head,
                                                    int8_attn, dev)
    x_mid = torch.empty_like(x)
    h8 = kernels.empty_pitched((b, t, c), dev)
    g8 = kernels.empty_pitched((b, t, c4), dev)
    if scratch is not None:
        scratch.update(h8a=h8a, qkv=qkv, y8=y8, head_scales=head_scales,
                       qkv8=qkv8, x_mid=x_mid, h8=h8, g8=g8)
    lib = kernels.library()
    _count(_FULL, int8_attn)
    err = lib.block_quant(
        x.data_ptr(), w_qkv.data_ptr(), w_proj.data_ptr(), w_fc.data_ptr(),
        w_mp.data_ptr(), scales.data_ptr(), vc.data_ptr(), v3c.data_ptr(),
        v4c.data_ptr(), h8a.data_ptr(), qkv.data_ptr(), y8.data_ptr(),
        head_scales.data_ptr(), qkv8.data_ptr(), x_mid.data_ptr(),
        h8.data_ptr(),
        g8.data_ptr(), out.data_ptr(), b, t, c, c4, n_head,
        sm_scale(c, n_head), int(int8_attn),
        kernels.stream_ptr(dev))
    kernels.check(err, _FULL)
    return out


def fused_attn_block_quant(x: torch.Tensor, blk: dict, *, n_head: int,
                           int8_attn: bool = False, rail_rows=None):
    """ln1 + int8 qkv + attention + int8 c_proj + residual + ln2 + int8
    quantize for one calibrated block (an entry of
    quantize_transformer(model, act_absmax)["blocks"], packed by
    `pack_block`). x: (B, T, C) f32. Returns (x_mid f32 (B, T, C), h8
    int8 (B, T, C)): the post-attention residual stream and the
    quantized ln2 output for c_fc. int8_attn: scores and P@V on int8
    operands with per (batch, head) scales. rail_rows (B, T) int32:
    overwritten with each row's count of h8 at +-127."""
    scales, vc, v3c, _ = packed_operands(blk)
    w_qkv, w_proj, _, _ = packed_weights(blk)
    return attn_block_quant(x, w_qkv, w_proj, scales, vc[:6], v3c,
                            n_head=n_head, int8_attn=int8_attn,
                            rail_rows=rail_rows)


def fused_block_quant(x: torch.Tensor, blk: dict, *, n_head: int,
                      int8_attn: bool = False) -> torch.Tensor:
    """One whole calibrated-int8 transformer block: fused_attn_block_quant
    plus the int8 MLP and its residual. Returns the next residual
    stream (B, T, C) f32."""
    scales, vc, v3c, v4c = packed_operands(blk)
    return block_quant(x, *packed_weights(blk), scales, vc, v3c, v4c,
                       n_head=n_head, int8_attn=int8_attn)
