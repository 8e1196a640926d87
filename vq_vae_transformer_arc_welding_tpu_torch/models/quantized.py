"""Calibrated int8 transformer serving.

Port of vq_vae_transformer_arc_welding_tpu/models/quantized.py:
`QLinear`, `quantize_linear`, `qdot`, `qdot_prequantized`,
`quantize_transformer`, `calibrate_activation_absmax`, the plain int8
chain `quantized_backbone`, the whole-block variant
`quantized_backbone_block` (`block_fusion='attn'`), `quantized_classify`
and the in-path saturation counters `_row_clip_frac*`.

Every Linear is quantized per output channel to symmetric int8;
activations are quantized per tensor with a calibrated scale
(127 / absmax), multiplied int8 x int8 -> int32, and dequantized by the
two scales. LayerNorm, softmax and residuals stay f32. The int8
boundaries are bit-comparable with the JAX package: `act_scale` is
computed in Python double and cast to f32 as there, and torch.round
rounds half to even like jnp.round.

Layout: `QLinear.w_int8` is (out, in), torch's Linear layout; the JAX
package stores (in, out).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.activations import gelu, new_gelu
from ..ops.attention import causal_attention_core, merge_heads, split_heads
from ..ops.fused_block_quant import fused_attn_block_quant, pack_block
from ..ops.int8 import int8_matmul, quantize_act
from ..ops.norm import layer_norm
from .transformer import linear


class QLinear(NamedTuple):
    w_int8: torch.Tensor             # (out, in) int8
    scale: torch.Tensor              # (out,) f32 per-output-channel scale
    bias: torch.Tensor | None
    act_scale: torch.Tensor | None = None  # () f32 calibrated 127/absmax


def quantize_linear(w: torch.Tensor, bias: torch.Tensor | None = None,
                    act_absmax: float | None = None) -> QLinear:
    """w: (out, in) f32. Per-output-channel symmetric int8."""
    absmax = w.abs().amax(dim=1)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    w_q = torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(
        torch.int8)
    act_scale = (None if act_absmax is None else torch.tensor(
        127.0 / max(float(act_absmax), 1e-6), dtype=torch.float32,
        device=w.device))
    return QLinear(w_q.contiguous(), scale.float(), bias, act_scale)


def qdot(x: torch.Tensor, q: QLinear) -> torch.Tensor:
    """f32 activations -> int8 -> int8 product -> f32. Without a
    calibrated act_scale the scale is the tensor's dynamic absmax."""
    if q.act_scale is not None:
        s_x = q.act_scale
    else:
        ax = x.abs().max()
        s_x = torch.where(ax > 0, 127.0 / ax, torch.ones_like(ax))
    o = int8_matmul(quantize_act(x, s_x), q.w_int8)
    y = o.float() * (q.scale / s_x)
    return y + q.bias if q.bias is not None else y


def qdot_prequantized(x_int8: torch.Tensor, q: QLinear) -> torch.Tensor:
    """qdot for activations already quantized with q.act_scale."""
    y = int8_matmul(x_int8, q.w_int8).float() * (q.scale / q.act_scale)
    return y + q.bias if q.bias is not None else y


def quantize_transformer(model, act_absmax: dict | None = None) -> dict:
    """Quantize every Linear of a TransformerDecoder. `act_absmax`
    (from calibrate_activation_absmax) bakes static activation scales
    in; without it scales are dynamic per call. Calibrated blocks also
    carry the fused attention kernel's packed operands (`pack_block`)."""
    am = act_absmax or {}
    ch = model.class_head

    def q(p, site):
        return quantize_linear(p.weight, getattr(p, "bias", None),
                               act_absmax=am.get(site))

    ln_f = model.transformer.ln_f
    qp = {
        "tok_emb": model.embedding.latent_embedding.weight,
        "ln_f_scale": ln_f.weight, "ln_f_bias": ln_f.bias,
        "lm_head": q(model.lm_head, "lm_in"),
        "class_head": {"l1": q(ch.linear_1, "l1_in"),
                       "l2": q(ch.linear_2, "l2_in")},
        "blocks": [],
    }
    for i, blk in enumerate(model.blocks):
        qp["blocks"].append(pack_block({
            "ln1_scale": blk.ln_1.weight, "ln1_bias": blk.ln_1.bias,
            "ln2_scale": blk.ln_2.weight, "ln2_bias": blk.ln_2.bias,
            "c_attn": q(blk.attn.c_attn, f"b{i}_attn_in"),
            "c_proj": q(blk.attn.c_proj, f"b{i}_proj_in"),
            "c_fc": q(blk.mlp.c_fc, f"b{i}_fc_in"),
            "m_proj": q(blk.mlp.c_proj, f"b{i}_mproj_in"),
        }))
    return qp


@torch.no_grad()
def calibrate_activation_absmax(model, sample_ids: torch.Tensor,
                                margin: float = 1.25) -> dict:
    """Run the f32 forward on calibration ids and record the absmax of
    every quantized matmul's input (x margin for headroom)."""
    am: dict[str, float] = {}

    def rec(site, x):
        am[site] = float(x.abs().max()) * margin
        return x

    x = model.embed(sample_ids)
    for i, blk in enumerate(model.blocks):
        h = rec(f"b{i}_attn_in",
                layer_norm(x, blk.ln_1.weight, blk.ln_1.bias))
        q, k, v = linear(h, blk.attn.c_attn).split(model.d_model, dim=-1)
        q, k, v = (split_heads(z, model.n_head) for z in (q, k, v))
        y = rec(f"b{i}_proj_in", merge_heads(causal_attention_core(q, k, v)))
        x = x + linear(y, blk.attn.c_proj)
        h = rec(f"b{i}_fc_in", layer_norm(x, blk.ln_2.weight, blk.ln_2.bias))
        h = rec(f"b{i}_mproj_in", new_gelu(linear(h, blk.mlp.c_fc)))
        x = x + linear(h, blk.mlp.c_proj)
    ln_f = model.transformer.ln_f
    x = layer_norm(x, ln_f.weight, ln_f.bias)
    rec("lm_in", x)
    rec("l1_in", x)
    rec("l2_in", gelu(linear(x, model.class_head.linear_1).squeeze(-1)))
    return am


def _row_clip_frac_prequant(h8: torch.Tensor) -> torch.Tensor:
    """(B, T, C) int8 -> per-row fraction at the clamp rail +-127 (B,)."""
    dims = tuple(range(1, h8.ndim))
    return (h8.to(torch.int32).abs() >= 127).float().mean(dim=dims)


def _row_clip_frac(a: torch.Tensor, act_scale) -> torch.Tensor:
    """Per-row fraction of f32 activations that act_scale clips (B,)."""
    dims = tuple(range(1, a.ndim))
    return ((a.abs() * act_scale) > 127.5).float().mean(dim=dims)


def _embed(model, qparams, x_ids):
    t = x_ids.shape[1]
    return qparams["tok_emb"][x_ids.long()] + model.pe[None, :t]


def quantized_backbone(model, qparams, x_ids, sat_rows: list | None = None):
    """The plain int8 chain: every op separate, attention unfused."""

    def sat(a, q):
        if sat_rows is not None and q.act_scale is not None:
            sat_rows.append(_row_clip_frac(a, q.act_scale))
        return a

    x = _embed(model, qparams, x_ids)
    for blk in qparams["blocks"]:
        h = layer_norm(x, blk["ln1_scale"], blk["ln1_bias"])
        qkv = qdot(sat(h, blk["c_attn"]), blk["c_attn"])
        q, k, v = qkv.split(model.d_model, dim=-1)
        q, k, v = (split_heads(z, model.n_head) for z in (q, k, v))
        y = merge_heads(causal_attention_core(q, k, v))
        x = x + qdot(sat(y, blk["c_proj"]), blk["c_proj"])
        h = layer_norm(x, blk["ln2_scale"], blk["ln2_bias"])
        mid = new_gelu(qdot(sat(h, blk["c_fc"]), blk["c_fc"]))
        x = x + qdot(sat(mid, blk["m_proj"]), blk["m_proj"])
    return layer_norm(x, qparams["ln_f_scale"], qparams["ln_f_bias"])


def quantized_backbone_block(model, qparams, x_ids,
                             sat_rows: list | None = None):
    """Backbone with each block's attention half in one fused call
    (ops/fused_block_quant.py): ln1 -> int8 qkv -> attention -> int8
    c_proj -> residual -> ln2 -> int8, returning (x_mid, h8). The int8
    MLP stays outside. h8 matches the plain chain at every int8
    boundary; the f32 stream agrees to ~1e-3 (attention normalizes
    after P@V). sat_rows collects the sites visible outside the fused
    call: the rail count of h8 and the f32 m_proj input."""
    x = _embed(model, qparams, x_ids)
    for blk in qparams["blocks"]:
        x_mid, h8 = fused_attn_block_quant(x, blk, n_head=model.n_head)
        g = new_gelu(qdot_prequantized(h8, blk["c_fc"]))
        if sat_rows is not None:
            sat_rows.append(_row_clip_frac_prequant(h8))
            if blk["m_proj"].act_scale is not None:
                sat_rows.append(_row_clip_frac(g, blk["m_proj"].act_scale))
        x = x_mid + qdot(g, blk["m_proj"])
    return layer_norm(x, qparams["ln_f_scale"], qparams["ln_f_bias"])


def quantized_classify(model, qparams, x_ids, *,
                       block_fusion: str | None = None,
                       sat_rows: list | None = None) -> torch.Tensor:
    """(B, T) ids -> (B, 2) class logits. block_fusion: None (plain
    chain) or 'attn' (fused attention half per block). The JAX
    package's 'full', 'attn8' and '-bf16' variants are not ported yet."""
    if block_fusion == "attn":
        x = quantized_backbone_block(model, qparams, x_ids, sat_rows=sat_rows)
    elif block_fusion is None:
        x = quantized_backbone(model, qparams, x_ids, sat_rows=sat_rows)
    else:
        raise NotImplementedError(f"block_fusion={block_fusion!r}")
    ch = qparams["class_head"]
    if sat_rows is not None and ch["l1"].act_scale is not None:
        sat_rows.append(_row_clip_frac(x, ch["l1"].act_scale))
    h = gelu(qdot(x, ch["l1"]).squeeze(-1))
    if sat_rows is not None and ch["l2"].act_scale is not None:
        sat_rows.append(_row_clip_frac(h, ch["l2"].act_scale))
    return qdot(h, ch["l2"])

