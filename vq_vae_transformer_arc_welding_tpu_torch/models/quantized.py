"""Calibrated int8 transformer serving.

Port of vq_vae_transformer_arc_welding_tpu/models/quantized.py:
`QLinear`, `quantize_linear`, `qdot`, `qdot_prequantized`,
`quantize_transformer`, `calibrate_activation_absmax`, the plain int8
chain `quantized_backbone`, the drift probe `saturation_stats`, the
whole-block variants `quantized_backbone_block` (`block_fusion` 'attn',
'full', 'attn8', 'full8', each with or without '-bf16'), the fused
attention path `quantized_backbone_fused` (`fused_attention=True`),
`quantized_classify`, the in-path saturation counters
`_row_clip_frac*`, the int8 sampler (`quantized_lm_logits`,
`_q_attn_cached`, `_q_token_step`, `_q_prefill`,
`quantized_generate_kv`), and the opt-in int8 encoder
(`calibrate_encoder_absmax`, `quantize_encoder`,
`encode_indices_quantized`).

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

import math
from typing import NamedTuple

import torch

from ..ops import fused_attn_quant, fused_mlp_quant, int8_gemm
from ..ops.activations import gelu, new_gelu
from ..ops.attention import causal_attention_core, merge_heads, split_heads
from ..ops.conv import center_tap_dense
from ..ops.fused_block_quant import (fused_attn_block_quant,
                                     fused_block_quant, pack_block,
                                     packed_operands, packed_weights)
from ..ops.int8 import int8_matmul, quantize_act
from ..ops.norm import batch_norm_apply, layer_norm
from ..ops.vq import nearest_codes
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
    carry the fused kernels' packed operands (`pack_block`)."""
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


def quantized_backbone(model, qparams, x_ids, sat_stats: dict | None = None,
                       sat_rows: list | None = None):
    """The plain int8 chain: every op separate, attention unfused.
    sat_stats collects each site's clipped fraction (a 0-d tensor) by
    site name; sat_rows the per-row fractions (B,)."""

    def sat(site, a, q):
        if q.act_scale is not None:
            if sat_stats is not None:
                sat_stats[site] = ((a.abs() * q.act_scale) > 127.5).float(
                ).mean()
            if sat_rows is not None:
                sat_rows.append(_row_clip_frac(a, q.act_scale))
        return a

    x = _embed(model, qparams, x_ids)
    for i, blk in enumerate(qparams["blocks"]):
        h = layer_norm(x, blk["ln1_scale"], blk["ln1_bias"])
        qkv = qdot(sat(f"b{i}_attn_in", h, blk["c_attn"]), blk["c_attn"])
        q, k, v = qkv.split(model.d_model, dim=-1)
        q, k, v = (split_heads(z, model.n_head) for z in (q, k, v))
        y = merge_heads(causal_attention_core(q, k, v))
        x = x + qdot(sat(f"b{i}_proj_in", y, blk["c_proj"]), blk["c_proj"])
        h = layer_norm(x, blk["ln2_scale"], blk["ln2_bias"])
        mid = new_gelu(qdot(sat(f"b{i}_fc_in", h, blk["c_fc"]), blk["c_fc"]))
        x = x + qdot(sat(f"b{i}_mproj_in", mid, blk["m_proj"]),
                     blk["m_proj"])
    return layer_norm(x, qparams["ln_f_scale"], qparams["ln_f_bias"])


def saturation_stats(model, qparams, x_ids):
    """Per-site clipped-activation fractions of the calibrated int8 path
    on `x_ids`, plus the overall mean: the drift probe that covers the
    sites the fused kernels hide (the 'full' variants expose none).
    Runs the plain int8 chain, whose scales and quantization points are
    the fused kernels'. Returns (overall, per_site) as 0-d tensors."""
    stats: dict = {}
    x = quantized_backbone(model, qparams, x_ids, sat_stats=stats)
    ch = qparams["class_head"]
    if ch["l1"].act_scale is not None:
        stats["l1_in"] = ((x.abs() * ch["l1"].act_scale) > 127.5).float(
        ).mean()
    h = gelu(qdot(x, ch["l1"]).squeeze(-1))
    if ch["l2"].act_scale is not None:
        stats["l2_in"] = ((h.abs() * ch["l2"].act_scale) > 127.5).float(
        ).mean()
    if not stats:
        raise ValueError("saturation_stats needs calibrated act scales")
    overall = sum(stats.values()) / len(stats)
    return overall, stats


def _mlp_int8_gemm(blk, h8, resid, clip_rows=None):
    """The int8 MLP after the attention half, resid + m_proj(q8(new_gelu(
    c_fc(h8)))), as two calls of the int8 GEMM (ops/int8_gemm.py) on the
    operands #6 takes from the block's pack: c_fc with the GELU+q8
    epilogue at m_proj's act scale, then m_proj with the f32 epilogue
    and the residual. The same roundings as the eager chain
    `qdot(new_gelu(qdot_prequantized(h8, c_fc)), m_proj)`, so the same
    bits. clip_rows (rows of h8,) int32: each row's count of m_proj
    inputs that its act scale clips is added to it (the numerator of
    `_row_clip_frac` on new_gelu's output)."""
    scales, vc, _, v4c = packed_operands(blk)
    _, _, w_fc, w_mp = packed_weights(blk)
    lead = h8.shape[:-1]
    g8 = int8_gemm.int8_gemm(h8.reshape(-1, h8.shape[-1]), w_fc, v4c[0],
                             v4c[1], qscale=scales[3], clip_rows=clip_rows)
    out = int8_gemm.int8_gemm(g8, w_mp, vc[6], vc[7],
                              resid=resid.reshape(-1, resid.shape[-1]))
    return out.reshape(*lead, -1)


def quantized_backbone_block(model, qparams, x_ids, *, full_block=False,
                             int8_attn=False, stream_dtype=None,
                             sat_rows: list | None = None):
    """Backbone with whole-block fusion (ops/fused_block_quant.py).
    full_block: one kernel per block (#6); otherwise each block's
    attention half in one kernel (#2), returning (x_mid, h8), and the
    int8 MLP outside it as two int8 GEMM calls (`_mlp_int8_gemm`).
    int8_attn: scores and P@V on int8 operands.
    stream_dtype (torch.bfloat16 for the '-bf16' variants): the
    residual stream between kernels is rounded to it where the JAX
    kernels write it: the attention half's x_mid (h8 is computed from
    the f32 x_mid before that) and the block output; the kernels take
    and give f32, so the casts run outside them.

    h8 matches the plain chain at every int8 boundary; the f32 stream
    agrees to ~1e-3 (attention normalizes after P@V). sat_rows
    (attention-half variants only) collects, per block, the sites
    visible outside the fused call: the rail count of h8, which #2's
    last LayerNorm+q8 launch makes, and the clipped share of the f32
    m_proj input, which the c_fc GEMM's GELU+q8 epilogue counts without
    writing that input. The counts of a call go into one zeroed int32
    buffer (2 per block, one per row) and become per-sample fractions
    after the last block; the MLP stays the two GEMM calls."""
    if sat_rows is not None and full_block:
        raise ValueError(
            "in-path saturation monitoring needs the attn-half block "
            "fusion (the full-block kernel exposes no quantization "
            "sites); use block_fusion='attn' or the saturation_stats "
            "probe")

    def stream(a):
        return a if stream_dtype is None else a.to(stream_dtype)

    x = stream(_embed(model, qparams, x_ids))
    # per block: the rows' count of h8 at +-127, then of clipped m_proj
    # inputs (the block path needs every act scale, so both sites apply)
    counts = None if sat_rows is None else torch.zeros(
        (2 * len(qparams["blocks"]), *x_ids.shape), dtype=torch.int32,
        device=x.device)
    for i, blk in enumerate(qparams["blocks"]):
        if full_block:
            x = stream(fused_block_quant(x.float(), blk, n_head=model.n_head,
                                         int8_attn=int8_attn))
            continue
        x_mid, h8 = fused_attn_block_quant(
            x.float(), blk, n_head=model.n_head, int8_attn=int8_attn,
            rail_rows=None if counts is None else counts[2 * i])
        x = stream(_mlp_int8_gemm(
            blk, h8, stream(x_mid).float(),
            clip_rows=None if counts is None else counts[2 * i + 1].view(-1)))
    if counts is not None:
        t = x_ids.shape[1]
        per_sample = counts.sum(-1).float()
        for i, blk in enumerate(qparams["blocks"]):
            sat_rows.append(per_sample[2 * i] / (t * model.d_model))
            sat_rows.append(per_sample[2 * i + 1]
                            / (t * blk["c_fc"].w_int8.shape[0]))
    return layer_norm(x.float(), qparams["ln_f_scale"],
                      qparams["ln_f_bias"])


def quantized_backbone_fused(model, qparams, x_ids, *, fused_mlp=False,
                             fused_qkv=True, attn_block_rows=None):
    """Backbone with the fused attention + int8 output kernels
    (ops/fused_attn_quant.py): fused_qkv (default) pulls the int8 qkv
    projection in (#10), else qkv = qdot(h, c_attn) feeds the attention
    kernel (#11). fused_mlp runs the MLP as one kernel (#8), else as
    the qdot chain. Needs calibrated act scales; reads the block's
    packed operands."""
    x = _embed(model, qparams, x_ids)
    for blk in qparams["blocks"]:
        if blk["c_proj"].act_scale is None:
            raise ValueError("fused path needs calibrated act scales")
        h = layer_norm(x, blk["ln1_scale"], blk["ln1_bias"])
        if fused_qkv:
            scales, _, v3c, _ = packed_operands(blk)
            y8 = fused_attn_quant.qkv_attention_quant(
                h, packed_weights(blk)[0], scales[:2], v3c,
                n_head=model.n_head, block_rows=attn_block_rows)
        else:
            y8 = fused_attn_quant.fused_causal_attention_quant(
                qdot(h, blk["c_attn"]), blk["c_proj"].act_scale,
                n_head=model.n_head)
        x = x + qdot_prequantized(y8, blk["c_proj"])
        h = layer_norm(x, blk["ln2_scale"], blk["ln2_bias"])
        if fused_mlp:
            scales, vc, _, v4c = packed_operands(blk)
            _, _, w_fc, w_mp = packed_weights(blk)
            x = x + fused_mlp_quant.mlp_quant(h, w_fc, w_mp, scales[2:], v4c,
                                              vc[6:])
        else:
            x = x + qdot(new_gelu(qdot(h, blk["c_fc"])), blk["m_proj"])
    return layer_norm(x, qparams["ln_f_scale"], qparams["ln_f_bias"])


def quantized_classify(model, qparams, x_ids, *, fused_attention=False,
                       block_fusion: str | None = None,
                       sat_rows: list | None = None,
                       **fused_kw) -> torch.Tensor:
    """(B, T) ids -> (B, 2) class logits. block_fusion: None | 'attn' |
    'full' | 'attn8' | 'full8': whole-block fusion
    (quantized_backbone_block); the '8' variants also run the score and
    P@V products on int8 operands. A '-bf16' suffix (e.g. 'attn-bf16')
    carries the residual stream between kernels in bfloat16. It
    replaces fused_attention, which runs quantized_backbone_fused with
    the fused_* options (fused_mlp, fused_qkv, attn_block_rows).

    sat_rows: pass a list to collect per-row clipped-activation
    fractions (B,) from the sites visible in-path plus the class head:
    on the unfused and attention-half paths only."""
    if block_fusion is not None:
        if fused_attention or fused_kw:
            raise ValueError(
                "block_fusion replaces the fused_attention path; do not "
                "combine it with fused_attention/fused_* options")
        bf, stream_dtype = block_fusion, None
        if bf.endswith("-bf16"):
            bf, stream_dtype = bf[:-5], torch.bfloat16
        x = quantized_backbone_block(
            model, qparams, x_ids, full_block=bf.startswith("full"),
            int8_attn=bf.endswith("8"), stream_dtype=stream_dtype,
            sat_rows=sat_rows)
    elif fused_attention:
        if sat_rows is not None:
            raise ValueError(
                "in-path saturation monitoring is wired for the unfused "
                "and block_fusion='attn' paths; use saturation_stats")
        x = quantized_backbone_fused(model, qparams, x_ids, **fused_kw)
    else:
        if fused_kw:
            raise ValueError("fused_* options need fused_attention=True")
        x = quantized_backbone(model, qparams, x_ids, sat_rows=sat_rows)
    ch = qparams["class_head"]
    if sat_rows is not None and ch["l1"].act_scale is not None:
        sat_rows.append(_row_clip_frac(x, ch["l1"].act_scale))
    h = gelu(qdot(x, ch["l1"]).squeeze(-1))
    if sat_rows is not None and ch["l2"].act_scale is not None:
        sat_rows.append(_row_clip_frac(h, ch["l2"].act_scale))
    return qdot(h, ch["l2"])


def quantized_lm_logits(model, qparams, x_ids) -> torch.Tensor:
    """(B, T) ids -> (B, T, n_classes) next-token logits through the
    plain int8 chain and the int8 lm_head."""
    return qdot(quantized_backbone(model, qparams, x_ids),
                qparams["lm_head"])


# -- int8 KV-cached autoregressive sampling -----------------------------------
#
# For full-int8 deployments: the control flow of the f32 generate_kv
# with every Linear an int8 product and the weights stored in int8 (a
# quarter of the f32 weights' memory). The products are plain
# `qdot`s, as in the JAX package: a decode step has one row per stream
# (ops/int8.int8_matmul pads those up to torch._int_mm's minimum), and
# lm_head's 258 columns take the exact-f32 route. serve.sample_tokens
# keeps the f32 sampler, whose ids equal the reference's; for the
# card's ms per token of both see PERF.md.


def _q_attn_cached(model, blk, x_tok, k_cache, v_cache, pos: int):
    """One-token attention against (B, H, T, D) caches with int8
    projections (mirrors TransformerDecoder._attn_cached). The caches
    are updated in place."""
    qkv = qdot(x_tok, blk["c_attn"])                  # (B, 1, 3C)
    q, k, v = (split_heads(z, model.n_head)
               for z in qkv.split(model.d_model, dim=-1))
    k_cache[:, :, pos] = k[:, :, 0]
    v_cache[:, :, pos] = v[:, :, 0]
    att = (q @ k_cache.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    att = att.masked_fill(model.key_pos[:k_cache.shape[2]] > pos,
                          float("-inf"))
    y = torch.softmax(att, dim=-1) @ v_cache
    return qdot(merge_heads(y), blk["c_proj"]), k_cache, v_cache


def _q_token_step(model, qparams, tok, pos: int, caches):
    """One token (B,) at position `pos` through the int8 blocks against
    the caches. Returns (logits (B, n_classes), caches)."""
    x = qparams["tok_emb"][tok.long()][:, None] + model.pe[pos]
    for blk, (k_c, v_c) in zip(qparams["blocks"], caches):
        h = layer_norm(x, blk["ln1_scale"], blk["ln1_bias"])
        a, _, _ = _q_attn_cached(model, blk, h, k_c, v_c, pos)
        x = x + a
        h = layer_norm(x, blk["ln2_scale"], blk["ln2_bias"])
        x = x + qdot(new_gelu(qdot(h, blk["c_fc"])), blk["m_proj"])
    x = layer_norm(x, qparams["ln_f_scale"], qparams["ln_f_bias"])
    return qdot(x[:, 0], qparams["lm_head"]), caches


def _q_prefill(model, qparams, x_ids, caches):
    """Batched single-forward prompt prefill with int8 products, writing
    every block's K/V in place (mirrors TransformerDecoder._prefill)."""
    t0 = x_ids.shape[1]
    x = _embed(model, qparams, x_ids)
    for blk, (k_c, v_c) in zip(qparams["blocks"], caches):
        h = layer_norm(x, blk["ln1_scale"], blk["ln1_bias"])
        q, k, v = (split_heads(z, model.n_head) for z in
                   qdot(h, blk["c_attn"]).split(model.d_model, dim=-1))
        k_c[:, :, :t0] = k
        v_c[:, :, :t0] = v
        y = merge_heads(causal_attention_core(q, k, v))
        x = x + qdot(y, blk["c_proj"])
        h = layer_norm(x, blk["ln2_scale"], blk["ln2_bias"])
        x = x + qdot(new_gelu(qdot(h, blk["c_fc"])), blk["m_proj"])
    x = layer_norm(x, qparams["ln_f_scale"], qparams["ln_f_bias"])
    return qdot(x[:, -1], qparams["lm_head"]), caches


@torch.inference_mode()
def quantized_generate_kv(model, qparams, x_ids, *, do_sample: bool = False,
                          top_k: int | None = None,
                          generator: torch.Generator | None = None,
                          num_steps: int | None = None,
                          noise=None) -> torch.Tensor:
    """Int8 KV-cached sampling, the control flow of
    TransformerDecoder.generate_kv (batched prefill; KV steps while the
    context fits seq_len; full-recompute tail once the reference's
    context cropping kicks in) with every Linear an int8 product.

    Self-consistency contract (tests): greedy output equals a greedy
    loop over quantized_lm_logits full-recompute forwards."""
    steps, buf, noise = model._start(x_ids, num_steps, do_sample, generator,
                                     noise)
    b, t0 = buf.shape[0], buf.shape[1] - steps
    sample = dict(do_sample=do_sample, top_k=top_k)

    def window_logits(window):
        return quantized_lm_logits(model, qparams, window)

    n_kv = max(0, min(steps, model.seq_len - t0 + 1))
    if n_kv == 0:
        return model._recompute_scan(buf, t0, noise, logits_fn=window_logits,
                                     **sample)
    cache_len = model.seq_len
    shape = (b, model.n_head, cache_len, model.d_model // model.n_head)
    caches = [tuple(torch.zeros(shape, device=buf.device) for _ in range(2))
              for _ in qparams["blocks"]]
    logits, caches = _q_prefill(model, qparams, buf[:, :t0], caches)
    for i in range(n_kv):
        cur = t0 + i
        nxt = model._sample_from_logits(
            logits, noise[i] if do_sample else None, **sample)
        buf[:, cur] = nxt
        logits, caches = _q_token_step(model, qparams, nxt,
                                       min(cur, cache_len - 1), caches)
    if steps > n_kv:
        buf = model._recompute_scan(
            buf, t0 + n_kv, noise[n_kv:] if do_sample else None,
            logits_fn=window_logits, **sample)
    return buf


# -- opt-in int8 VQ-VAE encoder for serving -----------------------------------
#
# The encoder's center-tap products (two per resblock and sep_conv)
# become calibrated int8 `qdot`s; patch-embed, GELU, eval BatchNorm and
# the VQ distances and argmin stay f32. The JAX package has no Pallas
# kernel here, so these stay plain products too. The ids are no longer
# bit-comparable with the f32 encoder's: quantization noise can flip
# codes near Voronoi boundaries.


def _bn(h: torch.Tensor, bn) -> torch.Tensor:
    return batch_norm_apply(h, bn.weight, bn.bias, bn.running_mean,
                            bn.running_var)


@torch.no_grad()
def calibrate_encoder_absmax(model, sample_cycles: torch.Tensor,
                             margin: float = 1.25) -> dict:
    """Eval-mode encoder forward on calibration cycles, recording the
    absmax input of every center-tap product (x margin): sites
    `b{i}_c1`, `b{i}_c2` and `sep`."""
    am: dict[str, float] = {}

    def rec(site, x):
        am[site] = float(x.abs().max()) * margin
        return x

    h = model.patch_embed_out(sample_cycles)
    for i, blk in enumerate(model.resblocks):
        conv1, bn1, conv2, bn2 = (blk.block[j] for j in (1, 2, 4, 5))
        c = center_tap_dense(rec(f"b{i}_c1", gelu(h)), conv1.weight,
                             conv1.bias)
        if model.batch_norm:
            c = _bn(c, bn1)
        c = center_tap_dense(rec(f"b{i}_c2", gelu(c)), conv2.weight,
                             conv2.bias)
        if model.batch_norm:
            c = _bn(c, bn2)
        h = h + c
    rec("sep", h)
    return am


def quantize_encoder(model, enc_absmax: dict) -> dict:
    """Per-output-channel int8 QLinears for every center-tap product of
    the encoder (the conv kernel's center tap (O, I) is the port's
    QLinear layout)."""
    def tap(conv, site):
        w = conv.weight
        return quantize_linear(w[:, :, w.shape[-1] // 2], conv.bias,
                               act_absmax=enc_absmax[site])

    return {
        "blocks": [{"c1": tap(blk.block[1], f"b{i}_c1"),
                    "c2": tap(blk.block[4], f"b{i}_c2")}
                   for i, blk in enumerate(model.resblocks)],
        "sep": tap(model.encoder[1].shared_conv, "sep"),
    }


def encode_indices_quantized(model, qenc: dict,
                             x: torch.Tensor) -> torch.Tensor:
    """Eval-mode encode + nearest-code ids with int8 center-tap products;
    the VQ distances and argmin stay f32 on the int8 z_e. x: (B,
    seq_len, input_dim) -> (B, enc_out_len) int32."""
    h = model.patch_embed_out(x)
    for blk, q in zip(model.resblocks, qenc["blocks"]):
        c = qdot(gelu(h), q["c1"])
        if model.batch_norm:
            c = _bn(c, blk.block[2])
        c = qdot(gelu(c), q["c2"])
        if model.batch_norm:
            c = _bn(c, blk.block[5])
        h = h + c
    z_e = qdot(h, qenc["sep"])
    flat = z_e.reshape(-1, model.embedding_dim)
    return nearest_codes(flat, model.codebook).reshape(z_e.shape[:-1])
