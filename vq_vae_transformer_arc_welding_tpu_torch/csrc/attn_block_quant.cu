// attn_block_quant: the attention half of a calibrated-int8 transformer
// block, as a short sequence of launches (int8_block.cu).
//
// Replaces vq_vae_transformer_arc_welding_tpu/ops/pallas_block_quant.py::
// fused_attn_block_quant (pallas_call at :255), both values of
// int8_attn:
//   h8   = q8(LN1(x), s_attn)
//   qkv  = int32(h8 @ Wqkv^T) * deq_qkv + b_qkv              (f32)
//   y    = causal softmax attention per head, 1/sqrt(d) scale,
//          normalized after P@V; int8_attn: scores and P@V on
//          int8 operands with per (batch, head) scales        (f32)
//   y8   = q8(y, s_proj)
//   xmid = x + (int32(y8 @ Wproj^T) * deq_proj + b_proj)
//   h8   = q8(LN2(xmid), s_fc)
// Launches: LN+q8 rows, the qkv GEMM, attention (int8_attn: the
// per-head quantizing pass, then the s8 tensor-core attention), the
// c_proj GEMM with the residual, LN+q8 rows (ln_q8.cuh), the last with
// the in-path saturation monitor's count of each row's h8 at +-127 where
// rail_rows is given. The f32 qkv round trip through device memory
// (158 MB at batch 80) is the price of the split.
#include "int8_block.cuh"

// x (B*T, C) f32; w_qkv (3C, C) int8; w_proj (C, C) int8;
// scales (4,) f32 [s_attn, s_proj, s_fc, s_mproj]; vc (6, C) f32 rows
// [ln1_s, ln1_b, ln2_s, ln2_b, deq_proj, b_proj]; v3c (2, 3C) f32 rows
// [deq_qkv, b_qkv]. Scratch: h8a (B*T, C) int8, qkv (B*T, 3C) f32,
// y8 (B*T, C) int8; int8_attn only: head_scales (B, 3, n_head) f32 and
// qkv8 (B, n_head, 3, T_pad * HW) int8, the attention's int8 operands,
// HW the head width C / n_head padded to 32, 64 or 128, or past 128 to a
// multiple of 32 (attention_int8.cuh::head_width).
// Outputs: x_mid (B*T, C) f32, h8 (B*T, C) int8; rail_rows (B*T,) int32
// or null: each row's count of h8 at +-127.
// sm_scale: 1/sqrt(C / n_head), rounded to f32 by the caller.
// C from 1 to 4,096 in any heads, both values of int8_attn; every int8
// matrix, the weights included, in rows pitch16 of its width bytes apart.
extern "C" int attn_block_quant(const void* x, const void* w_qkv,
                                const void* w_proj, const void* scales,
                                const void* vc, const void* v3c, void* h8a,
                                void* qkv, void* y8, void* head_scales,
                                void* qkv8, void* x_mid, void* h8,
                                void* rail_rows, int batch, int t, int c,
                                int n_head, float sm_scale, int int8_attn,
                                void* stream) {
  if (!arcweld::heads_ok(c, n_head)) return cudaErrorInvalidValue;
  return arcweld::launch_attn_half(
      static_cast<const float*>(x), static_cast<const int8_t*>(w_qkv),
      static_cast<const int8_t*>(w_proj), static_cast<const float*>(scales),
      static_cast<const float*>(vc), static_cast<const float*>(v3c),
      static_cast<int8_t*>(h8a), static_cast<float*>(qkv),
      static_cast<int8_t*>(y8), static_cast<float*>(head_scales),
      static_cast<int8_t*>(qkv8), static_cast<float*>(x_mid),
      static_cast<int8_t*>(h8), static_cast<int*>(rail_rows), batch, t, c,
      n_head, sm_scale, int8_attn != 0, static_cast<cudaStream_t>(stream));
}

// #2's LayerNorm+q8 rows alone (ln_q8.cuh; card tests and chip_smoke.py):
// x (rows, C) f32; scale, bias (C,) f32; qscale () f32. Output: out
// (rows, C) int8 in rows pitch16(C) bytes apart; rail_rows (rows,) int32
// or null: each row's count of out at +-127. C from 1 to 4,096.
extern "C" int ln_q8(const void* x, const void* scale, const void* bias,
                     const void* qscale, void* out, void* rail_rows, int rows,
                     int c, void* stream) {
  if (c < 1 || c > arcweld::MAX_C) return cudaErrorInvalidValue;
  return arcweld::launch_ln_q8(
      static_cast<const float*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const float*>(qscale),
      static_cast<int8_t*>(out), static_cast<int*>(rail_rows), rows, c,
      static_cast<cudaStream_t>(stream));
}

// the widest head on the attentions' tiles (#2 and #6, both values of
// int8_attn); wider ones run on their wide forms
extern "C" int attention_max_head_dim() { return arcweld::MAX_HEAD_DIM; }
