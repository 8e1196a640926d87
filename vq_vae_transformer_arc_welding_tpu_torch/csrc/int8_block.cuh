// The launch functions of the calibrated-int8 transformer kernels.
//
// int8_block.cu holds the device kernels and these host functions; the
// C entries (attn_block_quant.cu, block_quant.cu, mlp_quant.cu,
// attn_quant.cu) compose them. Every function launches on stream `s`
// and returns cudaGetLastError() after its last launch. q8 is
// clip(round-half-even(v * s), -127, 127).
//
// Widths: C (d_model) from 1 to MAX_C, any n_head that divides it. Every
// int8 matrix of c values a row lies in rows pitch16(c) bytes apart
// (int8_gemm_sm90.cuh: the pitch a tensor map takes), f32 ones
// contiguous; the int8 attention too (heads past MAX_HEAD_DIM on its
// wide form).
#pragma once

#include "common.cuh"

namespace arcweld {

constexpr int MAX_HEAD_DIM = 128;  // widest head on the attentions' tiles
constexpr int MAX_C = 4096;  // widest C of every kernel here

// out[r, :] = q8(LN(x[r, :]) * scale + bias, *qscale); x (rows, c) f32,
// c up to MAX_C; rail_rows (rows,) int32 or null: rail_rows[r] = the
// count of out[r, :] at +-127 (ln_q8.cuh)
cudaError_t launch_ln_q8(const float* x, const float* scale,
                         const float* bias, const float* qscale, int8_t* out,
                         int* rail_rows, int rows, int c, cudaStream_t s);

// out[r, i] = q8(x[r, i], *qscale): x (rows, c) f32, out int8
cudaError_t launch_q8_rows(const float* x, const float* qscale, int8_t* out,
                           int rows, int c, cudaStream_t s);

// out[m, n] = float(sum_k a[m, k] w[n, k]) * cs[n] + cb[n] (+ resid[m, n])
// a (rows, k), w (n_cols, k) int8, 16-byte aligned; out f32 (both GEMMs:
// int8_gemm_sm90.cuh)
cudaError_t launch_gemm(const int8_t* a, const int8_t* w, const float* cs,
                        const float* cb, const float* resid, float* out,
                        int rows, int n_cols, int k, cudaStream_t s);

// out[m, n] = q8(new_gelu(float(sum_k a[m, k] w[n, k]) * cs[n] + cb[n]),
//                *qscale), int8; clip_rows (rows,) int32 or null:
// clip_rows[m] += the count of n with |new_gelu(..) * *qscale| > 127.5
cudaError_t launch_gemm_gelu_q8(const int8_t* a, const int8_t* w,
                                const float* cs, const float* cb,
                                const float* qscale, int* clip_rows,
                                int8_t* out, int rows, int n_cols, int k,
                                cudaStream_t s);

// C up to MAX_C, split into n_head heads: the shapes both attentions
// take (heads up to MAX_HEAD_DIM on their tiles, wider ones on their
// wide forms)
bool heads_ok(int c, int n_head);

// y8 (batch, t, C) = q8(causal attention of qkv (batch, t, 3C), *qscale),
// n_head heads of width C / n_head, the f32 attention (attention_tc.cuh).
cudaError_t launch_attention(const float* qkv, const float* qscale,
                             int8_t* y8, int batch, int t, int c, int n_head,
                             float sm_scale, cudaStream_t s);

// The same with int8_attn (attention_int8.cuh): scores and P@V on int8
// operands quantized with per (batch, head) scales, which are written to
// head_scales (batch, 3, n_head) f32, the operands to qkv8 (batch,
// n_head, 3, T_pad * HW) int8 (attn8::padded(t) rows, HW =
// attn8::head_width(C / n_head); layout there).
cudaError_t launch_attention_int8(const float* qkv, const float* qscale,
                                  int8_t* y8, float* head_scales,
                                  int8_t* qkv8, int batch, int t, int c,
                                  int n_head, float sm_scale, cudaStream_t s);

// The attention half of a block (kernel #2):
//   h8a = q8(LN1(x)), qkv = h8a @ Wqkv dequantized + bias,
//   y8 = attention(qkv), x_mid = x + (y8 @ Wproj dequantized + bias),
//   h8 = q8(LN2(x_mid)).
// scales (4,) [s_attn, s_proj, s_fc, s_mproj]; vc rows [ln1_s, ln1_b,
// ln2_s, ln2_b, deq_proj, b_proj]; v3c rows [deq_qkv, b_qkv]. head_scales
// and qkv8: launch_attention_int8's, read only when int8_attn. rail_rows
// (batch * t,) int32 or null: each row's count of h8 at +-127.
cudaError_t launch_attn_half(const float* x, const int8_t* w_qkv,
                             const int8_t* w_proj, const float* scales,
                             const float* vc, const float* v3c, int8_t* h8a,
                             float* qkv, int8_t* y8, float* head_scales,
                             int8_t* qkv8, float* x_mid, int8_t* h8,
                             int* rail_rows, int batch, int t, int c,
                             int n_head, float sm_scale, bool int8_attn,
                             cudaStream_t s);

// The int8 MLP from its quantized input (the MLP half of kernel #6, and
// kernel #8 after its q8 prologue):
//   g8 = q8(new_gelu(h8 @ Wfc * fc_deq + fc_bias), *g_scale)
//   out = g8 @ Wmp * mp_deq + mp_bias (+ resid)
// h8 (rows, c), w_fc (c4, c), w_mp (c, c4) int8; g8 (rows, c4) scratch.
cudaError_t launch_mlp(const int8_t* h8, const int8_t* w_fc,
                       const int8_t* w_mp, const float* fc_deq,
                       const float* fc_bias, const float* g_scale,
                       const float* mp_deq, const float* mp_bias,
                       const float* resid, int8_t* g8, float* out, int rows,
                       int c, int c4, cudaStream_t s);

}  // namespace arcweld
