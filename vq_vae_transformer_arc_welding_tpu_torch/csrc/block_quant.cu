// block_quant: one whole calibrated-int8 transformer block, as a short
// sequence of launches (int8_block.cu).
//
// Replaces vq_vae_transformer_arc_welding_tpu/ops/pallas_block_quant.py::
// fused_block_quant (pallas_call at :307), both values of int8_attn:
// attn_block_quant's launches (x -> x_mid, h8), then the int8 MLP and
// its residual:
//   g8  = q8(new_gelu(int32(h8 @ Wfc^T) * deq_fc + b_fc), s_mproj)
//   out = x_mid + (int32(g8 @ Wmp^T) * deq_mp + b_mp)
// The TPU kernel kept the (T, 4C) MLP intermediate in VMEM. Here the
// c_fc GEMM's epilogue applies GELU and writes g8 as int8, so the
// intermediate makes one int8 round trip through device memory (52.6 MB
// at batch 80); keeping a row tile's g8 on chip is later work.
#include "int8_block.cuh"

// x (B*T, C) f32; w_qkv (3C, C), w_proj (C, C), w_fc (C4, C),
// w_mp (C, C4) int8; scales (4,) [s_attn, s_proj, s_fc, s_mproj];
// vc (8, C) rows [ln1_s, ln1_b, ln2_s, ln2_b, deq_proj, b_proj, deq_mp,
// b_mp]; v3c (2, 3C) [deq_qkv, b_qkv]; v4c (2, C4) [deq_fc, b_fc].
// Scratch: h8a, y8, h8 (B*T, C) int8, qkv (B*T, 3C) f32, head_scales
// (B, 3, n_head) f32 and qkv8 (B, n_head, 3, T_pad * HW) int8 (int8_attn
// only), x_mid (B*T, C) f32, g8 (B*T, C4) int8. Output: out (B*T, C) f32.
// C from 1 to 4,096 in any heads, C4 >= 1; every int8
// matrix in rows pitch16 of its width bytes apart.
extern "C" int block_quant(const void* x, const void* w_qkv,
                           const void* w_proj, const void* w_fc,
                           const void* w_mp, const void* scales,
                           const void* vc, const void* v3c, const void* v4c,
                           void* h8a, void* qkv, void* y8, void* head_scales,
                           void* qkv8, void* x_mid, void* h8, void* g8,
                           void* out, int batch, int t, int c, int c4,
                           int n_head, float sm_scale, int int8_attn,
                           void* stream) {
  if (!arcweld::heads_ok(c, n_head) || c4 < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scales);
  const float* vcf = static_cast<const float*>(vc);
  const float* v4f = static_cast<const float*>(v4c);
  cudaError_t e = arcweld::launch_attn_half(
      static_cast<const float*>(x), static_cast<const int8_t*>(w_qkv),
      static_cast<const int8_t*>(w_proj), sc, vcf,
      static_cast<const float*>(v3c), static_cast<int8_t*>(h8a),
      static_cast<float*>(qkv), static_cast<int8_t*>(y8),
      static_cast<float*>(head_scales), static_cast<int8_t*>(qkv8),
      static_cast<float*>(x_mid), static_cast<int8_t*>(h8), nullptr, batch,
      t, c, n_head, sm_scale, int8_attn != 0, s);
  if (e != cudaSuccess) return e;
  return arcweld::launch_mlp(
      static_cast<const int8_t*>(h8), static_cast<const int8_t*>(w_fc),
      static_cast<const int8_t*>(w_mp), v4f, v4f + c4, sc + 3, vcf + 6 * c,
      vcf + 7 * c, static_cast<const float*>(x_mid),
      static_cast<int8_t*>(g8), static_cast<float*>(out), batch * t, c, c4,
      s);
}
