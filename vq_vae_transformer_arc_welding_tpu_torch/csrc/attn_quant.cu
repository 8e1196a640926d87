// attn_quant: causal attention with an int8 output, from an f32 qkv
// (#11) or from the f32 ln1 output through the int8 qkv GEMM (#10).
//
// Replaces vq_vae_transformer_arc_welding_tpu/ops/pallas_attn_quant.py:
//   fused_causal_attention_quant (pallas_call at :214):
//     y8 = q8(causal softmax attention(qkv), y_scale)
//   fused_qkv_attention_quant (pallas_call at :164):
//     qkv = int32(q8(h, x_scale) @ Wqkv^T) * deq + bias, then the same.
// The attention is int8_block.cu's attention_kernel, the one launch of
// attn_block_quant that computes it. #10's block_rows option has no
// counterpart: the TPU kernel tiled its (T, T) scores by causal row
// blocks to skip fully masked columns, and this kernel already walks the
// keys of each 64-query tile only up to the tile's causal limit. For
// #10 the f32 qkv makes a round trip through device memory, which the
// TPU kernel kept in VMEM.
#include "int8_block.cuh"

// qkv (B*T, 3C) f32, n_head heads, C up to 4,096; y_scale () f32.
// Output y8 (B*T, C) int8, rows pitch16(C) bytes apart. sm_scale:
// 1/sqrt(C / n_head), rounded to f32 by the caller.
extern "C" int causal_attention_quant(const void* qkv, const void* y_scale,
                                      void* y8, int batch, int t, int c,
                                      int n_head, float sm_scale,
                                      void* stream) {
  return arcweld::launch_attention(
      static_cast<const float*>(qkv), static_cast<const float*>(y_scale),
      static_cast<int8_t*>(y8), batch, t, c, n_head, sm_scale,
      static_cast<cudaStream_t>(stream));
}

// h (B*T, C) f32; w_qkv (3C, C) int8; scales (2,) f32 [x_scale, y_scale];
// v3c (2, 3C) f32 rows [deq, bias]. Scratch: h8 (B*T, C) int8, qkv
// (B*T, 3C) f32. Output y8 (B*T, C) int8. The int8 matrices, w_qkv
// included, in rows pitch16(C) bytes apart.
extern "C" int qkv_attention_quant(const void* h, const void* w_qkv,
                                   const void* scales, const void* v3c,
                                   void* h8, void* qkv, void* y8, int batch,
                                   int t, int c, int n_head, float sm_scale,
                                   void* stream) {
  if (!arcweld::heads_ok(c, n_head)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scales);
  const float* v3f = static_cast<const float*>(v3c);
  const int rows = batch * t;
  cudaError_t e = arcweld::launch_q8_rows(static_cast<const float*>(h), sc,
                                          static_cast<int8_t*>(h8), rows, c,
                                          s);
  if (e != cudaSuccess) return e;
  e = arcweld::launch_gemm(static_cast<const int8_t*>(h8),
                           static_cast<const int8_t*>(w_qkv), v3f, v3f + 3 * c,
                           nullptr, static_cast<float*>(qkv), rows, 3 * c, c,
                           s);
  if (e != cudaSuccess) return e;
  return arcweld::launch_attention(static_cast<const float*>(qkv), sc + 1,
                                   static_cast<int8_t*>(y8), batch, t, c,
                                   n_head, sm_scale, s);
}
