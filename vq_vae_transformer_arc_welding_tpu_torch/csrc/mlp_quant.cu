// mlp_quant: the calibrated-int8 transformer MLP, as a short sequence
// of launches (int8_block.cu).
//
// Replaces vq_vae_transformer_arc_welding_tpu/ops/pallas_mlp_quant.py::
// fused_mlp_quant (pallas_call at :67):
//   h8  = q8(h, s_fc)
//   g8  = q8(new_gelu(int32(h8 @ Wfc^T) * (fc.scale / s_fc) + b_fc), s_mp)
//   out = int32(g8 @ Wmp^T) * (mp.scale / s_mp) + b_mp     (no residual)
// The GEMMs and their epilogues are block_quant's MLP half. h8 and the
// int8 (rows, 4C) intermediate g8 make a round trip through device
// memory, which the TPU kernel kept in VMEM.
#include "int8_block.cuh"

// h (rows, C) f32; w_fc (C4, C), w_mp (C, C4) int8; scales (2,) f32
// [s_fc, s_mp]; v4c (2, C4) rows [fc.scale / s_fc, b_fc]; vmp (2, C)
// rows [mp.scale / s_mp, b_mp]. Scratch: h8 (rows, C), g8 (rows, C4)
// int8. Output: out (rows, C) f32. Any C and C4; the int8 matrices, the
// weights included, in rows pitch16 of their width bytes apart.
extern "C" int mlp_quant(const void* h, const void* w_fc, const void* w_mp,
                         const void* scales, const void* v4c, const void* vmp,
                         void* h8, void* g8, void* out, int rows, int c,
                         int c4, void* stream) {
  if (c < 1 || c4 < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scales);
  const float* v4f = static_cast<const float*>(v4c);
  const float* vmf = static_cast<const float*>(vmp);
  cudaError_t e = arcweld::launch_q8_rows(static_cast<const float*>(h), sc,
                                          static_cast<int8_t*>(h8), rows, c,
                                          s);
  if (e != cudaSuccess) return e;
  return arcweld::launch_mlp(
      static_cast<const int8_t*>(h8), static_cast<const int8_t*>(w_fc),
      static_cast<const int8_t*>(w_mp), v4f, v4f + c4, sc + 1, vmf, vmf + c,
      nullptr, static_cast<int8_t*>(g8), static_cast<float*>(out), rows, c,
      c4, s);
}
