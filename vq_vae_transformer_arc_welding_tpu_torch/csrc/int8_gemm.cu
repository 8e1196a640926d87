// int8_gemm: the int8 GEMM of kernels #2, #6, #8 and #10 on its own
// (int8_gemm_sm90.cuh, behind int8_block.cu's launch_gemm and
// launch_gemm_gelu_q8). Serving calls it for the int8 MLP after kernel
// #2 on the attention-half paths (models/quantized.py::_mlp_int8_gemm:
// c_fc with the GELU+q8 epilogue and, where the in-path saturation
// monitor asks, its clip count; m_proj with the residual); the card
// tests and chip_smoke.py hold it against the plain stage and time it
// at each shape.
#include "int8_block.cuh"

// a (rows, k), w (n, k) int8 in rows pitch16(k) bytes apart; cs, cb
// (n,) f32; resid (rows, n) f32 or
// null; qscale () f32 or null. qscale null: out (rows, n) f32 =
// float(a @ w^T) * cs + cb (+ resid), and clip_rows must be null.
// Otherwise out (rows, n) int8, rows pitch16(n) bytes apart, =
// q8(new_gelu(float(a @ w^T) * cs + cb),
// *qscale), resid must be null, and where clip_rows (rows,) int32 is
// given each row's count of |new_gelu(..) * *qscale| > 127.5 is added to
// it.
extern "C" int int8_gemm(const void* a, const void* w, const void* cs,
                         const void* cb, const void* resid,
                         const void* qscale, void* clip_rows, void* out,
                         int rows, int n, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* a8 = static_cast<const int8_t*>(a);
  const int8_t* w8 = static_cast<const int8_t*>(w);
  const float* csf = static_cast<const float*>(cs);
  const float* cbf = static_cast<const float*>(cb);
  if (qscale == nullptr) {
    if (clip_rows != nullptr) return cudaErrorInvalidValue;
    return arcweld::launch_gemm(a8, w8, csf, cbf,
                                static_cast<const float*>(resid),
                                static_cast<float*>(out), rows, n, k, s);
  }
  if (resid != nullptr) return cudaErrorInvalidValue;
  return arcweld::launch_gemm_gelu_q8(
      a8, w8, csf, cbf, static_cast<const float*>(qscale),
      static_cast<int*>(clip_rows), static_cast<int8_t*>(out), rows, n, k, s);
}
