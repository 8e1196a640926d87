// int8_block: the device kernels of the calibrated-int8 transformer and
// the host functions that launch them (declared in int8_block.cuh).
//
// The TPU kernels (pallas_block_quant.py, pallas_mlp_quant.py,
// pallas_attn_quant.py) keep one sequence's (T, 3C) f32 qkv or (T, 4C)
// MLP tile in VMEM; at T = 321, C = 512 those are 2 MB and 2.6 MB, far
// above the 227 KB of shared memory a Hopper block has. So each TPU
// kernel becomes a short sequence of launches that split where the data
// stops fitting, built from these pieces:
//   ln_q8_kernel          LayerNorm + quantize, one warp a row, 16-byte
//                         loads and 4-byte stores (ln_q8.cuh), with
//                         the count of each row's outputs at +-127;
//   q8_kernel             quantize, four values a thread;
//   int8_gemm_sm90_kernel int8 GEMM (int8_gemm_sm90.cuh): wgmma s8 fed
//                         by TMA, a persistent tile walk, exact s32 sums,
//                         with one of two epilogues: dequant + bias
//                         (+ residual) to f32, or dequant + bias -> tanh
//                         GELU -> q8 to int8, stored by TMA;
//   attention_kernel      attention_tc.cuh's causal tile on the packed
//                         qkv: 128 query rows a block (16 a warp) laid
//                         from the end of T, keys and values
//                         double-buffered through shared memory by
//                         cp.async, Q K^T as FP32 FMA chains over the
//                         head dims in order (the plain GEMM's rounding),
//                         P@V in split TF32 on the tensor cores
//                         (mma.sync m16n8k8, hi*hi + hi*lo + lo*hi), the
//                         softmax in FP32 with the row max kept online
//                         and the division by the row sum after P@V; the
//                         output is quantized straight to int8;
//   head_quant_kernel,    the int8 attention (attention_int8.cuh): a
//   attention_int8_kernel per-head pass writes 127 / absmax of q, k
//                         and v and the int8 operands once, in the
//                         tensor cores' layout; then 64-query tiles take
//                         both products as s8 mma.sync into s32 (exact
//                         integer sums), P quantized with the
//                         final row max (two passes over the keys).
// What bounds them on an H100: the f32 attention's scores run on the
// FP32 cores and its P@V on the tensor cores three times over (split
// TF32); the int8 attention's products are a small share of its work
// beside the softmax; the f32 qkv and the int8 (rows, 4C) MLP
// intermediate make a round trip through device memory (158 MB and
// 52.6 MB at batch 80), the traffic the TPU kernels avoided. The TPU's
// 8-row padding of T has no counterpart: every kernel masks the ragged
// edge (the int8 attention pads its int8 operands with zeros to 64 rows).
// Both attentions take any head width: up to MAX_HEAD_DIM on their
// tiles (64 on its own instantiation, another on the smallest of 32, 64
// and 128 that holds it, padded with zero columns), wider heads on their
// wide forms (attention_tc.cuh's causal_attention_tile_wide, in
// clusters of 2, 4 or 8 blocks that form a stage's scores once;
// attention_int8.cuh's attention_int8_wide_kernel), a block for each
// 128 output columns.
// Off the multiples of 64 (and above 1,024) the pieces run on their
// general forms: the GEMM's GENERAL instantiation, ln_q8_any_kernel and
// q8_rows_kernel, the int8 rows pitch16(C) bytes apart.
#include "int8_block.cuh"

#include "attention_int8.cuh"
#include "attention_tc.cuh"
#include "int8_gemm_sm90.cuh"
#include "ln_q8.cuh"

#include <algorithm>

namespace {

namespace attn_tc = arcweld::attn_tc;
namespace attn8 = arcweld::attn8;

static_assert(arcweld::MAX_HEAD_DIM == attn_tc::MAX_HD &&
                  arcweld::MAX_HEAD_DIM == attn8::MAX_NARROW,
              "one widest narrow head for the attentions");

__global__ void __launch_bounds__(256)
q8_kernel(const float4* __restrict__ x, const float* __restrict__ qscale,
          char4* __restrict__ out, size_t n4) {
  const float qs = *qscale;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const float4 v = x[i];
    out[i] = make_char4(arcweld::q8(v.x, qs), arcweld::q8(v.y, qs),
                        arcweld::q8(v.z, qs), arcweld::q8(v.w, qs));
  }
}

// out[r * pitch16(c) + i] = q8(x[r * c + i], *qscale): the rows of a
// width off the multiples of 16, a value a thread
__global__ void __launch_bounds__(256)
q8_rows_kernel(const float* __restrict__ x, const float* __restrict__ qscale,
               int8_t* __restrict__ out, int rows, int c) {
  const float qs = *qscale;
  const int pitch = arcweld::pitch16(c);
  const size_t n = (size_t)rows * c;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    out[i / c * pitch + i % c] = arcweld::q8(x[i], qs);
}

// The f32 attention (#2, #6, #10, #11): attention_tc.cuh's tile on
// the packed qkv, its output quantized straight to int8:
//   y8[b, i, h*hd + e] = q8((sum_j p_ij v_je) / sum_j p_ij, *qscale)
// rows pitch bytes apart (pitch16(C)). operator() is the unpadded
// tile's (hd == HD), one() the padded and the wide ones'.
template <int HD>
struct StoreQ8 {
  int8_t* y8;
  int t, pitch;
  float qs;
  int hd;
  __device__ __forceinline__ void operator()(int b, int h, int row, int col,
                                             float y0, float y1,
                                             float l) const {
    *reinterpret_cast<char2*>(y8 + ((size_t)b * t + row) * pitch + h * HD +
                              col) =
        make_char2(arcweld::q8(__fdiv_rn(y0, l), qs),
                   arcweld::q8(__fdiv_rn(y1, l), qs));
  }
  __device__ __forceinline__ void one(int b, int h, int row, int col, float y,
                                      float l) const {
    y8[((size_t)b * t + row) * pitch + h * hd + col] =
        arcweld::q8(__fdiv_rn(y, l), qs);
  }
};

// hd: the real head width (HD without PAD)
template <int HD, bool PAD>
__global__ void __launch_bounds__(attn_tc::THREADS,
                                  attn_tc::Shape<HD>::MIN_BLOCKS)
attention_kernel(const float* __restrict__ qkv, const float* __restrict__ qscale,
                 int8_t* __restrict__ y8, int t, int n_head, float sm_scale,
                 bool vec16, int hd) {
  const int hw = PAD ? hd : HD;
  const int c = n_head * hw;
  const attn_tc::Operands in{qkv, qkv + c, qkv + 2 * c, (long long)t * 3 * c,
                             hw, 3LL * c, t, sm_scale, vec16, hw};
  attn_tc::causal_attention_tile<HD, PAD>(
      in, StoreQ8<HD>{y8, t, arcweld::pitch16(c), *qscale, hw});
}

// heads wider than attn_tc::MAX_HD: the wide tile, in clusters of N
template <int N, bool QRES>
__global__ void __launch_bounds__(attn_tc::THREADS, 1)
attention_wide_kernel(const float* __restrict__ qkv,
                      const float* __restrict__ qscale,
                      int8_t* __restrict__ y8, int t, int n_head,
                      float sm_scale, bool vec16, int hd) {
  const int c = n_head * hd;
  const attn_tc::Operands in{qkv, qkv + c, qkv + 2 * c, (long long)t * 3 * c,
                             hd, 3LL * c, t, sm_scale, vec16, hd};
  attn_tc::causal_attention_tile_wide<N, QRES>(
      in, StoreQ8<attn_tc::PIECE>{y8, t, arcweld::pitch16(c), *qscale, hd});
}

template <int N, bool QRES>
cudaError_t launch_attention_wide_at(const float* qkv, const float* qscale,
                                     int8_t* y8, int batch, int t, int c,
                                     int n_head, float sm_scale,
                                     cudaStream_t s) {
  const int hd = c / n_head;
  return arcweld::launch_cluster(
      attention_wide_kernel<N, QRES>, attn_tc::wide_grid(batch, n_head, t, hd),
      attn_tc::THREADS, attn_tc::Wide<N, QRES>::SMEM, N, s, qkv, qscale, y8,
      t, n_head, sm_scale,
      attn_tc::rows_aligned16(qkv, qkv + c, qkv + 2 * c, (long long)t * 3 * c,
                              hd, 3LL * c, hd),
      hd);
}

cudaError_t launch_attention_wide(const float* qkv, const float* qscale,
                                  int8_t* y8, int batch, int t, int c,
                                  int n_head, float sm_scale,
                                  cudaStream_t s) {
  const int hd = c / n_head;
  switch (attn_tc::wide_cluster(hd)) {
    case 2:
      return launch_attention_wide_at<2, true>(qkv, qscale, y8, batch, t, c,
                                               n_head, sm_scale, s);
    case 4:
      return launch_attention_wide_at<4, true>(qkv, qscale, y8, batch, t, c,
                                               n_head, sm_scale, s);
    default:
      return attn_tc::wide_resident(hd)
                 ? launch_attention_wide_at<8, true>(qkv, qscale, y8, batch,
                                                     t, c, n_head, sm_scale, s)
                 : launch_attention_wide_at<8, false>(
                       qkv, qscale, y8, batch, t, c, n_head, sm_scale, s);
  }
}

// the cluster size of the f32 attention's last launch (0: a narrow
// tile's, or none), read back by attention_cluster
int last_attention_cluster = 0;

template <int HD, bool PAD>
cudaError_t launch_attention_at(const float* qkv, const float* qscale,
                                int8_t* y8, int batch, int t, int c,
                                int n_head, float sm_scale, cudaStream_t s) {
  constexpr size_t SMEM = attn_tc::Shape<HD>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      attention_kernel<HD, PAD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM);
  if (e != cudaSuccess) return e;
  const int hd = c / n_head;
  attention_kernel<HD, PAD>
      <<<attn_tc::grid(batch, n_head, t), attn_tc::THREADS, SMEM, s>>>(
          qkv, qscale, y8, t, n_head, sm_scale,
          attn_tc::rows_aligned16(qkv, qkv + c, qkv + 2 * c,
                                  (long long)t * 3 * c, hd, 3LL * c, hd),
          hd);
  return cudaGetLastError();
}

template <int HD, bool PAD>
cudaError_t launch_attention_int8_at(const float* qkv, const float* qscale,
                                     int8_t* y8, float* head_scales,
                                     int8_t* qkv8, int batch, int t, int c,
                                     int n_head, float sm_scale,
                                     cudaStream_t s) {
  const int hd = c / n_head;
  cudaError_t e = cudaFuncSetAttribute(
      attn8::head_quant_kernel<HD, PAD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)attn8::quant_smem(INT_MAX, hd));
  if (e != cudaSuccess) return e;
  attn8::head_quant_kernel<HD, PAD>
      <<<dim3(n_head, 3, batch), attn8::QUANT_THREADS,
         attn8::quant_smem(t, hd), s>>>(qkv, head_scales, qkv8, t, n_head,
                                        hd);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  attn8::attention_int8_kernel<HD, PAD>
      <<<dim3(n_head, batch, (t + attn8::TT - 1) / attn8::TT),
         attn8::THREADS, 0, s>>>(qkv8, head_scales, qscale, y8, t, n_head,
                                 sm_scale, hd);
  return cudaGetLastError();
}

// heads wider than attn8::MAX_NARROW: the int8 attention's wide form
cudaError_t launch_attention_int8_wide(const float* qkv, const float* qscale,
                                       int8_t* y8, float* head_scales,
                                       int8_t* qkv8, int batch, int t, int c,
                                       int n_head, float sm_scale,
                                       cudaStream_t s) {
  const int hd = c / n_head;
  cudaError_t e = cudaFuncSetAttribute(
      attn8::head_quant_wide_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)attn8::quant_smem(INT_MAX, hd));
  if (e != cudaSuccess) return e;
  attn8::head_quant_wide_kernel<<<dim3(n_head, 3, batch),
                                  attn8::QUANT_THREADS,
                                  attn8::quant_smem(t, hd), s>>>(
      qkv, head_scales, qkv8, t, n_head, hd);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  attn8::attention_int8_wide_kernel<<<
      dim3(n_head * attn8::pieces(hd), batch, (t + attn8::TT - 1) / attn8::TT),
      attn8::THREADS, 0, s>>>(qkv8, head_scales, qscale, y8, t, n_head,
                              sm_scale, hd);
  return cudaGetLastError();
}

}  // namespace

namespace arcweld {

cudaError_t launch_ln_q8(const float* x, const float* scale,
                         const float* bias, const float* qscale, int8_t* out,
                         int* rail_rows, int rows, int c, cudaStream_t s) {
  static_assert(lnq8::MAX_ANY_C == MAX_C, "LayerNorm rows: the widest");
  return lnq8::launch(x, scale, bias, qscale, out, rail_rows, rows, c, s);
}

cudaError_t launch_q8_rows(const float* x, const float* qscale, int8_t* out,
                           int rows, int c, cudaStream_t s) {
  if (rows < 1 || c < 1) return cudaErrorInvalidValue;
  const size_t n = (size_t)rows * c;
  if (c % 16 != 0) {   // rows pitch16(c) bytes apart
    const unsigned grid =
        (unsigned)std::min<size_t>((n + 255) / 256, (size_t)132 * 16);
    q8_rows_kernel<<<grid, 256, 0, s>>>(x, qscale, out, rows, c);
    return cudaGetLastError();
  }
  const size_t n4 = n / 4;
  const unsigned grid =
      (unsigned)std::min<size_t>((n4 + 255) / 256, (size_t)132 * 16);
  q8_kernel<<<grid, 256, 0, s>>>(reinterpret_cast<const float4*>(x), qscale,
                                 reinterpret_cast<char4*>(out), n4);
  return cudaGetLastError();
}

cudaError_t launch_gemm(const int8_t* a, const int8_t* w, const float* cs,
                        const float* cb, const float* resid, float* out,
                        int rows, int n_cols, int k, cudaStream_t s) {
  return gemm90::launch<false>(a, w, cs, cb, resid, nullptr, nullptr, out,
                               rows, n_cols, k, s);
}

cudaError_t launch_gemm_gelu_q8(const int8_t* a, const int8_t* w,
                                const float* cs, const float* cb,
                                const float* qscale, int* clip_rows,
                                int8_t* out, int rows, int n_cols, int k,
                                cudaStream_t s) {
  return gemm90::launch<true>(a, w, cs, cb, nullptr, qscale, clip_rows, out,
                              rows, n_cols, k, s);
}

bool heads_ok(int c, int n_head) {
  static_assert(MAX_C <= attn_tc::MAX_WIDE_HD, "one head of every width");
  return n_head >= 1 && c >= n_head && c % n_head == 0 && c <= MAX_C;
}

cudaError_t launch_attention(const float* qkv, const float* qscale,
                             int8_t* y8, int batch, int t, int c, int n_head,
                             float sm_scale, cudaStream_t s) {
  if (batch < 1 || batch > 65535 || t < 1 || !heads_ok(c, n_head))
    return cudaErrorInvalidValue;
  const int hd = c / n_head;
  last_attention_cluster = 0;
  if (hd > attn_tc::MAX_HD) {
    const cudaError_t e = launch_attention_wide(qkv, qscale, y8, batch, t, c,
                                                n_head, sm_scale, s);
    if (e == cudaSuccess) last_attention_cluster = attn_tc::wide_cluster(hd);
    return e;
  }
  switch (attn_tc::padded_head(hd)) {
    case 32:
      return launch_attention_at<32, true>(qkv, qscale, y8, batch, t, c,
                                           n_head, sm_scale, s);
    case 64:
      return hd == 64 ? launch_attention_at<64, false>(
                            qkv, qscale, y8, batch, t, c, n_head, sm_scale, s)
                      : launch_attention_at<64, true>(
                            qkv, qscale, y8, batch, t, c, n_head, sm_scale, s);
    default:
      return launch_attention_at<128, true>(qkv, qscale, y8, batch, t, c,
                                            n_head, sm_scale, s);
  }
}

cudaError_t launch_attention_int8(const float* qkv, const float* qscale,
                                  int8_t* y8, float* head_scales,
                                  int8_t* qkv8, int batch, int t, int c,
                                  int n_head, float sm_scale, cudaStream_t s) {
  if (batch < 1 || batch > 65535 || t < 1 || t > 65535 * attn8::TT ||
      !heads_ok(c, n_head) || head_scales == nullptr || qkv8 == nullptr)
    return cudaErrorInvalidValue;
  const int hd = c / n_head;
  if (hd > attn8::MAX_NARROW)
    return launch_attention_int8_wide(qkv, qscale, y8, head_scales, qkv8,
                                      batch, t, c, n_head, sm_scale, s);
  switch (attn_tc::padded_head(hd)) {
    case 32:
      return launch_attention_int8_at<32, true>(
          qkv, qscale, y8, head_scales, qkv8, batch, t, c, n_head, sm_scale,
          s);
    case 64:
      return hd == 64 ? launch_attention_int8_at<64, false>(
                            qkv, qscale, y8, head_scales, qkv8, batch, t, c,
                            n_head, sm_scale, s)
                      : launch_attention_int8_at<64, true>(
                            qkv, qscale, y8, head_scales, qkv8, batch, t, c,
                            n_head, sm_scale, s);
    default:
      return launch_attention_int8_at<128, true>(
          qkv, qscale, y8, head_scales, qkv8, batch, t, c, n_head, sm_scale,
          s);
  }
}

cudaError_t launch_attn_half(const float* x, const int8_t* w_qkv,
                             const int8_t* w_proj, const float* scales,
                             const float* vc, const float* v3c, int8_t* h8a,
                             float* qkv, int8_t* y8, float* head_scales,
                             int8_t* qkv8, float* x_mid, int8_t* h8,
                             int* rail_rows, int batch, int t, int c,
                             int n_head, float sm_scale, bool int8_attn,
                             cudaStream_t s) {
  const int rows = batch * t;
  if (!heads_ok(c, n_head)) return cudaErrorInvalidValue;
  cudaError_t e;
  if ((e = launch_ln_q8(x, vc, vc + c, scales + 0, h8a, nullptr, rows, c,
                        s)) != cudaSuccess)
    return e;
  if ((e = launch_gemm(h8a, w_qkv, v3c, v3c + 3 * c, nullptr, qkv, rows,
                       3 * c, c, s)) != cudaSuccess)
    return e;
  e = int8_attn ? launch_attention_int8(qkv, scales + 1, y8, head_scales,
                                        qkv8, batch, t, c, n_head, sm_scale,
                                        s)
                : launch_attention(qkv, scales + 1, y8, batch, t, c, n_head,
                                   sm_scale, s);
  if (e != cudaSuccess) return e;
  if ((e = launch_gemm(y8, w_proj, vc + 4 * c, vc + 5 * c, x, x_mid, rows, c,
                       c, s)) != cudaSuccess)
    return e;
  return launch_ln_q8(x_mid, vc + 2 * c, vc + 3 * c, scales + 2, h8,
                      rail_rows, rows, c, s);
}

cudaError_t launch_mlp(const int8_t* h8, const int8_t* w_fc,
                       const int8_t* w_mp, const float* fc_deq,
                       const float* fc_bias, const float* g_scale,
                       const float* mp_deq, const float* mp_bias,
                       const float* resid, int8_t* g8, float* out, int rows,
                       int c, int c4, cudaStream_t s) {
  cudaError_t e = launch_gemm_gelu_q8(h8, w_fc, fc_deq, fc_bias, g_scale,
                                      nullptr, g8, rows, c4, c, s);
  if (e != cudaSuccess) return e;
  return launch_gemm(g8, w_mp, mp_deq, mp_bias, resid, out, rows, c, c4, s);
}

}  // namespace arcweld

// the cluster size of the last launch of the f32 attention (#2, #6, #10,
// #11 without int8_attn): wide_cluster(hd) where a wide tile ran, else 0
extern "C" int attention_cluster() { return last_attention_cluster; }
