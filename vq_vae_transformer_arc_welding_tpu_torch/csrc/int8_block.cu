// int8_block: the device kernels of the calibrated-int8 transformer and
// the host functions that launch them (declared in int8_block.cuh).
//
// The TPU kernels (pallas_block_quant.py, pallas_mlp_quant.py,
// pallas_attn_quant.py) keep one sequence's (T, 3C) f32 qkv or (T, 4C)
// MLP tile in VMEM; at T = 321, C = 512 those are 2 MB and 2.6 MB, far
// above the 227 KB of shared memory a Hopper block has. So each TPU
// kernel becomes a short sequence of launches that split where the data
// stops fitting, built from these pieces:
//   ln_q8_kernel          one warp per row: LayerNorm + quantize;
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
//   head_absmax_kernel    per (batch, head): 127 / absmax of q, k and v
//                         over the valid rows (int8 attention);
//   attention_int8_kernel 64-query tiles on FP32 FMAs, 4 rows x 4
//                         columns a thread, with q, k, v quantized by
//                         those scales: scores are exact integer sums,
//                         scaled once; P is quantized with the FINAL row
//                         max, so the keys are walked twice (pass 1
//                         finds the max, pass 2 recomputes the same
//                         exact scores); P@V sums p8 * v8 exactly.
// Integer sums run as FP32 FMAs on integer values: every partial sum is
// an integer below 2^24 (64 * 127^2 for a score, 321 * 127^2 for P@V at
// T = 321), so it is exact in any order, as the TPU's int32 sums are.
// What bounds them on an H100: the f32 attention's scores run on the
// FP32 cores and its P@V on the tensor cores three times over (split
// TF32), the int8 attention's products on the FP32 cores; the f32 qkv
// and the int8 (rows, 4C) MLP intermediate make a round trip through
// device memory (158 MB and 52.6 MB at batch 80), the traffic the TPU
// kernels avoided. The TPU's 8-row padding of T has no counterpart: every
// kernel masks the ragged edge.
#include "int8_block.cuh"

#include "attention_tc.cuh"
#include "int8_gemm_sm90.cuh"

#include <algorithm>

namespace {

using arcweld::HEAD_DIM;
namespace attn_tc = arcweld::attn_tc;

constexpr int LN_WARPS = 8;
constexpr int LN_MAX_PER_LANE = arcweld::LN_MAX_C / 32;

// out[row] = q8(LN(x[row]) , *qscale)
__global__ void __launch_bounds__(32 * LN_WARPS)
ln_q8_kernel(const float* __restrict__ x, const float* __restrict__ scale,
             const float* __restrict__ bias, const float* __restrict__ qscale,
             int8_t* __restrict__ out, int rows, int c) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * LN_WARPS + threadIdx.x / 32;
  if (row >= rows) return;
  const float* xr = x + (size_t)row * c;
  const int per = c / 32;
  float v[LN_MAX_PER_LANE];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < LN_MAX_PER_LANE; ++i)
    if (i < per) {
      v[i] = xr[i * 32 + lane];
      s += v[i];
    }
  const float mean = __fdiv_rn(arcweld::warp_sum(s), (float)c);
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < LN_MAX_PER_LANE; ++i)
    if (i < per) {
      const float d = __fsub_rn(v[i], mean);
      q = __fadd_rn(q, __fmul_rn(d, d));
    }
  const float var = __fdiv_rn(arcweld::warp_sum(q), (float)c);
  const float qs = *qscale;
  int8_t* orow = out + (size_t)row * c;
#pragma unroll
  for (int i = 0; i < LN_MAX_PER_LANE; ++i)
    if (i < per) {
      const int col = i * 32 + lane;
      orow[col] = arcweld::q8(
          arcweld::norm_affine(v[i], mean, var, scale[col], bias[col]), qs);
    }
}

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

// The int8 attention's tiles (attention_int8_kernel): one block per
// (64-query tile, head, batch), thread (ty, tx) = (tid / 16, tid % 16)
// owns query rows 4ty..4ty+3 and score / output columns 4tx..4tx+3.
constexpr int QT = 64;            // queries per attention block
constexpr int KT = 64;            // keys per shared-memory tile
constexpr int HD = HEAD_DIM;
constexpr int AT_THREADS = 256;   // 16 row groups x 16 column groups
constexpr int PAD = HD + 4;       // row stride: float4-aligned, rows 4
                                  // apart land on other banks

constexpr size_t attention_smem() {
  // q (QT x PAD), k transposed (HD x PAD), v (KT x HD), p (QT x PAD)
  return sizeof(float) * ((size_t)QT * PAD + (size_t)HD * PAD +
                          (size_t)KT * HD + (size_t)QT * PAD);
}

__device__ __forceinline__ float f4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// max / sum over the 16 lanes that share a row group (a half warp)
__device__ __forceinline__ float group16_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float group16_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// s[r][j] = sum_e q_s[r0 + r][e] * k_s[e][c0 + j], summed over e in order
__device__ __forceinline__ void score_tile(const float* q_s, const float* k_s,
                                           int r0, int c0, float (&s)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[r][j] = 0.0f;
#pragma unroll 4
  for (int e = 0; e < HD; e += 4) {
    float4 qv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      qv[r] = *reinterpret_cast<const float4*>(q_s + (r0 + r) * PAD + e);
#pragma unroll
    for (int ee = 0; ee < 4; ++ee) {
      const float4 kv =
          *reinterpret_cast<const float4*>(k_s + (e + ee) * PAD + c0);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float a = f4(qv[r], ee);
        s[r][0] = fmaf(a, kv.x, s[r][0]);
        s[r][1] = fmaf(a, kv.y, s[r][1]);
        s[r][2] = fmaf(a, kv.z, s[r][2]);
        s[r][3] = fmaf(a, kv.w, s[r][3]);
      }
    }
  }
}

// o[r][:] += p_s[r0 + r][:] @ v_s[:, c0 .. c0 + 3] over the tile's keys
__device__ __forceinline__ void pv_tile(const float* p_s, const float* v_s,
                                        int r0, int c0, float (&o)[4][4]) {
#pragma unroll 4
  for (int j = 0; j < KT; j += 4) {
    float4 pv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pv[r] = *reinterpret_cast<const float4*>(p_s + (r0 + r) * PAD + j);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float4 vv =
          *reinterpret_cast<const float4*>(v_s + (j + jj) * HD + c0);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p = f4(pv[r], jj);
        o[r][0] = fmaf(p, vv.x, o[r][0]);
        o[r][1] = fmaf(p, vv.y, o[r][1]);
        o[r][2] = fmaf(p, vv.z, o[r][2]);
        o[r][3] = fmaf(p, vv.w, o[r][3]);
      }
    }
  }
}

// The f32 attention (#2, #6, #10, #11): attention_tc.cuh's tile on
// the packed qkv, its output quantized straight to int8:
//   y8[b, i, h*64 + e] = q8((sum_j p_ij v_je) / sum_j p_ij, *qscale)
struct StoreQ8 {
  int8_t* y8;
  int t, c;
  float qs;
  __device__ __forceinline__ void operator()(int b, int h, int row, int col,
                                             float y0, float y1,
                                             float l) const {
    *reinterpret_cast<char2*>(y8 + ((size_t)b * t + row) * c + h * HD +
                              col) =
        make_char2(arcweld::q8(__fdiv_rn(y0, l), qs),
                   arcweld::q8(__fdiv_rn(y1, l), qs));
  }
};

static_assert(attn_tc::HD == HD, "one head width for both attentions");
__global__ void __launch_bounds__(attn_tc::THREADS, attn_tc::MIN_BLOCKS)
attention_kernel(const float* __restrict__ qkv, const float* __restrict__ qscale,
                 int8_t* __restrict__ y8, int t, int n_head, float sm_scale,
                 bool vec16) {
  const int c = n_head * HD;
  const attn_tc::Operands in{qkv, qkv + c, qkv + 2 * c, (long long)t * 3 * c,
                             HD, 3LL * c, t, sm_scale, vec16};
  attn_tc::causal_attention_tile(in, StoreQ8{y8, t, c, *qscale});
}

// head_scales[b, which, h] = 127 / max(max_{i < t, e} |qkv[b, i, which*C +
// h*64 + e]|, 1e-6): which = 0, 1, 2 for q, k, v. Grid (3 * n_head, batch).
__global__ void __launch_bounds__(256)
head_absmax_kernel(const float* __restrict__ qkv, float* __restrict__ scales,
                   int t, int n_head) {
  __shared__ float red[8];
  const int c = n_head * HD, c3 = 3 * c;
  const int which = blockIdx.x / n_head, h = blockIdx.x % n_head;
  const int b = blockIdx.y;
  const float* base = qkv + (size_t)b * t * c3 + which * c + h * HD;
  float mx = 0.0f;
  for (int idx = threadIdx.x; idx < t * HD; idx += blockDim.x)
    mx = fmaxf(mx, fabsf(base[(size_t)(idx / HD) * c3 + idx % HD]));
  mx = arcweld::warp_max(mx);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = mx;
  __syncthreads();
  if (threadIdx.x < 32) {
    mx = arcweld::warp_max(threadIdx.x < 8 ? red[threadIdx.x] : 0.0f);
    if (threadIdx.x == 0)
      scales[((size_t)b * 3 + which) * n_head + h] =
          __fdiv_rn(127.0f, fmaxf(mx, 1e-6f));
  }
}

// The int8-attention variant (pallas_block_quant.py::_attn_core,
// int8_attn=True), heaviest query tiles first:
//   s_ij = float(sum_e q8_ie k8_je) * (sm_scale / (sq * sk)),
//   p_ij = exp(s_ij - max_j s_ij), l_i = sum_j p_ij (unquantized),
//   y8_i = q8(float(sum_j q8(p_ij, 127) v8_j) / (127 * sv) / l_i, *qscale)
// q8, k8, v8 are quantized with this (batch, head)'s scales. Because P
// is quantized with the final row max, pass 1 walks the keys for the
// max and pass 2 recomputes the same exact scores for P and P@V.
__global__ void __launch_bounds__(AT_THREADS)
attention_int8_kernel(const float* __restrict__ qkv,
                      const float* __restrict__ head_scales,
                      const float* __restrict__ qscale,
                      int8_t* __restrict__ y8, int t, int n_head,
                      float sm_scale) {
  extern __shared__ float4 sm4[];
  float* q_s = reinterpret_cast<float*>(sm4);   // QT x PAD, [row][e]
  float* k_s = q_s + QT * PAD;                   // HD x PAD, [e][key]
  float* v_s = k_s + HD * PAD;                   // KT x HD, [key][e]
  float* p_s = v_s + KT * HD;                    // QT x PAD, [row][key]
  const int c = n_head * HD, c3 = 3 * c;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * QT;
  const int h = blockIdx.y, b = blockIdx.z;
  const float* base = qkv + (size_t)b * t * c3 + h * HD;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int r0 = 4 * ty, c0 = 4 * tx;
  const float* hs = head_scales + (size_t)b * 3 * n_head;
  const float sq = hs[h], sk = hs[n_head + h], sv = hs[2 * n_head + h];
  const float factor = __fdiv_rn(sm_scale, __fmul_rn(sq, sk));

  for (int idx = tid; idx < QT * HD; idx += AT_THREADS) {
    const int r = idx / HD, e = idx % HD;
    q_s[r * PAD + e] =
        q0 + r < t ? (float)arcweld::q8(base[(size_t)(q0 + r) * c3 + e], sq)
                   : 0.0f;
  }
  const int kv_end = min(t, q0 + QT);

  // pass 1: the row max of the scaled scores over the causal keys
  float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  for (int k0 = 0; k0 < kv_end; k0 += KT) {
    __syncthreads();
    for (int idx = tid; idx < KT * HD; idx += AT_THREADS) {
      const int j = idx / HD, e = idx % HD;
      k_s[e * PAD + j] =
          k0 + j < t ? (float)arcweld::q8(base[(size_t)(k0 + j) * c3 + c + e],
                                          sk)
                     : 0.0f;
    }
    __syncthreads();
    float s[4][4];
    score_tile(q_s, k_s, r0, c0, s);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = q0 + r0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + c0 + j;
        if (kj <= qi && kj < t)
          mx[r] = fmaxf(mx[r], __fmul_rn(s[r][j], factor));
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) mx[r] = group16_max(mx[r]);

  // pass 2: p, its sum, q8(p, 127) and the exact p8 @ v8
  float l[4] = {0.0f, 0.0f, 0.0f, 0.0f}, o[4][4] = {};
  for (int k0 = 0; k0 < kv_end; k0 += KT) {
    __syncthreads();
    for (int idx = tid; idx < KT * HD; idx += AT_THREADS) {
      const int j = idx / HD, e = idx % HD;
      const bool ok = k0 + j < t;
      const float* row = base + (size_t)(k0 + j) * c3 + e;
      k_s[e * PAD + j] = ok ? (float)arcweld::q8(row[c], sk) : 0.0f;
      v_s[idx] = ok ? (float)arcweld::q8(row[2 * c], sv) : 0.0f;
    }
    __syncthreads();
    float s[4][4];
    score_tile(q_s, k_s, r0, c0, s);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = q0 + r0 + r;
      float p8[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + c0 + j;
        const float p = (kj <= qi && kj < t)
                            ? expf(__fmul_rn(s[r][j], factor) - mx[r])
                            : 0.0f;
        l[r] += p;
        p8[j] = (float)arcweld::q8(p, 127.0f);
      }
      *reinterpret_cast<float4*>(p_s + (r0 + r) * PAD + c0) =
          make_float4(p8[0], p8[1], p8[2], p8[3]);
    }
    __syncthreads();
    pv_tile(p_s, v_s, r0, c0, o);
  }

  const float qs = *qscale;
  const float dq = __fmul_rn(127.0f, sv);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float lr = group16_sum(l[r]);
    const int qi = q0 + r0 + r;
    if (qi >= t) continue;
    char4 out;
    out.x = arcweld::q8(__fdiv_rn(__fdiv_rn(o[r][0], dq), lr), qs);
    out.y = arcweld::q8(__fdiv_rn(__fdiv_rn(o[r][1], dq), lr), qs);
    out.z = arcweld::q8(__fdiv_rn(__fdiv_rn(o[r][2], dq), lr), qs);
    out.w = arcweld::q8(__fdiv_rn(__fdiv_rn(o[r][3], dq), lr), qs);
    *reinterpret_cast<char4*>(y8 + ((size_t)b * t + qi) * c + h * HD + c0) =
        out;
  }
}

}  // namespace

namespace arcweld {

cudaError_t launch_ln_q8(const float* x, const float* scale,
                         const float* bias, const float* qscale, int8_t* out,
                         int rows, int c, cudaStream_t s) {
  if (c % 32 != 0 || c > LN_MAX_C) return cudaErrorInvalidValue;
  ln_q8_kernel<<<(rows + LN_WARPS - 1) / LN_WARPS, 32 * LN_WARPS, 0, s>>>(
      x, scale, bias, qscale, out, rows, c);
  return cudaGetLastError();
}

cudaError_t launch_q8(const float* x, const float* qscale, int8_t* out,
                      size_t n, cudaStream_t s) {
  if (n % 4 != 0) return cudaErrorInvalidValue;
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
  return gemm90::launch<false>(a, w, cs, cb, resid, nullptr, out, rows,
                               n_cols, k, s);
}

cudaError_t launch_gemm_gelu_q8(const int8_t* a, const int8_t* w,
                                const float* cs, const float* cb,
                                const float* qscale, int8_t* out, int rows,
                                int n_cols, int k, cudaStream_t s) {
  return gemm90::launch<true>(a, w, cs, cb, nullptr, qscale, out, rows,
                              n_cols, k, s);
}

cudaError_t launch_attention(const float* qkv, const float* qscale,
                             int8_t* y8, float* head_scales, int batch, int t,
                             int n_head, float sm_scale, bool int8_attn,
                             cudaStream_t s) {
  cudaError_t e;
  if (batch < 1 || batch > 65535 || t < 1) return cudaErrorInvalidValue;
  if (!int8_attn) {
    e = cudaFuncSetAttribute(attention_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)attn_tc::SMEM);
    if (e != cudaSuccess) return e;
    const int c = n_head * HD;
    attention_kernel<<<attn_tc::grid(batch, n_head, t), attn_tc::THREADS,
                       attn_tc::SMEM, s>>>(
        qkv, qscale, y8, t, n_head, sm_scale,
        attn_tc::rows_aligned16(qkv, qkv + c, qkv + 2 * c,
                                (long long)t * 3 * c, HD, 3LL * c));
    return cudaGetLastError();
  }
  const size_t smem = attention_smem();
  dim3 grid((t + QT - 1) / QT, n_head, batch);
  if (head_scales == nullptr) return cudaErrorInvalidValue;
  head_absmax_kernel<<<dim3(3 * n_head, batch), 256, 0, s>>>(qkv, head_scales,
                                                             t, n_head);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  e = cudaFuncSetAttribute(attention_int8_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  attention_int8_kernel<<<grid, AT_THREADS, smem, s>>>(
      qkv, head_scales, qscale, y8, t, n_head, sm_scale);
  return cudaGetLastError();
}

cudaError_t launch_attn_half(const float* x, const int8_t* w_qkv,
                             const int8_t* w_proj, const float* scales,
                             const float* vc, const float* v3c, int8_t* h8a,
                             float* qkv, int8_t* y8, float* head_scales,
                             float* x_mid, int8_t* h8, int batch, int t,
                             int c, int n_head, float sm_scale,
                             bool int8_attn, cudaStream_t s) {
  const int rows = batch * t;
  if (c != n_head * HD) return cudaErrorInvalidValue;
  cudaError_t e;
  if ((e = launch_ln_q8(x, vc, vc + c, scales + 0, h8a, rows, c, s)) !=
      cudaSuccess)
    return e;
  if ((e = launch_gemm(h8a, w_qkv, v3c, v3c + 3 * c, nullptr, qkv, rows,
                       3 * c, c, s)) != cudaSuccess)
    return e;
  if ((e = launch_attention(qkv, scales + 1, y8, head_scales, batch, t,
                            n_head, sm_scale, int8_attn, s)) != cudaSuccess)
    return e;
  if ((e = launch_gemm(y8, w_proj, vc + 4 * c, vc + 5 * c, x, x_mid, rows, c,
                       c, s)) != cudaSuccess)
    return e;
  return launch_ln_q8(x_mid, vc + 2 * c, vc + 3 * c, scales + 2, h8, rows, c,
                      s);
}

cudaError_t launch_mlp(const int8_t* h8, const int8_t* w_fc,
                       const int8_t* w_mp, const float* fc_deq,
                       const float* fc_bias, const float* g_scale,
                       const float* mp_deq, const float* mp_bias,
                       const float* resid, int8_t* g8, float* out, int rows,
                       int c, int c4, cudaStream_t s) {
  cudaError_t e = launch_gemm_gelu_q8(h8, w_fc, fc_deq, fc_bias, g_scale, g8,
                                      rows, c4, c, s);
  if (e != cudaSuccess) return e;
  return launch_gemm(g8, w_mp, mp_deq, mp_bias, resid, out, rows, c, c4, s);
}

}  // namespace arcweld
