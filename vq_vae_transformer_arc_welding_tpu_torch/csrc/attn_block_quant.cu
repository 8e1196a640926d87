// attn_block_quant: the attention half of a calibrated-int8 transformer
// block, as a short sequence of launches.
//
// Replaces vq_vae_transformer_arc_welding_tpu/ops/pallas_block_quant.py::
// fused_attn_block_quant (pallas_call at :255, int8_attn=False):
//   h8   = q8(LN1(x), s_attn)
//   qkv  = int32(h8 @ Wqkv^T) * deq_qkv + b_qkv              (f32)
//   y    = causal softmax attention per head, 1/sqrt(d) scale,
//          normalized after P@V                            (f32)
//   y8   = q8(y, s_proj)
//   xmid = x + (int32(y8 @ Wproj^T) * deq_proj + b_proj)
//   h8   = q8(LN2(xmid), s_fc)
// q8 is clip(round-half-even(v * s), -127, 127).
//
// Why several launches: the TPU kernel keeps one sequence's (T, 3C)
// f32 qkv tile in VMEM; at T = 321, C = 512 that is 2 MB, far above the
// 227 KB of shared memory a Hopper block has. So the work splits where
// the data stops fitting, and each piece is written for what it
// computes:
//   1. ln_q8_kernel      one warp per row: LayerNorm + quantize;
//   2. int8_gemm_kernel  int8 GEMM on the tensor cores (mma.sync
//                        m16n8k32 s8, exact s32 sums), epilogue
//                        dequant + bias;
//   3. attention_kernel  per (batch, head, 64-query tile): keys and
//                        values stream through shared memory 64 at a
//                        time up to the tile's causal limit (66 KB per
//                        block, three blocks per SM); scores and P@V
//                        are register-tiled FP32 FMAs, 4 rows x 4
//                        columns per thread; the row max is kept online
//                        and the division by the row sum waits until
//                        after P@V; the output is quantized straight to
//                        int8;
//   4. int8_gemm_kernel  c_proj, epilogue dequant + bias + residual;
//   5. ln_q8_kernel      LayerNorm 2 + quantize.
// What bounds it on an H100: the two int8 GEMMs are small (2 x 10^10
// MACs at batch 80) and the attention is FP32 work of the same order;
// the f32 qkv round trip through device memory (158 MB at batch 80) is
// the traffic the TPU kernel avoided. The GEMMs use mma.sync, not yet
// wgmma with TMA; the FP32 attention does not use the tensor cores; a
// flash-style attention that keeps qkv on chip is later work. The TPU's 8-row
// padding of T has no counterpart: every kernel masks the ragged edge.
#include "common.cuh"

namespace {

constexpr int LN_WARPS = 8;
constexpr int LN_MAX_PER_LANE = 32;   // C <= 1024

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

constexpr int GB = 64;           // GEMM tile: 64 x 64 outputs
constexpr int GKW = 16;          // 16 int32 words = 64 int8 of K per stage
constexpr int GSTRIDE = GKW + 4; // 20 words: fragment loads hit 32 banks

// d += a (16 x 32 s8, row) * b (32 x 8 s8, col), exact s32 sums
__device__ __forceinline__ void mma_s8(int (&d)[4], const int (&a)[4], int b0,
                                       int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// out[m, n] = float(sum_k a[m, k] * w[n, k]) * cs[n] + cb[n] (+ resid[m, n])
// a (M, K) and w (N, K) int8, both K-contiguous: the row.col operand
// layout of mma.m16n8k32, so a fragment register is one 32-bit word of
// a shared-memory row. Warp w computes the 16 x 32 sub-tile at rows
// 16*(w/2), columns 32*(w%2) of the block's 64 x 64 tile. Needs K and
// N multiples of 64.
__global__ void __launch_bounds__(256)
int8_gemm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ w,
                 const float* __restrict__ cs, const float* __restrict__ cb,
                 const float* __restrict__ resid, float* __restrict__ out,
                 int m_rows, int n_cols, int k) {
  __shared__ __align__(16) int a_s[GB][GSTRIDE];
  __shared__ __align__(16) int w_s[GB][GSTRIDE];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;        // mma group, thread in group
  const int wm = (warp / 2) * 16, wn = (warp % 2) * 32;
  const int m0 = blockIdx.y * GB, n0 = blockIdx.x * GB;
  const int lr = tid / 4, lw = (tid % 4) * 4;   // loader: row, first word
  int acc[4][4] = {};
  for (int k0 = 0; k0 < k; k0 += 4 * GKW) {
    int4 av = make_int4(0, 0, 0, 0);
    if (m0 + lr < m_rows)
      av = *reinterpret_cast<const int4*>(a + (size_t)(m0 + lr) * k + k0 +
                                          4 * lw);
    const int4 wv = *reinterpret_cast<const int4*>(
        w + (size_t)(n0 + lr) * k + k0 + 4 * lw);
    *reinterpret_cast<int4*>(&a_s[lr][lw]) = av;
    *reinterpret_cast<int4*>(&w_s[lr][lw]) = wv;
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < GKW; ks += 8) {       // two k32 steps
      const int kw = ks + tg;
      const int af[4] = {a_s[wm + g][kw], a_s[wm + g + 8][kw],
                         a_s[wm + g][kw + 4], a_s[wm + g + 8][kw + 4]};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int* wr = w_s[wn + 8 * j + g];
        mma_s8(acc[j], af, wr[kw], wr[kw + 4]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + wn + 8 * j + 2 * tg;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + g + 8 * half;
      if (m >= m_rows) continue;
      float y0 = __fadd_rn(__fmul_rn((float)acc[j][2 * half], cs[n]), cb[n]);
      float y1 = __fadd_rn(__fmul_rn((float)acc[j][2 * half + 1], cs[n + 1]),
                           cb[n + 1]);
      if (resid != nullptr) {
        const float2 r = *reinterpret_cast<const float2*>(
            resid + (size_t)m * n_cols + n);
        y0 = __fadd_rn(r.x, y0);
        y1 = __fadd_rn(r.y, y1);
      }
      *reinterpret_cast<float2*>(out + (size_t)m * n_cols + n) =
          make_float2(y0, y1);
    }
  }
}

constexpr int QT = 64;            // queries per attention block
constexpr int KT = 64;            // keys per shared-memory tile
constexpr int HD = 64;            // head width the kernel is written for
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

// One block per (64-query tile, head, batch), heaviest tiles first.
// Thread (ty, tx) = (tid / 16, tid % 16) owns query rows 4ty..4ty+3 and
// score columns / output columns 4tx..4tx+3. Keys stream through shared
// memory 64 at a time up to the tile's causal limit; the row max is
// kept online (numerators rescaled when it grows), and the division by
// the row sum comes after P@V, as in the TPU kernel:
//   y8[b, i, h*64 + e] = q8((sum_j p_ij v_je) / sum_j p_ij, *qscale),
//   p_ij = exp(s_ij - max_j s_ij), s_ij = (q_i . k_j) * sm_scale, j <= i
__global__ void __launch_bounds__(AT_THREADS)
attention_kernel(const float* __restrict__ qkv, const float* __restrict__ qscale,
                 int8_t* __restrict__ y8, int t, int n_head, float sm_scale) {
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

  for (int idx = tid; idx < QT * HD; idx += AT_THREADS) {
    const int r = idx / HD, e = idx % HD;
    q_s[r * PAD + e] = q0 + r < t ? base[(size_t)(q0 + r) * c3 + e] : 0.0f;
  }
  float m[4], l[4], o[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[r][j] = 0.0f;
  }

  const int kv_end = min(t, q0 + QT);
  for (int k0 = 0; k0 < kv_end; k0 += KT) {
    __syncthreads();   // the previous tile's k, v and p are consumed
    for (int idx = tid; idx < KT * HD; idx += AT_THREADS) {
      const int j = idx / HD, e = idx % HD;
      const bool ok = k0 + j < t;
      const float* row = base + (size_t)(k0 + j) * c3 + e;
      k_s[e * PAD + j] = ok ? row[c] : 0.0f;
      v_s[idx] = ok ? row[2 * c] : 0.0f;
    }
    __syncthreads();

    // scores s[r][j] for rows r0+r, keys k0+c0+j, summed over e in order
    float s[4][4] = {};
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

    // online softmax numerators; rows past t still see keys < t
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = q0 + r0 + r;
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + c0 + j;
        s[r][j] = (kj <= qi && kj < t) ? __fmul_rn(s[r][j], sm_scale)
                                       : -INFINITY;
        tmax = fmaxf(tmax, s[r][j]);
      }
      const float m_new = fmaxf(m[r], group16_max(tmax));
      const float alpha = expf(m[r] - m_new);   // 0 on the first tile
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[r][j] = expf(s[r][j] - m_new);
        psum += s[r][j];
      }
      l[r] = l[r] * alpha + group16_sum(psum);
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) o[r][j] *= alpha;
      *reinterpret_cast<float4*>(p_s + (r0 + r) * PAD + c0) =
          make_float4(s[r][0], s[r][1], s[r][2], s[r][3]);
    }
    __syncthreads();

    // o[r][:] += p[r][:] @ v over this tile's keys
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

  const float qs = *qscale;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + r0 + r;
    if (qi >= t) continue;
    char4 out;
    out.x = arcweld::q8(__fdiv_rn(o[r][0], l[r]), qs);
    out.y = arcweld::q8(__fdiv_rn(o[r][1], l[r]), qs);
    out.z = arcweld::q8(__fdiv_rn(o[r][2], l[r]), qs);
    out.w = arcweld::q8(__fdiv_rn(o[r][3], l[r]), qs);
    *reinterpret_cast<char4*>(y8 + ((size_t)b * t + qi) * c + h * HD + c0) =
        out;
  }
}

}  // namespace

// x (B*T, C) f32; w_qkv (3C, C) int8; w_proj (C, C) int8;
// scales (4,) f32 [s_attn, s_proj, s_fc, s_mproj]; vc (6, C) f32 rows
// [ln1_s, ln1_b, ln2_s, ln2_b, deq_proj, b_proj]; v3c (2, 3C) f32 rows
// [deq_qkv, b_qkv]. Scratch: h8a (B*T, C) int8, qkv (B*T, 3C) f32,
// y8 (B*T, C) int8. Outputs: x_mid (B*T, C) f32, h8 (B*T, C) int8.
// sm_scale: 1/sqrt(C / n_head), rounded to f32 by the caller.
extern "C" int attn_block_quant(const void* x, const void* w_qkv,
                                const void* w_proj, const void* scales,
                                const void* vc, const void* v3c, void* h8a,
                                void* qkv, void* y8, void* x_mid, void* h8,
                                int batch, int t, int c, int n_head,
                                float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* sc = static_cast<const float*>(scales);
  const float* vcf = static_cast<const float*>(vc);
  const float* v3f = static_cast<const float*>(v3c);
  const int rows = batch * t;
  if (c % 64 != 0 || c / 32 > LN_MAX_PER_LANE || c != n_head * HD)
    return cudaErrorInvalidValue;
  cudaError_t e;
  const int ln_grid = (rows + LN_WARPS - 1) / LN_WARPS;

  ln_q8_kernel<<<ln_grid, 32 * LN_WARPS, 0, s>>>(
      xf, vcf, vcf + c, sc + 0, static_cast<int8_t*>(h8a), rows, c);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  dim3 g_qkv((3 * c + GB - 1) / GB, (rows + GB - 1) / GB);
  int8_gemm_kernel<<<g_qkv, 256, 0, s>>>(
      static_cast<const int8_t*>(h8a), static_cast<const int8_t*>(w_qkv),
      v3f, v3f + 3 * c, nullptr, static_cast<float*>(qkv), rows, 3 * c, c);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const size_t smem = attention_smem();
  e = cudaFuncSetAttribute(attention_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  dim3 g_att((t + QT - 1) / QT, n_head, batch);
  attention_kernel<<<g_att, AT_THREADS, smem, s>>>(
      static_cast<const float*>(qkv), sc + 1, static_cast<int8_t*>(y8), t,
      n_head, sm_scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  dim3 g_proj((c + GB - 1) / GB, (rows + GB - 1) / GB);
  int8_gemm_kernel<<<g_proj, 256, 0, s>>>(
      static_cast<const int8_t*>(y8), static_cast<const int8_t*>(w_proj),
      vcf + 4 * c, vcf + 5 * c, xf, static_cast<float*>(x_mid), rows, c, c);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  ln_q8_kernel<<<ln_grid, 32 * LN_WARPS, 0, s>>>(
      static_cast<const float*>(x_mid), vcf + 2 * c, vcf + 3 * c, sc + 2,
      static_cast<int8_t*>(h8), rows, c);
  return cudaGetLastError();
}

extern "C" int attn_block_quant_head_dim() { return HD; }
