// flash_attn: causal softmax(Q K^T / sqrt(D)) V in f32, per (batch, head),
// with no score tensor in device memory.
//
// Replaces vq_vae_transformer_arc_welding_tpu/ops/pallas_attn.py
// (flash_causal_attention: _forward's pallas_call at :73, _attn_kernel).
// The TPU kernel holds one (T, T) score tile per (batch, head) in VMEM,
// pads T to a multiple of 8 and takes four (batch, head) pairs per
// program. Here one block takes a 64-query tile of one head of one
// sample; keys and values stream through shared memory 64 at a time up
// to the tile's causal limit, the row max is kept online (numerators
// rescaled when it grows) and the division by the row sum comes after
// P@V. Any T: the ragged edge is masked. The tile arithmetic is that of
// int8_block.cu's attention_kernel, written again here for f32 operands
// read through strides and an f32 output, so that the int8 kernels'
// registers and times do not depend on this file.
//
// What bounds it on an H100: operations. 4 B H T^2 D / 2 FP32 operations
// against four (B, H, T, D) tensors of bytes; the products are FP32 FMAs
// outside the tensor cores, 4 rows x 4 columns a thread. FMA contraction
// is allowed: the contract with the plain version is a tolerance.
#include "common.cuh"

namespace {

constexpr int QT = 64;            // queries per block
constexpr int KT = 64;            // keys per shared-memory tile
constexpr int HD = 64;            // head width the kernel is written for
constexpr int THREADS = 256;      // 16 row groups x 16 column groups
constexpr int PAD = HD + 4;       // row stride: float4-aligned, rows 4
                                  // apart land on other banks

constexpr size_t flash_smem() {
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

// Thread (ty, tx) = (tid / 16, tid % 16) owns query rows 4ty..4ty+3 and
// score columns / output columns 4tx..4tx+3.
//   o[b, h, i, :] = (sum_j p_ij v_j) / sum_j p_ij,
//   p_ij = exp(s_ij - max_j s_ij), s_ij = (q_i . k_j) * sm_scale, j <= i
// q, k, v element (b, h, i, e) at b*sb + h*sh + i*st + e; o likewise
// with (sob, soh, sot). Grid (query tiles, heads, batch), heaviest tiles
// first.
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int t, long long sb, long long sh, long long st,
                       long long sob, long long soh, long long sot,
                       float sm_scale) {
  extern __shared__ float4 sm4[];
  float* q_s = reinterpret_cast<float*>(sm4);   // QT x PAD, [row][e]
  float* k_s = q_s + QT * PAD;                   // HD x PAD, [e][key]
  float* v_s = k_s + HD * PAD;                   // KT x HD, [key][e]
  float* p_s = v_s + KT * HD;                    // QT x PAD, [row][key]
  const int q0 = (gridDim.x - 1 - blockIdx.x) * QT;
  const long long base = blockIdx.z * sb + blockIdx.y * sh;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int r0 = 4 * ty, c0 = 4 * tx;

  for (int idx = tid; idx < QT * HD; idx += THREADS) {
    const int r = idx / HD, e = idx % HD;
    q_s[r * PAD + e] = q0 + r < t ? q[base + (q0 + r) * st + e] : 0.0f;
  }
  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.0f;
  }

  const int kv_end = min(t, q0 + QT);
  for (int k0 = 0; k0 < kv_end; k0 += KT) {
    __syncthreads();   // the previous tile's k, v and p are consumed
    for (int idx = tid; idx < KT * HD; idx += THREADS) {
      const int j = idx / HD, e = idx % HD;
      const bool ok = k0 + j < t;
      const long long at = base + (k0 + j) * st + e;
      k_s[e * PAD + j] = ok ? k[at] : 0.0f;
      v_s[idx] = ok ? v[at] : 0.0f;
    }
    __syncthreads();

    // s[r][j] = sum_e q_s[r0 + r][e] * k_s[e][c0 + j]
    float s[4][4];
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

    // online softmax numerators; rows past t still see keys < t
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = q0 + r0 + r;
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + c0 + j;
        s[r][j] = (kj <= qi && kj < t) ? s[r][j] * sm_scale : -INFINITY;
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
      for (int j = 0; j < 4; ++j) acc[r][j] *= alpha;
      *reinterpret_cast<float4*>(p_s + (r0 + r) * PAD + c0) =
          make_float4(s[r][0], s[r][1], s[r][2], s[r][3]);
    }
    __syncthreads();

    // acc[r][:] += p_s[r0 + r][:] @ v_s[:, c0 .. c0 + 3]
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
          acc[r][0] = fmaf(p, vv.x, acc[r][0]);
          acc[r][1] = fmaf(p, vv.y, acc[r][1]);
          acc[r][2] = fmaf(p, vv.z, acc[r][2]);
          acc[r][3] = fmaf(p, vv.w, acc[r][3]);
        }
      }
    }
  }

  const long long obase = blockIdx.z * sob + blockIdx.y * soh;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + r0 + r;
    if (qi >= t) continue;
    *reinterpret_cast<float4*>(o + obase + qi * sot + c0) =
        make_float4(acc[r][0] / l[r], acc[r][1] / l[r], acc[r][2] / l[r],
                    acc[r][3] / l[r]);
  }
}

}  // namespace

// q, k, v (batch, n_head, t, 64) f32 read through the strides (sb, sh,
// st) in floats, the last axis contiguous; o written through (sob, soh,
// sot), offsets multiples of 4 floats from a 16-byte-aligned pointer.
// sm_scale: 1/sqrt(64).
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* o, int batch, int n_head, int t,
                                   long long sb, long long sh, long long st,
                                   long long sob, long long soh,
                                   long long sot, float sm_scale,
                                   void* stream) {
  if (batch < 1 || n_head < 1 || t < 1 || (sob | soh | sot) % 4 != 0)
    return cudaErrorInvalidValue;
  const size_t smem = flash_smem();
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((t + QT - 1) / QT, n_head, batch);
  flash_attention_kernel<<<grid, THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), t, sb, sh, st,
      sob, soh, sot, sm_scale);
  return cudaGetLastError();
}
