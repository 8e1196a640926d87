// nearest_codes_f32: nearest codebook row of every latent row.
//
// Replaces vq_vae_transformer_arc_welding_tpu/ops/pallas_vq.py::
// nearest_codes_pallas (pallas_call at :59): z (N, D) f32 and the
// (K, D) codebook -> (N,) int32, the first index among the minima of
// d = sum e^2 - 2 z.e (the row-constant sum z^2 is left out, as in the
// TPU kernel). The (N, K) distances never reach device memory.
//
// What bounds it on an H100: at N = 25,600, K = 256, D = 32 it is 0.42
// GFLOP over 3.4 MB, a few microseconds either way, so the launch and
// the latency of one thread's dependent FMAs are what shows.
//
// Design: one thread per row, its z row in registers; each block keeps
// the codebook (rows zero-padded to DP floats, which adds exact zeros
// to the sums) and the K squared norms in shared memory, where every
// read is a broadcast. A thread scans codes 0..K-1 with d < best, so
// the first index among equal minima wins. z.e is summed in index
// order with FMAs, sum e^2 as rounded products added in index order.
#include "common.cuh"

namespace {

constexpr int NC_THREADS = 128;

template <int DP>
__global__ void __launch_bounds__(NC_THREADS)
nearest_codes_kernel(const float* __restrict__ z,
                     const float* __restrict__ codebook,
                     int* __restrict__ ids, int n_rows, int d_emb,
                     int k_codes) {
  extern __shared__ float4 smem4[];
  float* cb_s = reinterpret_cast<float*>(smem4);   // K x DP
  float* esq_s = cb_s + k_codes * DP;               // K
  const int tid = threadIdx.x;
  for (int i = tid; i < k_codes * DP; i += NC_THREADS) {
    const int dd = i % DP;
    cb_s[i] = dd < d_emb ? codebook[(size_t)(i / DP) * d_emb + dd] : 0.0f;
  }
  __syncthreads();
  for (int k = tid; k < k_codes; k += NC_THREADS) {
    float s = 0.0f;
    for (int dd = 0; dd < d_emb; ++dd) {
      const float e = cb_s[k * DP + dd];
      s = __fadd_rn(s, __fmul_rn(e, e));
    }
    esq_s[k] = s;
  }
  __syncthreads();

  const int row = blockIdx.x * NC_THREADS + tid;
  if (row >= n_rows) return;
  float zr[DP];
#pragma unroll
  for (int dd = 0; dd < DP; ++dd)
    zr[dd] = dd < d_emb ? z[(size_t)row * d_emb + dd] : 0.0f;
  float best = INFINITY;
  int best_k = 0;
#pragma unroll 4
  for (int k = 0; k < k_codes; ++k) {
    const float4* e4 = reinterpret_cast<const float4*>(cb_s + k * DP);
    float cross = 0.0f;
#pragma unroll
    for (int q = 0; q < DP / 4; ++q) {
      const float4 e = e4[q];
      cross = fmaf(zr[4 * q + 0], e.x, cross);
      cross = fmaf(zr[4 * q + 1], e.y, cross);
      cross = fmaf(zr[4 * q + 2], e.z, cross);
      cross = fmaf(zr[4 * q + 3], e.w, cross);
    }
    const float dist = __fadd_rn(esq_s[k], __fmul_rn(-2.0f, cross));
    if (dist < best) {
      best = dist;
      best_k = k;
    }
  }
  ids[row] = best_k;
}

template <int DP>
cudaError_t launch(const float* z, const float* codebook, int* ids,
                   int n_rows, int d_emb, int k_codes, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)k_codes * (DP + 1);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      nearest_codes_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  nearest_codes_kernel<DP>
      <<<(n_rows + NC_THREADS - 1) / NC_THREADS, NC_THREADS, smem, stream>>>(
          z, codebook, ids, n_rows, d_emb, k_codes);
  return cudaGetLastError();
}

}  // namespace

extern "C" int nearest_codes_f32(const void* z, const void* codebook,
                                 void* ids, int n_rows, int d_emb,
                                 int k_codes, void* stream) {
  const float* zf = static_cast<const float*>(z);
  const float* cb = static_cast<const float*>(codebook);
  int* out = static_cast<int*>(ids);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d_emb < 1 || k_codes < 1) return cudaErrorInvalidValue;
  if (d_emb <= 8) return launch<8>(zf, cb, out, n_rows, d_emb, k_codes, s);
  if (d_emb <= 16) return launch<16>(zf, cb, out, n_rows, d_emb, k_codes, s);
  if (d_emb <= 32) return launch<32>(zf, cb, out, n_rows, d_emb, k_codes, s);
  if (d_emb <= 64) return launch<64>(zf, cb, out, n_rows, d_emb, k_codes, s);
  return cudaErrorInvalidValue;
}
