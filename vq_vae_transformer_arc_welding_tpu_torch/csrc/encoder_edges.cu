// encoder_entry_f32 and encoder_exit_f32: the first and the last group
// of encoder resblocks with the ends of the encoder inside the kernel.
//
// Replace vq_vae_transformer_arc_welding_tpu/ops/pallas_encoder.py::
// fused_encoder_entry_eval (pallas_call at :404) and
// fused_encoder_exit_eval (pallas_call at :436).
//
//   entry: x = patches (N, P) @ w_pe (P, C) + b_pe, then the group's
//          resblocks -> (N, C) f32
//   exit:  the group's resblocks, z = x @ w_sep (C, D) + b_sep,
//          d = (sum z^2 + sum e^2) - 2 z.e over the (K, D) codebook,
//          the first index among the minima -> (N,) int32
//
// Both are the tile of encoder_chain.cuh with a prologue or an epilogue
// on the block's 32 rows, so the patch-embed output, z and the (N, K)
// distances never reach device memory. What bounds them is the chain's
// FP32 FMA rate: per row a resblock is 524 K FMAs at C = 512, the
// patch-embed 12.8 K and sep_conv with the distances 24.6 K (D = 32,
// K = 256). The ends are written for exactness first; the exit's
// epilogue runs with one block per SM and nothing to hide its latency
// behind, which is what its time shows.
//
// Exactness: every dot product is summed in index order with FMAs, the
// squared norms as rounded products added in index order, and d keeps
// the reference's order (zsq + esq) - 2 * cross. Each lane scans its
// codes in increasing order with d < best, and the reduction over lanes
// takes the smaller d and, on equal d, the smaller index: the first
// index among equal minima, as the reference's argmin.
#include "encoder_chain.cuh"

namespace {

using namespace arcweld::enc;

constexpr int WARPS = THREADS / 32;
constexpr int ROWS_PER_WARP = BM / WARPS;   // 4
constexpr int MAX_Z_ROWS = 8;                // z rows per thread at D = 64

// xr = patches[block rows] @ w_pe + b_pe. The block's BM x P patch rows
// are staged in a_s (free before the first resblock); w_pe comes from
// L2. k runs in index order.
template <int C>
__device__ __forceinline__ void embed_rows(
    const float* __restrict__ patches, const float* __restrict__ w_pe,
    const float* __restrict__ b_pe, int patch,
    float (&xr)[ROWS][Tile<C>::COLS], float* __restrict__ a_s, int rg, int cg,
    int tid, int n_rows) {
  using T = Tile<C>;
  const int row_base = blockIdx.x * BM;
  for (int i = tid; i < BM * patch; i += THREADS)
    a_s[i] = row_base + i / patch < n_rows
                 ? patches[(size_t)row_base * patch + i] : 0.0f;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int c = 0; c < T::COLS; ++c) xr[r][c] = 0.0f;
  for (int k = 0; k < patch; ++k) {
    float4 wv[T::NJ];
#pragma unroll
    for (int j = 0; j < T::NJ; ++j)
      wv[j] = *reinterpret_cast<const float4*>(w_pe + (size_t)k * C +
                                               j * 256 + cg * 4);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float p = a_s[(rg * ROWS + r) * patch + k];
#pragma unroll
      for (int j = 0; j < T::NJ; ++j) {
        xr[r][4 * j + 0] = fmaf(p, wv[j].x, xr[r][4 * j + 0]);
        xr[r][4 * j + 1] = fmaf(p, wv[j].y, xr[r][4 * j + 1]);
        xr[r][4 * j + 2] = fmaf(p, wv[j].z, xr[r][4 * j + 2]);
        xr[r][4 * j + 3] = fmaf(p, wv[j].w, xr[r][4 * j + 3]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < T::NJ; ++j) {
    const float4 b =
        *reinterpret_cast<const float4*>(b_pe + j * 256 + cg * 4);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      xr[r][4 * j + 0] += b.x;
      xr[r][4 * j + 1] += b.y;
      xr[r][4 * j + 2] += b.z;
      xr[r][4 * j + 3] += b.w;
    }
  }
  __syncthreads();   // the first resblock overwrites a_s
}

// ids[block rows] = nearest code of x @ w_sep + b_sep, for the block's
// rows x staged in a_s (BM x C). Shared memory, all free after the last
// resblock: z (BM x D) goes to w_s; then the codebook, its rows padded
// to D + 1 floats so that lanes on neighbouring codes hit different
// banks, and the K squared norms take a_s over. Needs THREADS % D == 0,
// D <= 64 and K * (D + 2) <= BM * C. Not inlined: it takes pointers
// only, so the chain before it keeps the register allocation it has in
// encoder_chain_f32.
template <int C>
__device__ __noinline__ void nearest_rows(
    float* __restrict__ a_s, float* __restrict__ w_s,
    const float* __restrict__ w_sep, const float* __restrict__ b_sep,
    const float* __restrict__ codebook, int* __restrict__ ids, int n_rows,
    int d_emb, int k_codes, int tid) {
  // z: this thread's column of rows r0, r0 + rstep, ...
  const int dcol = tid % d_emb;
  const int r0 = tid / d_emb;
  const int rstep = THREADS / d_emb;
  const int n_z = BM / rstep;
  float zacc[MAX_Z_ROWS];
#pragma unroll
  for (int i = 0; i < MAX_Z_ROWS; ++i) zacc[i] = 0.0f;
  // the chain's weights have swept w_sep out of L1, so every row comes
  // from L2: 16 rows in flight per thread
#pragma unroll 16
  for (int k = 0; k < C; ++k) {
    const float wv = w_sep[(size_t)k * d_emb + dcol];
#pragma unroll
    for (int i = 0; i < MAX_Z_ROWS; ++i)
      if (i < n_z) zacc[i] = fmaf(a_s[(r0 + i * rstep) * C + k], wv, zacc[i]);
  }
  float* z_s = w_s;
  const float bias = b_sep[dcol];
#pragma unroll
  for (int i = 0; i < MAX_Z_ROWS; ++i)
    if (i < n_z) z_s[(r0 + i * rstep) * d_emb + dcol] = zacc[i] + bias;
  __syncthreads();   // x in a_s is consumed; z_s is complete

  const int dp = d_emb + 1;
  float* cb_s = a_s;
  float* esq_s = a_s + k_codes * dp;
  // D is a multiple of 8: a float4 never straddles two codes
  const float4* cb4 = reinterpret_cast<const float4*>(codebook);
#pragma unroll 8
  for (int i = tid; i < k_codes * d_emb / 4; i += THREADS) {
    const float4 e = cb4[i];
    float* dst = cb_s + (4 * i / d_emb) * dp + 4 * i % d_emb;
    dst[0] = e.x;
    dst[1] = e.y;
    dst[2] = e.z;
    dst[3] = e.w;
  }
  __syncthreads();
  for (int k = tid; k < k_codes; k += THREADS) {
    float s = 0.0f;
    for (int dd = 0; dd < d_emb; ++dd) {
      const float e = cb_s[k * dp + dd];
      s = __fadd_rn(s, __fmul_rn(e, e));
    }
    esq_s[k] = s;
  }
  const int warp = tid / 32;
  const int lane = tid % 32;
  const float* z_w = z_s + warp * ROWS_PER_WARP * d_emb;   // the warp's rows
  float zsq[ROWS_PER_WARP];
#pragma unroll
  for (int q = 0; q < ROWS_PER_WARP; ++q) {
    float s = 0.0f;
    for (int dd = 0; dd < d_emb; ++dd) {
      const float zv = z_w[q * d_emb + dd];
      s = __fadd_rn(s, __fmul_rn(zv, zv));
    }
    zsq[q] = s;
  }
  __syncthreads();   // esq_s is complete

  float best[ROWS_PER_WARP];
  int best_k[ROWS_PER_WARP];
#pragma unroll
  for (int q = 0; q < ROWS_PER_WARP; ++q) {
    best[q] = INFINITY;
    best_k[q] = k_codes;
  }
  for (int k = lane; k < k_codes; k += 32) {
    const float* e = cb_s + k * dp;
    float cross[ROWS_PER_WARP];
#pragma unroll
    for (int q = 0; q < ROWS_PER_WARP; ++q) cross[q] = 0.0f;
    for (int dd = 0; dd < d_emb; ++dd) {
      const float ev = e[dd];
#pragma unroll
      for (int q = 0; q < ROWS_PER_WARP; ++q)
        cross[q] = fmaf(z_w[q * d_emb + dd], ev, cross[q]);
    }
    const float es = esq_s[k];
#pragma unroll
    for (int q = 0; q < ROWS_PER_WARP; ++q) {
      const float dist = __fadd_rn(__fadd_rn(zsq[q], es),
                                   __fmul_rn(-2.0f, cross[q]));
      if (dist < best[q]) {
        best[q] = dist;
        best_k[q] = k;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < ROWS_PER_WARP; ++q) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, best[q], o);
      const int ok = __shfl_xor_sync(0xffffffffu, best_k[q], o);
      if (od < best[q] || (od == best[q] && ok < best_k[q])) {
        best[q] = od;
        best_k[q] = ok;
      }
    }
    const int row = blockIdx.x * BM + warp * ROWS_PER_WARP + q;
    // no distance below +inf (a non-finite row): code 0
    if (lane == 0 && row < n_rows)
      ids[row] = best_k[q] < k_codes ? best_k[q] : 0;
  }
}

template <int C>
__global__ void __launch_bounds__(THREADS, 1)
encoder_entry_kernel(const float* __restrict__ patches,
                     const float* __restrict__ w_pe,
                     const float* __restrict__ b_pe,
                     const float* __restrict__ w,
                     const float* __restrict__ vecs, float* __restrict__ out,
                     int n_rows, int patch, int n_blocks, int use_bn) {
  using T = Tile<C>;
  extern __shared__ float4 smem4[];
  float* a_s = reinterpret_cast<float*>(smem4);
  float* w_s = a_s + T::A_FLOATS;
  const int tid = threadIdx.x;
  const int rg = tid / 64;
  const int cg = tid % 64;
  const int row0 = blockIdx.x * BM + rg * ROWS;

  float xr[ROWS][T::COLS];
  embed_rows<C>(patches, w_pe, b_pe, patch, xr, a_s, rg, cg, tid, n_rows);
  resblock_chain<C>(xr, a_s, w_s, w, vecs, n_blocks, use_bn, rg, cg, tid);
  store_rows<C>(out, xr, row0, cg, n_rows);
}

template <int C>
__global__ void __launch_bounds__(THREADS, 1)
encoder_exit_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ vecs,
                    const float* __restrict__ w_sep,
                    const float* __restrict__ b_sep,
                    const float* __restrict__ codebook, int* __restrict__ ids,
                    int n_rows, int n_blocks, int use_bn, int d_emb,
                    int k_codes) {
  using T = Tile<C>;
  extern __shared__ float4 smem4[];
  float* a_s = reinterpret_cast<float*>(smem4);
  float* w_s = a_s + T::A_FLOATS;
  const int tid = threadIdx.x;
  const int rg = tid / 64;
  const int cg = tid % 64;
  const int row0 = blockIdx.x * BM + rg * ROWS;

  float xr[ROWS][T::COLS];
  load_rows<C>(x, xr, row0, cg, n_rows);
  resblock_chain<C>(xr, a_s, w_s, w, vecs, n_blocks, use_bn, rg, cg, tid);
  // a_s is free after the last resblock: stage the rows for sep_conv
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int j = 0; j < T::NJ; ++j)
      store4(a_s + (rg * ROWS + r) * C + j * 256 + cg * 4, xr[r][4 * j + 0],
             xr[r][4 * j + 1], xr[r][4 * j + 2], xr[r][4 * j + 3]);
  __syncthreads();
  nearest_rows<C>(a_s, w_s, w_sep, b_sep, codebook, ids, n_rows, d_emb,
                  k_codes, tid);
}

}  // namespace

extern "C" int encoder_entry_f32(const void* patches, const void* w_pe,
                                 const void* b_pe, const void* weights,
                                 const void* vecs, void* out, int n_rows,
                                 int patch, int c, int n_blocks, int use_bn,
                                 void* stream) {
  // hidden 512 only, as encoder_chain_f32; the staged patch rows must
  // fit the A tile
  if (c != 512 || patch < 1 || patch > 512) return cudaErrorInvalidValue;
  return launch_rows<512>(
      encoder_entry_kernel<512>, n_rows, static_cast<cudaStream_t>(stream),
      static_cast<const float*>(patches), static_cast<const float*>(w_pe),
      static_cast<const float*>(b_pe), static_cast<const float*>(weights),
      static_cast<const float*>(vecs), static_cast<float*>(out), n_rows,
      patch, n_blocks, use_bn);
}

extern "C" int encoder_exit_f32(const void* x, const void* weights,
                                const void* vecs, const void* w_sep,
                                const void* b_sep, const void* codebook,
                                void* ids, int n_rows, int c, int n_blocks,
                                int use_bn, int d_emb, int k_codes,
                                void* stream) {
  if (c != 512 || d_emb < 8 || d_emb > 64 || THREADS % d_emb || k_codes < 1 ||
      k_codes * (d_emb + 2) > Tile<512>::A_FLOATS)
    return cudaErrorInvalidValue;
  return launch_rows<512>(
      encoder_exit_kernel<512>, n_rows, static_cast<cudaStream_t>(stream),
      static_cast<const float*>(x), static_cast<const float*>(weights),
      static_cast<const float*>(vecs), static_cast<const float*>(w_sep),
      static_cast<const float*>(b_sep), static_cast<const float*>(codebook),
      static_cast<int*>(ids), n_rows, n_blocks, use_bn, d_emb, k_codes);
}
