// The eval-mode VQ-VAE encoder resblock on a row tile, on the FP32 CUDA
// cores: the device code of the encoder's two ends, #4 and #5
// (encoder_edges.cu). #1 and #3 (encoder_chain.cu, encoder_resblock.cu)
// run the resblock on the tensor cores instead (encoder_tc.cuh); the
// ends are written around this tile's register patch xr (embed_rows
// writes it, the exit's epilogue reads it and reuses the A tile for the
// codebook), and move onto the new tile in later work.
//
// Per resblock and row:
//   h = gelu(x) @ W1 + b1 [-> eval BN] -> gelu -> @ W2 + b2 [-> eval BN]
//   x = x + h
// all in f32 as plain FP32 FMAs on the CUDA cores, no TF32: the
// codebook ids downstream must stay comparable with the exact
// reference.
//
// What bounds it on an H100: FP32 FMA rate. At hidden 512 every
// resblock is 2 x 512 x 512 FMAs per row, about 1 MFMA, against 4 KB
// of row state; the weights (1 MB per matrix) come from L2.
//
// Design: a block owns BM = 32 whole rows (all C columns) for the whole
// chain, because each GEMM needs every column of the row before it.
// The residual stream x stays in registers (each thread owns an 8 x
// 4*NJ patch of it, the same patch it computes); the GEMM's A operand,
// gelu(x) or gelu(c1), is materialized once per GEMM in shared memory
// (BM x C f32, 64 KB at C = 512), so the GELU runs once per element,
// not once per use. W is streamed through a double-buffered shared
// tile of BK rows, with the next tile prefetched into registers while
// the current one is consumed. The bias, optional BN and the residual
// add run in the epilogue on the registers. The TPU kernels' 8-row
// padding has no counterpart: rows past N are masked.
#pragma once

#include "common.cuh"

namespace arcweld {
namespace enc {

constexpr int BM = 32;         // rows per block
constexpr int BK = 8;          // W rows per shared-memory stage
constexpr int THREADS = 256;   // 4 row groups x 64 column groups
constexpr int ROWS = 8;        // rows per thread

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

template <int C>
struct Tile {
  static constexpr int NJ = C / 256;        // float4 column groups per thread
  static constexpr int COLS = 4 * NJ;       // columns per thread
  static constexpr int W_F4 = BK * C / 4;   // float4 per W stage
  static constexpr int W_PER_T = W_F4 / THREADS;
  static constexpr int A_FLOATS = BM * C;       // the A tile
  static constexpr int W_FLOATS = 2 * BK * C;   // the two W stages
  static constexpr size_t SMEM = sizeof(float) * (A_FLOATS + W_FLOATS);
};

// acc[r][c] = sum_k A_s[row r][k] * W[k][col c] for this thread's patch.
template <int C>
__device__ __forceinline__ void gemm_tile(const float* __restrict__ a_s,
                                          float* __restrict__ w_s,
                                          const float* __restrict__ w,
                                          float (&acc)[ROWS][Tile<C>::COLS],
                                          int rg, int cg, int tid) {
  using T = Tile<C>;
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int c = 0; c < T::COLS; ++c) acc[r][c] = 0.0f;

  const float4* w4 = reinterpret_cast<const float4*>(w);
  float4 pre[T::W_PER_T];
#pragma unroll
  for (int i = 0; i < T::W_PER_T; ++i) pre[i] = w4[tid + i * THREADS];
#pragma unroll
  for (int i = 0; i < T::W_PER_T; ++i)
    reinterpret_cast<float4*>(w_s)[tid + i * THREADS] = pre[i];
  __syncthreads();

  constexpr int STAGES = C / BK;
  for (int s = 0; s < STAGES; ++s) {
    const float* cur = w_s + (s & 1) * BK * C;
    if (s + 1 < STAGES) {
#pragma unroll
      for (int i = 0; i < T::W_PER_T; ++i)
        pre[i] = w4[(s + 1) * T::W_F4 + tid + i * THREADS];
    }
    const int k0 = s * BK;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 a[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        a[r] = *reinterpret_cast<const float4*>(
            a_s + (rg * ROWS + r) * C + k0 + kk);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int j = 0; j < T::NJ; ++j) {
          const float4 b = *reinterpret_cast<const float4*>(
              cur + (kk + q) * C + j * 256 + cg * 4);
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            const float av = q == 0 ? a[r].x : q == 1 ? a[r].y
                           : q == 2 ? a[r].z : a[r].w;
            acc[r][4 * j + 0] = fmaf(av, b.x, acc[r][4 * j + 0]);
            acc[r][4 * j + 1] = fmaf(av, b.y, acc[r][4 * j + 1]);
            acc[r][4 * j + 2] = fmaf(av, b.z, acc[r][4 * j + 2]);
            acc[r][4 * j + 3] = fmaf(av, b.w, acc[r][4 * j + 3]);
          }
        }
      }
    }
    if (s + 1 < STAGES) {
      float* nxt = w_s + ((s + 1) & 1) * BK * C;
#pragma unroll
      for (int i = 0; i < T::W_PER_T; ++i)
        reinterpret_cast<float4*>(nxt)[tid + i * THREADS] = pre[i];
    }
    __syncthreads();
  }
}

// This thread's patch of rows row0.. of x (N, C); zeros past n_rows.
template <int C>
__device__ __forceinline__ void load_rows(const float* __restrict__ x,
                                          float (&xr)[ROWS][Tile<C>::COLS],
                                          int row0, int cg, int n_rows) {
  using T = Tile<C>;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = row0 + r;
#pragma unroll
    for (int j = 0; j < T::NJ; ++j) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < n_rows)
        v = *reinterpret_cast<const float4*>(x + (size_t)row * C + j * 256 +
                                             cg * 4);
      xr[r][4 * j + 0] = v.x;
      xr[r][4 * j + 1] = v.y;
      xr[r][4 * j + 2] = v.z;
      xr[r][4 * j + 3] = v.w;
    }
  }
}

template <int C>
__device__ __forceinline__ void store_rows(
    float* __restrict__ out, const float (&xr)[ROWS][Tile<C>::COLS], int row0,
    int cg, int n_rows) {
  using T = Tile<C>;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = row0 + r;
    if (row >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < T::NJ; ++j)
      *reinterpret_cast<float4*>(out + (size_t)row * C + j * 256 + cg * 4) =
          make_float4(xr[r][4 * j + 0], xr[r][4 * j + 1], xr[r][4 * j + 2],
                      xr[r][4 * j + 3]);
  }
}

// One resblock on the registers: xr += block(xr). w1, w2: (C, C) in
// (in, out) layout; v: its (10, C) vector rows [b1, bn1 mean, var,
// scale, bias, b2, bn2 mean, var, scale, bias]. Ends on a barrier of
// gemm_tile, so a_s and w_s are free when it returns.
template <int C>
__device__ __forceinline__ void resblock(
    float (&xr)[ROWS][Tile<C>::COLS], float (&acc)[ROWS][Tile<C>::COLS],
    float* __restrict__ a_s, float* __restrict__ w_s,
    const float* __restrict__ w1, const float* __restrict__ w2,
    const float* __restrict__ v, int use_bn, int rg, int cg, int tid) {
  using T = Tile<C>;
  // A = gelu(x)
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int j = 0; j < T::NJ; ++j)
      store4(a_s + (rg * ROWS + r) * C + j * 256 + cg * 4,
             gelu_erf(xr[r][4 * j + 0]), gelu_erf(xr[r][4 * j + 1]),
             gelu_erf(xr[r][4 * j + 2]), gelu_erf(xr[r][4 * j + 3]));
  __syncthreads();
  gemm_tile<C>(a_s, w_s, w1, acc, rg, cg, tid);
  // epilogue 1: + b1 [-> BN1] -> gelu, becomes the next A
#pragma unroll
  for (int j = 0; j < T::NJ; ++j) {
    const int c = j * 256 + cg * 4;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float h[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        h[e] = acc[r][4 * j + e] + v[c + e];
        if (use_bn)
          h[e] = norm_affine(h[e], v[C + c + e], v[2 * C + c + e],
                             v[3 * C + c + e], v[4 * C + c + e]);
        h[e] = gelu_erf(h[e]);
      }
      store4(a_s + (rg * ROWS + r) * C + c, h[0], h[1], h[2], h[3]);
    }
  }
  __syncthreads();
  gemm_tile<C>(a_s, w_s, w2, acc, rg, cg, tid);
  // epilogue 2: + b2 [-> BN2], residual add
#pragma unroll
  for (int j = 0; j < T::NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = j * 256 + cg * 4 + e;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float h = acc[r][4 * j + e] + v[5 * C + c];
        if (use_bn)
          h = norm_affine(h, v[6 * C + c], v[7 * C + c], v[8 * C + c],
                          v[9 * C + c]);
        xr[r][4 * j + e] = xr[r][4 * j + e] + h;
      }
    }
}

// n_blocks resblocks from the packed operands: w (2n, C, C), vecs (10n, C).
template <int C>
__device__ __forceinline__ void resblock_chain(
    float (&xr)[ROWS][Tile<C>::COLS], float* __restrict__ a_s,
    float* __restrict__ w_s, const float* __restrict__ w,
    const float* __restrict__ vecs, int n_blocks, int use_bn, int rg, int cg,
    int tid) {
  float acc[ROWS][Tile<C>::COLS];
  for (int blk = 0; blk < n_blocks; ++blk)
    resblock<C>(xr, acc, a_s, w_s, w + (size_t)(2 * blk) * C * C,
                w + (size_t)(2 * blk + 1) * C * C,
                vecs + (size_t)10 * blk * C, use_bn, rg, cg, tid);
}

// One block of THREADS per BM rows, with the tile's dynamic shared memory.
template <int C, typename Kernel, typename... Args>
cudaError_t launch_rows(Kernel kernel, int n_rows, cudaStream_t stream,
                        Args... args) {
  const size_t smem = Tile<C>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<(n_rows + BM - 1) / BM, THREADS, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace enc
}  // namespace arcweld
