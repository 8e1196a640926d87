// encoder_chain_f32: n eval-mode VQ-VAE encoder resblocks on a row tile.
//
// Replaces vq_vae_transformer_arc_welding_tpu/ops/pallas_encoder.py::
// fused_encoder_eval (pallas_call at :311). Per resblock and row:
//   h = gelu(x) @ W1 + b1 [-> eval BN] -> gelu -> @ W2 + b2 [-> eval BN]
//   x = x + h
// all in f32, no TF32: the codebook ids downstream must stay
// comparable with the exact reference, so the products are plain FP32
// FMAs on the CUDA cores.
//
// What bounds it on an H100: FP32 FMA issue. At hidden 512 every
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
// add run in the epilogue on the registers. The TPU kernel's 8-row
// padding has no counterpart: rows past N are masked.
//
// Not yet done (later work): tensor cores would need TF32 or bf16 and
// so break the exact-id contract; 3xTF32 splitting is the candidate.
#include "common.cuh"

namespace {

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
  static constexpr size_t SMEM = sizeof(float) * (BM * C + 2 * BK * C);
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

template <int C>
__global__ void __launch_bounds__(THREADS, 1)
encoder_chain_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ vecs, float* __restrict__ out,
                     int n_rows, int n_blocks, int use_bn) {
  using T = Tile<C>;
  extern __shared__ float4 smem4[];
  float* a_s = reinterpret_cast<float*>(smem4);   // BM x C
  float* w_s = a_s + BM * C;                       // 2 x BK x C

  const int tid = threadIdx.x;
  const int rg = tid / 64;   // uniform across a warp: A reads broadcast
  const int cg = tid % 64;
  const int row0 = blockIdx.x * BM + rg * ROWS;

  float xr[ROWS][T::COLS];
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

  float acc[ROWS][T::COLS];
  for (int blk = 0; blk < n_blocks; ++blk) {
    const float* v = vecs + (size_t)10 * blk * C;
    // A = gelu(x)
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int j = 0; j < T::NJ; ++j)
        store4(a_s + (rg * ROWS + r) * C + j * 256 + cg * 4,
               arcweld::gelu_erf(xr[r][4 * j + 0]),
               arcweld::gelu_erf(xr[r][4 * j + 1]),
               arcweld::gelu_erf(xr[r][4 * j + 2]),
               arcweld::gelu_erf(xr[r][4 * j + 3]));
    __syncthreads();
    gemm_tile<C>(a_s, w_s, w + (size_t)(2 * blk) * C * C, acc, rg, cg, tid);
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
            h[e] = arcweld::norm_affine(h[e], v[C + c + e], v[2 * C + c + e],
                                        v[3 * C + c + e], v[4 * C + c + e]);
          h[e] = arcweld::gelu_erf(h[e]);
        }
        store4(a_s + (rg * ROWS + r) * C + c, h[0], h[1], h[2], h[3]);
      }
    }
    __syncthreads();
    gemm_tile<C>(a_s, w_s, w + (size_t)(2 * blk + 1) * C * C, acc, rg, cg,
                 tid);
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
            h = arcweld::norm_affine(h, v[6 * C + c], v[7 * C + c],
                                     v[8 * C + c], v[9 * C + c]);
          xr[r][4 * j + e] = xr[r][4 * j + e] + h;
        }
      }
  }

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

template <int C>
cudaError_t launch(const float* x, const float* w, const float* vecs,
                   float* out, int n_rows, int n_blocks, int use_bn,
                   cudaStream_t stream) {
  const size_t smem = Tile<C>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      encoder_chain_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const int grid = (n_rows + BM - 1) / BM;
  encoder_chain_kernel<C><<<grid, THREADS, smem, stream>>>(
      x, w, vecs, out, n_rows, n_blocks, use_bn);
  return cudaGetLastError();
}

}  // namespace

extern "C" int encoder_chain_f32(const void* x, const void* weights,
                                 const void* vecs, void* out, int n_rows,
                                 int c, int n_blocks, int use_bn,
                                 void* stream) {
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(weights);
  const float* vf = static_cast<const float*>(vecs);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // hidden 512, the bench model's width; another width needs its own
  // instantiation (C a multiple of 256)
  if (c != 512) return cudaErrorInvalidValue;
  return launch<512>(xf, wf, vf, of, n_rows, n_blocks, use_bn, s);
}

extern "C" const char* arcweld_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
