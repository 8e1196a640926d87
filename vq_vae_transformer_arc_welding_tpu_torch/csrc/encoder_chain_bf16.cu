// encoder_chain_bf16: n eval-mode VQ-VAE encoder resblocks on a row tile,
// with both products of every resblock on the bf16 tensor cores.
//
// Replaces vq_vae_transformer_arc_welding_tpu/ops/pallas_encoder.py::
// fused_encoder_eval with compute_dtype=bfloat16 (_resblock_chain's
// `cdt`, :209-232; pallas_call at :311). Per resblock and row:
//   h = gelu(x)            f32, exact erf
//   c = bf16(h) @ W1 + b1  bf16 x bf16 products summed in f32 [-> eval BN]
//   h = gelu(c)            f32
//   c = bf16(h) @ W2 + b2  the same [-> eval BN]
//   x = x + c              f32
// x (N, C) f32 in and out; W (2n, C, C) bf16 in (in, out) layout, cast
// once by the caller; vecs (10n, C) f32. Only the products' inputs are
// rounded (round to nearest even); FMA contraction is allowed, the
// contract is a tolerance against the plain version, not bit equality.
//
// What bounds it on an H100: bf16 tensor-core rate. A resblock is
// 2 x 2 x 512 x 512 operations per row against 4 KB of row state, and
// the 8.4 MB of weights of all eight resblocks come from L2.
//
// Design: a block owns BM = 64 whole rows for the whole chain (each
// product needs every column of the row before it) and runs 32 warps
// on them. The product's A operand, gelu(.) already rounded to bf16,
// sits in shared memory (65 KB, half an f32 tile's size per row); W is
// streamed from L2 by cp.async through a ring of two stages of BK = 64
// rows, one on its way while the other is multiplied. The weights of a
// call are contiguous, so the ring runs on through the epilogues into
// the next product's W. The f32 residual stream is not kept in shared
// memory: the block reads its rows where the residual is added and
// writes them back, 128 KB that only this block touches and that stay
// in L2 from one resblock to the next.
// The warps form a 2 x 16 grid of 32 x 32 output tiles: per k step of
// 16 a warp loads two A fragments (ldmatrix) and two pairs of B
// fragments (ldmatrix.trans, which turns the row-major (k, n) tile into
// the column fragments mma wants) for 8 mma.sync.m16n8k16. The 32
// accumulators of a thread are a fragment: rows g and g + 8, column
// pairs 2t of each 8-column tile, so bias, BN, gelu and the residual
// add are written for that layout. Rows of A and W are padded by 16
// bytes so that the eight rows of an ldmatrix fall on distinct banks.
// Why 32 warps: with 8 warps of 64 x 64 tiles (128 accumulators a
// thread, the fewest shared-memory reads per product) the same call
// takes 2.8 ms where this takes 1.6 (H100, 25,600 rows, 8 resblocks):
// the gelu of the epilogues, a serial chain per element, costs 1.3 ms
// of it with two warps a scheduler to hide it, and 0.2 here. A deeper
// ring (up to nine stages) measures no faster: the W stream is not
// what the block waits for. scripts/bench_encoder_bf16_variants.py
// rewrites the constants below and times the variants in turns.
//
// Not yet done (later work): wgmma with TMA (every warp row re-reads B
// and every warp column A from shared memory here), W shared by a
// cluster, a persistent grid (400 blocks of 64 rows make 3.03 waves on
// 132 SMs, and the fourth costs a quarter of the time).
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

using namespace arcweld;
using bf16 = __nv_bfloat16;

constexpr int C = 512;          // hidden width the kernel is built for
constexpr int BM = 64;          // rows per block
constexpr int BK = 64;          // W rows per stage
constexpr int STAGES = 2;       // ring of W stages
constexpr int THREADS = 1024;
constexpr int WARPS_M = 2;      // warps along the rows
constexpr int WARPS_N = THREADS / 32 / WARPS_M;
constexpr int WM = BM / WARPS_M;              // rows per warp
constexpr int WN = C / WARPS_N;               // output columns per warp
constexpr int MT = WM / 16;                   // 16-row mma tiles per warp
constexpr int NT = WN / 8;                    // 8-column mma tiles per warp
constexpr int LD = C + 8;       // padded row of A and of a W stage, in bf16
constexpr int A_ELEMS = BM * LD;
constexpr int W_ELEMS = BK * LD;
constexpr int K_STAGES = C / BK;              // stages per product
constexpr size_t SMEM = sizeof(bf16) * (A_ELEMS + STAGES * W_ELEMS);
static_assert(BK % 16 == 0 && C % BK == 0 && STAGES >= 2, "stage shape");
static_assert(NT % 2 == 0 && NT * 8 * WARPS_N == C && MT * 16 * WARPS_M == BM,
              "warp tile");
static_assert(BK * C / 8 % THREADS == 0, "16-byte pieces per thread");
static_assert(SMEM <= 232448, "shared memory of one block");

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `Pending` of this thread's newest groups are in flight.
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// Four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8. r[i] holds matrix i's (row g, columns 2t, 2t + 1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The same, each matrix transposed: r[i] holds matrix i's (rows 2t,
// 2t + 1, column g), the B fragment of a row-major (k, n) tile.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The call's W as one stream of stages: stage g holds rows g * BK .. of
// the (2 n_blocks * C, C) weights and goes to ring slot g % STAGES. One
// commit group per call, an empty one past the stream's end, so that
// the groups can be counted.
__device__ __forceinline__ void fetch_stage(const bf16* __restrict__ w,
                                            bf16* __restrict__ w_s, int g,
                                            int n_stages, int tid) {
  if (g < n_stages) {
    bf16* dst = w_s + (g % STAGES) * W_ELEMS;
    const bf16* src = w + (size_t)g * BK * C;
#pragma unroll
    for (int i = 0; i < BK * C / 8 / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int row = idx >> 6, piece = idx & 63;
      cp_async16(dst + row * LD + piece * 8, src + row * C + piece * 8);
    }
  }
  cp_async_commit();
}

// acc = A_s (BM x C) @ W (C x C) for this warp's WM x WN tile, W being
// stages g0 .. g0 + K_STAGES - 1 of the stream, of which STAGES - 1 are
// already on their way. Every step starts on a barrier (the first one
// makes A_s visible) and the product ends on one, so that A_s is free
// when it returns.
__device__ __forceinline__ void gemm(const bf16* __restrict__ a_s,
                                     bf16* __restrict__ w_s,
                                     const bf16* __restrict__ w, int g0,
                                     int n_stages, float (&acc)[MT][NT][4],
                                     int warp_m, int warp_n, int lane,
                                     int tid) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

  const int lrow = lane & 15, lcol = (lane >> 4) * 8;
  for (int s = 0; s < K_STAGES; ++s) {
    const int g = g0 + s;
    // stage g has landed for this thread once all but the STAGES - 2
    // groups after it have ended; after the barrier it has for every
    // thread, and every warp is done with stage g - 1, whose slot the
    // next copy overwrites
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    fetch_stage(w, w_s, g + STAGES - 1, n_stages, tid);
    const bf16* ws = w_s + (g % STAGES) * W_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(a[mt], a_s + (warp_m * WM + mt * 16 + lrow) * LD +
                               s * BK + kk + lcol);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, ws + (kk + lrow) * LD + warp_n * WN + np * 16 + lcol);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS, 1)
encoder_chain_bf16_kernel(const float* __restrict__ x,
                          const bf16* __restrict__ w,
                          const float* __restrict__ vecs,
                          float* out, int n_rows, int n_blocks,
                          int use_bn) {
  extern __shared__ float4 smem4[];
  bf16* a_s = reinterpret_cast<bf16*>(smem4);   // BM x LD
  bf16* w_s = a_s + A_ELEMS;                     // STAGES x BK x LD

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int warp_m = warp % WARPS_M, warp_n = warp / WARPS_M;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * BM;
  const int n_stages = 2 * n_blocks * K_STAGES;

  for (int s = 0; s < STAGES - 1; ++s) fetch_stage(w, w_s, s, n_stages, tid);

  // the first product's A = bf16(gelu(x)); zeros past N
  for (int i = tid; i < BM * C / 4; i += THREADS) {
    const int row = i >> 7, c4 = i & 127;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + row < n_rows)
      v = *reinterpret_cast<const float4*>(x + (size_t)(row0 + row) * C +
                                           c4 * 4);
    *reinterpret_cast<uint2*>(a_s + row * LD + c4 * 4) =
        make_uint2(pack_bf16(gelu_erf(v.x), gelu_erf(v.y)),
                   pack_bf16(gelu_erf(v.z), gelu_erf(v.w)));
  }

  float acc[MT][NT][4];
  for (int blk = 0; blk < n_blocks; ++blk) {
    const float* v = vecs + (size_t)10 * blk * C;
    // the residual stream: the input for the first resblock, then the
    // rows this block wrote to `out` for the resblock before
    const float* res = blk == 0 ? x : out;

    gemm(a_s, w_s, w, 2 * blk * K_STAGES, n_stages, acc, warp_m, warp_n, lane, tid);
    // epilogue 1 on the fragment: + b1 [-> BN1] -> gelu -> the next A
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = warp_n * WN + nt * 8 + 2 * t;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = warp_m * WM + mt * 16 + g + 8 * half;
          float h[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            h[e] = acc[mt][nt][2 * half + e] + v[c + e];
            if (use_bn)
              h[e] = norm_affine(h[e], v[C + c + e], v[2 * C + c + e],
                                 v[3 * C + c + e], v[4 * C + c + e]);
            h[e] = gelu_erf(h[e]);
          }
          *reinterpret_cast<uint32_t*>(a_s + row * LD + c) =
              pack_bf16(h[0], h[1]);
        }
    }

    gemm(a_s, w_s, w, (2 * blk + 1) * K_STAGES, n_stages, acc, warp_m, warp_n,
         lane, tid);
    // epilogue 2: + b2 [-> BN2], the residual add, out, and the next
    // resblock's A = bf16(gelu(x))
    const bool more = blk + 1 < n_blocks;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = warp_n * WN + nt * 8 + 2 * t;
      // the tile's eight residual pairs first, all in flight together:
      // the loads could not pass the stores to `out` between them
      float2 xv[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = row0 + warp_m * WM + mt * 16 + g + 8 * half;
          xv[mt][half] = row < n_rows
              ? *reinterpret_cast<const float2*>(res + (size_t)row * C + c)
              : make_float2(0.f, 0.f);
        }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = warp_m * WM + mt * 16 + g + 8 * half;
          float h[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            h[e] = acc[mt][nt][2 * half + e] + v[5 * C + c + e];
            if (use_bn)
              h[e] = norm_affine(h[e], v[6 * C + c + e], v[7 * C + c + e],
                                 v[8 * C + c + e], v[9 * C + c + e]);
          }
          const float2 y = make_float2(xv[mt][half].x + h[0],
                                       xv[mt][half].y + h[1]);
          if (row0 + row < n_rows)
            *reinterpret_cast<float2*>(out + (size_t)(row0 + row) * C + c) =
                y;
          if (more)
            *reinterpret_cast<uint32_t*>(a_s + row * LD + c) =
                pack_bf16(gelu_erf(y.x), gelu_erf(y.y));
        }
    }
  }
  cp_async_wait<0>();
}

}  // namespace

extern "C" int encoder_chain_bf16(const void* x, const void* weights,
                                  const void* vecs, void* out, int n_rows,
                                  int c, int n_blocks, int use_bn,
                                  void* stream) {
  // hidden 512, the bench model's width, as the f32 chain
  if (c != C) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      encoder_chain_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM);
  if (e != cudaSuccess) return e;
  encoder_chain_bf16_kernel<<<(n_rows + BM - 1) / BM, THREADS, SMEM,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const bf16*>(weights),
      static_cast<const float*>(vecs), static_cast<float*>(out), n_rows,
      n_blocks, use_bn);
  return cudaGetLastError();
}
