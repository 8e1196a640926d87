// The VQ-VAE encoder's resblocks where the f32 tile (encoder_tc.cuh,
// hidden 1 to 512) and 1b's tile (encoder_chain_bf16.cu, hidden 512)
// do not run: in f32 above hidden 512, in bf16 at every hidden width but
// 512, with the encoder's two ends in f32 above 512.
//
// Replaces, at those widths, vq_vae_transformer_arc_welding_tpu/ops/
// pallas_encoder.py::fused_encoder_eval (pallas_call at :311; with
// compute_dtype=bfloat16 too), fused_resblock_eval (:106),
// fused_encoder_entry_eval (:404) and fused_encoder_exit_eval (:436):
//   encoder_wide_f32 / encoder_wide_bf16: n resblocks on (N, C) rows
//   encoder_wide_entry_f32: patch-embed, then n resblocks
//   encoder_wide_exit_f32:  n resblocks, sep_conv, the nearest code
// Per resblock and row, in f32 (common.cuh's rounding rules):
//   h = gelu(gelu(x) @ W1 + b1 [-> eval BN])
//   x = x + (h @ W2 + b2 [-> eval BN])
// The products in split TF32 (A_lo W_hi + A_hi W_lo + A_hi W_hi a k
// step, the f32 tile's three terms: f32 accuracy), or with both inputs
// rounded to bf16 (to nearest even) and summed in f32 (1b's contract).
//
// What bounds it on an H100: the products. At hidden 1,024 a resblock
// is 2 x 1,024 x 1,024 multiply-adds a row: 322 GFLOP of TF32 (three
// terms) at 25,600 rows, 0.65 ms at 495 TFLOP/s, against 0.21 GB of rows
// and weights (0.06 ms at 3.35 TB/s).
//
// Design, and why: one launch a product, h in device memory between the
// two products of a resblock. The f32 tile keeps a 64-row tile's A (all
// C columns) in one block's shared memory for the whole chain; above
// 512 that is 256 KB and more, which no block holds. Its own notes leave
// a cluster for that (a block per 512 columns, A's other columns read
// through distributed shared memory, cluster barriers around each
// product's epilogue), but its producer warpgroup would have to join or
// be kept out of every cluster barrier, and a fault there hangs the card.
// This kernel is the simple one the widths need first: each block
// computes a 64 x 128 tile of one product, A and W coming through
// shared memory in chunks of 32 of K (the next chunk's loads in flight
// in registers while the tensor cores multiply this one), mma.sync
// m16n8k8 TF32 or m16n8k16 bf16 from eight warps of 32 x 32 (four of
// 32 x 64 took 255 registers and spilled), and a rolled epilogue over
// the stashed tile. Each element of a chunk is converted once, as it is
// stored: split into its TF32 hi and lo terms, or rounded to bf16 (W
// comes as bf16 and is stored as it is). The fragments are read as
// they lie by ldmatrix: A's (a TF32 fragment is four 8 x 4-word
// matrices), f32 W's from W stored transposed, bf16 W's by
// ldmatrix.trans. Converting at each fragment read instead did it once
// per warp that reads it (four for A, two for W) and set the kernel's
// time (3.1x in bf16, 1.2x in f32 at hidden 1,024: PERF.md, from
// scripts/bench_encoder_wide.py). What it costs against the tile: every
// product reads its A (N x C) and writes its output from and to device
// memory (three (N, C) passes a resblock beside the tile's two a
// group), the GELU of A is made again by each of the C / 128 column
// blocks, and mma.sync runs below wgmma's rate. PERF.md has its times
// beside its bound.
//
// Widths: any C from 1; K and the columns past C are zeros (loads past
// the row are not made), so no row needs any alignment. The ends:
// the patch-embed as FP32 FMAs in index order from zero, then the bias
// (#4's prologue in encoder_edges.cu); sep_conv the same, and the
// nearest code by code_scan.cuh, as #5's epilogue.
#include <cuda_bf16.h>

#include <mutex>
#include <type_traits>

#include "code_scan.cuh"
#include "common.cuh"

namespace {

using namespace arcweld;
namespace scan = arcweld::code_scan;

constexpr int BM = 64;        // rows a block
constexpr int BN = 128;       // output columns a block
constexpr int BK = 32;        // K a chunk
constexpr int THREADS = 256;  // eight warps, 2 x 4, of 32 rows x 32 columns
// blocks an SM, so that one stores its chunk while another multiplies:
// bf16 fits two in 128 registers a thread; split TF32 at 128 spills
// (184 bytes, ptxas) and runs one
constexpr int BF16_BLOCKS = 2, F32_BLOCKS = 1;
constexpr int A_LOADS = BM * BK / THREADS;   // 8 a thread, a row each
constexpr int W_LOADS = BK * BN / THREADS;   // 16 a thread
static_assert(A_LOADS * (THREADS / 32) == BM && BN * 2 == THREADS,
              "a chunk's loads: a warp's rows of A, two threads a W column");
constexpr int O_PITCH = BN + 4;   // the stashed output tile, in floats

// A chunk's operands in shared memory, each converted once, as it is
// stored. Split TF32: A's and W's hi and lo terms, 32-bit words, A as
// rows of k and W transposed, rows of n, both of BK + 4 words (eight
// 16-byte ldmatrix rows on distinct banks; W's stores, 8 n by 4 k a
// warp, likewise). bf16: A and W rounded to bf16, A rows of BK + 8 and
// W rows (k) of BN + 8 elements (16-byte rows, eight of them on
// distinct banks for ldmatrix and ldmatrix.trans). The output tile
// reuses the space.
template <bool BF16>
struct Chunk {
  using T = std::conditional_t<BF16, __nv_bfloat16, uint32_t>;
  static constexpr int TERMS = BF16 ? 1 : 2;
  static constexpr int A_PITCH = BF16 ? BK + 8 : BK + 4;
  static constexpr int W_PITCH = BF16 ? BN + 8 : BK + 4;
  static constexpr int A_ELEMS = BM * A_PITCH;
  static constexpr int W_ELEMS = (BF16 ? BK : BN) * W_PITCH;
  static constexpr int BYTES =
      (int)sizeof(T) * TERMS * (A_ELEMS + W_ELEMS);
  static constexpr int SMEM = BYTES > (int)sizeof(float) * BM * O_PITCH
                                  ? BYTES
                                  : (int)sizeof(float) * BM * O_PITCH;
  static_assert(A_PITCH * sizeof(T) % 16 == 0 && W_PITCH * sizeof(T) % 16 == 0,
                "ldmatrix rows are 16-byte aligned");
};

__device__ __forceinline__ uint32_t tf32_of(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// hi = cvt.rna.tf32(v), lo = cvt.rna.tf32(v - hi); v - hi is exact
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_of(v);
  lo = tf32_of(__fsub_rn(v, __uint_as_float(hi)));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8 x 8 b16 matrices (8 x 4 32-bit words: a TF32 fragment's
// quarter); lanes 8 i .. 8 i + 7 give matrix i's row addresses,
// register i holds matrix i (.trans: transposed)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16 x 8 TF32) * b (8 x 8 TF32)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16 x 16 bf16) * b (16 x 8 bf16)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One product of a resblock on a 64 x 128 output tile (blockIdx.x:
// row tile * column tiles + column tile). FIRST: A = gelu(a), a the
// residual stream, and dst = gelu(A @ W + b [-> BN]) (h); otherwise
// A = a (h) and dst = resid + (A @ W + b [-> BN]), resid the residual
// stream (dst may be resid: each element is read, then written, by one
// thread). a, resid, dst: (N, cw) f32; w (cw, cw) in (in, out) layout,
// f32 (split TF32) or bf16; vr: the product's vector rows (b, and BN's
// mean, var, scale and bias), rows of cw.
template <typename W, bool FIRST, bool USE_BN>
__global__ void __launch_bounds__(THREADS,
                                  sizeof(W) == 2 ? BF16_BLOCKS : F32_BLOCKS)
product_kernel(const float* a, const W* __restrict__ w,
               const float* __restrict__ vr, const float* resid, float* dst,
               int n_rows, int cw) {
  constexpr bool BF16 = sizeof(W) == 2;
  using CK = Chunk<BF16>;
  using T = typename CK::T;
  constexpr int AP = CK::A_PITCH, WP = CK::W_PITCH;
  extern __shared__ float4 smem4[];
  T* const a_s = reinterpret_cast<T*>(smem4);       // [TERMS][BM][AP]
  T* const w_s = a_s + CK::TERMS * CK::A_ELEMS;  // [TERMS][BK][WP], f32 [BN]
  const int col_tiles = (cw + BN - 1) / BN;
  const int row0 = blockIdx.x / col_tiles * BM;
  const int col0 = blockIdx.x % col_tiles * BN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int wr = warp / 4 * 32, wc = warp % 4 * 32;   // the warp's tile
  constexpr int NT = 4;                                // its 8-column tiles
  // ldmatrix's row of the lane: rows 0-15 of a 16-row block, then the
  // next 16-byte column
  const int lrow = lane % 16, lcol = lane / 16;

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

  // the next chunk in registers: A rows warp * A_LOADS + i at k0 +
  // lane, W's j-th element of the thread at (k0 + w_k(j), col0 +
  // w_n(j)); zeros past the matrices. bf16: rows of k, two threads a
  // column; f32: 8 x 4 blocks of (n, k), a warp's 4 rows of 8 columns
  // (transposed as they are stored)
  float ra[A_LOADS];
  W rw[W_LOADS];
  const int wk = tid / BN, wn = tid % BN;
  auto w_k = [&](int j) {
    return BF16 ? 2 * j + wk : (j * 8 + warp) / 16 * 4 + lane % 4;
  };
  auto w_n = [&](int j) {
    return BF16 ? wn : (j * 8 + warp) % 16 * 8 + lane / 4;
  };
  auto load = [&](int k0) {
    const int k = k0 + lane;
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const int row = row0 + warp * A_LOADS + i;
      ra[i] = row < n_rows && k < cw ? a[(size_t)row * cw + k] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < W_LOADS; ++j) {
      const int kj = k0 + w_k(j), n = col0 + w_n(j);
      rw[j] = kj < cw && n < cw ? w[(size_t)kj * cw + n] : W(0.0f);
    }
  };
  load(0);
  for (int k0 = 0; k0 < cw; k0 += BK) {
    // the chunk into shared memory, each element converted here once
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const float v = FIRST ? gelu_erf(ra[i]) : ra[i];
      const int at = (warp * A_LOADS + i) * AP + lane;
      if constexpr (BF16) {
        a_s[at] = __float2bfloat16_rn(v);
      } else {
        split_tf32(v, a_s[at], a_s[CK::A_ELEMS + at]);
      }
    }
#pragma unroll
    for (int j = 0; j < W_LOADS; ++j) {
      if constexpr (BF16) {
        w_s[w_k(j) * WP + w_n(j)] = rw[j];
      } else {
        const int at = w_n(j) * WP + w_k(j);
        split_tf32(rw[j], w_s[at], w_s[CK::W_ELEMS + at]);
      }
    }
    __syncthreads();
    if (k0 + BK < cw) load(k0 + BK);
    if constexpr (BF16) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t af[2][4], bf[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldsm_x4(af[mt], a_s + (wr + mt * 16 + lrow) * AP + kk + 8 * lcol);
        // two 8-column tiles an ldmatrix: k 0-7 and 8-15 of each
#pragma unroll
        for (int np = 0; np < NT / 2; ++np)
          ldsm_x4_trans(bf[np], w_s + (kk + lrow) * WP + wc +
                                    (2 * np + lcol) * 8);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            mma_bf16(acc[mt][nt], af[mt], bf[nt / 2][nt % 2 * 2],
                     bf[nt / 2][nt % 2 * 2 + 1]);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 8) {
        // a TF32 fragment is four 8 x 4-word matrices: rows 0-7 and
        // 8-15 at k 0-3, then at k 4-7
        uint32_t ahi[2][4], alo[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const T* p = a_s + (wr + mt * 16 + lrow) * AP + kk + 4 * lcol;
          ldsm_x4(ahi[mt], p);
          ldsm_x4(alo[mt], p + CK::A_ELEMS);
        }
        // and B's as 8 x 4-word matrices of W's rows (n): two 8-column
        // tiles an ldmatrix, k 0-3 and 4-7 of each
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          const T* q = w_s + (wc + (2 * np + lcol) * 8 + lane % 8) * WP + kk +
                       lane / 8 % 2 * 4;
          uint32_t bhi[4], blo[4];
          ldsm_x4(bhi, q);
          ldsm_x4(blo, q + CK::W_ELEMS);
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              float (&d)[4] = acc[mt][2 * np + h];
              mma_tf32(d, alo[mt], bhi[2 * h], bhi[2 * h + 1]);
              mma_tf32(d, ahi[mt], blo[2 * h], blo[2 * h + 1]);
              mma_tf32(d, ahi[mt], bhi[2 * h], bhi[2 * h + 1]);
            }
        }
      }
    }
    __syncthreads();  // the chunk is read: the next one may be stored
  }

  // the tile into shared memory as it is, then one column and every
  // other row a thread
  float* const o_s = reinterpret_cast<float*>(smem4);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int r = wr + mt * 16 + g, c = wc + nt * 8 + 2 * tq;
      o_s[r * O_PITCH + c] = acc[mt][nt][0];
      o_s[r * O_PITCH + c + 1] = acc[mt][nt][1];
      o_s[(r + 8) * O_PITCH + c] = acc[mt][nt][2];
      o_s[(r + 8) * O_PITCH + c + 1] = acc[mt][nt][3];
    }
  __syncthreads();
  const int col = col0 + wn;
  if (col >= cw) return;
  const float b = vr[col];
  float mean = 0.f, var = 0.f, sc = 0.f, bi = 0.f;
  if (USE_BN) {
    mean = vr[cw + col];
    var = vr[2 * cw + col];
    sc = vr[3 * cw + col];
    bi = vr[4 * cw + col];
  }
  const int rows = n_rows - row0 < BM ? n_rows - row0 : BM;
  for (int r = wk; r < rows; r += THREADS / BN) {
    float y = o_s[r * O_PITCH + wn] + b;
    if (USE_BN) y = norm_affine(y, mean, var, sc, bi);
    const size_t at = (size_t)(row0 + r) * cw + col;
    dst[at] = FIRST ? gelu_erf(y) : resid[at] + y;
  }
}

// a kernel's dynamic shared memory raised to `smem` once a device
// (it is fixed for each kernel)
template <auto Kernel>
cudaError_t allow_smem(size_t smem) {
  constexpr int MAX_DEVICES = 64;
  static std::once_flag once[MAX_DEVICES];
  static cudaError_t err[MAX_DEVICES];
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::call_once(once[dev], [dev, smem] {
    err[dev] = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  });
  return err[dev];
}

// out = patches @ w_pe + b_pe: FMAs in index order from zero, then the
// bias; a thread an output
__global__ void __launch_bounds__(256)
embed_kernel(const float* __restrict__ patches, const float* __restrict__ w_pe,
             const float* __restrict__ b_pe, float* __restrict__ out,
             int n_rows, int patch, int cw) {
  const size_t i = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= (size_t)n_rows * cw) return;
  const int row = (int)(i / cw), col = (int)(i % cw);
  float acc = 0.0f;
  for (int k = 0; k < patch; ++k)
    acc = fmaf(__ldg(patches + (size_t)row * patch + k),
               __ldg(w_pe + (size_t)k * cw + col), acc);
  out[i] = acc + __ldg(b_pe + col);
}

// the floats of the exit kernel's shared memory: z and the codebook's
// chunks, as the f32 tile's exit has them (its A tile at width 512)
constexpr int EXIT_FLOATS = BM * 512;
constexpr int X_PITCH = 32 + 4;   // x staged 32 of K a row
static_assert(scan::ROWS == BM, "the scan's rows are a block's");

// ids of 64 rows a block: z = x @ w_sep + b_sep (FMAs in index order from
// zero, as #5's epilogue: column slices of DS, x staged through shared
// memory 32 of K at a time), then code_scan::scan_codes. x (N, cw),
// w_sep (cw, d_emb), b_sep (d_emb,), codebook (k_codes, d_emb).
template <int DP>
__global__ void __launch_bounds__(scan::THREADS, 1)
exit_kernel(const float* __restrict__ x, const float* __restrict__ w_sep,
            const float* __restrict__ b_sep, const float* __restrict__ codebook,
            int* __restrict__ ids, int n_rows, int cw, int d_emb,
            int k_codes) {
  constexpr int DS = DP < 64 ? DP : 64;
  constexpr int S = DP / DS;
  constexpr int RSTEP = scan::THREADS / DS;
  constexpr int NZ = BM / RSTEP;
  static_assert(NZ * RSTEP == BM, "z's rows");
  extern __shared__ float4 smem4[];
  float* const sm = reinterpret_cast<float*>(smem4);
  float* const x_s = sm;
  const int row0 = blockIdx.x * BM;
  const int ct = threadIdx.x;
  const int dcol = ct % DS, r0 = ct / DS;
  float zacc[S][NZ];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int col = s * DS + dcol;
    const bool live = col < d_emb;
#pragma unroll
    for (int i = 0; i < NZ; ++i) zacc[s][i] = 0.0f;
    for (int k0 = 0; k0 < cw; k0 += 32) {
      __syncthreads();  // the staged rows before are read
      const int k = k0 + ct % 32;
#pragma unroll
      for (int i = 0; i < BM / 8; ++i) {
        const int row = i * 8 + ct / 32;
        x_s[row * X_PITCH + ct % 32] =
            row0 + row < n_rows && k < cw ? x[(size_t)(row0 + row) * cw + k]
                                          : 0.0f;
      }
      float w[32];
#pragma unroll
      for (int j = 0; j < 32; ++j)
        w[j] = live && k0 + j < cw ? __ldg(w_sep + (size_t)(k0 + j) * d_emb
                                           + col)
                                   : 0.0f;
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < 32; ++kk)
#pragma unroll
        for (int i = 0; i < NZ; ++i)
          zacc[s][i] =
              fmaf(x_s[(r0 + i * RSTEP) * X_PITCH + kk], w[kk], zacc[s][i]);
    }
  }
  __syncthreads();  // x_s is read: z takes its place
  float* const z_s = sm;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int col = s * DS + dcol;
    const float bias = col < d_emb ? __ldg(b_sep + col) : 0.0f;
#pragma unroll
    for (int i = 0; i < NZ; ++i)
      z_s[(r0 + i * RSTEP) * DP + col] = zacc[s][i] + bias;
  }
  scan::scan_codes<DP>(z_s, sm + BM * DP, scan::chunk_codes(DP, EXIT_FLOATS),
                       codebook, ids, row0, n_rows, d_emb, k_codes, ct);
}

template <int DP>
cudaError_t launch_exit(const float* x, const float* w_sep,
                        const float* b_sep, const float* codebook, int* ids,
                        int n_rows, int cw, int d_emb, int k_codes,
                        cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * EXIT_FLOATS;
  cudaError_t e = allow_smem<exit_kernel<DP>>(smem);
  if (e != cudaSuccess) return e;
  exit_kernel<DP><<<(n_rows + BM - 1) / BM, scan::THREADS, smem, stream>>>(
      x, w_sep, b_sep, codebook, ids, n_rows, cw, d_emb, k_codes);
  return cudaGetLastError();
}

template <typename W, bool FIRST>
cudaError_t launch_product(const float* a, const W* w, const float* vr,
                           const float* resid, float* dst, int n_rows,
                           int cw, int use_bn, cudaStream_t stream) {
  constexpr int smem = Chunk<sizeof(W) == 2>::SMEM;
  const size_t blocks = (size_t)((n_rows + BM - 1) / BM) * ((cw + BN - 1) / BN);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  cudaError_t e = use_bn ? allow_smem<product_kernel<W, FIRST, true>>(smem)
                         : allow_smem<product_kernel<W, FIRST, false>>(smem);
  if (e != cudaSuccess) return e;
  if (use_bn)
    product_kernel<W, FIRST, true><<<(unsigned)blocks, THREADS, smem, stream>>>(
        a, w, vr, resid, dst, n_rows, cw);
  else
    product_kernel<W, FIRST, false><<<(unsigned)blocks, THREADS, smem, stream>>>(
        a, w, vr, resid, dst, n_rows, cw);
  return cudaGetLastError();
}

// n_blocks resblocks on x into out (x may be out), h (N, cw) between
// each resblock's two products
template <typename W>
cudaError_t chain(const float* x, const W* weights, const float* vecs,
                  float* h, float* out, int n_rows, int cw, int n_blocks,
                  int use_bn, cudaStream_t stream) {
  for (int blk = 0; blk < n_blocks; ++blk) {
    const float* src = blk == 0 ? x : out;
    const W* w1 = weights + (size_t)2 * blk * cw * cw;
    const float* v = vecs + (size_t)10 * blk * cw;
    cudaError_t e = launch_product<W, true>(src, w1, v, nullptr, h, n_rows,
                                            cw, use_bn, stream);
    if (e != cudaSuccess) return e;
    e = launch_product<W, false>(h, w1 + (size_t)cw * cw, v + 5 * cw, src,
                                 out, n_rows, cw, use_bn, stream);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

bool shape_ok(int n_rows, int c, int n_blocks) {
  return n_rows >= 1 && n_blocks >= 1 && c >= 1 && c <= 4096;
}

}  // namespace

// x, h, out (N, c), c from 1 to 4,096 (the kernels take any c; the limit
// is the wrappers'), h the scratch between a resblock's products and
// out not x; weights (2 n_blocks, c, c) f32 in (in, out) layout (the
// pack's weights, not split); vecs (10 n_blocks, c)
extern "C" int encoder_wide_f32(const void* x, const void* weights,
                                const void* vecs, void* h, void* out,
                                int n_rows, int c, int n_blocks, int use_bn,
                                void* stream) {
  if (!shape_ok(n_rows, c, n_blocks)) return cudaErrorInvalidValue;
  return chain(static_cast<const float*>(x),
               static_cast<const float*>(weights),
               static_cast<const float*>(vecs), static_cast<float*>(h),
               static_cast<float*>(out), n_rows, c, n_blocks, use_bn,
               static_cast<cudaStream_t>(stream));
}

// the same with the weights in bf16 ((2 n_blocks, c, c), (in, out)):
// both products' inputs rounded to bf16, sums in f32 (1b)
extern "C" int encoder_wide_bf16(const void* x, const void* weights,
                                 const void* vecs, void* h, void* out,
                                 int n_rows, int c, int n_blocks, int use_bn,
                                 void* stream) {
  if (!shape_ok(n_rows, c, n_blocks)) return cudaErrorInvalidValue;
  return chain(static_cast<const float*>(x),
               static_cast<const __nv_bfloat16*>(weights),
               static_cast<const float*>(vecs), static_cast<float*>(h),
               static_cast<float*>(out), n_rows, c, n_blocks, use_bn,
               static_cast<cudaStream_t>(stream));
}

// patches (N, patch); w_pe (patch, c); b_pe (c,); then encoder_wide_f32
// on the patch-embed rows, in out
extern "C" int encoder_wide_entry_f32(const void* patches, const void* w_pe,
                                      const void* b_pe, const void* weights,
                                      const void* vecs, void* h, void* out,
                                      int n_rows, int patch, int c,
                                      int n_blocks, int use_bn,
                                      void* stream) {
  if (!shape_ok(n_rows, c, n_blocks) || patch < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t n = (size_t)n_rows * c;
  embed_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(patches), static_cast<const float*>(w_pe),
      static_cast<const float*>(b_pe), static_cast<float*>(out), n_rows,
      patch, c);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return chain(static_cast<const float*>(out),
               static_cast<const float*>(weights),
               static_cast<const float*>(vecs), static_cast<float*>(h),
               static_cast<float*>(out), n_rows, c, n_blocks, use_bn, s);
}

// encoder_wide_f32 on x into resid, then sep_conv (w_sep (c, D), b_sep
// (D,)) and the nearest code of the (K, D) codebook, any K and D from 1
// to 256, into ids (N,) int32
extern "C" int encoder_wide_exit_f32(const void* x, const void* weights,
                                     const void* vecs, const void* w_sep,
                                     const void* b_sep, const void* codebook,
                                     void* h, void* resid, void* ids,
                                     int n_rows, int c, int n_blocks,
                                     int use_bn, int d_emb, int k_codes,
                                     void* stream) {
  if (!shape_ok(n_rows, c, n_blocks) || d_emb < 1 || d_emb > scan::MAX_D ||
      k_codes < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* r = static_cast<float*>(resid);
  cudaError_t e = chain(static_cast<const float*>(x),
                        static_cast<const float*>(weights),
                        static_cast<const float*>(vecs),
                        static_cast<float*>(h), r, n_rows, c, n_blocks,
                        use_bn, s);
  if (e != cudaSuccess) return e;
  const float* ws = static_cast<const float*>(w_sep);
  const float* bs = static_cast<const float*>(b_sep);
  const float* cb = static_cast<const float*>(codebook);
  int* out = static_cast<int*>(ids);
  switch (scan::padded(d_emb)) {
    case 8:
      return launch_exit<8>(r, ws, bs, cb, out, n_rows, c, d_emb, k_codes, s);
    case 16:
      return launch_exit<16>(r, ws, bs, cb, out, n_rows, c, d_emb, k_codes, s);
    case 32:
      return launch_exit<32>(r, ws, bs, cb, out, n_rows, c, d_emb, k_codes, s);
    case 64:
      return launch_exit<64>(r, ws, bs, cb, out, n_rows, c, d_emb, k_codes, s);
    case 128:
      return launch_exit<128>(r, ws, bs, cb, out, n_rows, c, d_emb, k_codes,
                              s);
    default:
      return launch_exit<256>(r, ws, bs, cb, out, n_rows, c, d_emb, k_codes,
                              s);
  }
}
