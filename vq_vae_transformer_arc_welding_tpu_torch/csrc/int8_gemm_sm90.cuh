// int8_gemm_sm90: the int8 GEMM of the calibrated-int8 transformer
// kernels (#2, #6, #8, #10), written for Hopper (sm_90a). Included once,
// by int8_block.cu, whose launch_gemm / launch_gemm_gelu_q8 launch it.
//
//   y[m, n] = float(sum_k a[m, k] * w[n, k]) * cs[n] + cb[n], then
//     Q8 = false: out f32 = y (+ resid[m, n]);
//     Q8 = true:  out int8 = q8(new_gelu(y), *qscale), and, where clip_rows
//                 is given, clip_rows[m] += the count of n with
//                 |new_gelu(y[m, n]) * *qscale| > 127.5.
//
// a (M, K) and w (N, K) int8 are both K-contiguous, the operand layout
// 8-bit wgmma takes from shared memory, so neither is transposed. The
// sums are s32 and exact in any order; the epilogue rounds as the plain
// version does (__fmul_rn, __fadd_rn, round half to even), so outputs
// are bit-equal.
//
// What bounds it: at the transformer's shapes three of the four GEMMs
// move more bytes than they compute (the f32 output and residual), and
// the fourth (c_fc) spends more time in its GELU epilogue than in its
// products. So the design keeps the tensor cores fed, and runs one
// tile's epilogue while the next tile's products run:
//  - products: wgmma.mma_async m64n128k32 .s32.s8.s8, both operands
//    from shared memory through 128-byte-swizzle descriptors; a tile is
//    128 x 128 outputs, computed by a team of two consumer warpgroups
//    of 64 rows each;
//  - loads: one producer thread issues TMA (cp.async.bulk.tensor.2d)
//    into a ring of STAGES 128-byte K stages (A 128 x 128 and W 128 x
//    128 int8 each), completion on mbarriers; TMA zero-fills rows past
//    M, columns past N and K past its end, so ragged edges need no code;
//  - persistent tile walk: one block per SM walks the tiles i =
//    blockIdx.x, + gridDim.x, ...; tile i is row block i / tiles_n,
//    column block i % tiles_n, so the blocks at work at one time share
//    a few A row panels and all of W in L2;
//  - with the GELU+q8 epilogue two teams take the block's tiles in
//    turns (ping-pong): while one runs its epilogue (16 warps share
//    c_fc's tanh GELU) the other runs its products on the stages the
//    producer has loaded meanwhile; with the f32 epilogue one team takes
//    every tile, and the shared memory a second team would stage in
//    holds two more ring stages instead (5, not 3), which the shapes
//    bound by bytes need more;
//  - epilogue: a warpgroup's 64 x 128 outputs go into its own
//    128-byte-swizzled staging tile in shared memory (no bank
//    conflicts) and one thread stores it by TMA, which clips rows past
//    M and columns past N; the f32 residual comes into the same staging
//    tile by TMA while the products run, and is added in place;
//  - registers: setmaxnreg gives the consumers 232 (one team) or 112
//    (two) and the producer 40 or 24;
//  - the in-path saturation monitor's count (JAX's `_row_clip_frac` on
//    the m_proj input, models/quantized.py): the GELU+q8 epilogue forms
//    the product the quantization rounds, p = new_gelu(y) * qscale, once,
//    and counts |p| > 127.5 (the criterion, not the clamp: p = 127.5
//    rounds to 128 and is clamped, but is not counted). A thread counts
//    its two rows in two registers, a quad of lanes (one row) adds them
//    by two shuffles, and one atomic a row and tile adds the sum to
//    clip_rows: integers, exact in any order of the tiles and teams. Rows
//    past M (TMA's zero rows, whose new_gelu(cb) may clip) count nothing.
//    The count is an instantiation of its own (COUNT), taken where
//    clip_rows is given: its compares cost c_fc's epilogue-bound GEMM
//    5-7% (scripts/bench_classify_monitor.py), which the calls without
//    the monitor do not pay.
//
// Any N, K >= 1 (GENERAL). A tensor map wants a row pitch in bytes that
// is a multiple of 16, so the int8 operands and the int8 output lie in
// rows pitch16(K) (pitch16(N)) bytes apart, their pad never read: the
// maps' extents are K and N, and TMA zero-fills a box past them. Where
// N and K are multiples of 64 and the pointers aligned, the pitch is
// the width and the kernel is the one above. Otherwise the GENERAL
// instantiation reads cs and cb a float at a time (N may be odd, their
// rows 4-byte aligned) and, with the f32 epilogue, stores each output
// (and reads its residual) straight from the accumulators to device
// memory, masked to M and N: an f32 row of N % 4 != 0 floats has no
// 16-byte pitch. The arithmetic is the same, so are the bits.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)

#include "common.cuh"

namespace arcweld {
namespace gemm90 {

constexpr int BM = 128;                 // output rows a tile
constexpr int BN = 128;                 // output columns a tile
constexpr int BK = 128;                 // int8 of K a stage: one swizzle row
constexpr int WG_ROWS = 64;             // rows of a consumer warpgroup
constexpr int TEAM = BM / WG_ROWS;      // consumer warpgroups on a tile
constexpr int TILE_A = BM * BK, TILE_W = BN * BK;
constexpr int STAGE = TILE_A + TILE_W;  // 32 KB
constexpr int K_STEP = 32;              // int8 of K a wgmma
constexpr int F32_PANEL = 32;           // f32 columns of a 128-byte row
constexpr int ACC = BN / 2;             // s32 accumulators a thread

// The f32 GEMMs move more bytes than they compute: one team and the
// deepest ring (5 stages). The GELU+q8 one spends more time in its
// epilogue than in its products: two teams in turns, and 6 stages.
template <bool Q8>
struct Config {
  static constexpr int TEAMS = Q8 ? 2 : 1;   // teams taking tiles in turns
  static constexpr int CONSUMERS = TEAM * TEAMS;
  static constexpr int THREADS = 128 * (1 + CONSUMERS);  // warpgroup 0 loads
  // setmaxnreg moves registers within what the block was launched with,
  // 65536 / THREADS a thread in steps of 8; a request beyond it waits
  // for ever
  static constexpr int PRODUCER_REGS = Q8 ? 24 : 40;
  static constexpr int CONSUMER_REGS = Q8 ? 112 : 232;
  static_assert(128 * (PRODUCER_REGS + CONSUMERS * CONSUMER_REGS) <=
                    THREADS * (65536 / THREADS / 8 * 8),
                "setmaxnreg asks for more registers than the block holds");
  // a warpgroup's staging tile: 8 KB of int8 or 32 KB of f32 (four
  // panels of 32 columns); what is left of 227 KB holds the stages
  static constexpr int OUT_WG = WG_ROWS * BN * (Q8 ? 1 : 4);
  static constexpr int STAGES = Q8 ? 6 : 5;
  static constexpr size_t SMEM =
      1024 + (size_t)STAGES * STAGE + (size_t)CONSUMERS * OUT_WG;
};

__host__ __device__ constexpr int tiles_n(int n_cols) {
  return (n_cols + BN - 1) / BN;
}

__host__ __device__ constexpr int tiles(int m_rows, int n_cols) {
  return (m_rows + BM - 1) / BM * tiles_n(n_cols);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// box at (c0 innermost, c1) of the map -> shared memory, counted on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void named_sync(uint32_t id, uint32_t threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// shared memory descriptor of a K-major tile with the 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart (SBO); LBO unused
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (the registers change behind its back)
__device__ __forceinline__ void fence_acc(int (&d)[ACC]) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (+)= A (64 x 32 s8, desc a) * W^T (32 x 128 s8, desc w), s32
__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[ACC], uint64_t a,
                                                 uint64_t w, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(w), "r"(accumulate));
}

// The kernel. tm_a: a (M, K) int8, box 128 x 128; tm_w: w (N, K) int8,
// box 128 x 128; tm_out: out (M, N), box 64 rows x 128 bytes (int8) or
// 64 rows x 32 f32; tm_resid: resid (M, N) f32 as tm_out (unused when
// has_resid is 0); all with the 128-byte swizzle. clip_rows: (M,) int32,
// read by the COUNT instantiation (Q8 only). out_f32, resid_f32: the f32
// (M, N) output and residual, which GENERAL f32 writes and reads
// directly (the maps unused).
template <bool Q8, bool COUNT, bool GENERAL>
__global__ void __launch_bounds__(Config<Q8>::THREADS, 1)
int8_gemm_sm90_kernel(const __grid_constant__ CUtensorMap tm_a,
                      const __grid_constant__ CUtensorMap tm_w,
                      const __grid_constant__ CUtensorMap tm_out,
                      const __grid_constant__ CUtensorMap tm_resid,
                      const float* __restrict__ cs,
                      const float* __restrict__ cb,
                      const float* __restrict__ qscale,
                      int* __restrict__ clip_rows,
                      float* __restrict__ out_f32,
                      const float* __restrict__ resid_f32, int has_resid,
                      int m_rows, int n_cols, int k) {
  constexpr int S = Config<Q8>::STAGES, TEAMS = Config<Q8>::TEAMS;
  constexpr int CONSUMERS = Config<Q8>::CONSUMERS;
  constexpr int PANEL = WG_ROWS * 128;  // bytes of a 128-byte-wide panel
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[S], empty[S];
  __shared__ __align__(8) uint64_t resid_in[CONSUMERS], turn_done[TEAMS];
  // TMA's 128-byte swizzle and the descriptors want 1024-byte alignment
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - raw);
  const int nt_n = tiles_n(n_cols);
  const int n_tiles = tiles(m_rows, n_cols);
  const int k_blocks = (k + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), TEAM * 128);
    }
    for (int c = 0; c < CONSUMERS; ++c) mbar_init(smem_u32(&resid_in[c]), 1);
    for (int c = 0; c < TEAMS; ++c)
      mbar_init(smem_u32(&turn_done[c]), TEAM * 128);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the block's j-th tile is blockIdx.x + j gridDim.x; its K stages are
  // the ring's q = j k_blocks + kb: slot q % S, phase (q / S) % 2. The
  // teams run their products in the tiles' order (turn_done): a team
  // that skipped the other's stages could otherwise find a slot two
  // phases behind and read its parity as done.
  if (wg == 0) {
    // -- producer: one thread keeps the ring of stages full ---------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        Config<Q8>::PRODUCER_REGS));
    if (threadIdx.x == 0) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(&tm_a))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(&tm_w))
                   : "memory");
      int s = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int m0 = tile / nt_n * BM, n0 = tile % nt_n * BN;
        for (int kb = 0; kb < k_blocks; ++kb) {
          mbar_wait(smem_u32(&empty[s]), phase ^ 1);
          const uint32_t bar = smem_u32(&full[s]);
          mbar_expect_tx(bar, STAGE);
          const uint32_t dst = base + s * STAGE;
          tma_load(dst, &tm_a, bar, kb * BK, m0);
          tma_load(dst + TILE_A, &tm_w, bar, kb * BK, n0);
          if (++s == S) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // -- consumers: team tm takes the block's tiles j = tm, tm + TEAMS,
    // ...; its warpgroup half owns rows 64 half .. 64 half + 63 of each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        Config<Q8>::CONSUMER_REGS));
    const int cw = wg - 1, tm = cw / TEAM, half = cw % TEAM;
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    // accumulator layout of m64nNk32: acc[4j + 2h + e] is row
    // 16 warp + lane / 4 + 8 h, column 8 j + 2 (lane % 4) + e
    const int r_lo = 16 * warp + lane / 4, c_lo = 2 * (lane % 4);
    const uint32_t out_s = base + S * STAGE + cw * Config<Q8>::OUT_WG;
    uint8_t* const out_p = smem + S * STAGE + cw * Config<Q8>::OUT_WG;
    const uint32_t resid_bar = smem_u32(&resid_in[cw]);
    const float qs = Q8 ? *qscale : 0.0f;
    uint32_t resid_phase = 0;
    int acc[ACC] = {};
    for (int j = tm, tile = blockIdx.x + tm * gridDim.x; tile < n_tiles;
         j += TEAMS, tile += TEAMS * gridDim.x) {
      const int m0 = tile / nt_n * BM + half * WG_ROWS;
      const int n0 = tile % nt_n * BN;
      // rows past M: the last row block's second half may hold none
      const bool rows_in = m0 < m_rows;
      const bool resid = !Q8 && !GENERAL && has_resid && rows_in;
      // the staging tile is free once the last tile's store has read it;
      // the residual comes into it while the products run
      if (t == 0 && resid) {
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
        mbar_expect_tx(resid_bar, Config<Q8>::OUT_WG);
#pragma unroll
        for (int p = 0; p < BN / F32_PANEL; ++p)
          tma_load(out_s + p * PANEL, &tm_resid, resid_bar,
                   n0 + p * F32_PANEL, m0);
      }
      __syncwarp();
      // this tile's products wait for the other team's on tile j - 1
      if (TEAMS > 1 && j > 0)
        mbar_wait(smem_u32(&turn_done[(tm + TEAMS - 1) % TEAMS]),
                  ((j - 1) / TEAMS) & 1);
      int q = j * k_blocks, prev = 0;
      for (int kb = 0; kb < k_blocks; ++kb, ++q) {
        const int s = q % S;
        mbar_wait(smem_u32(&full[s]), (q / S) & 1);
        __syncwarp();  // wgmma is .aligned: the warp leaves the spin together
        const uint32_t a_s = base + s * STAGE + half * WG_ROWS * BK;
        const uint32_t w_s = base + s * STAGE + TILE_A;
        fence_acc(acc);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < BK / K_STEP; ++kk)
          wgmma_m64n128k32(acc, sw128_desc(a_s + kk * K_STEP),
                           sw128_desc(w_s + kk * K_STEP), kb | kk);
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        fence_acc(acc);
        // keep this stage's products in flight; the one before is done
        asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
        fence_acc(acc);
        if (kb > 0) mbar_arrive(smem_u32(&empty[prev]));
        prev = s;
      }
      if (TEAMS > 1) mbar_arrive(smem_u32(&turn_done[tm]));
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_acc(acc);
      mbar_arrive(smem_u32(&empty[prev]));

      // -- epilogue, in the staging tile: 16-byte chunk c of row r sits
      // at chunk c ^ (r % 8) of its 128-byte row (the 128-byte swizzle)
      if (resid) {
        mbar_wait(resid_bar, resid_phase);
        resid_phase ^= 1;
      } else if (t == 0) {
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      }
      named_sync(1 + cw, 128);
      __syncwarp();
      int clipped[2] = {0, 0};  // rows r_lo and r_lo + 8
#pragma unroll
      for (int jc = 0; jc < BN / 8; ++jc) {
        const int col = 8 * jc + c_lo;
        const int n = n0 + col;
        if (n >= n_cols) continue;
        // column n + 1 is in (N is even) but for GENERAL's last column
        const bool two = !GENERAL || n + 1 < n_cols;
        float2 sc, bi;
        if constexpr (GENERAL) {
          sc = make_float2(cs[n], two ? cs[n + 1] : 0.0f);
          bi = make_float2(cb[n], two ? cb[n + 1] : 0.0f);
        } else {
          sc = *reinterpret_cast<const float2*>(cs + n);
          bi = *reinterpret_cast<const float2*>(cb + n);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r_lo + 8 * h;
          const float y0 = __fadd_rn(
              __fmul_rn((float)acc[4 * jc + 2 * h], sc.x), bi.x);
          const float y1 = __fadd_rn(
              __fmul_rn((float)acc[4 * jc + 2 * h + 1], sc.y), bi.y);
          if constexpr (Q8) {
            const float p0 = __fmul_rn(arcweld::new_gelu(y0), qs);
            const float p1 = __fmul_rn(arcweld::new_gelu(y1), qs);
            if constexpr (COUNT)
              clipped[h] +=
                  (fabsf(p0) > 127.5f) + (two && fabsf(p1) > 127.5f);
            *reinterpret_cast<char2*>(
                out_p + row * 128 + (((col >> 4) ^ (row & 7)) << 4) +
                (col & 15)) =
                make_char2(arcweld::q8_of(p0), arcweld::q8_of(p1));
          } else if constexpr (GENERAL) {
            const int gr = m0 + row;
            if (gr < m_rows) {
              const size_t at = (size_t)gr * n_cols + n;
              out_f32[at] = has_resid ? __fadd_rn(resid_f32[at], y0) : y0;
              if (two)
                out_f32[at + 1] =
                    has_resid ? __fadd_rn(resid_f32[at + 1], y1) : y1;
            }
          } else {
            const int pc = col % F32_PANEL;
            float2* at = reinterpret_cast<float2*>(
                out_p + (col / F32_PANEL) * PANEL + row * 128 +
                (((pc >> 2) ^ (row & 7)) << 4) + (pc & 3) * 4);
            if (resid) {
              const float2 r = *at;
              *at = make_float2(__fadd_rn(r.x, y0), __fadd_rn(r.y, y1));
            } else {
              *at = make_float2(y0, y1);
            }
          }
        }
      }
      if constexpr (COUNT) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int cnt = clipped[h];
          cnt += __shfl_xor_sync(0xffffffffu, cnt, 1);
          cnt += __shfl_xor_sync(0xffffffffu, cnt, 2);
          const int row = m0 + r_lo + 8 * h;
          if (lane % 4 == 0 && cnt != 0 && row < m_rows)
            atomicAdd(clip_rows + row, cnt);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      named_sync(1 + cw, 128);
      if (t == 0 && rows_in) {
        if constexpr (Q8) {
          tma_store(&tm_out, out_s, n0, m0);
        } else if constexpr (!GENERAL) {
#pragma unroll
          for (int p = 0; p < BN / F32_PANEL; ++p)
            if (n0 + p * F32_PANEL < n_cols)
              tma_store(&tm_out, out_s + p * PANEL, n0 + p * F32_PANEL, m0);
        }
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      }
      __syncwarp();
    }
    if (t == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
}

// -- host side ----------------------------------------------------------------

// cuTensorMapEncodeTiled, reached through the runtime (the library links
// no libcuda); null where the driver has none
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a row-major (rows, cols) tensor of elem-byte values whose rows lie
// pitch values apart, read or written in boxes of box_rows x box_cols
// with the 128-byte swizzle
inline cudaError_t make_map(CUtensorMap* map, const void* ptr, bool f32,
                            int rows, int cols, int pitch, int box_rows,
                            int box_cols) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const int elem = f32 ? 4 : 1;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch * elem};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(
      map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
      2, const_cast<void*>(ptr), dims, strides, box, steps,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

inline bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Any N, K >= 1 and at least one row. a (rows, k) and w (n, k) int8 in
// rows pitch16(k) bytes apart, the int8 out in rows pitch16(n) bytes
// apart, each 16-byte aligned (TMA); f32 out and resid (rows, n)
// contiguous; clip_rows only with Q8. N and K multiples of 64 with out
// and resid 16-byte aligned, cs and cb 8-byte, take the kernel's first
// form, any other shape its GENERAL one. One block per SM, or one per
// tile where there are fewer tiles.
template <bool Q8>
cudaError_t launch(const int8_t* a, const int8_t* w, const float* cs,
                   const float* cb, const float* resid, const float* qscale,
                   int* clip_rows, void* out, int rows, int n_cols, int k,
                   cudaStream_t s) {
  if (rows < 1 || n_cols < 1 || k < 1 || (!Q8 && clip_rows != nullptr))
    return cudaErrorInvalidValue;
  if (!aligned(a, 16) || !aligned(w, 16) || (Q8 && !aligned(out, 16)))
    return cudaErrorMisalignedAddress;
  const bool general = n_cols % 64 != 0 || k % 64 != 0 ||
                       !aligned(out, 16) || !aligned(resid, 16) ||
                       !aligned(cs, 8) || !aligned(cb, 8);
  CUtensorMap tm_a, tm_w, tm_out, tm_resid;
  cudaError_t e;
  const int out_cols = Q8 ? BN : F32_PANEL;
  const int out_pitch = Q8 ? pitch16(n_cols) : n_cols;
  if ((e = make_map(&tm_a, a, false, rows, k, pitch16(k), BM, BK)) !=
          cudaSuccess ||
      (e = make_map(&tm_w, w, false, n_cols, k, pitch16(k), BN, BK)) !=
          cudaSuccess)
    return e;
  if (Q8 || !general) {
    if ((e = make_map(&tm_out, out, !Q8, rows, n_cols, out_pitch, WG_ROWS,
                      out_cols)) != cudaSuccess ||
        (e = make_map(&tm_resid, resid != nullptr ? resid : out, !Q8, rows,
                      n_cols, out_pitch, WG_ROWS, out_cols)) != cudaSuccess)
      return e;
  } else {
    tm_out = tm_resid = tm_a;  // GENERAL f32 stores without TMA
  }
  int dev, sms;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  const bool count = clip_rows != nullptr;
  const auto kernel =
      general ? (count ? int8_gemm_sm90_kernel<Q8, Q8, true>
                       : int8_gemm_sm90_kernel<Q8, false, true>)
              : (count ? int8_gemm_sm90_kernel<Q8, Q8, false>
                       : int8_gemm_sm90_kernel<Q8, false, false>);
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)Config<Q8>::SMEM);
  if (e != cudaSuccess) return e;
  const int grid = tiles(rows, n_cols) < sms ? tiles(rows, n_cols) : sms;
  kernel<<<grid, Config<Q8>::THREADS, Config<Q8>::SMEM, s>>>(
      tm_a, tm_w, tm_out, tm_resid, cs, cb, qscale, clip_rows,
      Q8 ? nullptr : static_cast<float*>(out), resid, resid != nullptr,
      rows, n_cols, k);
  return cudaGetLastError();
}

}  // namespace gemm90
}  // namespace arcweld
