// The nearest code of 64 rows of z, with the codebook streamed through
// shared memory in chunks: the search at the end of encoder_exit_f32
// (#5, encoder_edges.cu, in the f32 tile's A tile) and of
// encoder_wide_exit_f32 (#5 above hidden 512, encoder_wide.cu).
//
// Arithmetic, fixed whatever the chunking: z.e as FMAs in index order
// from zero over D padded with zeros to DP (8, 16, 32, 64, 128 or 256;
// exact zeros added), sum z^2 and sum e^2 as rounded products added in
// index order, d = (zsq + esq) + (-2 x cross) with one rounding each,
// as ops/vq.nearest_codes orders it.
//
// First index: each lane scans the codes lane, lane + 32, ... of a chunk,
// the chunks in increasing order, keeping d < best; so a lane's best is
// the first of its equal minima across chunk boundaries too. The
// reduction over the warp's lanes then takes the smaller d and, on
// equal d, the smaller index: the first index among the row's minima.
// A row with no finite distance gets code 0.
//
// The chunk: as many codes as fit the floats after z, in rows of DP + 4
// (so that rows stay 16-byte aligned and the float4 reads of eight lanes
// on neighbouring codes fall in different banks) and their norms; at
// D = 32 the f32 tile's exit holds 830 codes a chunk, so the bench
// model's codebook (K = 256) is one chunk and is read as before.
// Single-buffered: in the tile the producer owns the ring meanwhile.
#pragma once

#include "common.cuh"

namespace arcweld {
namespace code_scan {

constexpr int ROWS = 64;                        // rows a scan
constexpr int THREADS = 256;                    // the threads that scan
constexpr int WARP_ROWS = ROWS / (THREADS / 32);   // rows a warp: 8
constexpr int MAX_D = 256;

// the width z and the codebook are padded to
__host__ __device__ constexpr int padded(int d) {
  return d <= 8 ? 8 : d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64
         : d <= 128 ? 128 : 256;
}
__host__ __device__ constexpr int code_pitch(int dp) { return dp + 4; }
// codes a chunk, where z (ROWS x dp) and the chunk share `floats`
__host__ __device__ constexpr int chunk_codes(int dp, int floats) {
  return (floats - ROWS * dp) / (code_pitch(dp) + 1);
}

// the scanning threads' barrier (named barrier 1: the f32 tile's
// consumers, or a whole block of THREADS)
__device__ __forceinline__ void sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(THREADS) : "memory");
}

// ids[row0 .. row0 + ROWS - 1] (rows below n_rows) for the rows of z_s
// (ROWS x DP, zeros past d_emb, complete before the call on every
// scanning thread's side of the first sync below) against the
// (k_codes, d_emb) codebook; cb_s
// holds `chunk` codes of code_pitch(DP) floats and their norms. Called
// by the THREADS scanning threads, ct 0 .. THREADS - 1. Ends on a
// barrier: z_s and cb_s may be written again after it.
template <int DP>
__device__ __forceinline__ void scan_codes(const float* z_s, float* cb_s,
                                           int chunk,
                                           const float* __restrict__ codebook,
                                           int* __restrict__ ids, int row0,
                                           int n_rows, int d_emb, int k_codes,
                                           int ct) {
  constexpr int PITCH = code_pitch(DP);
  float* const esq_s = cb_s + chunk * PITCH;
  const int warp = ct / 32;
  const int lane = ct % 32;
  const float* z_w = z_s + warp * WARP_ROWS * DP;   // the warp's rows
  const bool vec = d_emb % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(codebook) % 16 == 0;
  float zsq[WARP_ROWS], best[WARP_ROWS];
  int best_k[WARP_ROWS];
  sync();  // z_s is complete
#pragma unroll
  for (int q = 0; q < WARP_ROWS; ++q) {
    float s = 0.0f;
#pragma unroll 8
    for (int dd = 0; dd < DP; ++dd) {
      const float zv = z_w[q * DP + dd];
      s = __fadd_rn(s, __fmul_rn(zv, zv));
    }
    zsq[q] = s;
    best[q] = INFINITY;
    best_k[q] = k_codes;
  }
  for (int c0 = 0; c0 < k_codes; c0 += chunk) {
    const int kc = k_codes - c0 < chunk ? k_codes - c0 : chunk;
    // the chunk's codes, zeros from d_emb to DP
    if (vec) {
      const int q4 = d_emb / 4;
      const float4* src =
          reinterpret_cast<const float4*>(codebook + (size_t)c0 * d_emb);
#pragma unroll 4
      for (int i = ct; i < kc * q4; i += THREADS)
        *reinterpret_cast<float4*>(cb_s + (i / q4) * PITCH + 4 * (i % q4)) =
            __ldg(src + i);
      const int pad = DP - d_emb;
      for (int i = ct; i < kc * pad; i += THREADS)
        cb_s[(i / pad) * PITCH + d_emb + i % pad] = 0.0f;
    } else {
      for (int i = ct; i < kc * DP; i += THREADS) {
        const int k = i / DP, dd = i % DP;
        cb_s[k * PITCH + dd] =
            dd < d_emb ? __ldg(codebook + (size_t)(c0 + k) * d_emb + dd)
                       : 0.0f;
      }
    }
    sync();  // the chunk is complete
    for (int k = ct; k < kc; k += THREADS) {
      float s = 0.0f;
#pragma unroll 8
      for (int dd = 0; dd < DP; ++dd) {
        const float e = cb_s[k * PITCH + dd];
        s = __fadd_rn(s, __fmul_rn(e, e));
      }
      esq_s[k] = s;
    }
    sync();  // esq_s is complete
    for (int k = lane; k < kc; k += 32) {
      const float* e = cb_s + k * PITCH;
      float cross[WARP_ROWS];
#pragma unroll
      for (int q = 0; q < WARP_ROWS; ++q) cross[q] = 0.0f;
      // not unrolled: the warp's z rows (8 DP floats) are the same for
      // every code, and an unrolled loop hoists their loads out of the
      // scan into registers, which spill
#pragma unroll 1
      for (int dd = 0; dd < DP; dd += 4) {
        const float4 ev = *reinterpret_cast<const float4*>(e + dd);
#pragma unroll
        for (int q = 0; q < WARP_ROWS; ++q) {
          const float4 zv =
              *reinterpret_cast<const float4*>(z_w + q * DP + dd);
          cross[q] = fmaf(zv.x, ev.x, cross[q]);
          cross[q] = fmaf(zv.y, ev.y, cross[q]);
          cross[q] = fmaf(zv.z, ev.z, cross[q]);
          cross[q] = fmaf(zv.w, ev.w, cross[q]);
        }
      }
      const float es = esq_s[k];
#pragma unroll
      for (int q = 0; q < WARP_ROWS; ++q) {
        const float dist = __fadd_rn(__fadd_rn(zsq[q], es),
                                     __fmul_rn(-2.0f, cross[q]));
        if (dist < best[q]) {
          best[q] = dist;
          best_k[q] = c0 + k;
        }
      }
    }
    sync();  // the chunk is read: the next one may land
  }
#pragma unroll
  for (int q = 0; q < WARP_ROWS; ++q) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, best[q], o);
      const int ok = __shfl_xor_sync(0xffffffffu, best_k[q], o);
      if (od < best[q] || (od == best[q] && ok < best_k[q])) {
        best[q] = od;
        best_k[q] = ok;
      }
    }
    const int row = row0 + warp * WARP_ROWS + q;
    // no distance below +inf (a non-finite row): code 0
    if (lane == 0 && row < n_rows)
      ids[row] = best_k[q] < k_codes ? best_k[q] : 0;
  }
}

}  // namespace code_scan
}  // namespace arcweld
