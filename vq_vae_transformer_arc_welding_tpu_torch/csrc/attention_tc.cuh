// attention_tc: the causal attention tile of kernel #9 (flash_attn.cu) and
// of int8_block.cu's f32 attention_kernel (#2, #6, #10, #11), written once
// for Hopper. Each of the two files instantiates it with its own epilogue,
// so that neither file's registers depend on the other's.
//
//   o[b, h, i, :] = (sum_j p_ij v_j) / sum_j p_ij,
//   p_ij = exp(s_ij - max_j s_ij), s_ij = (q_i . k_j) * sm_scale, j <= i
//
// Work split. A block of WARPS = 8 warps takes QROWS = 128 query rows of
// one (batch, head), 16 a warp (one m16 tile of mma.sync); two blocks
// share an SM. The row tiles are laid from the end of the sequence: block
// z takes the rows [T - 128 (z + 1), T - 128 z), so a ragged T leaves its
// short tile at rows 0.., whose causal limit is a few keys, and never
// gives a block of 128 rows one row that walks every key (T = 321: the
// short tile is rows 0 .. 64). Rows below 0 are idle. Grid (heads, batch,
// row tiles): the heaviest tiles of every (batch, head) come first. Keys
// and values stream through shared memory KT = 64 at a time up to the
// block's causal limit, in a double buffer filled by cp.async (zero-filled
// past T); inside a stage each warp skips the 8-key column blocks beyond
// its own last row. The softmax is FP32: the row max is kept online
// (numerators rescaled when it grows) and the division by the row sum
// comes after P@V, in the epilogue.
//
// Products. Q K^T is an FP32 FMA chain over the head dims in order (q_i0
// k_j0 first), the order of a plain f32 GEMM, so the scores round as the
// plain version's do: a score of 60 that rounds elsewhere moves p by ~4e-6
// of itself, more than the f32 attention's contract allows at the output
// (split-TF32 scores part from the plain version by more than #9's 2e-5 at
// chip_smoke's inputs: tests/test_torch_attention_split.py). P@V runs on the
// tensor cores as mma.sync.m16n8k8 in split TF32: every operand x becomes hi
// = tf32(x) (cvt.rna) and lo = tf32(x - hi), and hi*hi + hi*lo + lo*hi is
// summed. TF32 alone keeps 11 bits of each operand and misses an f32
// attention by ~1e-2; the split keeps ~22. The tensor core truncates its
// sums, so the three products of each 8-key step go into a fresh accumulator
// that is added to the running f32 sum with one rounded add. A thread's
// scores are mma's accumulator layout (rows g and g + 8, columns 2 tg and 2
// tg + 1 of each 8-column block), and the keys inside each 8-key step are
// renumbered (k index tg -> key 2 tg, tg + 4 -> key 2 tg + 1), so that the
// scores are P's A fragment as they stand; V is read [key][dim] with the
// same renumbering. Row strides of 68 floats keep every fragment and score
// load free of bank conflicts (RS = HD + 4 at every head width).
//
// Head widths: the tile is a template of the head width HD, instantiated
// at 32, 64 and 128 (Shape below). A narrower real head runs padded with
// zero columns; at HD 128 the tile's 203 KB of shared memory leave one
// block an SM.
//
// A head wider than 128 (up to MAX_WIDE_HD) runs on the wide tile
// (causal_attention_tile_wide), a block per PIECE = 128 output columns,
// the blocks of one (head, row tile) launched as clusters of n =
// wide_cluster(hd) blocks along x (n = 2 for 2 pieces, 4 for 3-4, 8
// from 5: the portable limit). A head of more than 8 pieces takes
// ceil(pieces / 8) cluster groups, each a cluster of 8 blocks (the last
// group's blocks past the head's pieces store nothing). Each cluster
// forms a stage's scores once: the stage's 128 x 64 score tile is cut
// into 64 units of 16 rows x 8 keys (a row block, a key block), and its
// 8n warps take 8 / n units each, in order, so block r of the cluster
// takes the rows [128 r / n, 128 (r + 1) / n) and all 64 keys. Each unit
// is one FMA chain over every head dim in order (the chunks of
// 128 columns in turn, zero-filled past the head), so the scores keep
// the unchunked chain's bits, the plain GEMM's order (the design that
// instead gave each block a 128-column chunk with its own chain and
// added the chunks' sums in order missed #9's 2e-5 against plain by less
// than a factor 2 of margin at a head of 300; tests/test_torch_wide_
// attention.py). Each block writes its units to one of two slots in its
// shared memory, one cluster barrier makes them visible, and every warp
// reads its 16 rows x 64 keys through distributed shared memory from the
// block that formed them; then the narrow tile's softmax_step and
// pv_step for the block's own 128 columns of V. The score work is
// ceil(pieces / 8) times a head's (a block a piece forming them alone
// would form them once a piece).
//   Shared memory a block (f32): Q of the block's 128 / n rows for the
// whole head where the head fits in 8 pieces ((128 / n) x 132 floats a
// chunk, 67,584 bytes at most), else streamed with K a chunk at a time;
// a ring of K chunks (64 x 132 floats, with Q's 16 x 132 when streamed)
// of 2 places (4 streamed); V's piece, single (64 x 132), copied at the
// start of a stage while its scores form; two score slots of 64 / n
// units x 128 floats. n = 2: 67,584 + 2 x 33,792 + 33,792 + 2 x 16,384
// = 201,728 bytes; a head past 8 pieces: 4 x 42,240 + 33,792 + 2 x
// 4,096 = 210,944 (Wide::SMEM, checked against 227 KB below): one
// block an SM.
//   Barriers: every thread of every block joins each stage's cluster
// barrier and the last one after the loop (causally idle rows and the
// blocks past the head's pieces too), and no block returns before that
// last one, after which no peer reads its slots.

// What bounds it on an H100 (at the bench shape, T = 321, B = 80, H = 8):
// the bytes of q, k, v and the output (210 MB f32, 3.35 TB/s: 0.063 ms);
// both products in split TF32 would take 6 x 4.2 GFLOP at 495 TFLOP/s
// (0.051 ms). As the tile runs them, 4.2 GFLOP of FP32 score FMAs take
// 0.063 ms at 67 TFLOP/s. In practice shared memory paces the score loop:
// for each head dim a thread's 2 rows x 16 keys (32 FMAs) read 18 floats,
// and an SM delivers 32 floats a clock to 128 FMA lanes. Two m16 tiles a
// warp nearly halve the reads per FMA, but their registers leave an SM 8
// warps instead of 16, and that tile was slower (PERF.md, Findings).
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace arcweld {
namespace attn_tc {

constexpr int WROWS = 16;               // query rows per warp: one m16 tile
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int QROWS = WROWS * WARPS;    // query rows per block
constexpr int KT = 64;                  // keys per stage
constexpr int NB = KT / 8;              // 8-key column blocks
constexpr int MAX_HD = 128;             // the widest head an instantiation takes
constexpr int PIECE = MAX_HD;           // output columns a block of the wide tile
constexpr int MAX_WIDE_HD = 4096;       // the widest head the wide tile takes

// The tile of head width HD (32, 64 or 128): a head of real width hd
// <= HD runs on the smallest that holds it (PAD, below, unless hd == HD
// == 64), its columns hd .. HD - 1 zero-filled in shared memory. A zero
// column adds an exact 0.0 to every score (the FMA chain over the real
// columns is unchanged), and P@V's columns past hd are never stored.
template <int HD>
struct Shape {
  static constexpr int RS = HD + 4;     // row stride of Q, K and V tiles
  // two blocks an SM where the shared memory holds them (about 203 KB
  // a block at HD 128, one an SM)
  static constexpr int MIN_BLOCKS = HD <= 64 ? 2 : 1;
  static constexpr int STAGE = 2 * KT * RS;      // K then V, floats
  static constexpr size_t SMEM = sizeof(float) * (QROWS * RS + 2 * STAGE);
};

// the instantiation a real head width hd runs on
__host__ __device__ constexpr int padded_head(int hd) {
  return hd <= 32 ? 32 : hd <= 64 ? 64 : 128;
}

inline dim3 grid(int batch, int n_head, int t) {
  return dim3(n_head, batch, (t + QROWS - 1) / QROWS);
}

// The wide tile: a head of width hd in pieces of PIECE output columns,
// clusters of wide_cluster(hd) blocks, wide_groups(hd) clusters a (head,
// row tile); its grid: (head, group, rank) folded into x, batch, row
// tiles
constexpr int WIDE_MAX_CLUSTER = 8;

__host__ __device__ constexpr int pieces(int hd) {
  return (hd + PIECE - 1) / PIECE;
}

__host__ __device__ constexpr int wide_cluster(int hd) {
  return pieces(hd) <= 2 ? 2 : pieces(hd) <= 4 ? 4 : WIDE_MAX_CLUSTER;
}

__host__ __device__ constexpr int wide_groups(int hd) {
  return (pieces(hd) + wide_cluster(hd) - 1) / wide_cluster(hd);
}

// Q stays in shared memory for the whole launch up to 8 pieces
__host__ __device__ constexpr bool wide_resident(int hd) {
  return pieces(hd) <= WIDE_MAX_CLUSTER;
}

inline dim3 wide_grid(int batch, int n_head, int t, int hd) {
  return dim3(n_head * wide_groups(hd) * wide_cluster(hd), batch,
              (t + QROWS - 1) / QROWS);
}

// The wide tile's shapes for clusters of N with Q resident (QRES) or
// streamed, in floats: QR rows of Q a block, U units (16 rows x 8 keys)
// a warp; the ring of STAGES places (K's chunk, and Q's when streamed),
// V's piece, two slots of the block's units
template <int N, bool QRES>
struct Wide {
  static_assert(N == 2 || N == 4 || N == 8, "a cluster of 2, 4 or 8");
  static_assert(QRES || N == WIDE_MAX_CLUSTER, "Q streamed past 8 pieces");
  static constexpr int RS = PIECE + 4;
  static constexpr int QR = QROWS / N;
  static constexpr int UNITS = (QROWS / WROWS) * NB;
  static constexpr int U = UNITS / (N * WARPS);
  static constexpr int STAGES = QRES ? 2 : 4;
  static constexpr int Q_FLOATS = QRES ? N * QR * RS : 0;
  static constexpr int RING = (QRES ? 0 : QR * RS) + KT * RS;
  static constexpr int SLOT = UNITS / N * WROWS * 8;
  static constexpr size_t SMEM =
      sizeof(float) * (Q_FLOATS + STAGES * RING + KT * RS + 2 * SLOT);
  static_assert(SMEM <= 232448, "227 KB of shared memory a block");
};

// q, k, v element (b, h, i, e) at b*sb + h*sh + i*st + e (floats).
// vec16: every row starts 16-byte aligned (the pointers and the strides,
// and hd a multiple of 4 where the head is padded), so rows are copied
// 16 bytes at a time, else 4. hd: the real head width, read only by a
// padded tile; sm_scale is 1/sqrt(hd).
struct Operands {
  const float* q;
  const float* k;
  const float* v;
  long long sb, sh, st;
  int t;
  float sm_scale;
  bool vec16;
  int hd;
};

__host__ inline bool rows_aligned16(const void* q, const void* k,
                                    const void* v, long long sb,
                                    long long sh, long long st, int hd) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(q) |
                      reinterpret_cast<uintptr_t>(k) |
                      reinterpret_cast<uintptr_t>(v);
  return p % 16 == 0 && (sb | sh | st | hd) % 4 == 0;
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}

// d = a (16 x 8, row) * b (8 x 8, col) + d, TF32 operands, f32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b over one k8 step in split TF32: small terms first, into a
// fresh accumulator, then one rounded f32 add
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] = __fadd_rn(d[i], c[i]);
}

// 16 (or 4) bytes from global to shared memory; zeros where !ok
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [r0, r0 + N) of x (HD floats each, row i at base + i * st) into
// dst, RS floats apart, by the block's THREADS threads; rows outside
// [0, t), and with PAD the columns from hd on, are zero-filled
template <int N, int HD, bool PAD>
__device__ __forceinline__ void copy_rows(float* dst, const float* x,
                                          long long base, long long st,
                                          int r0, int t, bool vec16, int hd) {
  constexpr int RS = Shape<HD>::RS;
  if (vec16) {
#pragma unroll
    for (int i = 0; i < N * HD / 4 / THREADS; ++i) {
      const int c = threadIdx.x + i * THREADS;
      const int row = c / (HD / 4), col = 4 * (c % (HD / 4));
      const int r = r0 + row;
      const bool ok = r >= 0 && r < t && (!PAD || col < hd);
      cp_async16(dst + row * RS + col,
                 x + base + (long long)(ok ? r : 0) * st +
                     (PAD && !ok ? 0 : col),
                 ok);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < N * HD / THREADS; ++i) {
      const int e = threadIdx.x + i * THREADS;
      const int row = e / HD, col = e % HD;
      const int r = r0 + row;
      const bool ok = r >= 0 && r < t && (!PAD || col < hd);
      cp_async4(dst + row * RS + col,
                x + base + (long long)(ok ? r : 0) * st +
                    (PAD && !ok ? 0 : col),
                ok);
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

constexpr int R = 2;                    // a thread's rows: g, g + 8

// s[r][j][c] = fma(q_e, k_e, s) over e = 0 .. HD - 1 in order, carried
// on from s: row r, key 8 j + 2 tg + c of the stage, j < nb
template <int HD>
__device__ __forceinline__ void score_chain(float (&s)[R][NB][2],
                                            const float* q_row,
                                            const float* k_s, int nb,
                                            int tg) {
  constexpr int RS = Shape<HD>::RS;
#pragma unroll 2
  for (int e = 0; e < HD; e += 4) {
    float4 x[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      x[r] = *reinterpret_cast<const float4*>(q_row + 8 * r * RS + e);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if (j < nb) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float4 kv = *reinterpret_cast<const float4*>(
              k_s + (8 * j + 2 * tg + c) * RS + e);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            float& a = s[r][j][c];
            a = fmaf(x[r].x, kv.x, a);
            a = fmaf(x[r].y, kv.y, a);
            a = fmaf(x[r].z, kv.z, a);
            a = fmaf(x[r].w, kv.w, a);
          }
        }
      }
    }
  }
}

// scale, causal mask and online softmax numerators of a stage's scores
// (keys from k0), rescaling the running row sums l and outputs o
template <int HD>
__device__ __forceinline__ void softmax_step(float (&s)[R][NB][2],
                                             float (&o)[HD / 8][4],
                                             float (&m)[R], float (&l)[R],
                                             const int (&lim)[R], int nb,
                                             int k0, int tg, float sm_scale) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if (j < nb) {
        const int kc = k0 + 8 * j + 2 * tg;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          s[r][j][c] = kc + c <= lim[r] ? __fmul_rn(s[r][j][c], sm_scale)
                                        : -INFINITY;
          mx = fmaxf(mx, s[r][j][c]);
        }
      }
    }
    // every row sees key 0 in the first stage, so m is finite from
    // there
    const float mn = fmaxf(m[r], quad_max(mx));
    const float alpha = expf(m[r] - mn);
    m[r] = mn;
    float ps = 0.0f;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if (j < nb) {
        s[r][j][0] = expf(s[r][j][0] - mn);
        s[r][j][1] = expf(s[r][j][1] - mn);
        ps += s[r][j][0] + s[r][j][1];
      }
    }
    l[r] = l[r] * alpha + ps;   // this thread's columns; summed at the end
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      o[n][2 * r] *= alpha;
      o[n][2 * r + 1] *= alpha;
    }
  }
}

// o += P V: k step j is the keys of column block j
template <int HD>
__device__ __forceinline__ void pv_step(float (&o)[HD / 8][4],
                                        const float (&s)[R][NB][2],
                                        const float* v_s, int nb, int g,
                                        int tg) {
  constexpr int RS = Shape<HD>::RS;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    if (j < nb) {
      uint32_t ph[4], pl[4];
      split_tf32(s[0][j][0], ph[0], pl[0]);   // row g, key 2 tg
      split_tf32(s[1][j][0], ph[1], pl[1]);   // row g + 8
      split_tf32(s[0][j][1], ph[2], pl[2]);   // row g, key 2 tg + 1
      split_tf32(s[1][j][1], ph[3], pl[3]);
      const float* vr = v_s + (8 * j + 2 * tg) * RS + g;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(vr[8 * n], bh0, bl0);
        split_tf32(vr[RS + 8 * n], bh1, bl1);
        mma3(o[n], ph, pl, bh0, bh1, bl0, bl1);
      }
    }
  }
}

// The tile of block (h, b, z) = blockIdx, THREADS threads, SMEM bytes
// of dynamic shared memory. A warp owns one m16 tile of rows; thread
// (warp, g = lane / 4, tg = lane % 4) holds rows g and g + 8 of it, and
// of each 8-column block the columns 2 tg, 2 tg + 1 (mma's accumulator
// layout). store(b, h, row, col, y0, y1, l) writes columns col, col + 1
// of a valid row: y / l; with PAD, store.one(b, h, row, col, y, l) writes
// column col alone, for the columns below in.hd (any hd: a pair of an
// odd-width head is not aligned).
template <int HD, bool PAD, class Store>
__device__ __forceinline__ void causal_attention_tile(const Operands& in,
                                                      const Store& store) {
  static_assert(HD == 32 || HD == 64 || HD == 128, "a head width of the tile");
  constexpr int RS = Shape<HD>::RS;
  constexpr int STAGE = Shape<HD>::STAGE;
  extern __shared__ float4 smem4[];
  float* const q_s = reinterpret_cast<float*>(smem4);  // QROWS x RS
  float* const stages = q_s + QROWS * RS;  // 2 x (K: KT x RS, V: KT x RS)
  const int h = blockIdx.x, b = blockIdx.y;
  const int q_end = in.t - QROWS * (int)blockIdx.z;     // rows < q_end
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tg = lane % 4;
  const int w_first = WROWS * warp;                     // in the block
  const int w0 = q_end - QROWS + w_first;               // may be < 0
  const int w_end = w0 + WROWS;
  const long long base = b * in.sb + h * in.sh;
  const int n_tiles = (q_end + KT - 1) / KT;
  // thread row r (0 .. R-1) is w0 + g + 8 r; a row below 0 attends to
  // key 0 (finite, never stored)
  int lim[R];
#pragma unroll
  for (int r = 0; r < R; ++r) lim[r] = max(w0 + g + 8 * r, 0);

  copy_rows<QROWS, HD, PAD>(q_s, in.q, base, in.st, q_end - QROWS, in.t,
                            in.vec16, in.hd);
  copy_rows<KT, HD, PAD>(stages, in.k, base, in.st, 0, in.t, in.vec16, in.hd);
  copy_rows<KT, HD, PAD>(stages + KT * RS, in.v, base, in.st, 0, in.t,
                         in.vec16, in.hd);
  cp_async_commit();

  // o[n]: rows g (0, 1) and g + 8 (2, 3), head dims 8 n + 2 tg, + 1
  float o[HD / 8][4] = {};
  float m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
  }
  const float* q_row = q_s + (w_first + g) * RS;   // row r at + 8 r RS

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * KT;
    if (it + 1 < n_tiles) {
      float* next = stages + ((it + 1) & 1) * STAGE;
      copy_rows<KT, HD, PAD>(next, in.k, base, in.st, k0 + KT, in.t,
                             in.vec16, in.hd);
      copy_rows<KT, HD, PAD>(next + KT * RS, in.v, base, in.st, k0 + KT,
                             in.t, in.vec16, in.hd);
    }
    cp_async_commit();
    cp_async_wait<1>();   // this stage's copies (and Q's) have landed
    __syncthreads();
    const float* k_s = stages + (it & 1) * STAGE;
    const float* v_s = k_s + KT * RS;
    // the 8-key column blocks this warp needs: keys below w_end
    const int nb = min(max((w_end - k0 + 7) / 8, 0), NB);

    if (nb > 0) {
      float s[R][NB][2];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < NB; ++j) s[r][j][0] = s[r][j][1] = 0.0f;
      score_chain<HD>(s, q_row, k_s, nb, tg);
      softmax_step<HD>(s, o, m, l, lim, nb, k0, tg, in.sm_scale);
      pv_step<HD>(o, s, v_s, nb, g, tg);
    }
    __syncthreads();   // this stage is consumed before it is refilled
  }

  if (w_end <= 0) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    l[r] = quad_sum(l[r]);
    const int row = w0 + g + 8 * r;
    if (row < 0) continue;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int col = 8 * n + 2 * tg;
      if (!PAD) {
        store(b, h, row, col, o[n][2 * r], o[n][2 * r + 1], l[r]);
      } else {
        if (col < in.hd) store.one(b, h, row, col, o[n][2 * r], l[r]);
        if (col + 1 < in.hd)
          store.one(b, h, row, col + 1, o[n][2 * r + 1], l[r]);
      }
    }
  }
}

// s[r][j][c] = fma(q_e, k_e, s) over e = 0 .. PIECE - 1 in order,
// carried on from s: the score chain of score_chain<PIECE> for a warp's
// U units, keys 8 j + 2 tg + c from k_s, j < nu
template <int U>
__device__ __forceinline__ void unit_chain(float (&s)[R][U][2],
                                           const float* q_row,
                                           const float* k_s, int nu,
                                           int tg) {
  constexpr int RS = Shape<PIECE>::RS;
#pragma unroll 2
  for (int e = 0; e < PIECE; e += 4) {
    float4 x[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      x[r] = *reinterpret_cast<const float4*>(q_row + 8 * r * RS + e);
#pragma unroll
    for (int j = 0; j < U; ++j) {
      if (j < nu) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float4 kv = *reinterpret_cast<const float4*>(
              k_s + (8 * j + 2 * tg + c) * RS + e);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            float& a = s[r][j][c];
            a = fmaf(x[r].x, kv.x, a);
            a = fmaf(x[r].y, kv.y, a);
            a = fmaf(x[r].z, kv.z, a);
            a = fmaf(x[r].w, kv.w, a);
          }
        }
      }
    }
  }
}

// The wide tile (a head of in.hd > MAX_HD columns) in clusters of N
// along x: block (h * groups * N + group * N + rank, b, z) = blockIdx,
// THREADS threads, Wide<N, QRES>::SMEM bytes of dynamic shared memory;
// writes columns [PIECE p, PIECE (p + 1)) of the head's rows through
// store.one, p = group * N + rank, where p < pieces(hd). For each stage
// of KT keys, the head's chunks in turn through the ring (a unit of the
// walk: chunk c of stage it), each carrying on the chain of the warp's
// units; then the units to a slot, a cluster barrier, the warp's rows'
// scores from their block's slot, softmax_step and pv_step on V's piece.
template <int N, bool QRES, class Store>
__device__ __forceinline__ void causal_attention_tile_wide(
    const Operands& in, const Store& store) {
  namespace cg = cooperative_groups;
  using W = Wide<N, QRES>;
  constexpr int HD = PIECE;
  constexpr int RS = W::RS;
  constexpr int U = W::U;
  constexpr int S = W::STAGES;
  extern __shared__ float4 smem4[];
  float* const q_s = reinterpret_cast<float*>(smem4);  // chunks of QR x RS
  float* const ring = q_s + W::Q_FLOATS;                // S x RING
  float* const v_s = ring + S * W::RING;                // KT x RS
  float* const slots = v_s + KT * RS;                   // 2 x SLOT
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int np = pieces(in.hd);
  const int per_head = wide_groups(in.hd) * N;
  const int h = blockIdx.x / per_head, piece = blockIdx.x % per_head;
  const bool stores = piece < np;               // a piece of the head
  const int b = blockIdx.y;
  const int c0 = PIECE * piece;                 // this block's columns
  const int q_end = in.t - QROWS * (int)blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tg = lane % 4;
  const long long base = b * in.sb + h * in.sh;
  const int n_tiles = (q_end + KT - 1) / KT;
  const int n_units = n_tiles * np;
  // P@V: the warp's 16 rows, as in the narrow tile
  const int w0 = q_end - QROWS + WROWS * warp;
  const int w_end = w0 + WROWS;
  int lim[R];
#pragma unroll
  for (int r = 0; r < R; ++r) lim[r] = max(w0 + g + 8 * r, 0);
  // the scores: the warp's units, row block urb (the block's rows from
  // q_first), key blocks uj .. uj + U - 1; the block's rows' owner of
  // each row block is block rb * N / WARPS of the cluster
  const int unit0 = (rank * WARPS + warp) * U;
  const int urb = unit0 / NB, uj = unit0 % NB;
  const int q_first = q_end - QROWS + W::QR * rank;
  const int u_end = q_end - QROWS + WROWS * (urb + 1);
  const int q_off = (WROWS * urb - W::QR * rank + g) * RS;

  // unit u: chunk u % np of stage u / np (K's, and Q's when streamed)
  auto fetch = [&](int u) {
    if (u < n_units) {
      const int c = u % np, cw = min(PIECE, in.hd - PIECE * c);
      float* dst = ring + (u % S) * W::RING;
      if (!QRES)
        copy_rows<W::QR, HD, true>(dst, in.q, base + PIECE * c, in.st,
                                   q_first, in.t, in.vec16, cw);
      copy_rows<KT, HD, true>(dst + (QRES ? 0 : W::QR * RS), in.k,
                              base + PIECE * c, in.st, KT * (u / np), in.t,
                              in.vec16, cw);
    }
    cp_async_commit();
  };

  if (QRES)
    for (int c = 0; c < np; ++c)
      copy_rows<W::QR, HD, true>(q_s + c * W::QR * RS, in.q,
                                 base + PIECE * c, in.st, q_first, in.t,
                                 in.vec16, min(PIECE, in.hd - PIECE * c));
#pragma unroll
  for (int i = 0; i < S - 1; ++i) fetch(i);     // Q joins unit 0's group

  float o[HD / 8][4] = {};
  float m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * KT;
    // the warp's units below its row block's last row
    const int nu = min(max((u_end - k0 + 7) / 8, 0), NB) - uj;
    float sp[R][U][2];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < U; ++j) sp[r][j][0] = sp[r][j][1] = 0.0f;
    for (int c = 0; c < np; ++c) {
      const int u = it * np + c;
      cp_async_wait<S - 2>();   // unit u has landed
      __syncthreads();          // ... for every thread, which have all
                                // read unit u - 1: its place takes u + S - 1
      if (c == 0 && stores)     // V's piece, read after the stage's units
        copy_rows<KT, HD, true>(v_s, in.v, base + c0, in.st, k0, in.t,
                                in.vec16, min(PIECE, in.hd - c0));
      fetch(u + S - 1);         // one cp.async group a unit (V's in it)
      const float* buf = ring + (u % S) * W::RING;
      if (nu > 0)
        unit_chain<U>(sp, (QRES ? q_s + c * W::QR * RS : buf) + q_off,
                      buf + (QRES ? 0 : W::QR * RS) + 8 * uj * RS, nu, tg);
    }
    // the units to this stage's slot: unit j of the warp at (warp U + j)
    // x 128, rows g and g + 8 of it, keys 2 tg, 2 tg + 1
    float* slot = slots + (it & 1) * W::SLOT;
#pragma unroll
    for (int j = 0; j < U; ++j)
      if (j < nu)
#pragma unroll
        for (int r = 0; r < R; ++r)
          *reinterpret_cast<float2*>(slot + (warp * U + j) * WROWS * 8 +
                                     (g + 8 * r) * 8 + 2 * tg) =
              make_float2(sp[r][j][0], sp[r][j][1]);
    cp_async_wait<0>();         // V's piece has landed
    cluster.sync();             // every block's units of the stage written
    const int nb = min(max((w_end - k0 + 7) / 8, 0), NB);
    if (stores && nb > 0) {
      // row block `warp`: units 8 warp + j of block `owner`
      const int owner = warp * N / WARPS;
      const float* src = cluster.map_shared_rank(slot, owner) +
                         (NB * warp - owner * (W::UNITS / N)) * WROWS * 8;
      float s[R][NB][2];
#pragma unroll
      for (int j = 0; j < NB; ++j) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float2 x = make_float2(0.0f, 0.0f);
          if (j < nb)
            x = *reinterpret_cast<const float2*>(
                src + j * WROWS * 8 + (g + 8 * r) * 8 + 2 * tg);
          s[r][j][0] = x.x;
          s[r][j][1] = x.y;
        }
      }
      softmax_step<HD>(s, o, m, l, lim, nb, k0, tg, in.sm_scale);
      pv_step<HD>(o, s, v_s, nb, g, tg);
    }
  }
  cluster.sync();               // no peer reads this block's slots now

  if (!stores || w_end <= 0) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    l[r] = quad_sum(l[r]);
    const int row = w0 + g + 8 * r;
    if (row < 0) continue;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int col = c0 + 8 * n + 2 * tg;
      if (col < in.hd) store.one(b, h, row, col, o[n][2 * r], l[r]);
      if (col + 1 < in.hd)
        store.one(b, h, row, col + 1, o[n][2 * r + 1], l[r]);
    }
  }
}

}  // namespace attn_tc
}  // namespace arcweld
