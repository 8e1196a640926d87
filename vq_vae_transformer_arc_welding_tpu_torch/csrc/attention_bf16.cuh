// attention_bf16: the causal attention tile of kernel #9 on bf16 q, k and v
// (flash_attn.cu's flash_attention_bf16), on the bf16 tensor cores.
//
//   o[b, h, i, :] = bf16((sum_j p_ij v_j) / sum_j p_ij),
//   p_ij = exp(s_ij - max_j s_ij), s_ij = (q_i . k_j) * sm_scale, j <= i
//
// as vq_vae_transformer_arc_welding_tpu/ops/pallas_attn.py::_attn_kernel
// computes it on bf16 operands: q, k and v widened to f32, one f32 dot,
// the scale after it, the softmax in f32 and the output rounded to bf16 to
// nearest even.
//
// Work split. A block of WARPS = 4 warps takes QROWS = 64 query rows of
// one (batch, head), 16 a warp (one m16 tile of mma.sync). The row tiles
// are laid from the end of the sequence: block z takes the rows
// [T - 64 (z + 1), T - 64 z), rows below 0 idle, so the short tile of a
// ragged T sits at the rows with the fewest keys. Grid (heads, batch, row
// tiles): the heaviest tiles of every (batch, head) are launched first.
// Q is copied once and held in registers as mma A fragments; keys and
// values stream through shared memory KT = 64 at a time up to the block's
// causal limit, in a ring of three stages filled by cp.async (zero-filled
// past T), so that two stages are in flight while one is read, with one
// barrier a stage; each warp skips the stages above its own last row,
// and the P@V products of the 16-key chunks above it.
//
// Q K^T: mma.sync.m16n8k16 on the bf16 q and k, f32 accumulators. A
// product of two bf16 values is exact in f32, so the scores are the f32
// dot of the widened operands up to the order of the sum. The scale
// multiplies the f32 sum afterwards, as the JAX kernel does: 1/sqrt(hd)
// is not a power of two at hd = 24, and a q pre-scaled in bf16 would move
// the scores (tests/test_torch_flash_bf16_split.py). K is staged [key][d],
// which is mma's .col B operand as it stands (ldmatrix). A stage's scores
// are formed for all four 16-key chunks, the head-dim steps outer, so
// that eight accumulators' products interleave with no branch between
// them (a chunk past the warp's rows is masked whole).
//
// Softmax in registers. A thread holds rows g and g + 8 of its warp's
// tile (g = lane / 4) and, of each 8-key block, keys 2 tg and 2 tg + 1
// (tg = lane % 4): mma's accumulator layout. The row max is kept online
// over the four threads of a quad (__shfl_xor_sync), the numerators are
// rescaled when it grows, p = exp_f32(s - max) in f32 (ex2.approx of the
// argument times log2 e), and the division by the row sum comes after
// P@V. Masked scores are -inf; every row's key 0
// is unmasked, so no row is empty (a row below 0 attends to key 0 alone
// and is never stored).
//
// P@V: the accumulators of two neighbouring 8-key blocks are, as they
// stand, the A fragment of an m16n8k16 product over those 16 keys, so P
// never passes through shared memory. V is exact in bf16 (ldmatrix.trans
// gives its B fragments); P is f32 and is split into three bf16 terms,
// hi = bf16(p), mid = bf16(p - hi), lo = bf16(p - hi - mid): three
// significands of 8 bits hold an f32 p exactly (two leave ~2^-17 of it,
// and move more than 1e-3 of the bf16 outputs across a rounding
// boundary: the test above). The tensor core truncates its sums, so
// each 16-key chunk's three products (lo, mid, hi) go into a fresh
// accumulator that is added to the running f32 sum with one rounded add.
//
// Head widths: the tile is a template of the head width HD, instantiated
// at 16, 32, 64 and 128 (padded_head); a narrower real head runs with its
// columns hd .. HD - 1 zero in shared memory (a zero column adds an exact
// 0 to every score; P@V's columns past hd are never stored). A row is
// HD + 8 elements apart: 16-byte rows whose eight ldmatrix addresses fall
// in eight different bank groups.
//
// A head wider than MAX_HD (up to 4,096) runs on a wide form: one block
// per PIECE = 128 output columns, the blocks of one (head, row tile)
// launched as clusters of n = wide_cluster(hd) along x (2 for 2 pieces,
// 4 for 3-4, 8 from 5; more than 8 pieces take ceil(pieces / 8)
// clusters, whose blocks past the head's pieces store nothing), each
// cluster forming a stage's scores once. The sum order is fixed:
// for each 128-column chunk of the head in order, its eight k16 steps
// (WIDE_SUM_STEPS) into a fresh accumulator, which the tensor core
// truncates at each step, added to the running f32 scores with one
// rounded add. One accumulator carried over the whole head, as the
// narrow tile's, loses a truncation a step to a sum that grows with the
// head: at a head of 4,096 that moved 4.6e-3 of the bf16 outputs from
// the float64 attention's, past the gate; a fresh one a chunk, 4.9e-4
// (scripts/bench_flash_bf16_wide_sums.py, which also builds a fresh
// accumulator a step, with rounded or compensated adds; PERF.md). Every
// score keeps that order element by element, so the outputs are the
// same bits in every form and cluster size. Then softmax_pv, as the
// narrow tile's, on the three bf16 terms of P for the block's piece of
// V. The score work is ceil(pieces / 8) times a head's (a block a piece
// forming them alone would form them once a piece).
//   Up to 4 pieces (causal_attention_bf16_tile_wide): the 64 x 64 score
// tile is cut into 32 units of 16 rows x 8 keys, and the cluster's 4n
// warps take 8 / n units each, in order (block r: rows 32 r .. at n = 2,
// row block r at 4), over the whole head; each block writes its units
// to one of two slots in its shared memory, one cluster barrier a stage
// makes them visible, and each warp reads its 16 rows x 64 keys from the
// blocks that formed them through distributed shared memory. Shared
// memory: Q of the block's rows for the whole head (32 rows x 2 chunks
// at n = 2, 16 x 4 at 4; 136 elements a row), a ring of three places of
// K's chunk (64 keys), V's piece (64 rows, single, copied at the start of
// a stage while its scores form), two f32 slots of the block's units: at
// n = 2, 17,408 + 3 x 17,408 + 17,408 + 2 x 8,192 = 103,424 bytes (Wide,
// checked against 227 KB below): two blocks an SM.
//   From 5 pieces (causal_attention_bf16_tile_chunks, clusters of 8):
// that split leaves every block reading Q's and K's rows over the whole
// head (384 KB a stage at 4,096, the key halves' K four times over a
// cluster), and at 4,096 it held 2.5 TB/s of L2 reads for 1.66x the
// speed of a block a piece (PERF.md). Here block r takes whole chunks of
// the head, [r np / 8, (r + 1) np / 8) (none where empty): each warp
// forms its 16 rows x 64 keys in a fresh accumulator a chunk (the steps
// above), each chunk's partial goes to its slot; after a cluster barrier each block
// sums its 8 rows over every chunk of the head in order from 0, the
// other blocks' slots read through distributed shared memory; after a
// second barrier each warp reads its rows' sums from the two blocks that
// hold them. Shared memory at seg = ceil(pieces / 8) chunks a block: Q
// of the 64 rows for them, three places of K's chunk, V's piece, seg
// slots of 64 x 72 f32 partials and 8 x 72 sums: at 4,096 (seg 4)
// 69,632 + 52,224 + 17,408 + 73,728 + 2,304 = 215,296 bytes, one block
// an SM; up to 8 pieces 107,776, two (Chunks::smem).
//   Barriers: every thread of every block joins each stage's cluster
// barriers and the one after the loop, and no block returns before that
// last one, after which no peer reads its shared memory.
//
// What bounds it on an H100 at (16, 8, 321, 64): the 21 MB of q, k, v and
// the output (0.0063 ms at 3.35 TB/s); the products, Q K^T once and P@V
// three times in bf16, take 4 x 0.84 GFLOP at 989 TFLOP/s (0.0034 ms).
// In practice the arithmetic does: per 64-key stage a warp runs 128
// mma.sync and some 700 other instructions (the exponentials of 32
// scores a thread, the split, the rescale, the sums), and the tile
// without its copies takes most of its time, with no one part dominant
// (scripts/bench_flash_bf16_variants.py; PERF.md).
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include "common.cuh"

namespace arcweld {
namespace attn_bf16 {

constexpr int WROWS = 16;              // query rows per warp: one m16 tile
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int QROWS = WROWS * WARPS;   // query rows per block
constexpr int KT = 64;                 // keys per stage
constexpr int KC = 16;                 // keys per P@V product (k16)
constexpr int NC = KT / KC;            // 16-key chunks a stage
constexpr int MAX_HD = 128;           // the widest head of the tile
constexpr int PIECE = MAX_HD;          // output columns a wide block
constexpr int MAX_WIDE_HD = 4096;      // the widest head of the wide tile
constexpr int WIDE_SUM_STEPS = 8;      // its k16 steps a fresh accumulator

template <int HD>
struct Shape {
  static_assert(HD == 16 || HD == 32 || HD == 64 || HD == 128,
                "a head width of the tile");
  static constexpr int RS = HD + 8;    // row stride of Q, K, V, elements
  // blocks an SM: four up to HD 32 (at most 128 registers a thread);
  // three at HD 64, which spilled at 128; one at HD 128, whose 64 output
  // accumulators a thread take it to 255 registers and whose ring takes
  // 119 KB of shared memory
  static constexpr int MIN_BLOCKS = HD <= 32 ? 4 : HD == 64 ? 3 : 1;
  // the ring of K and V stages: two in flight while one is read (a ring
  // of two, and two blocks an SM at HD 128, measured no faster:
  // scripts/bench_flash_bf16_variants.py)
  static constexpr int STAGES = 3;
  static constexpr int STAGE = 2 * KT * RS;      // K then V
  static constexpr size_t SMEM =
      sizeof(__nv_bfloat16) * (QROWS * RS + STAGES * STAGE);
};

// the instantiation a real head width hd runs on
__host__ __device__ constexpr int padded_head(int hd) {
  return hd <= 16 ? 16 : hd <= 32 ? 32 : hd <= 64 ? 64 : 128;
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

inline dim3 wide_grid(int batch, int n_head, int t, int hd) {
  return dim3(n_head * wide_groups(hd) * wide_cluster(hd), batch,
              (t + QROWS - 1) / QROWS);
}

// The wide tile's shapes for clusters of N = 2 or 4 (up to 4 pieces):
// units of 16 rows x 8 keys, PER_BLOCK a block (whole row blocks, all
// KT keys) and U a warp; the block's QR rows of Q (N chunks at most,
// held); a ring of STAGES places of K's chunk, V's piece and two f32
// slots of the block's units
template <int N>
struct Wide {
  static_assert(N == 2 || N == 4, "a cluster of 2 or 4");
  static constexpr int RS = Shape<PIECE>::RS;
  static constexpr int UNITS = (QROWS / WROWS) * (KT / 8);
  static constexpr int PER_BLOCK = UNITS / N;
  static constexpr int U = PER_BLOCK / WARPS;
  static constexpr int QR = PER_BLOCK / 8 * WROWS;
  static constexpr int STAGES = 3;
  static constexpr int Q_ELEMS = N * QR * RS;
  static constexpr int RING = KT * RS;
  static constexpr int SLOT = PER_BLOCK * WROWS * 8;   // floats
  static constexpr size_t SMEM =
      sizeof(__nv_bfloat16) * (Q_ELEMS + STAGES * RING + KT * RS) +
      sizeof(float) * 2 * SLOT;
  static_assert(PER_BLOCK % 8 == 0, "whole row blocks a block");
  static_assert(SMEM <= 232448, "227 KB of shared memory a block");
  static_assert(WIDE_SUM_STEPS * 16 == PIECE, "a fresh accumulator a chunk");
};

// The chunked form's shapes (5 pieces and more, clusters of 8): a
// block's segment of at most seg(hd) <= MAXL chunks of the head, Q of
// all QROWS rows for them (held, CHUNK_Q elements a chunk), a ring of
// STAGES places of K's chunk, V's piece; a slot of f32 partial scores a
// chunk of the segment (QROWS x KT, rows SRS floats apart) and the sums
// of the block's ROWS rows; smem(seg) bytes
struct Chunks {
  static constexpr int N = WIDE_MAX_CLUSTER;
  static constexpr int MAXL = MAX_WIDE_HD / PIECE / N;
  static constexpr int RS = Shape<PIECE>::RS;
  static constexpr int SRS = KT + 8;
  static constexpr int ROWS = QROWS / N;
  static constexpr int STAGES = 3;
  static constexpr int CHUNK_Q = QROWS * RS;
  static constexpr int RING = KT * RS;
  static constexpr int SLOT = QROWS * SRS;             // floats
  __host__ __device__ static constexpr int seg(int hd) {
    return (pieces(hd) + N - 1) / N;
  }
  __host__ __device__ static constexpr size_t smem(int seg) {
    return sizeof(__nv_bfloat16) * (seg * CHUNK_Q + STAGES * RING + KT * RS) +
           sizeof(float) * (seg * SLOT + ROWS * SRS);
  }
  static_assert(ROWS * KT == 4 * THREADS, "four sums a thread");
};
static_assert(Chunks::smem(Chunks::MAXL) <= 232448,
              "227 KB of shared memory a block");

// q, k, v element (b, h, i, e) at b*sb + h*sh + i*st + e; vec16: every row
// starts 16-byte aligned and hd is a multiple of 8, so rows are copied 16
// bytes at a time, else an element at a time. hd: the real head width;
// sm_scale: 1/sqrt(hd).
struct Operands {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  long long sb, sh, st;
  int t;
  float sm_scale;
  bool vec16;
  int hd;
};

// o element (b, h, i, e) at b*sb + h*sh + i*st + e; pairs: two
// neighbouring columns are one aligned 4-byte store (hd even, the
// offsets even, o 4-byte aligned)
struct Output {
  __nv_bfloat16* o;
  long long sb, sh, st;
  bool pairs;
};

__host__ inline bool rows_aligned16(const void* q, const void* k,
                                    const void* v, long long sb,
                                    long long sh, long long st, int hd) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(q) |
                      reinterpret_cast<uintptr_t>(k) |
                      reinterpret_cast<uintptr_t>(v);
  return p % 16 == 0 && (sb | sh | st | hd) % 8 == 0;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lanes 8 i .. 8 i + 7 give matrix i's row
// addresses, register i holds matrix i (.trans: transposed)
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

// d = a (16 x 16, row) * b (16 x 8, col) + d, bf16 operands, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) rounded to bf16 to nearest even, x in the low half (the smaller
// k index of an mma fragment)
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(y), "f"(x));
  return r;
}

// x -= low half of u, y -= high half, both exact: a value minus its own
// bf16 rounding (or that of its remainder) loses no bit
__device__ __forceinline__ void take(float& x, float& y, uint32_t u) {
  x = __fsub_rn(x, __uint_as_float(u << 16));
  y = __fsub_rn(y, __uint_as_float(u & 0xffff0000u));
}

// p = (x, y) as three packed bf16 terms, hi + mid + lo
__device__ __forceinline__ void split3(float x, float y, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  hi = pack_bf16(x, y);
  take(x, y, hi);
  mid = pack_bf16(x, y);
  take(x, y, mid);
  lo = pack_bf16(x, y);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A thread's share of copying rows of q, k or v (element (row, e) at
// x[row * st + e], x the operand's base for the block's (batch, head))
// into shared memory, RS elements a row: where vec16, the 16-byte piece
// at column col of the rows row0 + RSTEP i (the same column every row,
// its address formed once), else element by element. Rows outside [0, t)
// and the columns from hd on are zero-filled. The element copies go
// through a register (cp.async moves 4 bytes at least) and are visible
// to the block after the __syncthreads that precedes the stage's use, as
// the cp.async copies are.
template <int HD>
struct RowCopy {
  static constexpr int RS = Shape<HD>::RS;
  static constexpr int CPR = HD / 8;             // 16-byte pieces a row
  static constexpr int RSTEP = THREADS / CPR;    // rows between a thread's
  const __nv_bfloat16* x;
  long long st;
  int t, hd, row0, col;
  bool vec16;

  __device__ __forceinline__ RowCopy(const __nv_bfloat16* x, long long st,
                                     int t, int hd, bool vec16)
      : x(x), st(st), t(t), hd(hd), row0(threadIdx.x / CPR),
        col(8 * (threadIdx.x % CPR)), vec16(vec16) {}

  // rows [r0, r0 + N) into dst
  template <int N>
  __device__ __forceinline__ void rows(__nv_bfloat16* dst, int r0) const {
    if (vec16) {
      const __nv_bfloat16* src = x + (long long)(r0 + row0) * st + col;
#pragma unroll
      for (int i = 0; i < N / RSTEP; ++i) {
        const int r = r0 + row0 + RSTEP * i;
        const bool ok = r >= 0 && r < t && col < hd;
        cp_async16(dst + (row0 + RSTEP * i) * RS + col,
                   ok ? src + RSTEP * i * st : x, ok);
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < N * HD / THREADS; ++i) {
        const int e = threadIdx.x + i * THREADS;
        const int row = e / HD, c = e % HD;
        const int r = r0 + row;
        dst[row * RS + c] = r >= 0 && r < t && c < hd
                                ? x[(long long)r * st + c]
                                : __float2bfloat16(0.0f);
      }
    }
  }
};

// e^x as 2^(x log2 e): the argument rounded once to f32 (a relative
// error of |x| 2^-24 in the result, which is below the f32 step where
// e^x > e^-1 and small where e^x is), then ex2.approx (2 ulp); -inf -> 0
__device__ __forceinline__ float exp_f32(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n"
      : "=f"(y)
      : "f"(__fmul_rn(x, 1.4426950408889634f)));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// One stage of keys and values (k_s, v_s: keys k0 .. k0 + 63) for a warp
// into its running o, row max m and partial row sums l. The scores of
// all NC chunks are formed, the head-dim steps outer, so that the eight
// accumulators' products interleave without a branch (a chunk past the
// warp's last row is masked whole); P@V runs on the first nc chunks
// alone (the others' p are 0). mask: some key of the stage lies past a
// row's limit (lim0, lim1).
// A k16 step of the scores s of a stage's NC chunks (k_row: this lane's
// ldmatrix row of K's tile at the step's columns)
template <int RS>
__device__ __forceinline__ void score_step(float (&s)[2 * NC][4],
                                           const uint32_t (&qf)[4],
                                           const __nv_bfloat16* k_row) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    // B fragments of the key blocks 2 c and 2 c + 1
    uint32_t kf[4];
    ldsm_x4(kf, k_row + KC * c * RS);
    mma_bf16(s[2 * c], qf, kf[0], kf[1]);
    mma_bf16(s[2 * c + 1], qf, kf[2], kf[3]);
  }
}

// this lane's ldmatrix row of a K tile (RS elements a row)
template <int RS>
__device__ __forceinline__ const __nv_bfloat16* k_row_of(
    const __nv_bfloat16* k_s) {
  const int lane = threadIdx.x % 32;
  return k_s + (lane % 8 + 8 * (lane / 16)) * RS + 8 * ((lane / 8) % 2);
}

template <int HD>
__device__ __forceinline__ void softmax_pv(
    float (&s)[2 * NC][4], float (&o)[HD / 8][4], float (&m)[2],
    float (&l)[2], const __nv_bfloat16* v_s, int nc, bool mask, int k0,
    int lim0, int lim1, float sm_scale);

template <int HD>
__device__ __forceinline__ void stage_step(
    const uint32_t (&qf)[HD / 16][4], float (&o)[HD / 8][4], float (&m)[2],
    float (&l)[2], const __nv_bfloat16* k_s, const __nv_bfloat16* v_s,
    int nc, bool mask, int k0, int lim0, int lim1, float sm_scale) {
  constexpr int RS = Shape<HD>::RS;
  constexpr int KD = HD / 16;          // k16 steps of Q K^T
  // s[j]: rows g (0, 1) and g + 8 (2, 3), keys k0 + 8 j + 2 tg, + 1
  float s[2 * NC][4] = {};
  const __nv_bfloat16* k_row = k_row_of<RS>(k_s);
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) score_step<RS>(s, qf[kk], k_row + 16 * kk);
  softmax_pv<HD>(s, o, m, l, v_s, nc, mask, k0, lim0, lim1, sm_scale);
}

// The rest of a stage from its scores s: scale, mask, the online
// softmax and o += P V on the first nc chunks
template <int HD>
__device__ __forceinline__ void softmax_pv(
    float (&s)[2 * NC][4], float (&o)[HD / 8][4], float (&m)[2],
    float (&l)[2], const __nv_bfloat16* v_s, int nc, bool mask, int k0,
    int lim0, int lim1, float sm_scale) {
  constexpr int RS = Shape<HD>::RS;
  constexpr int ND = HD / 8;           // 8-column blocks of the output
  const int lane = threadIdx.x % 32, tg = lane % 4;

  // scale, causal mask (on the stages that reach past a row), online
  // softmax numerators
#pragma unroll
  for (int j = 0; j < 2 * NC; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = __fmul_rn(s[j][i], sm_scale);
  if (mask) {
#pragma unroll
    for (int j = 0; j < 2 * NC; ++j) {
      const int kc = k0 + 8 * j + 2 * tg;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (kc + (i & 1) > (i < 2 ? lim0 : lim1)) s[j][i] = -INFINITY;
    }
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 2 * NC; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
    mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
  }
  // every row sees key 0 in the first stage, so m is finite from there
  const float mn0 = fmaxf(m[0], quad_max(mx0));
  const float mn1 = fmaxf(m[1], quad_max(mx1));
  const float alpha0 = exp_f32(m[0] - mn0), alpha1 = exp_f32(m[1] - mn1);
  m[0] = mn0;
  m[1] = mn1;
  float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
  for (int j = 0; j < 2 * NC; ++j) {
    s[j][0] = exp_f32(s[j][0] - mn0);
    s[j][1] = exp_f32(s[j][1] - mn0);
    s[j][2] = exp_f32(s[j][2] - mn1);
    s[j][3] = exp_f32(s[j][3] - mn1);
    ps0 += s[j][0] + s[j][1];
    ps1 += s[j][2] + s[j][3];
  }
  l[0] = l[0] * alpha0 + ps0;   // this thread's keys; summed at the end
  l[1] = l[1] * alpha1 + ps1;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    o[n][0] *= alpha0;
    o[n][1] *= alpha0;
    o[n][2] *= alpha1;
    o[n][3] *= alpha1;
  }

  // o += P V, 16 keys a step: P's A fragment is the scores of the key
  // blocks 2 c and 2 c + 1 as they stand, in three bf16 terms
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (c < nc) {
      uint32_t ph[4], pm[4], pl[4];
      split3(s[2 * c][0], s[2 * c][1], ph[0], pm[0], pl[0]);
      split3(s[2 * c][2], s[2 * c][3], ph[1], pm[1], pl[1]);
      split3(s[2 * c + 1][0], s[2 * c + 1][1], ph[2], pm[2], pl[2]);
      split3(s[2 * c + 1][2], s[2 * c + 1][3], ph[3], pm[3], pl[3]);
#pragma unroll
      for (int np = 0; np < ND / 2; ++np) {
        // B fragments of the head dims 16 np .. 16 np + 15
        uint32_t vf[4];
        ldsm_x4_trans(vf, v_s + (KC * c + lane % 16) * RS + 16 * np +
                              8 * (lane / 16));
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma_bf16(acc, pl, vf[2 * e], vf[2 * e + 1]);
          mma_bf16(acc, pm, vf[2 * e], vf[2 * e + 1]);
          mma_bf16(acc, ph, vf[2 * e], vf[2 * e + 1]);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            o[2 * np + e][i] = __fadd_rn(o[2 * np + e][i], acc[i]);
        }
      }
    }
  }
}

// The tile of block (h, b, z) = blockIdx, THREADS threads, Shape<HD>::SMEM
// bytes of dynamic shared memory.
template <int HD>
__device__ __forceinline__ void causal_attention_bf16_tile(
    const Operands& in, const Output& out) {
  constexpr int RS = Shape<HD>::RS;
  constexpr int STAGE = Shape<HD>::STAGE;
  constexpr int STAGES = Shape<HD>::STAGES;
  constexpr int KD = HD / 16;          // k16 steps of Q K^T
  constexpr int ND = HD / 8;           // 8-column blocks of the output
  extern __shared__ float4 smem4[];
  __nv_bfloat16* const q_s = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* const stages = q_s + QROWS * RS;   // STAGES x (K, V)
  const int h = blockIdx.x, b = blockIdx.y;
  const int q_end = in.t - QROWS * (int)blockIdx.z;      // rows < q_end
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tg = lane % 4;
  const int w0 = q_end - QROWS + WROWS * warp;           // may be < 0
  const int w_end = w0 + WROWS;
  const long long base = b * in.sb + h * in.sh;
  const int n_tiles = (q_end + KT - 1) / KT;
  // a thread's rows w0 + g and w0 + g + 8; a row below 0 attends to
  // key 0 (finite, never stored)
  const int lim0 = max(w0 + g, 0), lim1 = max(w0 + g + 8, 0);

  const RowCopy<HD> q_rows(in.q + base, in.st, in.t, in.hd, in.vec16);
  const RowCopy<HD> k_rows(in.k + base, in.st, in.t, in.hd, in.vec16);
  const RowCopy<HD> v_rows(in.v + base, in.st, in.t, in.hd, in.vec16);
  // stage i of the keys and values, keys 64 i .. 64 i + 63, into its
  // place in the ring; one cp.async group, empty past the last stage
  auto fetch = [&](int i) {
    if (i < n_tiles) {
      __nv_bfloat16* dst = stages + (i % STAGES) * STAGE;
      k_rows.template rows<KT>(dst, KT * i);
      v_rows.template rows<KT>(dst + KT * RS, KT * i);
    }
    cp_async_commit();
  };

  q_rows.template rows<QROWS>(q_s, q_end - QROWS);
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) fetch(i);
  cp_async_wait<STAGES - 1>();   // Q has landed
  __syncthreads();

  // Q's A fragments: k step kk holds head dims 16 kk .. 16 kk + 15
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    ldsm_x4(qf[kk], q_s + (WROWS * warp + lane % 16) * RS + 16 * kk +
                        8 * (lane / 16));

  // o[n]: rows g (0, 1) and g + 8 (2, 3), head dims 8 n + 2 tg, + 1
  float o[ND][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * KT;
    cp_async_wait<STAGES - 2>();   // stage it has landed
    // ... for every thread, which have all read stage it - 1: its place
    // takes stage it + STAGES - 1
    __syncthreads();
    fetch(it + STAGES - 1);
    const __nv_bfloat16* k_s = stages + (it % STAGES) * STAGE;
    const __nv_bfloat16* v_s = k_s + KT * RS;
    // the 16-key chunks this warp needs (keys below w_end), and whether
    // a key of the stage lies past a row's limit
    const int nc = min(max((w_end - k0 + KC - 1) / KC, 0), NC);
    const bool mask = k0 + KT - 1 > max(w0, 0);
    if (nc > 0)
      stage_step<HD>(qf, o, m, l, k_s, v_s, nc, mask, k0, lim0, lim1,
                     in.sm_scale);
  }

  if (w_end <= 0) return;
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + g + 8 * r;
    if (row < 0) continue;
    __nv_bfloat16* o_row = out.o + b * out.sb + h * out.sh + row * out.st;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int col = 8 * n + 2 * tg;
      const float y0 = o[n][2 * r] / l[r], y1 = o[n][2 * r + 1] / l[r];
      if (out.pairs) {
        if (col < in.hd)
          *reinterpret_cast<__nv_bfloat162*>(o_row + col) =
              __floats2bfloat162_rn(y0, y1);
      } else {
        if (col < in.hd) o_row[col] = __float2bfloat16_rn(y0);
        if (col + 1 < in.hd) o_row[col + 1] = __float2bfloat16_rn(y1);
      }
    }
  }
}

// The wide tile (a head of in.hd > MAX_HD columns) in clusters of N
// along x: block (h * groups * N + group * N + rank, b, z) = blockIdx,
// THREADS threads, Wide<N>::SMEM bytes of dynamic shared memory; writes
// columns [PIECE p, PIECE (p + 1)) of the head's rows, p = group * N +
// rank, where p < pieces(hd). For each stage of KT keys, the head's
// 128-column chunks of K in turn through the ring (zero past the head
// and past T), each chunk's k16 steps of the warp's units into a fresh
// accumulator added to their scores; then the units to a slot, a
// cluster barrier, the warp's rows' scores from the blocks that formed
// them, softmax_pv as in the tile above.
template <int N>
__device__ __forceinline__ void causal_attention_bf16_tile_wide(
    const Operands& in, const Output& out) {
  namespace cg = cooperative_groups;
  using W = Wide<N>;
  constexpr int HD = PIECE;
  constexpr int RS = W::RS;
  constexpr int ND = HD / 8;           // 8-column blocks of the output
  constexpr int U = W::U;
  constexpr int S = W::STAGES;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* const q_s = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* const ring = q_s + W::Q_ELEMS;       // S x RING
  __nv_bfloat16* const v_s = ring + S * W::RING;      // KT x RS
  float* const slots = reinterpret_cast<float*>(v_s + KT * RS);
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int np = pieces(in.hd);
  const int per_head = wide_groups(in.hd) * N;
  const int h = blockIdx.x / per_head, piece = blockIdx.x % per_head;
  const bool stores = piece < np;                // a piece of the head
  const int b = blockIdx.y;
  const int c0 = PIECE * piece;                  // this block's columns
  const int q_end = in.t - QROWS * (int)blockIdx.z;      // rows < q_end
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tg = lane % 4;
  const int w0 = q_end - QROWS + WROWS * warp;           // may be < 0
  const int w_end = w0 + WROWS;
  const long long base = b * in.sb + h * in.sh;
  const int n_tiles = (q_end + KT - 1) / KT;
  const int n_units = n_tiles * np;
  const int lim0 = max(w0 + g, 0), lim1 = max(w0 + g + 8, 0);
  // the block's units from first (row block rb0, all keys); the
  // warp's: row block urb, key blocks uj .. uj + U - 1
  const int first = rank * W::PER_BLOCK;
  const int rb0 = first / 8;
  const int unit0 = first + warp * U;
  const int urb = unit0 / 8, uj = unit0 % 8;
  const int q_first = q_end - QROWS + WROWS * rb0;
  const int u_end = q_end - QROWS + WROWS * (urb + 1);
  const int q_lane = (WROWS * (urb - rb0) + lane % 16) * RS + 8 * (lane / 16);

  // unit u: K's chunk u % np of stage u / np, the block's keys
  auto fetch = [&](int u) {
    if (u < n_units) {
      const int c = u % np;
      RowCopy<HD>(in.k + base + PIECE * c, in.st, in.t,
                  min(PIECE, in.hd - PIECE * c), in.vec16)
          .template rows<KT>(ring + (u % S) * W::RING, KT * (u / np));
    }
    cp_async_commit();
  };

  for (int c = 0; c < np; ++c)
    RowCopy<HD>(in.q + base + PIECE * c, in.st, in.t,
                min(PIECE, in.hd - PIECE * c), in.vec16)
        .template rows<W::QR>(q_s + c * W::QR * RS, q_first);
#pragma unroll
  for (int i = 0; i < S - 1; ++i) fetch(i);      // Q joins unit 0's group

  float o[ND][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * KT;
    // the warp's units below its row block's last row
    const int nu =
        2 * min(max((u_end - k0 + KC - 1) / KC, 0), NC) - uj;
    float sp[U][4] = {};
    for (int c = 0; c < np; ++c) {
      const int u = it * np + c;
      cp_async_wait<S - 2>();   // unit u has landed
      __syncthreads();          // ... for every thread, which have all
                                // read unit u - 1: its place takes u + S - 1
      if (c == 0 && stores)     // V's piece, read after the stage's units
        RowCopy<HD>(in.v + base + c0, in.st, in.t, min(PIECE, in.hd - c0),
                    in.vec16)
            .template rows<KT>(v_s, k0);
      fetch(u + S - 1);         // one cp.async group a unit (V's in it)
      if (nu > 0) {
        const int cw = min(PIECE, in.hd - PIECE * c);
        const __nv_bfloat16* q_c = q_s + c * W::QR * RS + q_lane;
        const __nv_bfloat16* k_row = k_row_of<RS>(
            ring + (u % S) * W::RING + 8 * uj * RS);
        float part[U][4] = {};
#pragma unroll
        for (int kk = 0; kk < WIDE_SUM_STEPS; ++kk) {
          if (16 * kk < cw) {
            uint32_t qf[4];
            ldsm_x4(qf, q_c + 16 * kk);
#pragma unroll
            for (int j = 0; j < U; j += 2) {
              // B fragments of the key blocks uj + j and uj + j + 1
              uint32_t kf[4];
              ldsm_x4(kf, k_row + 8 * j * RS + 16 * kk);
              mma_bf16(part[j], qf, kf[0], kf[1]);
              mma_bf16(part[j + 1], qf, kf[2], kf[3]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < U; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            sp[j][i] = __fadd_rn(sp[j][i], part[j][i]);
      }
    }
    // the units to this stage's slot: unit j of the warp at (warp U + j)
    // x 128, rows g and g + 8 of it, keys 2 tg, 2 tg + 1
    float* slot = slots + (it & 1) * W::SLOT;
#pragma unroll
    for (int j = 0; j < U; ++j) {
      if (j < nu) {
        float* dst = slot + (warp * U + j) * WROWS * 8 + g * 8 + 2 * tg;
        *reinterpret_cast<float2*>(dst) = make_float2(sp[j][0], sp[j][1]);
        *reinterpret_cast<float2*>(dst + 64) =
            make_float2(sp[j][2], sp[j][3]);
      }
    }
    cp_async_wait<0>();         // V's piece has landed
    cluster.sync();             // every block's units of the stage written
    const int nc = min(max((w_end - k0 + KC - 1) / KC, 0), NC);
    if (stores && nc > 0) {
      // row block `warp`: unit 8 warp + j in block (8 warp + j) / PER_BLOCK
      float s[2 * NC][4];
#pragma unroll
      for (int j = 0; j < 2 * NC; ++j) {
        float2 x0 = make_float2(0.0f, 0.0f), x1 = x0;
        if (j < 2 * nc) {
          const int unit = 8 * warp + j, owner = unit / W::PER_BLOCK;
          const float* src = cluster.map_shared_rank(slot, owner) +
                             (unit - owner * W::PER_BLOCK) * WROWS * 8 +
                             g * 8 + 2 * tg;
          x0 = *reinterpret_cast<const float2*>(src);
          x1 = *reinterpret_cast<const float2*>(src + 64);
        }
        s[j][0] = x0.x;
        s[j][1] = x0.y;
        s[j][2] = x1.x;
        s[j][3] = x1.y;
      }
      const bool mask = k0 + KT - 1 > max(w0, 0);
      softmax_pv<HD>(s, o, m, l, v_s, nc, mask, k0, lim0, lim1,
                     in.sm_scale);
    }
  }
  cluster.sync();               // no peer reads this block's slots now

  if (!stores || w_end <= 0) return;
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + g + 8 * r;
    if (row < 0) continue;
    __nv_bfloat16* o_row =
        out.o + b * out.sb + h * out.sh + row * out.st + c0;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int col = 8 * n + 2 * tg;
      const float y0 = o[n][2 * r] / l[r], y1 = o[n][2 * r + 1] / l[r];
      if (out.pairs) {
        if (c0 + col < in.hd)
          *reinterpret_cast<__nv_bfloat162*>(o_row + col) =
              __floats2bfloat162_rn(y0, y1);
      } else {
        if (c0 + col < in.hd) o_row[col] = __float2bfloat16_rn(y0);
        if (c0 + col + 1 < in.hd) o_row[col + 1] = __float2bfloat16_rn(y1);
      }
    }
  }
}

// The chunked form (5 pieces and more: clusters of N = 8 along x, block
// (h * groups * N + group * N + rank, b, z) = blockIdx, THREADS threads,
// Chunks::smem(Chunks::seg(hd)) bytes of dynamic shared memory; writes
// columns [PIECE p,
// PIECE (p + 1)) of the head's rows, p = group * N + rank, where p <
// pieces(hd)). Block r takes the head's chunks [r np / N, (r + 1) np /
// N) (none where that is empty), Q of the tile's rows for them held. For
// each stage of KT keys: V's piece is copied; for each of the block's
// chunks, K's chunk through the ring and each warp's 16 rows x 64 keys
// in a fresh accumulator through the chunk's k16 steps (score_step, as
// the tile above), the partial to the chunk's slot; a cluster barrier; the
// block sums its ROWS rows' partials over every chunk of the head in the
// head's order from 0 (rounded adds, the other blocks' slots through
// distributed shared memory); a cluster barrier; each warp reads its
// rows' sums from the blocks that formed them, and softmax_pv on V's
// piece.
__device__ __forceinline__ void causal_attention_bf16_tile_chunks(
    const Operands& in, const Output& out) {
  namespace cg = cooperative_groups;
  using C = Chunks;
  constexpr int N = C::N;
  constexpr int HD = PIECE;
  constexpr int RS = C::RS;
  constexpr int ND = HD / 8;           // 8-column blocks of the output
  constexpr int S = C::STAGES;
  const int seg = C::seg(in.hd);
  extern __shared__ float4 smem4[];
  __nv_bfloat16* const q_s = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* const ring = q_s + seg * C::CHUNK_Q;  // S x RING
  __nv_bfloat16* const v_s = ring + S * C::RING;       // KT x RS
  float* const slots = reinterpret_cast<float*>(v_s + KT * RS);  // seg x SLOT
  float* const sums = slots + seg * C::SLOT;           // ROWS x SRS
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int np = pieces(in.hd);
  const int per_head = wide_groups(in.hd) * N;
  const int h = blockIdx.x / per_head, piece = blockIdx.x % per_head;
  const bool stores = piece < np;                // a piece of the head
  const int b = blockIdx.y;
  const int c0 = PIECE * piece;                  // this block's columns
  const int q_end = in.t - QROWS * (int)blockIdx.z;      // rows < q_end
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tg = lane % 4;
  const int w0 = q_end - QROWS + WROWS * warp;           // may be < 0
  const int w_end = w0 + WROWS;
  const long long base = b * in.sb + h * in.sh;
  const int n_tiles = (q_end + KT - 1) / KT;
  const int lim0 = max(w0 + g, 0), lim1 = max(w0 + g + 8, 0);
  // the block's chunks of the head, its units (a chunk of a stage)
  const int seg0 = rank * np / N, len = (rank + 1) * np / N - seg0;
  const int n_units = n_tiles * len;
  const __nv_bfloat16* q_lane =
      q_s + (WROWS * warp + lane % 16) * RS + 8 * (lane / 16);

  // unit u: K's chunk seg0 + u % len of stage u / len
  auto fetch = [&](int u) {
    if (u < n_units) {
      const int c = seg0 + u % len;
      RowCopy<HD>(in.k + base + PIECE * c, in.st, in.t,
                  min(PIECE, in.hd - PIECE * c), in.vec16)
          .template rows<KT>(ring + (u % S) * C::RING, KT * (u / len));
    }
    cp_async_commit();
  };

  for (int l = 0; l < len; ++l)
    RowCopy<HD>(in.q + base + PIECE * (seg0 + l), in.st, in.t,
                min(PIECE, in.hd - PIECE * (seg0 + l)), in.vec16)
        .template rows<QROWS>(q_s + l * C::CHUNK_Q, q_end - QROWS);
#pragma unroll
  for (int i = 0; i < S - 1; ++i) fetch(i);      // Q joins unit 0's group

  float o[ND][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l_sum[2] = {0.0f, 0.0f};
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * KT;
    const int nc = min(max((w_end - k0 + KC - 1) / KC, 0), NC);
    __syncthreads();            // the last stage's P@V has read V's piece
    if (stores)                 // V's piece, read after the stage's sums
      RowCopy<HD>(in.v + base + c0, in.st, in.t, min(PIECE, in.hd - c0),
                  in.vec16)
          .template rows<KT>(v_s, k0);
    cp_async_commit();
    for (int l = 0; l < len; ++l) {
      const int u = it * len + l;
      cp_async_wait<S - 2>();   // unit u has landed
      __syncthreads();          // ... for every thread, which have all
                                // read unit u - 1: its place takes u + S - 1
      fetch(u + S - 1);
      if (nc > 0) {
        const int cw = min(PIECE, in.hd - PIECE * (seg0 + l));
        const __nv_bfloat16* k_row =
            k_row_of<RS>(ring + (u % S) * C::RING);
        float part[2 * NC][4] = {};
#pragma unroll
        for (int kk = 0; kk < WIDE_SUM_STEPS; ++kk) {
          if (16 * kk < cw) {
            uint32_t qf[4];
            ldsm_x4(qf, q_lane + l * C::CHUNK_Q + 16 * kk);
            score_step<RS>(part, qf, k_row + 16 * kk);
          }
        }
        // the partial to its slot: rows g and g + 8 of the warp's, keys
        // 8 j + 2 tg, + 1
        float* dst = slots + l * C::SLOT + (WROWS * warp + g) * C::SRS +
                     2 * tg;
#pragma unroll
        for (int j = 0; j < 2 * NC; ++j) {
          *reinterpret_cast<float2*>(dst + 8 * j) =
              make_float2(part[j][0], part[j][1]);
          *reinterpret_cast<float2*>(dst + 8 * C::SRS + 8 * j) =
              make_float2(part[j][2], part[j][3]);
        }
      }
    }
    cp_async_wait<0>();         // V's piece has landed
    cluster.sync();             // every block's partials of the stage
    {
      // this block's rows: four keys a thread, the head's chunks in
      // order from 0, block by block
      const int row = C::ROWS * rank + threadIdx.x / (KT / 4);
      const int key = 4 * (threadIdx.x % (KT / 4));
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int r = 0; r < N; ++r) {
        const int s0 = r * np / N, n_r = (r + 1) * np / N - s0;
        const float* src =
            cluster.map_shared_rank(slots, r) + row * C::SRS + key;
        for (int l = 0; l < n_r; ++l) {
          const float4 x =
              *reinterpret_cast<const float4*>(src + l * C::SLOT);
          acc.x = __fadd_rn(acc.x, x.x);
          acc.y = __fadd_rn(acc.y, x.y);
          acc.z = __fadd_rn(acc.z, x.z);
          acc.w = __fadd_rn(acc.w, x.w);
        }
      }
      *reinterpret_cast<float4*>(sums + (row - C::ROWS * rank) * C::SRS +
                                 key) = acc;
    }
    cluster.sync();             // every block's sums of the stage
    if (stores && nc > 0) {
      // row w0 + g from block 2 warp, w0 + g + 8 from block 2 warp + 1
      const float* lo =
          cluster.map_shared_rank(sums, 2 * warp) + g * C::SRS + 2 * tg;
      const float* hi =
          cluster.map_shared_rank(sums, 2 * warp + 1) + g * C::SRS + 2 * tg;
      float s[2 * NC][4];
#pragma unroll
      for (int j = 0; j < 2 * NC; ++j) {
        float2 x0 = make_float2(0.0f, 0.0f), x1 = x0;
        if (j < 2 * nc) {
          x0 = *reinterpret_cast<const float2*>(lo + 8 * j);
          x1 = *reinterpret_cast<const float2*>(hi + 8 * j);
        }
        s[j][0] = x0.x;
        s[j][1] = x0.y;
        s[j][2] = x1.x;
        s[j][3] = x1.y;
      }
      const bool mask = k0 + KT - 1 > max(w0, 0);
      softmax_pv<HD>(s, o, m, l_sum, v_s, nc, mask, k0, lim0, lim1,
                     in.sm_scale);
    }
  }
  cluster.sync();               // no peer reads this block's sums now

  if (!stores || w_end <= 0) return;
  l_sum[0] = quad_sum(l_sum[0]);
  l_sum[1] = quad_sum(l_sum[1]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + g + 8 * r;
    if (row < 0) continue;
    __nv_bfloat16* o_row =
        out.o + b * out.sb + h * out.sh + row * out.st + c0;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int col = 8 * n + 2 * tg;
      const float y0 = o[n][2 * r] / l_sum[r];
      const float y1 = o[n][2 * r + 1] / l_sum[r];
      if (out.pairs) {
        if (c0 + col < in.hd)
          *reinterpret_cast<__nv_bfloat162*>(o_row + col) =
              __floats2bfloat162_rn(y0, y1);
      } else {
        if (c0 + col < in.hd) o_row[col] = __float2bfloat16_rn(y0);
        if (c0 + col + 1 < in.hd) o_row[col + 1] = __float2bfloat16_rn(y1);
      }
    }
  }
}

}  // namespace attn_bf16
}  // namespace arcweld
