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
// A head wider than MAX_HD (up to 4,096) runs on the wide tile
// (causal_attention_bf16_tile_wide): one block per PIECE = 128 output
// columns, folded into blockIdx.x beside the head. For each 64-key stage
// the block stages Q's and K's 128-column chunks of the head in turn
// through shared memory (no registers hold Q). Each chunk's eight k16
// steps (WIDE_SUM_STEPS) go into a fresh accumulator, which the tensor
// core truncates at each step, and that is added to the running f32
// scores with one rounded add, the chunks in the head's order: the same
// chain in every piece, so every piece's softmax is the same. One
// accumulator carried over the whole head, as the narrow tile's, loses
// a truncation a step to a sum that grows with the head: at a head of
// 4,096 that moved 4.6e-3 of the bf16 outputs from the float64
// attention's, past the gate; a fresh one a chunk, 4.9e-4
// (scripts/bench_flash_bf16_wide_sums.py, which also builds a fresh
// accumulator a step, with rounded or compensated adds; PERF.md). Then
// the softmax and P@V on the three bf16 terms of P, as the narrow
// tile's, for the block's piece of V. The scores are formed once a piece, (hd /
// 128)x the narrow tile's work, and nothing is double-buffered: a simple
// form that is right; its times are in PERF.md.
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

// the wide tile's blocks a head, its grid and its shared memory: Q's
// chunk, K's chunk and V's piece
__host__ __device__ constexpr int pieces(int hd) {
  return (hd + PIECE - 1) / PIECE;
}

inline dim3 wide_grid(int batch, int n_head, int t, int hd) {
  return dim3(n_head * pieces(hd), batch, (t + QROWS - 1) / QROWS);
}

constexpr size_t WIDE_SMEM =
    sizeof(__nv_bfloat16) * (QROWS + 2 * KT) * Shape<PIECE>::RS;

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

// The wide tile (a head of in.hd > MAX_HD columns): block (h *
// pieces(hd) + p, b, z) = blockIdx, THREADS threads, WIDE_SMEM bytes of
// dynamic shared memory; writes columns [PIECE p, PIECE (p + 1)) of the
// head's rows. For each stage of KT keys: V's piece is copied, then for
// each 128-column chunk of the head in order Q's and K's chunks (zero
// past the head and past T), the chunk's k16 steps into a fresh
// accumulator and that added to the scores; then softmax_pv as in the
// tile above.
__device__ __forceinline__ void causal_attention_bf16_tile_wide(
    const Operands& in, const Output& out) {
  constexpr int HD = PIECE;
  constexpr int RS = Shape<HD>::RS;
  constexpr int ND = HD / 8;           // 8-column blocks of the output
  extern __shared__ float4 smem4[];
  __nv_bfloat16* const q_s = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* const k_s = q_s + QROWS * RS;
  __nv_bfloat16* const v_s = k_s + KT * RS;
  const int np = pieces(in.hd);
  const int h = blockIdx.x / np, b = blockIdx.y;
  const int c0 = PIECE * (blockIdx.x % np);      // this block's columns
  const int q_end = in.t - QROWS * (int)blockIdx.z;      // rows < q_end
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tg = lane % 4;
  const int w0 = q_end - QROWS + WROWS * warp;           // may be < 0
  const int w_end = w0 + WROWS;
  const long long base = b * in.sb + h * in.sh;
  const int n_tiles = (q_end + KT - 1) / KT;
  const int lim0 = max(w0 + g, 0), lim1 = max(w0 + g + 8, 0);
  const __nv_bfloat16* k_row = k_row_of<RS>(k_s);

  float o[ND][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * KT;
    const int nc = min(max((w_end - k0 + KC - 1) / KC, 0), NC);
    const bool mask = k0 + KT - 1 > max(w0, 0);
    RowCopy<HD>(in.v + base + c0, in.st, in.t, min(PIECE, in.hd - c0),
                in.vec16)
        .rows<KT>(v_s, k0);
    float s[2 * NC][4] = {};
    for (int e0 = 0; e0 < in.hd; e0 += PIECE) {
      const int cw = min(PIECE, in.hd - e0);
      RowCopy<HD>(in.q + base + e0, in.st, in.t, cw, in.vec16)
          .rows<QROWS>(q_s, q_end - QROWS);
      RowCopy<HD>(in.k + base + e0, in.st, in.t, cw, in.vec16)
          .rows<KT>(k_s, k0);
      cp_async_commit();
      cp_async_wait<0>();   // this chunk (and, the first time, V) landed
      __syncthreads();
      if (nc > 0) {
#pragma unroll
        for (int k0s = 0; k0s < HD / 16; k0s += WIDE_SUM_STEPS) {
          float part[2 * NC][4] = {};
#pragma unroll
          for (int kk = k0s; kk < k0s + WIDE_SUM_STEPS; ++kk) {
            if (16 * kk < cw) {
              uint32_t qf[4];
              ldsm_x4(qf, q_s + (WROWS * warp + lane % 16) * RS + 16 * kk +
                              8 * (lane / 16));
              score_step<RS>(part, qf, k_row + 16 * kk);
            }
          }
#pragma unroll
          for (int j = 0; j < 2 * NC; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              s[j][i] = __fadd_rn(s[j][i], part[j][i]);
        }
      }
      __syncthreads();      // the chunk is consumed before the next
    }
    if (nc > 0)
      softmax_pv<HD>(s, o, m, l, v_s, nc, mask, k0, lim0, lim1, in.sm_scale);
    __syncthreads();        // V's piece is consumed before it is refilled
  }

  if (w_end <= 0) return;
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

}  // namespace attn_bf16
}  // namespace arcweld
