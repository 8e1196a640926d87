// attention_int8: the int8 attention of kernels #2 and #6 with
// int8_attn=True, on Hopper's s8 tensor cores. Included once, by
// int8_block.cu, whose launch_attention_int8 runs the two kernels below
// one after the other.
//
// Replaces the attention of vq_vae_transformer_arc_welding_tpu/ops/
// pallas_block_quant.py::_attn_core(int8_attn=True) (:94-146), reached
// from the pallas_calls at :255 (fused_attn_block_quant) and :307
// (fused_block_quant):
//   s_ij = float(sum_e q8_ie k8_je) * (sm_scale / (sq * sk)),  j <= i
//   p_ij = exp(s_ij - max_j s_ij),  l_i = sum_j p_ij  (unquantized)
//   y8_i = q8(float(sum_j q8(p_ij, 127) v8_j) / (127 * sv) / l_i, qscale)
// with q8, k8, v8 = q8(x, 127 / max(absmax over the head, 1e-6)) per
// (batch, head) of q, k and v.
//
// 1. head_quant_kernel, one block per (head, q/k/v, batch): brings the
//    head's T x 64 f32 slice into shared memory by cp.async (82 KB at
//    T = 321; rows past QUANT_ROWS are read from device memory again),
//    reduces its absmax, writes the scale to head_scales and the int8
//    operand once, in the layout the tensor cores read (qkv8 below).
//    Bound: the f32 qkv read once and the int8 written once, (158 + 39)
//    MB at batch 80 over 3.35 TB/s, 0.059 ms. The TPU kernel found the
//    scales in VMEM; here the qkv round trip through device memory is the
//    int8 GEMM's output, and this pass reads it once, where the first
//    port read it once for the absmax and again, for every query tile
//    that reaches a key, to quantize it anew. A pass of its own, not
//    the qkv GEMM's epilogue (atomics on the absmax there): the GEMM's
//    tile and its times at its three other shapes stay as they are.
// 2. attention_int8_kernel, one block of 4 warps per (64-query tile,
//    head, batch), the heaviest tiles of every (batch, head) first; a
//    warp takes 16 query rows. Both products are mma.sync.m16n8k32 s8 x
//    s8 -> s32: integer sums, exact in any order, so every score and
//    every P@V sum equals the FP32-core kernel's bit for bit (its sums
//    were integers below 2^24). The keys stream through shared memory 64
//    at a time in a cp.async double buffer, as int8 (a quarter of the
//    f32 bytes, quantized once). P is quantized with the final row max,
//    so the key tiles are walked twice: pass 1 keeps the largest integer
//    score of each row (scaled once at the end: f32 rounding is
//    monotonic), pass 2 recomputes the scores (two mma a 16 x 8 block),
//    forms p, l and p8 a 32-key step at a time and multiplies p8 by v8.
//    Only a stage that reaches past the warp's first row or past T
//    takes the masks; there a warp skips the 8-key blocks past its last
//    row and past T. mma.sync and not wgmma: the products are a small
//    share of the work, and the softmax between them wants each warp's
//    scores in its own registers; a 64-row wgmma tile spans four warps.
//    Bound: 8.47 G int8 operations at batch 80 take 0.0043 ms at 1,979
//    TOP/s; the int8 operands and y8 (52.6 MB) 0.0157 ms. The kernel
//    takes ~0.12 ms on an H100 (700 W): the softmax's FP32 work on 55 M
//    computed scores and the dependent chains from mma to p8 to mma, at
//    20 warps an SM (96 registers a thread). Cut out one at a time
//    (scripts/bench_int8_attention_variants.py), expf's accuracy costs
//    6% of it, pass 1 8%, P@V 16%, and masking every stage would add 14%.
//
// Fragments. mma's accumulator gives a thread rows g and g + 8 (g =
// lane / 4) and the columns 2 tg, 2 tg + 1 (tg = lane % 4) of each 8-key
// block; an s8 A fragment wants four neighbouring k positions 4 tg ..
// 4 tg + 3 (and 16 + 4 tg ..) of a 32-key step. The keys of each 32-key
// group are therefore renumbered: position p holds key key_of(p) (4 tg
// -> 2 tg, 4 tg + 1 -> 2 tg + 1, 4 tg + 2 -> 8 + 2 tg, 4 tg + 3 -> 9 +
// 2 tg, and the same 16 further on), so the p8 a thread computes are its
// A fragment as they stand, packed four to a register. v8 is stored
// transposed ([e][key], the K-major B operand of P@V) in that key order,
// so a B fragment is one 32-bit load. The sum runs over the same products
// in another order, which an integer sum does not see. The row sum l is
// an f32 sum: a thread adds its keys in walk order (tiles, then 8-key
// blocks, then its two columns) and the four threads of a row add theirs
// as (l0 + l1) + (l2 + l3); only l, and through it y8 by one step where l
// moves in its last place, may differ from another order's.
//
// qkv8, the int8 operands: (batch, n_head, 3, T_pad * HW) with T_pad =
// T rounded up to TT and HW = head_width(hd) (64 at the bench model's
// head); slot 0 q8 [row][e], slot 1 k8 [key][e], slot 2 v8 [e][key
// position] in key_of order; zero past T and from column (v8: row) hd
// on. head_scales (batch, 3, n_head): 127 / max(absmax, 1e-6) of q, k,
// v. y8's rows lie pitch16(C) bytes apart, as the c_proj GEMM reads them.
//
// Heads wider than MAX_NARROW (any width up to 4,096) take the wide
// form: the pass keeps the head's first kept_rows(hd) rows on chip (227
// KB / (4 hd)) and reads the rest again from device memory, a float at a
// time; its qkv8 rows are hd rounded up to the products' k step of 32.
// The tile, attention_int8_wide_kernel, gives each (64-query tile, head,
// batch) one block per PIECE = 128 output columns. Each block recomputes
// the integer scores over the whole head, a 64-key stage at a time, in k
// steps of 32 over 128-column chunks of k8 streamed through shared
// memory (q8's fragments read from device memory, L2, per chunk), then
// the same two passes as the narrow tile with P@V on its piece of v8.
// The scores and P@V are s8 x s8 -> s32 sums, exact in any order, so
// every piece sees the same row max and the same p8, and each output
// equals one unsplit product's; l is summed in the narrow tile's order.
// A simple form that is right: the score work is (hd / 128)x the narrow
// tile's and nothing is double-buffered; its times are in PERF.md.
#pragma once

#include "common.cuh"

#include <limits.h>

namespace arcweld {
namespace attn8 {

constexpr int TT = 64;          // query rows of a block, keys of a stage,
                                // and T's padding unit in qkv8
constexpr int WARPS = 4;        // 16 query rows a warp: one m16 tile
constexpr int THREADS = 32 * WARPS;
constexpr int VROW = TT + 16;   // bytes a V^T row (a stage's 64 keys)
                                // takes in shared memory
constexpr int QUANT_THREADS = 256;
constexpr int QUANT_ROWS = 384;         // rows of a head kept on chip by
                                        // the quantizing pass (96 KB at
                                        // head width 64) ...
constexpr int QUANT_SMEM = 231424;      // ... and at most these bytes (the
                                        // 227 KB of a block less the
                                        // pass's static 1 KB)
constexpr int MAX_NARROW = 128;         // the widest head on Tile<HD>
constexpr int PIECE = 128;              // output columns a wide block

// The tile of (padded) head width HD: 32, 64 or 128, the s8 products'
// k in steps of 32. A head of real width hd < HD (PAD) is held in qkv8
// padded to HD with zeros, which change neither its absmax nor any dot
// product; the pass reads the f32 qkv only up to hd, and y8 is written
// only there.
template <int HD>
struct Tile {
  static_assert(HD == 32 || HD == 64 || HD == 128, "a head width of the tile");
  static constexpr int KROW = HD + 16;    // bytes a K row takes in shared
                                          // memory: fragment loads free of
                                          // conflicts (as VROW's)
  static constexpr int STAGE = TT * KROW + HD * VROW;  // K, then V^T
};

__host__ __device__ constexpr int padded(int t) {
  return (t + TT - 1) / TT * TT;
}

// the width of a head's rows in qkv8: the tile's 32, 64 or 128, and
// past MAX_NARROW hd rounded up to the s8 products' k step of 32
__host__ __device__ constexpr int head_width(int hd) {
  return hd <= 32 ? 32 : hd <= 64 ? 64 : hd <= MAX_NARROW ? 128
                                                          : (hd + 31) / 32 * 32;
}

// the wide form's blocks a head: one per PIECE output columns
__host__ __device__ constexpr int pieces(int hd) {
  return (hd + PIECE - 1) / PIECE;
}

// rows of a head of width hd that the pass keeps on chip
__host__ __device__ constexpr int kept_rows(int hd) {
  return QUANT_SMEM / (4 * hd) < QUANT_ROWS ? QUANT_SMEM / (4 * hd)
                                            : QUANT_ROWS;
}

// the pass's dynamic shared memory: the head's first rows at its real
// width hd (t rows, or all it keeps)
inline size_t quant_smem(int t, int hd) {
  return sizeof(float) * hd * (size_t)(t < kept_rows(hd) ? t : kept_rows(hd));
}

// the key stored at position p of a 32-key group of v8
__host__ __device__ constexpr int key_of(int p) {
  return 16 * (p / 16) + 8 * (p % 4 / 2) + 2 * (p % 16 / 4) + p % 2;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float absmax4(float m, float4 v) {
  return fmaxf(fmaxf(fmaxf(m, fabsf(v.x)), fmaxf(fabsf(v.y), fabsf(v.z))),
               fabsf(v.w));
}

__device__ __forceinline__ uint32_t pack4(int8_t a, int8_t b, int8_t c,
                                          int8_t d) {
  return (uint32_t)(uint8_t)a | (uint32_t)(uint8_t)b << 8 |
         (uint32_t)(uint8_t)c << 16 | (uint32_t)(uint8_t)d << 24;
}

// d += a (16 x 32, row) * b (32 x 8, col), s8 operands, s32 sums
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The head's absmax over x_ij for i < t, j < hw (the f32 rows at src,
// c3 floats apart), its first `kept` rows brought into xs ([row][hw],
// compact) by cp.async as they are read; reduced over the block.
__device__ __forceinline__ float head_absmax(const float* src, float* xs,
                                             float* red, int t, int kept,
                                             int hw, int c3) {
  const int tid = threadIdx.x;
  for (int i = tid; i < kept * hw; i += QUANT_THREADS)
    cp_async4(xs + i, src + (size_t)(i / hw) * c3 + i % hw);
  cp_async_commit();
  float mx = 0.0f;
  for (int i = kept * hw + tid; i < t * hw; i += QUANT_THREADS)
    mx = fmaxf(mx, fabsf(src[(size_t)(i / hw) * c3 + i % hw]));
  cp_async_wait<0>();
  __syncthreads();
  for (int i = tid; i < kept * hw; i += QUANT_THREADS)
    mx = fmaxf(mx, fabsf(xs[i]));
  mx = warp_max(mx);
  if (tid % 32 == 0) red[tid / 32] = mx;
  __syncthreads();
  mx = red[0];
#pragma unroll
  for (int w = 1; w < QUANT_THREADS / 32; ++w) mx = fmaxf(mx, red[w]);
  return mx;
}

// head_quant_kernel's padded case and the wide form's pass: the head's
// hw columns as f32 (c3 floats a row at src), its scale to *scale, and
// its HD-wide rows of qkv8 at dst (HD a multiple of 32: the tile's width,
// a constant, or head_width(hw) past MAX_NARROW), zero from hw on and
// past t; a value at a time.
__device__ __forceinline__ void head_quant_padded(const float* src,
                                                  float* scale, int8_t* dst,
                                                  float* xs, float* red,
                                                  int t, int kept, int hw,
                                                  int c3, int HD) {
  const int CH = HD / 4;                   // 4-value chunks a row
  const int tid = threadIdx.x, tp = padded(t);
  const float s = __fdiv_rn(
      127.0f, fmaxf(head_absmax(src, xs, red, t, kept, hw, c3), 1e-6f));
  if (tid == 0) *scale = s;
  // x at (row r, column e), zero past t and past hw
  auto at = [&](int r, int e) -> float {
    return e >= hw || r >= t ? 0.0f
           : r < kept        ? xs[r * hw + e]
                             : src[(size_t)r * c3 + e];
  };
  if (blockIdx.y < 2) {   // q8, k8: [row][e], four values a thread
    for (int i = tid; i < tp * CH; i += QUANT_THREADS) {
      const int r = i / CH, e = 4 * (i % CH);
      reinterpret_cast<char4*>(dst)[i] =
          make_char4(q8(at(r, e), s), q8(at(r, e + 1), s),
                     q8(at(r, e + 2), s), q8(at(r, e + 3), s));
    }
    return;
  }
  for (int i = tid; i < tp / TT * HD; i += QUANT_THREADS) {   // v8^T
    const int e = i % HD, k0 = i / HD * TT;
    uint32_t w[TT / 4];
#pragma unroll
    for (int p = 0; p < TT; p += 4) {
      int8_t v8[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v8[j] = q8(at(k0 + (p + j) / 32 * 32 + key_of((p + j) % 32), e), s);
      w[p / 4] = pack4(v8[0], v8[1], v8[2], v8[3]);
    }
    uint4* o = reinterpret_cast<uint4*>(dst + (size_t)e * tp + k0);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      o[j] = make_uint4(w[4 * j], w[4 * j + 1], w[4 * j + 2], w[4 * j + 3]);
  }
}

// Grid (n_head, 3, batch), QUANT_THREADS threads, quant_smem(t, hd) bytes
// of dynamic shared memory. qkv (batch, t, 3C) f32, C = n_head * hd;
// qkv8's rows HD bytes wide. Without PAD hd is HD (and read as HD): the
// rows move as float4s; with PAD any hd < HD, a float at a time.
template <int HD, bool PAD>
__global__ void __launch_bounds__(QUANT_THREADS)
head_quant_kernel(const float* __restrict__ qkv, float* __restrict__ scales,
                  int8_t* __restrict__ qkv8, int t, int n_head, int hd) {
  extern __shared__ float4 xs4[];
  const float* xs = reinterpret_cast<const float*>(xs4);
  __shared__ float red[QUANT_THREADS / 32];
  constexpr int CH = HD / 4;               // 4-value chunks a row
  const int hw = PAD ? hd : HD;            // the real head width
  const int h = blockIdx.x, which = blockIdx.y, b = blockIdx.z;
  const int c3 = 3 * n_head * hw, tp = padded(t);
  const int kept = min(t, kept_rows(hw));
  const float* src = qkv + (size_t)b * t * c3 + which * (c3 / 3) + h * hw;
  int8_t* dst =
      qkv8 + (((size_t)b * n_head + h) * 3 + which) * (size_t)tp * HD;
  const int tid = threadIdx.x;

  if constexpr (PAD) {
    head_quant_padded(src, scales + ((size_t)b * 3 + which) * n_head + h,
                      dst, reinterpret_cast<float*>(xs4), red, t, kept, hw,
                      c3, HD);
    return;
  }
  for (int i = tid; i < kept * CH; i += QUANT_THREADS)
    cp_async16(xs4 + i, src + (size_t)(i / CH) * c3 + i % CH * 4);
  cp_async_commit();
  float mx = 0.0f;
  for (int i = kept * CH + tid; i < t * CH; i += QUANT_THREADS)
    mx = absmax4(mx, *reinterpret_cast<const float4*>(
                         src + (size_t)(i / CH) * c3 + i % CH * 4));
  cp_async_wait<0>();
  __syncthreads();
  for (int i = tid; i < kept * CH; i += QUANT_THREADS)
    mx = absmax4(mx, xs4[i]);
  mx = warp_max(mx);
  if (tid % 32 == 0) red[tid / 32] = mx;
  __syncthreads();
  mx = red[0];
#pragma unroll
  for (int w = 1; w < QUANT_THREADS / 32; ++w) mx = fmaxf(mx, red[w]);
  const float s = __fdiv_rn(127.0f, fmaxf(mx, 1e-6f));
  if (tid == 0) scales[((size_t)b * 3 + which) * n_head + h] = s;

  if (which < 2) {     // q8, k8: [row][e], four values a thread
    for (int i = tid; i < tp * CH; i += QUANT_THREADS) {
      const int r = i / CH;
      const float4 v =
          r < kept ? xs4[i]
          : r < t  ? *reinterpret_cast<const float4*>(
                        src + (size_t)r * c3 + i % CH * 4)
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      reinterpret_cast<char4*>(dst)[i] =
          make_char4(q8(v.x, s), q8(v.y, s), q8(v.z, s), q8(v.w, s));
    }
    return;
  }
  // v8^T: a thread writes the 64 key positions of one (e, 64-key tile),
  // neighbouring threads neighbouring e (conflict-free column reads)
  for (int i = tid; i < tp / TT * HD; i += QUANT_THREADS) {
    const int e = i % HD, k0 = i / HD * TT;
    uint32_t w[TT / 4];
#pragma unroll
    for (int p = 0; p < TT; p += 4) {
      int8_t v8[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + (p + j) / 32 * 32 + key_of((p + j) % 32);
        const float v = key < kept ? xs[key * HD + e]
                        : key < t  ? src[(size_t)key * c3 + e]
                                   : 0.0f;
        v8[j] = q8(v, s);
      }
      w[p / 4] = pack4(v8[0], v8[1], v8[2], v8[3]);
    }
    uint4* o = reinterpret_cast<uint4*>(dst + (size_t)e * tp + k0);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      o[j] = make_uint4(w[4 * j], w[4 * j + 1], w[4 * j + 2], w[4 * j + 3]);
  }
}

// a 64-key stage: k8 rows [k0, k0 + 64) and, with v, v8^T's columns
template <int HD>
__device__ __forceinline__ void load_stage(int8_t* st, const int8_t* k8,
                                           const int8_t* v8, int k0, int tp,
                                           bool with_v) {
  constexpr int KROW = Tile<HD>::KROW, KCH = HD / 16;  // a K row's chunks
  int8_t* const vs = st + TT * KROW;
  for (int i = threadIdx.x; i < TT * KCH; i += THREADS) {
    const int r = i / KCH, ch = i % KCH * 16;
    cp_async16(st + r * KROW + ch, k8 + (size_t)(k0 + r) * HD + ch);
    // at HD == TT a V^T row has a K row's chunks: one loop takes both
    if (HD == TT && with_v)
      cp_async16(vs + r * VROW + ch, v8 + (size_t)r * tp + k0 + ch);
  }
  if (HD != TT && with_v)
    for (int i = threadIdx.x; i < HD * (TT / 16); i += THREADS) {
      const int r = i / (TT / 16), ch = i % (TT / 16) * 16;
      cp_async16(vs + r * VROW + ch, v8 + (size_t)r * tp + k0 + ch);
    }
}

// The scores of 8-key block j of a stage for the warp's 16 rows:
// s[i] of mma's accumulator (rows g, g + 8; keys 8 j + 2 tg, + 1)
template <int HD>
__device__ __forceinline__ void scores(int (&s)[4], const int8_t* st,
                                       const uint32_t (&qa)[HD / 32][4],
                                       int j, int g, int tg) {
  const int8_t* kr = st + (8 * j + g) * Tile<HD>::KROW + 4 * tg;
  s[0] = s[1] = s[2] = s[3] = 0;
#pragma unroll
  for (int ks = 0; ks < HD / 32; ++ks)
    mma_s8(s, qa[ks], ld32(kr + 32 * ks), ld32(kr + 32 * ks + 16));
}

// Pass 1 on a stage: the row's largest integer score. float(s) * factor
// rounds monotonically in s (factor > 0), so the largest scaled score
// is the largest score scaled once. MASKED: the stage holds keys past
// the warp's first row or past T (the causal and T masks, and the
// warp's last needed 8-key block jn); else every score counts.
template <int HD, bool MASKED>
__device__ __forceinline__ void max_stage(int (&smax)[2], const int8_t* st,
                                          const uint32_t (&qa)[HD / 32][4],
                                          int k0,
                                          const int (&rows)[2], int t, int jn,
                                          int g, int tg) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (MASKED && j >= jn) break;
    int s[4];
    scores<HD>(s, st, qa, j, g, tg);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kj = k0 + 8 * j + 2 * tg + i % 2;
      if (!MASKED || (kj <= rows[i / 2] && kj < t))
        smax[i / 2] = max(smax[i / 2], s[i]);
    }
  }
}

// Pass 2 on a stage, a 32-key step at a time: p = exp(s * factor - mx),
// l += p, p8 = q8(p, 127) packed as P's A fragment (key_of order: block
// j's bytes go to register (j % 4) / 2 * 2, + 1 for row g + 8, at byte
// (j % 2) * 2), then o += p8 v8. p lies in [0, 1], so q8's clip is
// idle and p8 is the rounded p * 127.
template <int HD, bool MASKED>
__device__ __forceinline__ void pv_stage(int (&o)[HD / 8][4], float (&l)[2],
                                         const int8_t* st,
                                         const uint32_t (&qa)[HD / 32][4],
                                         const float (&mx)[2], float factor,
                                         int k0, const int (&rows)[2], int t,
                                         int jn, int g, int tg) {
  const int8_t* vs = st + TT * Tile<HD>::KROW;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    if (MASKED && 4 * kk >= jn) break;
    uint32_t pa[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = 4 * kk + jj;
      if (MASKED && j >= jn) break;
      int s[4];
      scores<HD>(s, st, qa, j, g, tg);
      uint32_t p8[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kj = k0 + 8 * j + 2 * tg + i % 2;
        float p = 0.0f;
        if (!MASKED || (kj <= rows[i / 2] && kj < t)) {
          p = expf(__fmul_rn((float)s[i], factor) - mx[i / 2]);
          l[i / 2] += p;
        }
        p8[i] = (uint32_t)__float2int_rn(__fmul_rn(p, 127.0f));
      }
      const int reg = jj / 2 * 2, sh = jj % 2 * 16;
      pa[reg] |= (p8[0] | p8[1] << 8) << sh;
      pa[reg + 1] |= (p8[2] | p8[3] << 8) << sh;
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int8_t* vr = vs + (8 * n + g) * VROW + 32 * kk + 4 * tg;
      mma_s8(o[n], pa, ld32(vr), ld32(vr + 16));
    }
  }
}

// Grid (n_head, batch, ceil(t / 64)), THREADS threads: the heaviest
// query tiles of every (batch, head) first. y8 (batch, t, C), C =
// n_head * hd, rows pitch16(C) bytes apart; without PAD hd is HD.
template <int HD, bool PAD>
__global__ void __launch_bounds__(THREADS)
attention_int8_kernel(const int8_t* __restrict__ qkv8,
                      const float* __restrict__ head_scales,
                      const float* __restrict__ qscale,
                      int8_t* __restrict__ y8, int t, int n_head,
                      float sm_scale, int hd) {
  __shared__ __align__(16) int8_t stages[2][Tile<HD>::STAGE];
  const int tp = padded(t);
  const int q0 = (gridDim.z - 1 - blockIdx.z) * TT;
  const int h = blockIdx.x, b = blockIdx.y;
  const int8_t* qh = qkv8 + ((size_t)b * n_head + h) * 3 * (size_t)tp * HD;
  const int8_t* kh = qh + (size_t)tp * HD;      // k8, then v8^T
  const int8_t* vh = kh + (size_t)tp * HD;
  const int lane = threadIdx.x % 32, g = lane / 4, tg = lane % 4;
  const int r0 = q0 + threadIdx.x / 32 * 16;          // the warp's rows
  const int rows[2] = {r0 + g, r0 + g + 8};
  const float* hs = head_scales + (size_t)b * 3 * n_head + h;
  const float sq = hs[0], sk = hs[n_head], sv = hs[2 * n_head];
  const float factor = __fdiv_rn(sm_scale, __fmul_rn(sq, sk));

  uint32_t qa[HD / 32][4];     // Q's A fragments, head dims 32 ks ..
#pragma unroll
  for (int ks = 0; ks < HD / 32; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      qa[ks][i] = ld32(qh + (size_t)rows[i % 2] * HD + ks * 32 + i / 2 * 16 +
                       4 * tg);

  const int n_kt = (min(t, q0 + TT) + TT - 1) / TT;   // key tiles a pass
  int smax[2] = {INT_MIN, INT_MIN};
  float mx[2], l[2] = {0.0f, 0.0f};
  int o[HD / 8][4] = {};
  load_stage<HD>(stages[0], kh, vh, 0, tp, false);
  cp_async_commit();
  for (int step = 0; step < 2 * n_kt; ++step) {
    const bool pass2 = step >= n_kt;
    if (step + 1 < 2 * n_kt) {
      const int nxt = step + 1;
      load_stage<HD>(stages[nxt % 2], kh, vh, (nxt % n_kt) * TT, tp,
                     nxt >= n_kt);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int k0 = (step % n_kt) * TT;
    if (k0 <= r0 + 15) {         // else every key is past the warp's rows
      const int8_t* st = stages[step % 2];
      // 8-key blocks this warp needs: up to its last row and below T
      const int jn = min(min(8, (r0 + 15 - k0) / 8 + 1), (t - k0 + 7) / 8);
      const bool full = k0 + TT - 1 <= r0 && k0 + TT <= t;
      if (!pass2) {
        if (full)
          max_stage<HD, false>(smax, st, qa, k0, rows, t, jn, g, tg);
        else
          max_stage<HD, true>(smax, st, qa, k0, rows, t, jn, g, tg);
      } else if (full) {
        pv_stage<HD, false>(o, l, st, qa, mx, factor, k0, rows, t, jn, g, tg);
      } else {
        pv_stage<HD, true>(o, l, st, qa, mx, factor, k0, rows, t, jn, g, tg);
      }
    }
    if (step == n_kt - 1)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        smax[r] = max(smax[r], __shfl_xor_sync(0xffffffffu, smax[r], 1));
        smax[r] = max(smax[r], __shfl_xor_sync(0xffffffffu, smax[r], 2));
        mx[r] = __fmul_rn((float)smax[r], factor);
      }
    __syncthreads();
  }

  const int hw = PAD ? hd : HD;       // the real head width
  const int pitch = pitch16(n_head * hw);
  const float qs = *qscale, dq = __fmul_rn(127.0f, sv);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (rows[r] >= t) continue;
    int8_t* yr = y8 + ((size_t)b * t + rows[r]) * pitch + h * hw + 2 * tg;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int8_t y0 =
          q8(__fdiv_rn(__fdiv_rn((float)o[n][2 * r], dq), l[r]), qs);
      const int8_t y1 =
          q8(__fdiv_rn(__fdiv_rn((float)o[n][2 * r + 1], dq), l[r]), qs);
      if (!PAD) {
        *reinterpret_cast<char2*>(yr + 8 * n) = make_char2(y0, y1);
      } else {     // a byte at a time: an odd hd leaves pairs unaligned
        const int e = 8 * n + 2 * tg;
        if (e < hw) yr[8 * n] = y0;
        if (e + 1 < hw) yr[8 * n + 1] = y1;
      }
    }
  }
}

// The wide form's pass: grid (n_head, 3, batch), QUANT_THREADS threads,
// quant_smem(t, hd) bytes of dynamic shared memory; any hd past
// MAX_NARROW, its qkv8 rows head_width(hd) bytes wide.
__global__ void __launch_bounds__(QUANT_THREADS)
head_quant_wide_kernel(const float* __restrict__ qkv,
                       float* __restrict__ scales, int8_t* __restrict__ qkv8,
                       int t, int n_head, int hd) {
  extern __shared__ float4 xs4[];
  __shared__ float red[QUANT_THREADS / 32];
  const int h = blockIdx.x, which = blockIdx.y, b = blockIdx.z;
  const int hw8 = head_width(hd), c3 = 3 * n_head * hd, tp = padded(t);
  head_quant_padded(
      qkv + (size_t)b * t * c3 + which * (c3 / 3) + h * hd,
      scales + ((size_t)b * 3 + which) * n_head + h,
      qkv8 + (((size_t)b * n_head + h) * 3 + which) * (size_t)tp * hw8,
      reinterpret_cast<float*>(xs4), red, t, min(t, kept_rows(hd)), hd, c3,
      hw8);
}

// The wide tile: block (h * pieces(hd) + piece, b, z) = blockIdx, THREADS
// threads, writes y8's columns [PIECE piece, PIECE (piece + 1)) of the
// head's rows. A stage's scores s[j] (8-key block j, mma's accumulator
// layout) are carried over the head's 128-column chunks of k8 (staged in
// ks) and q8 (fragments from device memory); pass 1 keeps the row's
// largest integer score, pass 2 forms p, l and p8 as pv_stage does and
// multiplies p8 by the piece's v8^T rows (staged in vs with the stage's
// first chunk). The masks and the 8-key blocks a warp skips are the
// narrow tile's.
__global__ void __launch_bounds__(THREADS)
attention_int8_wide_kernel(const int8_t* __restrict__ qkv8,
                           const float* __restrict__ head_scales,
                           const float* __restrict__ qscale,
                           int8_t* __restrict__ y8, int t, int n_head,
                           float sm_scale, int hd) {
  constexpr int KROW = PIECE + 16;     // a K chunk's row in shared memory
  __shared__ __align__(16) int8_t ks[TT * KROW];
  __shared__ __align__(16) int8_t vs[PIECE * VROW];
  const int hw8 = head_width(hd), np = pieces(hd), tp = padded(t);
  const int h = blockIdx.x / np, piece = blockIdx.x % np, b = blockIdx.y;
  const int p0 = PIECE * piece, pw = min(PIECE, hw8 - p0);  // v8^T rows
  const int q0 = (gridDim.z - 1 - blockIdx.z) * TT;
  const int8_t* qh = qkv8 + ((size_t)b * n_head + h) * 3 * (size_t)tp * hw8;
  const int8_t* kh = qh + (size_t)tp * hw8;      // k8, then v8^T
  const int8_t* vh = kh + (size_t)tp * hw8;
  const int tid = threadIdx.x, lane = tid % 32, g = lane / 4, tg = lane % 4;
  const int r0 = q0 + tid / 32 * 16;                  // the warp's rows
  const int rows[2] = {r0 + g, r0 + g + 8};
  const float* hs = head_scales + (size_t)b * 3 * n_head + h;
  const float sq = hs[0], sk = hs[n_head], sv = hs[2 * n_head];
  const float factor = __fdiv_rn(sm_scale, __fmul_rn(sq, sk));

  const int n_kt = (min(t, q0 + TT) + TT - 1) / TT;   // key tiles a pass
  int smax[2] = {INT_MIN, INT_MIN};
  float mx[2] = {0.0f, 0.0f}, l[2] = {0.0f, 0.0f};
  int o[PIECE / 8][4] = {};
  for (int step = 0; step < 2 * n_kt; ++step) {
    const bool pass2 = step >= n_kt;
    const int k0 = (step % n_kt) * TT;
    const bool live = k0 <= r0 + 15;   // else every key is past the rows
    // 8-key blocks this warp needs: up to its last row and below T
    const int jn =
        live ? min(min(8, (r0 + 15 - k0) / 8 + 1), (t - k0 + 7) / 8) : 0;
    if (pass2)
      for (int i = tid; i < pw * (TT / 16); i += THREADS) {
        const int r = i / (TT / 16), ch = i % (TT / 16) * 16;
        cp_async16(vs + r * VROW + ch, vh + (size_t)(p0 + r) * tp + k0 + ch);
      }
    int s[8][4] = {};
    for (int e0 = 0; e0 < hw8; e0 += PIECE) {
      const int kch = min(PIECE, hw8 - e0) / 16;    // a row's 16-byte chunks
      for (int i = tid; i < TT * kch; i += THREADS) {
        const int r = i / kch, ch = i % kch * 16;
        cp_async16(ks + r * KROW + ch, kh + (size_t)(k0 + r) * hw8 + e0 + ch);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < PIECE / 32; ++kk) {
        if (kk < kch / 2 && jn > 0) {
          uint32_t qa[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            qa[i] = ld32(qh + (size_t)rows[i % 2] * hw8 + e0 + 32 * kk +
                         i / 2 * 16 + 4 * tg);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (j < jn) {
              const int8_t* kr = ks + (8 * j + g) * KROW + 32 * kk + 4 * tg;
              mma_s8(s[j], qa, ld32(kr), ld32(kr + 16));
            }
          }
        }
      }
      __syncthreads();      // the chunk is consumed before the next
    }
    if (!pass2) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kj = k0 + 8 * j + 2 * tg + i % 2;
          if (j < jn && kj <= rows[i / 2] && kj < t)
            smax[i / 2] = max(smax[i / 2], s[j][i]);
        }
    } else {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        if (4 * kk >= jn) break;
        uint32_t pa[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = 4 * kk + jj;
          if (j >= jn) break;
          uint32_t p8[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int kj = k0 + 8 * j + 2 * tg + i % 2;
            float p = 0.0f;
            if (kj <= rows[i / 2] && kj < t) {
              p = expf(__fmul_rn((float)s[j][i], factor) - mx[i / 2]);
              l[i / 2] += p;
            }
            p8[i] = (uint32_t)__float2int_rn(__fmul_rn(p, 127.0f));
          }
          const int reg = jj / 2 * 2, sh = jj % 2 * 16;
          pa[reg] |= (p8[0] | p8[1] << 8) << sh;
          pa[reg + 1] |= (p8[2] | p8[3] << 8) << sh;
        }
#pragma unroll
        for (int n = 0; n < PIECE / 8; ++n) {
          if (8 * n < pw) {
            const int8_t* vr = vs + (8 * n + g) * VROW + 32 * kk + 4 * tg;
            mma_s8(o[n], pa, ld32(vr), ld32(vr + 16));
          }
        }
      }
    }
    if (step == n_kt - 1)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        smax[r] = max(smax[r], __shfl_xor_sync(0xffffffffu, smax[r], 1));
        smax[r] = max(smax[r], __shfl_xor_sync(0xffffffffu, smax[r], 2));
        mx[r] = __fmul_rn((float)smax[r], factor);
      }
    __syncthreads();        // vs is consumed before it is refilled
  }

  const int pitch = pitch16(n_head * hd);
  const float qs = *qscale, dq = __fmul_rn(127.0f, sv);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (rows[r] >= t) continue;
    int8_t* yr = y8 + ((size_t)b * t + rows[r]) * pitch + h * hd + p0;
#pragma unroll
    for (int n = 0; n < PIECE / 8; ++n) {
      const int e = 8 * n + 2 * tg;
      if (p0 + e < hd)
        yr[e] = q8(__fdiv_rn(__fdiv_rn((float)o[n][2 * r], dq), l[r]), qs);
      if (p0 + e + 1 < hd)
        yr[e + 1] =
            q8(__fdiv_rn(__fdiv_rn((float)o[n][2 * r + 1], dq), l[r]), qs);
    }
  }
}

}  // namespace attn8
}  // namespace arcweld
