// The eval-mode VQ-VAE encoder resblock on Hopper's tensor cores: the
// tile of encoder_chain_f32 (#1, encoder_chain.cu), resblock_f32 (#3,
// encoder_resblock.cu) and the encoder's two ends, encoder_entry_f32
// and encoder_exit_f32 (#4, #5, encoder_edges.cu, which add a prologue
// or an epilogue to each tile: `Ends` below). They replace
// vq_vae_transformer_arc_welding_tpu/ops/pallas_encoder.py::
// fused_encoder_eval (pallas_call at :311), fused_resblock_eval (:106),
// fused_encoder_entry_eval (:404) and fused_encoder_exit_eval (:436).
// Per resblock and row, in f32:
//   h = gelu(x) @ W1 + b1 [-> eval BN] -> gelu -> @ W2 + b2 [-> eval BN]
//   x = x + h
// with exact-erf GELU (erff) and BN in the reference's rounding order
// (common.cuh), n resblocks a launch (#1: the JAX group rule, 4 at
// hidden 512; #3: one).
//
// Arithmetic: split TF32. Every product input v is cut into
// hi = cvt.rna.tf32(v) and lo = cvt.rna.tf32(v - hi), and each 8-wide
// k step adds A_lo W_hi + A_hi W_lo + A_hi W_hi (in that order) to the
// f32 accumulators, as CUTLASS's 3xTF32 (OpMultiplyAddFastF32) does: the
// dropped lo*lo term is ~2^-22 of a product, so the sums keep f32
// accuracy where TF32 alone keeps ~2^-11 and would move codebook ids.
// W's hi and lo are made once, where the weights are packed
// (ops/fused_encoder.py::split_weights), in (out, in) layout, the
// K-major operand TF32 wgmma reads from shared memory, and laid out in
// global memory as the ring's stages: per matrix and k step, hi then lo
// of all C outputs, each in wgmma's no-swizzle K-major layout (8-row x
// 16-byte core matrices of 128 contiguous bytes; the two k halves of an
// 8-row group 128 bytes apart (LBO), 8-row groups 256 bytes apart
// (SBO)), so that a stage is 32 contiguous KB and one TMA box of 128-byte
// rows. A is gelu(x) or gelu(BN(c1)), made in the kernel, kept once in
// shared memory as f32 and split as it is loaded into wgmma's register
// fragments.
//
// What bounds it on an H100: the products. At hidden 512 a resblock is
// 2 x 512 x 512 multiply-adds a row, three TF32 products each: 107 GFLOP
// of TF32 for #1 at 25,600 rows, 0.65 ms at 495 TFLOP/s, against 53 MB
// of rows in and out (0.016 ms). A 64-row tile reads each W's hi and lo
// (2 MB a product) once: 6.4 GB of L2 reads a launch of #1 at 25,600
// rows, which L2 delivers at the tensor cores' pace. Beside the
// products: the two epilogue passes (exact-erf GELU on every element,
// twice a resblock), which no product overlaps, and the last round of
// tiles (below).
//
// Widths: the tile is a template of its width C, instantiated at 128,
// 256 and 512 (Tile below); every hidden width from 1 to 512 runs on the
// narrowest that holds it, padded with zero columns (1 to 128 on 128,
// 129 to 256 on 256, 257 to 512 on 512). x, out and the vector rows keep
// the true width cw: where cw is a multiple of 4 (and the vector rows
// start on 16 bytes) the passes move rows as float4s, as at the widths
// the tile was first written for; at any other width they move them a
// float at a time (`V4` below), since a row then need not start on 16
// bytes. Widths above 512 run on csrc/encoder_wide.cu. The numbers
// below are the 512 tile's.
//
// Design, and the budget of one block (one per SM, 227 KB of shared
// memory, 65,536 registers):
//  - a tile is BM = 64 rows (wgmma's M) with all C = 512 columns, for
//    the whole chain: each product needs every column of the row. Its
//    A operand, 64 x 512 f32, is 128 KB of shared memory, swizzled
//    (16-byte chunks XOR row % 8) so that fragment loads and the
//    passes over the tile are free of bank conflicts;
//  - W comes by TMA (cp.async.bulk.tensor.2d, one 256 x 128-byte box a
//    stage) into a ring of STAGES = 3 stages of one k step (8 of K) over
//    all 512 outputs, hi and lo: 32 KB a stage, 96 KB the ring; 224 KB
//    with A, which leaves no room for the residual stream. (Boxes of 32-
//    byte rows straight from an (out, in) matrix, 1,024 rows a stage,
//    were slower: TMA fetches a box row by row);
//  - one producer thread issues the loads, completion on mbarriers; two
//    consumer warpgroups each own half the outputs (m64n256k8: 128 f32
//    accumulators a thread; 64 x 512 in one warpgroup would take 256)
//    and both read all of A; setmaxnreg gives them 232 registers and
//    the producer 40;
//  - the epilogues: each warpgroup stashes its accumulators in the A
//    tile (which the product has finished reading), and all consumers
//    then make one coalesced pass over the tile: bias [-> BN] -> GELU
//    in place for the first product; for the second, bias [-> BN],
//    the residual add into the output and GELU into A for the next
//    resblock. BN is compiled in only for a model that has it;
//  - the residual stream x stays in the output buffer, which only this
//    block touches for its rows: epilogue 2 reads x there (from the
//    input on the first resblock), adds h and writes it back. That is
//    2 x 128 KB of L2 traffic a tile and resblock, ~0.08 ms a launch of
//    #1 at 25,600 rows; the FP32-core tile's registers held it, at 8
//    rows a thread;
//  - a persistent walk: min(tiles, SMs) blocks take the tiles
//    blockIdx.x, + gridDim.x, ...; the producer runs on into the next
//    tile's W while the consumers finish a tile. The last round holds
//    tiles % SMs tiles: at 25,600 rows 400 tiles on 132 SMs are 3.03
//    rounds' work in 4, so the 4 tiles of the fourth round cost as much
//    as a full round. A 64-row tile cannot be cut (wgmma's M), and
//    cutting its outputs across blocks needs the other blocks' columns
//    before each product (a cluster exchanging the A tile through
//    distributed shared memory): left to later work;
//  - rows past N are zeros in A and are neither read nor written;
//  - the ends (#4, #5) ride the same tiles: the entry's prologue writes
//    the patch-embed rows to the output buffer in place of load_a's
//    input (block 0 then reads its residual there too), and the exit's
//    last epilogue leaves x in the A tile for an epilogue of its own,
//    which then holds z, the codebook and its norms while the producer
//    fills the ring with the next tile's stages. Neither adds, skips or
//    reorders a stage.
#pragma once

#include <map>
#include <mutex>
#include <utility>

#include "int8_gemm_sm90.cuh"  // gemm90:: mbarrier, TMA and tensor-map helpers

namespace arcweld {
namespace enc_tc {

using gemm90::mbar_arrive;
using gemm90::mbar_expect_tx;
using gemm90::mbar_init;
using gemm90::mbar_wait;
using gemm90::named_sync;
using gemm90::smem_u32;
using gemm90::tma_load;

constexpr int BM = 64;                 // rows a tile: wgmma's M
constexpr int KSTEP = 8;               // TF32 of K a wgmma, and a stage
constexpr int STAGES = 3;
constexpr int CONSUMERS = 256;             // two warpgroups
constexpr int CONSUMER_WARPS = CONSUMERS / 32;
constexpr int THREADS = 128 + CONSUMERS;   // warpgroup 0 loads
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int MAX_C = 512;                 // the widest tile
// the floats the exit's epilogue may take from the A tile's start (z,
// the codebook and its norms): the widest tile's A tile at every width,
// the narrower tiles launched with that much shared memory
constexpr int EXIT_FLOATS = BM * MAX_C;

// The tile of width C (128, 256 or 512): C outputs, two warpgroups of
// C / 2 (wgmma m64n(C/2)k8). A hidden width cw (1 to 512) runs on the
// narrowest tile that holds it (tile_width): the
// pack's weights and vector rows are zero past cw (split_weights at C),
// x and out keep cw columns, and the passes read and write only those.
// Columns cw .. C - 1 of A stay exactly 0 through every resblock: zero
// weights and bias, BN of a zero column (0 - 0) * 0 + 0, GELU(0) = 0,
// a zero residual; the k-sums gain only exact zero terms.
template <int C>
struct Tile {
  static_assert(C == 128 || C == 256 || C == 512, "a width of the tile");
  static constexpr int HALF = C / 2;        // outputs of a consumer warpgroup
  static constexpr int KSTEPS = C / KSTEP;  // stages a product
  static constexpr int W_PART = HALF * KSTEP * 4;  // hi or lo of a
                                                   // warpgroup's outputs
  static constexpr int STAGE = 4 * W_PART;  // hi and lo of all C outputs
  static constexpr int BOX_ROWS = STAGE / 128;  // a stage as 128-byte rows
  static constexpr int A_FLOATS = BM * C;
  static constexpr int ACC = HALF / 2;      // f32 accumulators a thread
  // the passes over the tile: a row's C / 4 float4s on TPR consumers,
  // RSTEP rows at a time
  static constexpr int TPR = C / 4;
  static constexpr int RSTEP = CONSUMERS / TPR;
  // 1024 bytes of alignment slack, the ring, the A tile; the exit's
  // tile holds EXIT_FLOATS there at every width
  static constexpr size_t SMEM =
      1024 + (size_t)STAGES * STAGE + 4 * (size_t)A_FLOATS;
  static constexpr size_t SMEM_EXIT =
      1024 + (size_t)STAGES * STAGE +
      4 * (size_t)(A_FLOATS > EXIT_FLOATS ? A_FLOATS : EXIT_FLOATS);
  static_assert(SMEM_EXIT + 64 <= 232448,
                "more shared memory than a block has");
};

// the tile a hidden width runs on
__host__ __device__ constexpr int tile_width(int c) {
  return c <= 128 ? 128 : c <= 256 ? 256 : 512;
}
// setmaxnreg moves registers within what the block was launched with,
// 65536 / THREADS a thread in steps of 8 where ptxas gives the kernel
// all it may (__launch_bounds__(THREADS, 1)); a request beyond it waits
// for ever. Every kernel on the tile (#1, #3, #4, #5 at each width) is
// launched only where ptxas gave it exactly REGS (`launch`).
constexpr int REGS = 65536 / THREADS / 8 * 8;   // 168
static_assert(128 * PRODUCER_REGS + CONSUMERS * CONSUMER_REGS <=
                  THREADS * REGS,
              "setmaxnreg asks for more registers than the block holds");
// the A tile's f32 at (row, k): 16-byte chunks XOR row % 8
template <int C>
__device__ __forceinline__ int a_at(int row, int k) {
  return row * C + (k ^ ((row & 7) << 2));
}

// shared memory descriptor of a K-major tile without swizzle: 8-row x
// 16-byte core matrices, the next one along K 128 bytes on (LBO), the
// next 8 rows 256 bytes on (SBO)
__device__ __forceinline__ uint64_t core_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

// hi = cvt.rna.tf32(v), lo = cvt.rna.tf32(v - hi); v - hi is exact
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(v));
  const float rest = __fsub_rn(v, __uint_as_float(hi));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (the registers change behind its back)
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A (64 x 8 TF32 in registers) * W^T (8 x 64 TF32, desc w)
__device__ __forceinline__ void wgmma_m64n64k8(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t w) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(w), "r"(1));
}

// d += A (64 x 8 TF32 in registers) * W^T (8 x 128 TF32, desc w)
__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t w) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(w), "r"(1));
}

// d += A (64 x 8 TF32 in registers) * W^T (8 x 256 TF32, desc w)
__device__ __forceinline__ void wgmma_m64n256k8(float (&d)[128],
                                                const uint32_t (&a)[4],
                                                uint64_t w) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, {%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(w), "r"(1));
}

// d += A * W^T over a warpgroup's N = C / 2 outputs
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t w) {
  if constexpr (N == 64)
    wgmma_m64n64k8(d, a, w);
  else if constexpr (N == 128)
    wgmma_m64n128k8(d, a, w);
  else
    wgmma_m64n256k8(d, a, w);
}

// What a consumer thread is in the tile: warpgroup `half` owns outputs
// HALF half ..; its fragment rows are r0 and r0 + 8 (A) and its
// accumulator acc[4j + 2h + e] is row r0 + 8h, column
// HALF half + 8j + 2tq + e
struct Lane {
  int half, r0, tq;
  bool lane0;  // the warp's lane that releases stages
};

// One k step: A's fragment of k0 .. k0 + 7 split into hi and lo, the
// three products added to acc on the stage at `stage`, committed as a
// group.
// TF32 A fragment of m64nNk8: a[0] (r0, tq), a[1] (r0 + 8, tq),
// a[2] (r0, tq + 4), a[3] (r0 + 8, tq + 4).
template <int C>
__device__ __forceinline__ void k_step(float (&acc)[Tile<C>::ACC],
                                       uint32_t (&hi)[4], uint32_t (&lo)[4],
                                       const float* __restrict__ a_s, int k0,
                                       Lane ln, uint32_t stage) {
  constexpr int W_PART = Tile<C>::W_PART, HALF = Tile<C>::HALF;
  const int r1 = ln.r0 + 8;
  split_tf32(a_s[a_at<C>(ln.r0, k0 + ln.tq)], hi[0], lo[0]);
  split_tf32(a_s[a_at<C>(r1, k0 + ln.tq)], hi[1], lo[1]);
  split_tf32(a_s[a_at<C>(ln.r0, k0 + ln.tq + 4)], hi[2], lo[2]);
  split_tf32(a_s[a_at<C>(r1, k0 + ln.tq + 4)], hi[3], lo[3]);
  const uint64_t w_hi = core_desc(stage + ln.half * W_PART);
  const uint64_t w_lo = core_desc(stage + (2 + ln.half) * W_PART);
  fence_acc(acc);
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
  wgmma_tf32<HALF>(acc, lo, w_hi);
  wgmma_tf32<HALF>(acc, hi, w_lo);
  wgmma_tf32<HALF>(acc, hi, w_hi);
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// The ring's read side: its next slot and that slot's phase
struct Ring {
  uint32_t base, full, empty;  // shared addresses: stages, mbarriers
  int s;
  uint32_t phase;
  __device__ __forceinline__ void next() {
    if (++s == STAGES) {
      s = 0;
      phase ^= 1;
    }
  }
};

// acc = A (the A tile) @ W^T over this warpgroup's outputs, on the next
// KSTEPS stages of the ring. The A fragments alternate between two
// register sets: a set is written again only after wait_group 1 has
// seen its products done. A stage is released by one lane of each
// consumer warp (CONSUMER_WARPS arrivals) once the warp's wait_group
// has seen the products that read it done. acc starts from zeros
// written here, not from wgmma's scale-d = 0, so that it is dead, and
// holds no registers, between the epilogue that read it and the next
// product.
template <int C>
__device__ __forceinline__ void product(float (&acc)[Tile<C>::ACC],
                                        const float* __restrict__ a_s,
                                        Ring& ring, Lane ln) {
#pragma unroll
  for (int i = 0; i < Tile<C>::ACC; ++i) acc[i] = 0.f;
  uint32_t hi[2][4], lo[2][4];
  uint32_t prev = 0;
  for (int ks = 0; ks < Tile<C>::KSTEPS; ks += 2) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      mbar_wait(ring.full + 8 * ring.s, ring.phase);
      __syncwarp();  // wgmma is .aligned: the warp leaves the spin together
      k_step<C>(acc, hi[u], lo[u], a_s, (ks + u) * KSTEP, ln,
                ring.base + ring.s * Tile<C>::STAGE);
      fence_acc(acc);
      // keep this step's products in flight; the one before is done
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      fence_acc(acc);
      if (ks + u > 0 && ln.lane0) mbar_arrive(prev);
      prev = ring.empty + 8 * ring.s;
      ring.next();
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence_acc(acc);
  if (ln.lane0) mbar_arrive(prev);
}

// The passes over the whole tile (load_a and the epilogues) are
// coalesced and rolled: consumer ct takes columns 4 (ct % TPR) .. + 3 of
// rows ct / TPR, + RSTEP, ... as float4s (a warp: 512 bytes of one row;
// at C = 512, TPR = 128 and RSTEP = 2), so
// that each thread's vector rows are four columns loaded once. An
// epilogue unrolled over a thread's 128 accumulators puts BN and GELU
// 128 times into the code, hundreds of KB that the instruction cache
// cannot hold: the kernel then spent more time in its epilogues than
// in its products. So the accumulators are first stashed in the A tile
// as they are (`stash`), and the epilogue reads them back in a loop.
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Columns col .. col + 3 of a row p of cw floats, zeros from cw on. V4:
// cw is a multiple of 4 and p starts on 16 bytes, so one float4 that
// starts below cw lies within the row; otherwise a float at a time.
template <bool V4>
__device__ __forceinline__ float4 row4(const float* p, int col, int cw) {
  if (V4) return col < cw ? ld4(p + col) : make_float4(0.f, 0.f, 0.f, 0.f);
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (col < cw) v.x = p[col];
  if (col + 1 < cw) v.y = p[col + 1];
  if (col + 2 < cw) v.z = p[col + 2];
  if (col + 3 < cw) v.w = p[col + 3];
  return v;
}

// v into columns col .. col + 3 of a row p of cw floats, none from cw on
template <bool V4>
__device__ __forceinline__ void put4(float* p, int col, int cw, float4 v) {
  if (V4) {
    if (col < cw) *reinterpret_cast<float4*>(p + col) = v;
    return;
  }
  if (col < cw) p[col] = v.x;
  if (col + 1 < cw) p[col + 1] = v.y;
  if (col + 2 < cw) p[col + 2] = v.z;
  if (col + 3 < cw) p[col + 3] = v.w;
}

__device__ __forceinline__ float4 gelu4(float4 v) {
  return make_float4(gelu_erf(v.x), gelu_erf(v.y), gelu_erf(v.z),
                     gelu_erf(v.w));
}

// A = gelu(x) for the tile's rows, zeros past n_rows and from column cw
// on (x's row width). x may be the output buffer, which the entry's
// prologue has just written (each thread reads back its own stores): no
// __restrict__, no non-coherent loads.
template <int C, bool V4>
__device__ __forceinline__ void load_a(float* __restrict__ a_s,
                                       const float* x, int row0, int n_rows,
                                       int cw, int ct) {
  constexpr int TPR = Tile<C>::TPR, RSTEP = Tile<C>::RSTEP;
  const int col = 4 * (ct % TPR);
#pragma unroll 4
  for (int row = ct / TPR; row < BM; row += RSTEP) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + row < n_rows)
      v = row4<V4>(x + (size_t)(row0 + row) * cw, col, cw);
    *reinterpret_cast<float4*>(a_s + a_at<C>(row, col)) = gelu4(v);
  }
}

// An epilogue's vector rows at a consumer's four columns: the bias and,
// with BN, eval BN's mean, var, scale and bias. BN is a template
// parameter of the tile's body (encoder_tc): a runtime switch left its
// division and square root in the passes of a model without BN.
struct Cols {
  float4 b, mean, var, sc, bi;
};

// vr: rows of cw floats; zeros from column cw on
template <bool BN, bool V4>
__device__ __forceinline__ Cols cols_of(const float* __restrict__ vr,
                                        int col, int cw) {
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  Cols k{z, z, z, z, z};
  if (col >= cw) return k;
  k.b = row4<V4>(vr, col, cw);
  if (BN) {
    k.mean = row4<V4>(vr + cw, col, cw);
    k.var = row4<V4>(vr + 2 * cw, col, cw);
    k.sc = row4<V4>(vr + 3 * cw, col, cw);
    k.bi = row4<V4>(vr + 4 * cw, col, cw);
  }
  return k;
}

template <bool BN>
__device__ __forceinline__ float affine(float a, float b, float mean,
                                        float var, float sc, float bi) {
  const float y = a + b;
  return BN ? norm_affine(y, mean, var, sc, bi) : y;
}

// a + b [-> BN] on four columns
template <bool BN>
__device__ __forceinline__ float4 affine4(float4 a, const Cols& k) {
  return make_float4(
      affine<BN>(a.x, k.b.x, k.mean.x, k.var.x, k.sc.x, k.bi.x),
      affine<BN>(a.y, k.b.y, k.mean.y, k.var.y, k.sc.y, k.bi.y),
      affine<BN>(a.z, k.b.z, k.mean.z, k.var.z, k.sc.z, k.bi.z),
      affine<BN>(a.w, k.b.w, k.mean.w, k.var.w, k.sc.w, k.bi.w));
}

// this warpgroup's products into the A tile, as they are
template <int C>
__device__ __forceinline__ void stash(const float (&acc)[Tile<C>::ACC],
                                      float* __restrict__ a_s, Lane ln) {
#pragma unroll
  for (int j = 0; j < Tile<C>::ACC / 4; ++j) {
    const int c = ln.half * Tile<C>::HALF + 8 * j + 2 * ln.tq;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(a_s + a_at<C>(ln.r0 + 8 * h, c)) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

// epilogue 1 on the stashed c1: A = gelu(c1 + b1 [-> BN1])
template <bool BN, int C, bool V4>
__device__ __forceinline__ void epilogue_gelu(float* __restrict__ a_s,
                                              const float* __restrict__ v,
                                              int cw, int ct) {
  constexpr int TPR = Tile<C>::TPR, RSTEP = Tile<C>::RSTEP;
  const int col = 4 * (ct % TPR);
  const Cols k = cols_of<BN, V4>(v, col, cw);
#pragma unroll 4
  for (int row = ct / TPR; row < BM; row += RSTEP) {
    float4* p = reinterpret_cast<float4*>(a_s + a_at<C>(row, col));
    *p = gelu4(affine4<BN>(*p, k));
  }
}

// epilogue 2 on the stashed c2: x = src + (c2 + b2 [-> BN2]) into out
// for the rows below n_rows and, where another resblock follows,
// A = gelu(x); with `stage` (the exit's last resblock) A = x instead,
// zeros past n_rows, and nothing goes to out. src is read a batch of
// rows ahead of the stores to out (which it may be). src, out: rows of
// cw floats, read and written below column cw only.
template <bool BN, int C, bool V4>
__device__ __forceinline__ void epilogue_residual(
    float* __restrict__ a_s, const float* src, float* out,
    const float* __restrict__ v, int ct, int row0, int n_rows, int cw,
    bool more, bool stage) {
  constexpr int BATCH = 8;
  constexpr int TPR = Tile<C>::TPR, RSTEP = Tile<C>::RSTEP;
  static_assert(BM % (RSTEP * BATCH) == 0, "a thread's rows in batches");
  const int col = 4 * (ct % TPR);
  const Cols k = cols_of<BN, V4>(v + 5 * cw, col, cw);
  for (int r = ct / TPR; r < BM; r += RSTEP * BATCH) {
    float4 xo[BATCH];
#pragma unroll
    for (int q = 0; q < BATCH; ++q) {
      const int row = r + RSTEP * q;
      xo[q] = row0 + row < n_rows
                  ? row4<V4>(src + (size_t)(row0 + row) * cw, col, cw)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int q = 0; q < BATCH; ++q) {
      const int row = r + RSTEP * q;
      float4* p = reinterpret_cast<float4*>(a_s + a_at<C>(row, col));
      const float4 y = affine4<BN>(*p, k);
      float4 xn = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row0 + row < n_rows) {
        xn = make_float4(xo[q].x + y.x, xo[q].y + y.y, xo[q].z + y.z,
                         xo[q].w + y.w);
        if (!stage) put4<V4>(out + (size_t)(row0 + row) * cw, col, cw, xn);
      }
      if (more)
        *p = gelu4(xn);
      else if (stage)
        *p = xn;
    }
  }
}

// The block's dynamic shared memory: the ring from the first 1024-byte
// boundary (TMA and the descriptors want 128- and 16-byte alignment;
// 1024 is kept from the swizzled layouts), then the A tile. A function
// that takes the A tile from here, not as a pointer argument, reads it
// with shared-memory loads even where it is not inlined.
__device__ __forceinline__ uint8_t* ring_base() {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  return smem_raw + (((raw + 1023u) & ~1023u) - raw);
}

template <int C>
__device__ __forceinline__ float* a_tile() {
  return reinterpret_cast<float*>(ring_base() + STAGES * Tile<C>::STAGE);
}

// What a tile does before and after its resblocks. With ENTRY, `embed`
// (a template of the passes' V4) writes the tile's input rows
// (patch-embed) to out and ends on a barrier of the consumers, and the
// kernel's x is not read; with EXIT
// the last resblock leaves x in the A tile (epilogue_residual's
// `stage`), `search` reads it there and may use the whole A tile
// (a_tile(), and the exit up to EXIT_FLOATS from there). Both are called
// by the 256 consumer threads (ct 0 .. 255) with the tile's first row
// and the row width cw. NoEnds is #1's and #3's: neither.
struct NoEnds {
  static constexpr bool ENTRY = false, EXIT = false;
  template <bool V4>
  __device__ __forceinline__ void embed(float*, int, int, int, int) const {}
  __device__ __forceinline__ void search(int, int, int, int) const {}
};

// The kernel's body: n_blocks resblocks on x (N, cw) into out (N, cw)
// on the tile of width C >= cw. tm_w: the split weights at width C (the
// ring's stages in order) as rows of 32 f32, box BOX_ROWS rows, no
// swizzle; vecs (10 n_blocks, cw) as pack_encoder stacks them. x and
// out must not overlap.
template <bool BN, int C, bool V4, typename Ends>
__device__ __forceinline__ void encoder_tc_body(const CUtensorMap* tm_w,
                                                const float* __restrict__ x,
                                                const float* __restrict__ vecs,
                                                float* out, int n_rows,
                                                int cw, int n_blocks,
                                                Ends ends) {
  constexpr int STAGE = Tile<C>::STAGE, KSTEPS = Tile<C>::KSTEPS;
  constexpr int BOX_ROWS = Tile<C>::BOX_ROWS;
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  const uint32_t base = smem_u32(ring_base());
  float* const a_s = a_tile<C>();
  const int n_tiles = (n_rows + BM - 1) / BM;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // every tile reads the same stages in the same order: matrix m =
  // 0 .. 2 n_blocks - 1 (W1, W2 of each resblock), k steps 0 .. 63
  if (wg == 0) {
    // -- producer: one thread keeps the ring full -------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(tm_w))
                   : "memory");
      int s = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
        for (int m = 0; m < 2 * n_blocks; ++m)
          for (int ks = 0; ks < KSTEPS; ++ks) {
            mbar_wait(smem_u32(&empty[s]), phase ^ 1);
            const uint32_t bar = smem_u32(&full[s]);
            mbar_expect_tx(bar, STAGE);
            tma_load(base + s * STAGE, tm_w, bar, 0,
                     (m * KSTEPS + ks) * BOX_ROWS);
            if (++s == STAGES) {
              s = 0;
              phase ^= 1;
            }
          }
    }
  } else {
    // -- consumers --------------------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int t = threadIdx.x % 128, lane = t % 32;
    const Lane ln{wg - 1, 16 * (t / 32) + lane / 4, lane % 4, lane == 0};
    const int ct = threadIdx.x - 128;
    Ring ring{base, smem_u32(&full[0]), smem_u32(&empty[0]), 0, 0};
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int row0 = tile * BM;
      if (Ends::ENTRY) ends.template embed<V4>(out, row0, n_rows, cw, ct);
      load_a<C, V4>(a_s, Ends::ENTRY ? out : x, row0, n_rows, cw, ct);
      named_sync(1, CONSUMERS);
      for (int blk = 0; blk < n_blocks; ++blk) {
        const float* v = vecs + (size_t)10 * blk * cw;
        float acc[Tile<C>::ACC];
        product<C>(acc, a_s, ring, ln);
        named_sync(1, CONSUMERS);  // both halves have read A
        stash<C>(acc, a_s, ln);
        named_sync(1, CONSUMERS);
        epilogue_gelu<BN, C, V4>(a_s, v, cw, ct);
        named_sync(1, CONSUMERS);
        product<C>(acc, a_s, ring, ln);
        named_sync(1, CONSUMERS);
        stash<C>(acc, a_s, ln);
        named_sync(1, CONSUMERS);
        epilogue_residual<BN, C, V4>(a_s, blk == 0 && !Ends::ENTRY ? x : out,
                                 out, v, ct, row0, n_rows, cw,
                                 blk + 1 < n_blocks,
                                 Ends::EXIT && blk + 1 == n_blocks);
        named_sync(1, CONSUMERS);
      }
      if (Ends::EXIT) {
        ends.search(row0, n_rows, cw, ct);
        named_sync(1, CONSUMERS);  // the next tile's load_a writes A
      }
    }
  }
}

// The kernels' body: with eval BN where use_bn (the same for the
// launch). V4: the passes move rows as float4s (`rows_v4`); each kernel
// is instantiated for both, the float4 one being the code the tile had
// before it took other widths
template <int C, bool V4, typename Ends = NoEnds>
__device__ __forceinline__ void encoder_tc(const CUtensorMap* tm_w,
                                           const float* __restrict__ x,
                                           const float* __restrict__ vecs,
                                           float* out, int n_rows, int cw,
                                           int n_blocks, int use_bn,
                                           Ends ends = Ends{}) {
  if (use_bn)
    encoder_tc_body<true, C, V4>(tm_w, x, vecs, out, n_rows, cw, n_blocks,
                                 ends);
  else
    encoder_tc_body<false, C, V4>(tm_w, x, vecs, out, n_rows, cw, n_blocks,
                                  ends);
}

// whether a launch's rows move as float4s: cw a multiple of 4 and the
// vector rows on 16 bytes (x, out and the ends' operands start on 16
// bytes at every width, as `launch` and the C entries check)
inline bool rows_v4(int cw, const void* vecs) {
  return cw % 4 == 0 && gemm90::aligned(vecs, 16);
}

// -- host side ----------------------------------------------------------------

// the split weights of n_mats matrices for TMA: n_mats x KSTEPS stages
// as rows of 32 f32, a stage one box of BOX_ROWS rows
template <int C>
inline cudaError_t make_w_map(CUtensorMap* map, const float* split,
                              int n_mats) {
  constexpr int KSTEPS = Tile<C>::KSTEPS, BOX_ROWS = Tile<C>::BOX_ROWS;
  const gemm90::EncodeTiled encode = gemm90::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {32, (cuuint64_t)n_mats * KSTEPS * BOX_ROWS};
  const cuuint64_t strides[1] = {128};
  const cuuint32_t box[2] = {32, (cuuint32_t)BOX_ROWS};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(split),
      dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// a hidden width the tiles take: 1 to MAX_C
inline bool width_ok(int cw) { return cw >= 1 && cw <= MAX_C; }

// Launch `kernel` (a __global__ wrapper of encoder_tc<C> with this
// signature, then `ends...`) on n_rows rows of width cw, with `smem`
// bytes of dynamic shared memory (the tile's SMEM, or SMEM_EXIT): one
// block per SM, or one per tile where there are fewer tiles. x (null
// for the entry), split and out 16-byte aligned, vecs 8. A kernel that
// ptxas gave another register count than REGS is not launched
// (cudaErrorInvalidKernelImage): its setmaxnreg requests would hang.
// per kernel and device: ptxas's register count held against REGS and
// the SM count, asked once (both are fixed once the library is built),
// and the dynamic shared memory the kernel may use, raised as a call
// needs more
inline cudaError_t kernel_ready(const void* kernel, size_t smem, int* sms) {
  struct Ready {
    cudaError_t err;
    int sms, smem;
  };
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, Ready> ready;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  auto it = ready.find({kernel, dev});
  if (it == ready.end()) {
    Ready r = {cudaSuccess, 0, 0};
    cudaFuncAttributes fa = {};
    r.err = cudaDeviceGetAttribute(&r.sms, cudaDevAttrMultiProcessorCount, dev);
    if (r.err == cudaSuccess) r.err = cudaFuncGetAttributes(&fa, kernel);
    if (r.err == cudaSuccess && fa.numRegs != REGS)
      r.err = cudaErrorInvalidKernelImage;
    it = ready.emplace(std::make_pair(kernel, dev), r).first;
  }
  Ready& r = it->second;
  if (r.err != cudaSuccess) return r.err;
  if ((int)smem > r.smem) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    r.smem = (int)smem;
  }
  *sms = r.sms;
  return cudaSuccess;
}

template <int C, typename Kernel, typename... Ends>
cudaError_t launch(Kernel kernel, size_t smem, const float* x,
                   const float* split, const float* vecs, float* out,
                   int n_rows, int cw, int n_blocks, int use_bn,
                   cudaStream_t stream, Ends... ends) {
  if (n_rows < 1 || n_blocks < 1 || !width_ok(cw) || cw > C)
    return cudaErrorInvalidValue;
  if (!gemm90::aligned(x, 16) || !gemm90::aligned(split, 16) ||
      !gemm90::aligned(out, 16) || !gemm90::aligned(vecs, 8))
    return cudaErrorMisalignedAddress;
  CUtensorMap tm_w;
  cudaError_t e = make_w_map<C>(&tm_w, split, 2 * n_blocks);
  if (e != cudaSuccess) return e;
  int sms;
  e = kernel_ready(reinterpret_cast<const void*>(kernel), smem, &sms);
  if (e != cudaSuccess) return e;
  const int tiles = (n_rows + BM - 1) / BM;
  kernel<<<tiles < sms ? tiles : sms, THREADS, smem, stream>>>(
      tm_w, x, vecs, out, n_rows, cw, n_blocks, use_bn, ends...);
  return cudaGetLastError();
}

}  // namespace enc_tc
}  // namespace arcweld
