// encoder_chain_bf16: n eval-mode VQ-VAE encoder resblocks on a row tile,
// with both products of every resblock on Hopper's bf16 tensor cores.
//
// Replaces vq_vae_transformer_arc_welding_tpu/ops/pallas_encoder.py::
// fused_encoder_eval with compute_dtype=bfloat16 (_resblock_chain's
// `cdt`, :209-232; pallas_call at :311). Per resblock and row:
//   h = gelu(x)            f32, exact erf
//   c = bf16(h) @ W1 + b1  bf16 x bf16 products summed in f32 [-> eval BN]
//   h = gelu(c)            f32
//   c = bf16(h) @ W2 + b2  the same [-> eval BN]
//   x = x + c              f32
// x (N, C) f32 in and out; W the bf16 weights in the rings' stage order
// (ops/fused_encoder.py::stage_weights_bf16, made once where the
// weights are packed); vecs (10n, C) f32. Only the products' inputs are
// rounded (round to nearest even); the contract is a tolerance against
// the plain version, not bit equality (wgmma sums k in its own order).
//
// What bounds it on an H100: the bf16 products, 2 x 2 x 512 x 512 operations a
// row and resblock (214.7 GFLOP at 25,600 rows and eight resblocks, 0.217 ms at
// 989 TFLOP/s). Beside them: (1) the epilogues, ~200 M exact-erf GELUs a
// launch, whose issue costs about as much as the products, and whose round
// trips to shared and device memory (A's stores, the residual's loads and
// stores) keep the passes apart (the variants: PERF.md); (2) the weights, 8.4
// MB for eight resblocks, which every 64-row tile takes into its shared memory
// from L2: 3.4 GB a launch at 25,600 rows, which the SMs receive at about the
// products' pace (scripts/bench_encoder_bf16_variants.py, "W stream alone");
// (3) the last round of tiles (400 tiles of 64 rows on 132 SMs are 3.03 rounds'
// work in 4); (4) registers: ptxas holds every thread of a 384-thread block to
// 65536 / 384 = 168 of them.
//
// Design (one block of 384 threads per SM, 227 KB of shared memory):
//  - a tile is BM = 64 rows (wgmma's M) with all C = 512 columns for the
//    whole chain. Its A operand, bf16(gelu(.)), is 64 KB of shared
//    memory in wgmma's K-major layout with the 128-byte swizzle: 64 of K
//    a 128-byte row, 16-byte chunk c of row r at c ^ (r % 8), 8-row
//    groups 1024 bytes apart (SBO), the next 64 of K 8 KB on; a k step
//    of 16 is a descriptor 32 bytes into the row. A is double-buffered:
//    the epilogues of product p write the A of product p + 1;
//  - two consumer warpgroups each own half the outputs, as two passes of
//    128 (wgmma m64n128k16, A and W from shared memory: 64 f32
//    accumulators a thread, which leaves registers for an epilogue from
//    them; 128 a thread spilled). setmaxnreg gives the consumers 232
//    registers and the producer warpgroup 40, and ptxas allocates the
//    consumers' code within the 232. A build that needs fewer than 168
//    registers a thread is launched with fewer, and a request for 232
//    then hangs or faults the block (seen on the card), so the wrapper
//    refuses to launch a build that ptxas gave another count;
//  - one producer thread feeds a ring of STAGES stages by TMA, in the
//    order the passes run (warpgroup 0's first, 1's first, 0's second,
//    1's second), a stage 64 of K x 128 outputs (16 KB, rows of 64 of K,
//    which TMA swizzles as A is), multiplied by four wgmma in one commit
//    group so that a stage's products are in flight while the next
//    stage's are issued;
//  - ping-pong: a warpgroup runs a pass's epilogue (bias [-> BN] -> GELU
//    -> bf16 into the next A; or bias [-> BN], the residual add into
//    the output and bf16(GELU) into the next A) from its registers
//    while the other warpgroup's products run; its operands (the bias
//    and the residual rows) are loaded there, after L1 and L2 were
//    asked for them before the pass. Each 128-wide quarter of
//    the next A's K is marked written on an mbarrier (per quarter, two
//    taken in turns by product parity, so that a waiter never sees a
//    phase two ahead), and every pass multiplies the quarters in the
//    order they are written (K 0, 256, 128, 384 ..), waiting on each.
//    The passes take the ring's stages in turns, and a pass
//    begins waiting on its stages only once the pass before it (the
//    other warpgroup's) has seen all of its own land (a `turn`
//    mbarrier): a warpgroup that ran ahead into stages STAGES or more
//    beyond the last one loaded would find its slot's phase parity
//    already flipped and read the stage as landed;
//  - W is not shared between blocks: L2 delivers every block's W stream
//    at the products' pace. Two blocks of a cluster sharing each W stage
//    by TMA multicast halved the L2 reads of W but measured no faster
//    (PERF.md, PR 14), and that path is not kept;
//  - the residual stream x stays in the output buffer, which only this
//    block touches for its rows: epilogue 2 reads x there (from the
//    input on the first resblock), adds c and writes it back; a pass
//    reads and writes only its own columns, the same thread each
//    resblock;
//  - a persistent walk: the blocks take the tiles blockIdx, + gridDim,
//    ...; the producer runs on into the
//    next tile's W while the consumers finish a tile. Nothing adds,
//    skips or reorders a ring stage (a skipped stage breaks the
//    mbarriers' parity);
//  - rows past N are zeros in A and are neither read nor written.
// scripts/bench_encoder_bf16_variants.py builds variants of this source
// by editing its text (no ping-pong, no GELU, parts of the epilogues
// cut, the products alone, the ring alone) and times them in turns with
// another tree's kernel.
#include <cuda_bf16.h>

#include <mutex>

#include "int8_gemm_sm90.cuh"  // gemm90:: mbarrier, TMA and tensor-map helpers

namespace {

using namespace arcweld;
using gemm90::mbar_arrive;
using gemm90::mbar_expect_tx;
using gemm90::mbar_init;
using gemm90::mbar_wait;
using gemm90::smem_u32;
using bf16 = __nv_bfloat16;

constexpr int C = 512;                 // hidden width
constexpr int BM = 64;                 // rows a tile: wgmma's M
constexpr int HALF = C / 2;            // outputs of a consumer warpgroup
constexpr int QUARTER = C / 4;         // outputs of a pass
constexpr int KSTEP = 16;              // bf16 of K a wgmma
constexpr int STAGE_K = 64;            // K a stage
constexpr int STEPS = STAGE_K / KSTEP;      // wgmma a stage
constexpr int PASS_STAGES = C / STAGE_K;    // stages a pass
constexpr int STAGES = 6;
constexpr int W_STAGE = QUARTER * STAGE_K * 2;     // 16 KB
constexpr int RING = STAGES * W_STAGE;
constexpr int BOX_ROWS = W_STAGE / 128;    // a stage's TMA box
constexpr int A_BYTES = BM * C * 2;
constexpr int CONSUMERS = 256;             // two warpgroups
constexpr int THREADS = 128 + CONSUMERS;   // warpgroup 0 loads
constexpr int ACC = QUARTER / 2;           // f32 accumulators a thread
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
// the registers a thread the block is launched with, where ptxas gives
// the kernel all it may (__launch_bounds__(THREADS, 1)): 168
constexpr int REGS = 65536 / THREADS / 8 * 8;
static_assert(STAGE_K * 2 == 128, "a stage row is one 128-byte swizzle row");
// setmaxnreg moves registers within what the block was launched with; a
// request beyond it waits for ever. The wrapper checks that ptxas gave
// the kernel REGS registers (fewer would leave the requests unmet too)
static_assert(128 * PRODUCER_REGS + CONSUMERS * CONSUMER_REGS <=
                  THREADS * REGS,
              "setmaxnreg asks for more registers than the block holds");
// 1024 bytes of alignment slack, the ring, the two A tiles
constexpr size_t SMEM = 1024 + (size_t)RING + 2 * (size_t)A_BYTES;
static_assert(SMEM + 256 <= 232448, "more shared memory than a block has");

// the A tile's bf16 at (row, k): 64 of K a row of 128 bytes, its
// 16-byte chunk (k % 64) / 8 at chunk ((k % 64) / 8) ^ (row % 8), the
// next 64 of K a 64-row block (8 KB) on
__device__ __forceinline__ int a_off(int row, int k) {
  return (k >> 6) * (BM * 64) + row * 64 +
         ((((k >> 3) & 7) ^ (row & 7)) << 3) + (k & 7);
}

// the stage of K (64 wide) that a pass multiplies j-th: the 128-wide
// quarters of K in the order the epilogues write them (warpgroup 0's
// first pass, 1's first, 0's second, 1's second: K 0, 256, 128, 384)
__device__ __forceinline__ int k_stage(int j) {
  const int q = j / 2;
  return ((q & 1) * 2 + (q >> 1)) * 2 + j % 2;
}


// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (the registers change behind its back)
__device__ __forceinline__ void fence_acc(float (&d)[ACC]) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A (64 x 16 bf16, desc a) * W^T (16 x 128 bf16, desc w), f32
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[ACC], uint64_t a,
                                                 uint64_t w) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, "
      "1, 0, 0;\n}\n"
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
      : "l"(a), "l"(w), "r"(1));
}

__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}

// What a consumer thread is in the tile: warpgroup `half`; in a pass of
// 128 outputs from column c0 its accumulator acc[4j + 2e + f] is row
// r0 + 8e, column c0 + 8j + 2tq + f
struct Lane {
  int half, r0, tq;
  bool lane0;  // the warp's lane that releases stages
};

// The ring's read side: its stages and barriers (shared addresses)
struct Ring {
  uint32_t base, full, empty;
};

// The turns of the passes: pass P (counted over the walk: warpgroup P %
// 2's (P / 2)-th) begins on its stages once pass P - 1 has seen its own
// land; turn[h] completes once per pass of warpgroup h
struct Turn {
  uint32_t wait, wait_parity, done;  // the barrier to wait on, the mine
  bool first;                        // pass 0: nothing before it
};

// acc = A @ W^T over a pass's 128 outputs, on the ring's stages pos0 ..
// pos0 + PASS_STAGES - 1 (counted over the walk: slot pos % STAGES, phase
// pos / STAGES), in k_stage's order; before each quarter of K the pass
// waits for `ready` + 16 kq (the barrier of quarter kq, of this product's
// parity) to complete the phase of parity `parity`. A stage is released
// by one lane of each consumer warp once the warp's wait_group has seen
// the products that read it done. acc starts from zeros written here, so
// that it is dead between the epilogue that read it and the next pass.
__device__ __forceinline__ void pass_product(float (&acc)[ACC], uint32_t a_s,
                                             Ring ring, uint32_t pos0,
                                             Lane ln, uint32_t ready,
                                             uint32_t parity, Turn turn) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
  uint32_t prev = 0, cur = 0;
  if (!turn.first) mbar_wait(turn.wait, turn.wait_parity);
  for (int j = 0; j < PASS_STAGES; ++j) {
    const int kb = k_stage(j);
    if (j % 2 == 0) mbar_wait(ready + 16 * (kb / 2), parity);
    const uint32_t pos = pos0 + j, s = pos % STAGES;
    mbar_wait(ring.full + 8 * s, (pos / STAGES) & 1);
    if (j == PASS_STAGES - 1) mbar_arrive(turn.done);
    __syncwarp();  // wgmma is .aligned: the warp leaves the spin together
    cur = ring.empty + 8 * s;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int i = 0; i < STEPS; ++i)
      wgmma_m64n128k16(acc,
                       gemm90::sw128_desc(a_s + kb * (BM * 128) + i * 32),
                       gemm90::sw128_desc(ring.base + s * W_STAGE + i * 32));
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    fence_acc(acc);
    if (j + 1 < PASS_STAGES) {
      // keep this stage's products in flight; the one before is done
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      fence_acc(acc);
      if (j > 0 && ln.lane0) mbar_arrive(prev);
      prev = cur;
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence_acc(acc);
  if (ln.lane0) {
    mbar_arrive(prev);
    mbar_arrive(cur);
  }
}

// A's writes (generic proxy) made visible to the wgmma that reads them
// (async proxy); each writer fences before it arrives
__device__ __forceinline__ void fence_a() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float4 gelu4(float4 v) {
  return make_float4(gelu_erf(v.x), gelu_erf(v.y), gelu_erf(v.z),
                     gelu_erf(v.w));
}

// c + b [-> eval BN] on two columns: b the bias there, vr the bias row
// at those columns, eval BN's mean, var, scale and bias rows C apart
// after it
template <bool BN>
__device__ __forceinline__ float2 affine2(float x, float y, float2 b,
                                          const float* __restrict__ vr) {
  float2 r = make_float2(x + b.x, y + b.y);
  if (BN) {
    const float2 mean = ld2(vr + C), var = ld2(vr + 2 * C),
                 sc = ld2(vr + 3 * C), bi = ld2(vr + 4 * C);
    r = make_float2(norm_affine(r.x, mean.x, var.x, sc.x, bi.x),
                    norm_affine(r.y, mean.y, var.y, sc.y, bi.y));
  }
  return r;
}

// What a pass's epilogue reads from device memory, asked for before the
// pass: its vector rows (the bias, with BN four more; 128 columns from
// c0) into L1, and for epilogue 2 this thread's residual rows at the
// pass's columns into L2 (the input is not there on the first resblock).

template <bool BN>
__device__ __forceinline__ void prefetch_pass(const float* __restrict__ vr,
                                              const float* src, int c0,
                                              Lane ln, int t, int row0,
                                              int n_rows, bool residual) {
  constexpr int LINES = QUARTER * 4 / 128;  // 128-byte lines of a row
  if (t < (BN ? 5 : 1) * LINES)
    prefetch_l1(vr + (t / LINES) * C + c0 + 32 * (t % LINES));
  if (residual)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (row0 + ln.r0 + 8 * e < n_rows)
        asm volatile("prefetch.global.L2 [%0];" ::"l"(
            src + (size_t)(row0 + ln.r0 + 8 * e) * C + c0 + 32 * ln.tq));
}

// a pass's bias at this thread's columns
__device__ __forceinline__ void load_bias(float2 (&bias)[ACC / 4],
                                          const float* __restrict__ vr,
                                          int c0, Lane ln) {
#pragma unroll
  for (int j = 0; j < ACC / 4; ++j)
    bias[j] = ld2(vr + c0 + 8 * j + 2 * ln.tq);
}

// A's warpgroup half (K in HALF half ..) = bf16(gelu(x)) for the tile's
// rows, zeros past n_rows; warp w of the warpgroup takes the 16-column
// groups 4w .. 4w + 3 of the half, lane l the four columns 4 (l / 8) ..
// of a group in rows 8 rg + l % 8
__device__ __forceinline__ void load_a_half(bf16* a,
                                            const float* __restrict__ x,
                                            int row0, int n_rows, int half,
                                            int t) {
  const int w = t / 32, r_in = t % 8, q = (t % 32) / 8;
#pragma unroll 1
  for (int cg = 4 * w; cg < 4 * w + 4; ++cg) {
    const int k = half * HALF + 16 * cg + 4 * q;
#pragma unroll 4
    for (int rg = 0; rg < 8; ++rg) {
      const int row = 8 * rg + r_in;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row0 + row < n_rows) v = ld4(x + (size_t)(row0 + row) * C + k);
      const float4 g = gelu4(v);
      *reinterpret_cast<uint2*>(a + a_off(row, k)) =
          make_uint2(pack_bf16(g.x, g.y), pack_bf16(g.z, g.w));
    }
  }
}

// epilogue 1 of the pass from column c0: the next A at those columns =
// bf16(gelu(c1 + b1 [-> BN1]))
template <bool BN>
__device__ __forceinline__ void epi_gelu(const float (&acc)[ACC], bf16* a,
                                         const float* __restrict__ v, int c0,
                                         Lane ln) {
  float2 bias[ACC / 4];
  load_bias(bias, v, c0, ln);
#pragma unroll
  for (int j = 0; j < ACC / 4; ++j) {
    const int col = c0 + 8 * j + 2 * ln.tq;
    const float2 y0 = affine2<BN>(acc[4 * j], acc[4 * j + 1], bias[j],
                                  v + col);
    const float2 y1 = affine2<BN>(acc[4 * j + 2], acc[4 * j + 3], bias[j],
                                  v + col);
    const float4 g = gelu4(make_float4(y0.x, y0.y, y1.x, y1.y));
    *reinterpret_cast<uint32_t*>(a + a_off(ln.r0, col)) = pack_bf16(g.x, g.y);
    *reinterpret_cast<uint32_t*>(a + a_off(ln.r0 + 8, col)) =
        pack_bf16(g.z, g.w);
  }
}

// the residual stream at a pass's columns: xs[2j + e] is row r0 + 8e,
// columns c0 + 8j + 2tq ..; zeros past n_rows
__device__ __forceinline__ void load_x(float2 (&xs)[ACC / 2], const float* src,
                                       int c0, Lane ln, int row0,
                                       int n_rows) {
#pragma unroll
  for (int j = 0; j < ACC / 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = row0 + ln.r0 + 8 * e;
      xs[2 * j + e] = row < n_rows
                          ? ld2(src + (size_t)row * C + c0 + 8 * j + 2 * ln.tq)
                          : make_float2(0.f, 0.f);
    }
}

// epilogue 2 of the pass from column c0: x = src + (c2 + b2 [-> BN2]);
// where another resblock follows the next A at those columns =
// bf16(gelu(x)) (zeros past n_rows), made visible to the products and
// marked written on `ready` (when `signal`); only then x into out for
// the rows below n_rows, so that the mark waits on no store to device
// memory. src (the input or out) is loaded whole at the start.
template <bool BN>
__device__ __forceinline__ void epi_residual(const float (&acc)[ACC],
                                             bf16* a, const float* src,
                                             float* out,
                                             const float* __restrict__ v,
                                             int c0, Lane ln, int row0,
                                             int n_rows, bool more,
                                             uint32_t ready, bool signal) {
  float2 bias[ACC / 4], xs[ACC / 2];
  load_bias(bias, v + 5 * C, c0, ln);
  load_x(xs, src, c0, ln, row0, n_rows);
#pragma unroll
  for (int j = 0; j < ACC / 4; ++j) {
    const int col = c0 + 8 * j + 2 * ln.tq;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = ln.r0 + 8 * e;
      const float2 y = affine2<BN>(acc[4 * j + 2 * e], acc[4 * j + 2 * e + 1],
                                   bias[j], v + 5 * C + col);
      float2& xn = xs[2 * j + e];
      xn = row0 + row < n_rows ? make_float2(xn.x + y.x, xn.y + y.y)
                               : make_float2(0.f, 0.f);
    }
    if (more) {
      const float4 g = gelu4(make_float4(xs[2 * j].x, xs[2 * j].y,
                                         xs[2 * j + 1].x, xs[2 * j + 1].y));
      *reinterpret_cast<uint32_t*>(a + a_off(ln.r0, col)) =
          pack_bf16(g.x, g.y);
      *reinterpret_cast<uint32_t*>(a + a_off(ln.r0 + 8, col)) =
          pack_bf16(g.z, g.w);
    }
  }
  fence_a();
  if (signal) mbar_arrive(ready);
#pragma unroll
  for (int j = 0; j < ACC / 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = row0 + ln.r0 + 8 * e;
      if (row < n_rows)
        *reinterpret_cast<float2*>(out + (size_t)row * C + c0 + 8 * j +
                                   2 * ln.tq) = xs[2 * j + e];
    }
}

// The block's dynamic shared memory: the ring from the first 1024-byte
// boundary, then the two A tiles
__device__ __forceinline__ uint8_t* ring_base() {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  return smem_raw + (((raw + 1023u) & ~1023u) - raw);
}

// n_blocks resblocks on x (N, C) into out (N, C). tm_w: the staged
// weights as rows of 64 bf16, box BOX_ROWS rows, 128-byte swizzle; vecs
// (10 n_blocks, C) as pack_encoder stacks them. x and out must not
// overlap.
template <bool BN>
__device__ __forceinline__ void chain_body(const CUtensorMap* tm_w,
                                           const float* __restrict__ x,
                                           const float* __restrict__ vecs,
                                           float* out, int n_rows,
                                           int n_blocks) {
  // the ring's full and empty barriers; per quarter kq of A's K
  // (written by warpgroup kq / 2, pass kq % 2) and product parity a
  // barrier on which the writer's 128 threads mark it written
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  __shared__ __align__(8) uint64_t ready[4][2], turn[2];
  uint8_t* const smem = ring_base();
  const uint32_t base = smem_u32(smem);
  bf16* const a_tiles = reinterpret_cast<bf16*>(smem + RING);
  const uint32_t a_addr = base + RING;
  const int n_tiles = (n_rows + BM - 1) / BM;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 4);  // one warpgroup's warps
    }
    for (int kq = 0; kq < 4; ++kq)
      for (int par = 0; par < 2; ++par)
        mbar_init(smem_u32(&ready[kq][par]), 128);
    for (int h = 0; h < 2; ++h) mbar_init(smem_u32(&turn[h]), 128);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // every tile reads the same stages in the same order: matrix m =
  // 0 .. 2 n_blocks - 1 (W1, W2 of each resblock); its four passes in the
  // order they run (warpgroup h = 0, 1 of pass qq = 0, then of qq = 1),
  // each in k_stage's order
  if (wg == 0) {
    // -- producer: one thread keeps the ring full --------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(tm_w))
                   : "memory");
      int s = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
        for (int m = 0; m < 2 * n_blocks; ++m)
          for (int pass = 0; pass < 4; ++pass)
            for (int j = 0; j < PASS_STAGES; ++j) {
              mbar_wait(smem_u32(&empty[s]), phase ^ 1);
              const uint32_t bar = smem_u32(&full[s]);
              mbar_expect_tx(bar, W_STAGE);
              // stage (m, warpgroup, pass, K stage) of the pack as
              // 128-byte rows
              const int h = pass % 2, qq = pass / 2;
              const int row =
                  (((m * 2 + h) * 2 + qq) * PASS_STAGES + k_stage(j)) *
                  (W_STAGE / 128);
              gemm90::tma_load(base + s * W_STAGE, tm_w, bar, 0, row);
              if (++s == STAGES) {
                s = 0;
                phase ^= 1;
              }
            }
    }
    __syncwarp();
  } else {
    // -- consumers --------------------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int h = wg - 1, t = threadIdx.x % 128, lane = t % 32;
    const Lane ln{h, 16 * (t / 32) + lane / 4, lane % 4, lane == 0};
    const Ring ring{base, smem_u32(&full[0]), smem_u32(&empty[0])};
    // product p (counted over the walk) reads A tile p % 2, and its
    // epilogues write tile (p + 1) % 2; ready[kq][p % 2] completes for
    // the (p / 2)-th time when quarter kq of product p's A is written.
    // Pass qq of product p takes the ring's stages from
    // (4 p + 2 qq + h) PASS_STAGES on.
    int p = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int row0 = tile * BM;
      load_a_half(a_tiles + (p & 1) * (A_BYTES / 2), x, row0, n_rows, h, t);
      fence_a();
      mbar_arrive(smem_u32(&ready[2 * h][p & 1]));
      mbar_arrive(smem_u32(&ready[2 * h + 1][p & 1]));
      for (int blk = 0; blk < n_blocks; ++blk) {
        const float* v = vecs + (size_t)10 * blk * C;
        const bool more = blk + 1 < n_blocks;
        const float* src = blk == 0 ? x : out;
#pragma unroll 1
        for (int pp = 0; pp < 2; ++pp, ++p) {
          bf16* const next = a_tiles + ((p + 1) & 1) * (A_BYTES / 2);
#pragma unroll 1
          for (int qq = 0; qq < 2; ++qq) {
            const int c0 = h * HALF + qq * QUARTER;
            prefetch_pass<BN>(v + 5 * C * pp, src, c0, ln, t, row0, n_rows,
                              pp == 1);
            // this warpgroup's i-th pass, the walk's pass 2 i + h
            const int i = 2 * p + qq;
            const Turn tn{smem_u32(&turn[1 - h]), (uint32_t)(i - 1 + h) & 1,
                          smem_u32(&turn[h]), i == 0 && h == 0};
            float acc[ACC];
            pass_product(acc, a_addr + (p & 1) * A_BYTES, ring,
                         (4 * p + 2 * qq + h) * PASS_STAGES, ln,
                         smem_u32(&ready[0][p & 1]), (p >> 1) & 1, tn);
            // quarter 2h + qq of the next product's A: written, made
            // visible to its products and marked
            const uint32_t written = smem_u32(&ready[2 * h + qq][(p + 1) & 1]);
            if (pp == 1) {
              epi_residual<BN>(acc, next, src, out, v, c0, ln, row0, n_rows,
                               more, written, more);
            } else {
              epi_gelu<BN>(acc, next, v, c0, ln);
              fence_a();
              mbar_arrive(written);
            }
          }
        }
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
encoder_chain_bf16_kernel(const __grid_constant__ CUtensorMap tm_w,
                          const float* __restrict__ x,
                          const float* __restrict__ vecs, float* out,
                          int n_rows, int n_blocks, int use_bn) {
  if (use_bn)
    chain_body<true>(&tm_w, x, vecs, out, n_rows, n_blocks);
  else
    chain_body<false>(&tm_w, x, vecs, out, n_rows, n_blocks);
}

// the staged weights of n_mats matrices for TMA: as rows of 64 bf16, read
// in boxes of BOX_ROWS rows
cudaError_t make_w_map(CUtensorMap* map, const bf16* staged, int n_mats) {
  const gemm90::EncodeTiled encode = gemm90::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {64, (cuuint64_t)n_mats * C * C / 64};
  const cuuint64_t strides[1] = {128};
  const cuuint32_t box[2] = {64, (cuuint32_t)BOX_ROWS};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(staged),
      dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// once per device: the shared memory attribute, the check that ptxas
// gave the kernel the registers setmaxnreg assumes (a toolkit that gave
// it fewer would hang the launch: cudaErrorInvalidKernelImage instead),
// and the grid, as many blocks as fit on the card at once
cudaError_t grid_of(int* grid) {
  constexpr int MAX_DEVICES = 64;
  static std::once_flag once[MAX_DEVICES];
  static int blocks[MAX_DEVICES];
  static cudaError_t err[MAX_DEVICES];
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::call_once(once[dev], [dev] {
    int sms = 0, per_sm = 0;
    cudaFuncAttributes fa = {};
    err[dev] = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
    if (err[dev] == cudaSuccess)
      err[dev] = cudaFuncSetAttribute(
          encoder_chain_bf16_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (err[dev] == cudaSuccess)
      err[dev] = cudaFuncGetAttributes(&fa, encoder_chain_bf16_kernel);
    if (err[dev] == cudaSuccess && fa.numRegs != REGS)
      err[dev] = cudaErrorInvalidKernelImage;
    if (err[dev] == cudaSuccess)
      err[dev] = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, encoder_chain_bf16_kernel, THREADS, SMEM);
    if (err[dev] == cudaSuccess && per_sm < 1)
      err[dev] = cudaErrorInvalidConfiguration;
    blocks[dev] = sms * per_sm;
  });
  *grid = blocks[dev];
  return err[dev];
}

}  // namespace

// x (N, C) f32; staged: (2 n_blocks, C C) bf16 in the rings' stage order
// (ops/fused_encoder.py::stage_weights_bf16); vecs (10 n_blocks, C);
// out (N, C). x, staged, vecs and out 16-byte aligned.
extern "C" int encoder_chain_bf16(const void* x, const void* staged,
                                  const void* vecs, void* out, int n_rows,
                                  int c, int n_blocks, int use_bn,
                                  void* stream) {
  // hidden 512, the bench model's width, as the f32 chain
  if (c != C || n_rows < 1 || n_blocks < 1) return cudaErrorInvalidValue;
  if (!gemm90::aligned(x, 16) || !gemm90::aligned(staged, 16) ||
      !gemm90::aligned(out, 16) || !gemm90::aligned(vecs, 16))
    return cudaErrorMisalignedAddress;
  CUtensorMap tm_w;
  cudaError_t e =
      make_w_map(&tm_w, static_cast<const bf16*>(staged), 2 * n_blocks);
  if (e != cudaSuccess) return e;
  int grid;
  if ((e = grid_of(&grid)) != cudaSuccess) return e;
  // one block per tile where there are fewer tiles than fit at once
  const int n_tiles = (n_rows + BM - 1) / BM;
  encoder_chain_bf16_kernel<<<n_tiles < grid ? n_tiles : grid, THREADS, SMEM,
                              static_cast<cudaStream_t>(stream)>>>(
      tm_w, static_cast<const float*>(x), static_cast<const float*>(vecs),
      static_cast<float*>(out), n_rows, n_blocks, use_bn);
  return cudaGetLastError();
}
