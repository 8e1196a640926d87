// decode: one token of KV-cached sampling through a transformer block,
// the attention half (#12) or the whole block (#13), as one launch.
//
// Replaces vq_vae_transformer_arc_welding_tpu/ops/pallas_decode.py:
//   fused_decode_attn  (pallas_call at :149, _decode_body):
//     h = LN1(x); q, k, v = h Wqkv + b; K/V row `pos` written in place;
//     y = softmax(q K[:pos+1]^T / sqrt(D)) V[:pos+1] per head;
//     x_mid = x + y Wproj + b.              caches (B, H, T, D)
//   fused_block_decode (pallas_call at :371, _block_decode_body):
//     the same, then x_out = x_mid + new_gelu(LN2(x_mid) Wfc + b) Wmp + b.
//                                           caches (B, T, C), time-major
// x is (B, 1, C): one row per stream.
//
// What bounds it on an H100: bytes. At C = 512 a block's f32 weights are
// 12.6 MB and the cache rows 0..pos of B = 16 streams 10.5 MB at pos 160,
// against 0.1 GFLOP of products: 6.9 us at 3.35 TB/s; at GPT-2 XL's C =
// 1,600 the weights are 12 x 1,600^2 x 4 B = 123 MB, 36.7 us, and at C =
// 4,096 805 MB, 0.24 ms, plus the cache rows. The TPU kernels run one
// program per sample, each streaming every weight through VMEM; here the
// weights are read once by the whole card:
//
//  - One cooperative launch: a persistent grid of one block per SM
//    (cudaLaunchCooperativeKernel, so that a grid the card cannot hold at
//    once is refused, not hung), its phases separated by grid barriers:
//    qkv and the K/V row write | attention | c_proj + residual [| LN2 +
//    c_fc + GELU | m_proj + residual]: two barriers for #12, four for #13.
//  - Weights stream independently of the phases. Each block owns a run
//    of output columns of every product and, at its first instruction,
//    issues all of them as 1-D TMA copies (cp.async.bulk) into shared
//    memory, one mbarrier per chunk of 8 columns x a k piece. At C = 512
//    on 132 SMs that is ~95 KB a block, all of it on chip ~6 us into the
//    launch. Where a block's weights do not fit (C = 768 and up), the
//    chunks stream through a ring of slots in the order they are used,
//    each slot refilled once every warp is done with it.
//  - Two forms. The first form, the code of the shapes it took first (C
//    and c4 multiples of 64 up to C = 1,024, heads up to 128: the bench
//    model), reads w as it is, (n, k) in torch's Linear layout, in pieces
//    of KC, the largest multiple of 64 up to 512 dividing C and c4, a
//    copy a chunk where the rows are one range, else a copy a row. The
//    general form (see its section) takes any C from 1 to 4,096 and any
//    MLP width: each product's depth zero-padded to a multiple of 64
//    (pad64) and walked in pieces of up to 512 floats, a block's columns
//    walked in groups of up to MAX_COLS = 32 (the accumulators a thread
//    holds). It reads the weights in rows of pad64(k) floats, a copy a
//    row, or packed by the wrapper in the order it reads them, one bulk
//    copy a chunk (DecodeArgs::packed; BlockDecodeStack packs them once a
//    generation, where decode_general_form says the general form runs).
//    The wrapper (ops/fused_decode.py) hands x, and takes out, in rows of
//    pad64(C) floats; the scratch rows are padded alike and zero past C.
//    The added columns add exact 0s to every sum.
//  - The activations, x, y, x_mid and g, are read whole by every block:
//    a row tile of 16 rows x a piece at a time comes into shared memory
//    by TMA too (one copy where the rows are one range), NBUF tiles in
//    flight (GNBUF in the general form). Read as mma fragments straight
//    from L2, the 132 blocks' scattered 4-byte loads of the same few KB
//    took 5-9 us a product. LayerNorm's statistics come from the tile
//    where it holds the rows whole, else from L2 in two passes (the mean,
//    then the squares; any C), lane L taking the float4s L + 32 i in
//    order; a row's float4 past C reads the zero padding, whose squares
//    are taken off after the sum (row_var).
//  - m_proj (k = c4) is split over the grid by k pieces: a block reads
//    one piece of g (the general form: one range of pieces) and not all
//    of it, and the last block of a column range to finish adds the
//    partial sums in order.
//  - Products on the tensor cores: a row tile is mma's m16, a chunk's 8
//    columns its n8, the 8 warps split a chunk's k. Inside each 16-column
//    block the k order is permuted (a thread's 4 consecutive columns are
//    its fragment columns tg and tg + 4 of two k8 steps), so that A and W
//    are read as float4s (two-way bank conflicts, which cost less than a
//    padded layout's one TMA copy a row). Split TF32 (hi*hi + hi*lo +
//    lo*hi) keeps f32 accuracy; hi is x rounded to TF32 by integer
//    arithmetic and lo = x - hi, exact, whose low bits the tensor core
//    drops (cvt.rna's throughput held the first version's products). Two
//    accumulators a chunk keep the tensor core's dependent chains short.
//    The warps' partial sums are added in a fixed order in shared memory.
//    Batches above 16 rows walk row tiles over the weights on chip.
//  - Attention: one (sample, head) per block at a time (128 at batch 16),
//    reading only rows 0..pos; a half warp takes a key (16 lanes x float4
//    are its 64 floats) and loads UNROLL keys' K and V rows at once, the
//    first round of them (all but row pos) before the barrier that ends
//    the qkv product; its softmax runs online (flash-decoding within the
//    block), so any T is taken and no score leaves the registers. Other
//    head widths (up to 128): a head up to 64 wide on 16 lanes a key, up
//    to 128 on a warp a key, its lanes past the real width holding zeros
//    (Attend); the 64-wide head keeps its own instantiation. A head past
//    128 (attention_wide) spreads its keys over the block's warps, each
//    with its own online softmax over the whole head, and over blocks
//    where the (sample, head) items are fewer than half the grid, the
//    partials merged in order; rows read a float at a time where they are
//    not 16-byte aligned.
//  - Deterministic: every sum runs in a fixed order and no float atomic
//    is used, so two calls give the same bits. FMA contraction is allowed:
//    the contract with the plain version is a tolerance.
//
// Where the time goes: scripts/bench_decode_variants.py (a build that
// stamps every phase); the card's times: PERF.md.
//
// What the TPU shaped and this port drops: the 128-row DMA chunks (any T
// is taken), the token row padded to 8 rows, the 8-row write-back window
// (only row `pos` of K and V is written; every other row stays as it
// was), and the bias folded into the product through a ones column (the
// bias is added after the sum).
#include <mutex>

#include "attention_tc.cuh"

namespace {

using arcweld::attn_tc::MAX_HD;   // the widest head the attention takes
using arcweld::attn_tc::mma_tf32;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 16;           // a row tile: mma's m16
constexpr int NCOL = 8;            // weight rows (output columns) a chunk: n8
constexpr int MAX_KC = 512;        // a chunk's k extent, at most
constexpr int KBLOCKS = MAX_KC / (16 * WARPS);  // 16-column blocks a warp
constexpr int MAX_CG = 4;          // chunks of a column group: a block's
                                   // columns of a product are walked a
                                   // group at a time
constexpr int MAX_COLS = MAX_CG * NCOL;        // a column group's columns
constexpr int NBUF = 3;            // A tiles in flight
constexpr int MAX_BARS = 64;       // chunks (resident) or ring slots
constexpr int UNROLL = 16;         // keys a half warp has in flight
constexpr int N_PRODUCTS = 4;      // qkv, c_proj, c_fc, m_proj
constexpr int MAX_GRID = 1024;     // blocks; the barrier's counts follow
constexpr int MAX_C = 4096;        // the widest stream
constexpr int WIDE = 0;            // Attend's LPK for heads past MAX_HD

// shared memory: mbarriers (the ring's, then the A tiles') | weight ring |
// NBUF A tiles | partial sums | LN statistics | the attention's partial
// outputs and the half warps' max and sum
constexpr int TILE_FLOATS = ROWS * MAX_KC;
constexpr int RED_FLOATS = WARPS * MAX_CG * ROWS * NCOL;
constexpr int STAT_FLOATS = 2 * ROWS;
constexpr int ATT_FLOATS = 16 * 64 + 32;   // the widest need (Attend)
constexpr size_t SMEM = 232448;    // the most a block may have
// the ring and the tiles are copied to in 16-byte units
constexpr size_t BAR_BYTES = (8 * (MAX_BARS + NBUF) + 127) / 128 * 128;
constexpr size_t RING =
    (SMEM - BAR_BYTES -
     sizeof(float) * (NBUF * TILE_FLOATS + RED_FLOATS + STAT_FLOATS +
                      ATT_FLOATS)) / 128 * 128;

enum Epilogue { QKV, RESIDUAL, GELU };

}  // namespace

// The operands of one block, packed once by the wrapper (a ctypes
// Structure of the same layout in ops/fused_decode.py). The products'
// depths are padded with zeros to multiples of 64 (pad64: cp of C, c4p of
// c4; zeros add exact 0s to every sum): w_* are (n, k) with k padded,
// rows k apart, or, where `packed` is 1, packed by chunks and pieces,
// which only the general form reads (see its section); ln1_*, ln2_* hold cp
// floats, zero past C. The caches' element (b, h, t, e) is at b*sb +
// h*sh + t*st + e; scratch holds q (batch x C), y, x_mid (batch x cp
// each), g (batch x c4p), in the general form the wide attention's units
// (wide_unit_floats), then m_proj's partial sums (up to its pieces x
// batch x C), the columns past C (c4) zero; barrier is 2 + MAX_GRID
// words, the grid barrier's arrival count and generation, then m_proj's
// counts per column range (the wide attention's per item), all counts 0
// between launches. #12 leaves the MLP's pointers null and c4 0.
struct DecodeArgs {
  const float* ln1_s;
  const float* ln1_b;
  const float* w_qkv;
  const float* b_qkv;
  const float* w_proj;
  const float* b_proj;
  const float* ln2_s;
  const float* ln2_b;
  const float* w_fc;
  const float* b_fc;
  const float* w_mp;
  const float* b_mp;
  float* kc;
  float* vc;
  float* scratch;
  unsigned* barrier;
  long long sb, sh, st;
  int batch, t, c, c4, n_head;
  float sm_scale;
  int packed;       // the weights packed (the general form's layout)
};

namespace {
// n rounded up to a multiple of 64: a product's padded depth, and the
// row pitch of the activations it reads
__host__ __device__ inline int pad64(int n) { return (n + 63) / 64 * 64; }

// the largest multiple of 64 up to MAX_KC that divides cp and c4p
__host__ __device__ inline int chunk_k(int cp, int c4p) {
  for (int kc = MAX_KC; kc >= 64; kc -= 64)
    if (cp % kc == 0 && c4p % kc == 0) return kc;
  return 0;
}

// product p's output columns and (padded) input width
__host__ __device__ inline int cols_of(const DecodeArgs& a, int p) {
  return p == 0 ? 3 * a.c : p == 2 ? a.c4 : a.c;
}
__host__ __device__ inline int k_of(const DecodeArgs& a, int p) {
  return pad64(p == 3 ? a.c4 : a.c);
}

// One product's share in this block: columns [c0, c0 + ncol) of w (n,
// k), its k pieces q0 .. q0 + nq - 1 of kc, in chunks of up to 8 columns
// (ncg a piece, at most MAX_CG: the first form takes the shapes where a
// block's columns are one group). Resident: chunk (q, cg) has mbarrier
// cbase + q ncg + cg and its rows start at ring row rbase + q ncol + 8
// cg. Streaming: its use at row tile rt is the ring's use ubase + (rt nq
// + q) ncg + cg.
//
// m_proj (k = c4, four pieces at C = 512) is split over the grid by
// pieces where that fits: nsplit groups of blocks, one a piece, each
// group sharing C's columns out as the others do, so that a block reads
// one piece of g and not all of it; the group's blocks of a column range
// (grp) write partial sums, and the last of them to finish adds them in
// the pieces' order.
struct Product {
  const float* w;
  int k, c0, ncol, nq, ncg;
  int cbase, rbase, ubase;
  int q0, nsplit, grp;
};

// Product p of this block, its bases summed over the products before it.
// Every share is recomputed from the arguments where it is needed: a
// table of them indexed at run time would live in local memory, which
// goes to L2 when shared memory takes the SM's L1.
__device__ __forceinline__ Product product_of(const DecodeArgs& a, int p,
                                              int kc, int n_rt) {
  Product P{};
  int cbase = 0, rbase = 0, ubase = 0;
#pragma unroll
  for (int i = 0; i < N_PRODUCTS; ++i) {
    const int n = cols_of(a, i);           // n * gridDim.x < 2^31 (valid)
    const int nqt = k_of(a, i) / kc, grid = (int)gridDim.x;
    const int per = grid / max(nqt, 1), b = (int)blockIdx.x;
    int c0, ncol, nq = nqt, q0 = 0, nsplit = 1, grp = 0;
    if (i == 3 && nqt > 1 && per >= 1 && (n + per - 1) / per <= MAX_COLS) {
      nq = 1;
      nsplit = nqt;
      q0 = min(b / per, nqt - 1);
      grp = b % per;
      c0 = n * grp / per;
      ncol = b < per * nqt ? n * (grp + 1) / per - c0 : 0;
    } else {
      c0 = n * b / grid;
      ncol = n * (b + 1) / grid - c0;
    }
    const int ncg = (ncol + NCOL - 1) / NCOL;
    if (i == p)
      P = Product{i == 0 ? a.w_qkv : i == 1 ? a.w_proj : i == 2 ? a.w_fc
                                                                 : a.w_mp,
                  k_of(a, i), c0, ncol, nq, ncg, cbase, rbase, ubase,
                  q0, nsplit, grp};
    cbase += nq * ncg;
    rbase += nq * ncol;
    ubase += n_rt * nq * ncg;
  }
  return P;
}

struct Plan {
  int np;           // products: 2 (#12) or 4 (#13)
  int kc;           // chunk k extent, the row stride of ring and tiles
  int n_rt;         // row tiles
  bool resident;    // every chunk on chip at once
  int nslot;        // streaming: ring slots of NCOL rows
  int total;        // chunks (resident) or chunk uses (streaming)
};

__device__ __forceinline__ Plan make_plan(const DecodeArgs& a, bool mlp) {
  Plan pl;
  pl.np = mlp ? 4 : 2;
  pl.kc = chunk_k(pad64(a.c), mlp ? pad64(a.c4) : 0);
  pl.n_rt = (a.batch + ROWS - 1) / ROWS;
  // the bases of a product past the last are the totals (#12's MLP
  // products have no k pieces: c4 is 0)
  const Product end = product_of(a, N_PRODUCTS - 1, pl.kc, pl.n_rt);
  const int chunks = end.cbase + end.nq * end.ncg;
  const int rows = end.rbase + end.nq * end.ncol;
  const int uses = end.ubase + pl.n_rt * end.nq * end.ncg;
  pl.resident = (size_t)rows * pl.kc * sizeof(float) <= RING &&
                chunks <= MAX_BARS;
  const int fit = (int)(RING / (sizeof(float) * NCOL * pl.kc));
  pl.nslot = fit < MAX_BARS ? fit : MAX_BARS;
  pl.total = pl.resident ? chunks : uses;
  return pl;
}

// Where chunk i of product P lands (i counted from the product's first:
// resident, i = q ncg + cg; streaming, the product's use as above): its
// columns, k piece, mbarrier, parity and first ring row.
struct Chunk {
  int col0, rows, q, bar, row0;
  uint32_t parity;
};

// (the first form takes one column group a product, ncg <= MAX_CG)
__device__ __forceinline__ Chunk locate(const Plan& pl, const Product& P,
                                        int i) {
  Chunk ch;
  const int in_rt = i % (P.nq * P.ncg);
  const int cg = in_rt % P.ncg;
  ch.q = in_rt / P.ncg;
  ch.col0 = P.c0 + NCOL * cg;
  ch.rows = min(NCOL, P.ncol - NCOL * cg);
  if (pl.resident) {
    ch.bar = P.cbase + i;
    ch.parity = 0;
    ch.row0 = P.rbase + ch.q * P.ncol + NCOL * cg;
  } else {
    const int u = P.ubase + i;
    ch.bar = u % pl.nslot;
    ch.parity = (uint32_t)((u / pl.nslot) & 1);
    ch.row0 = ch.bar * NCOL;
  }
  return ch;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

__device__ __forceinline__ void expect_bytes(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// `bytes` (a multiple of 16) from global to shared memory, counted on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// A warp issues the chunks [from, to) of the plan, counted over all
// products in order, whose number is `mine` modulo `warps`: per chunk
// lane 0 arms its mbarrier with the bytes to come, then lane r copies
// weight row r.
__device__ void issue(const Plan& pl, const DecodeArgs& a, float* ring,
                      uint64_t* bars, int from, int to, int mine = 0,
                      int warps = 1) {
  const int lane = threadIdx.x % 32;
  const uint32_t bytes = (uint32_t)(pl.kc * sizeof(float));
  // the ring's slots were last read through the generic proxy
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  int first = 0;
#pragma unroll
  for (int p = 0; p < N_PRODUCTS; ++p) {
    if (p >= pl.np) break;
    const Product P = product_of(a, p, pl.kc, pl.n_rt);
    const int n = P.nq * P.ncg * (pl.resident ? 1 : pl.n_rt);
    for (int i = max(from, first); i < min(to, first + n); ++i) {
      if (i % warps != mine) continue;
      const Chunk ch = locate(pl, P, i - first);
      const uint32_t bar = smem_u32(&bars[ch.bar]);
      float* dst = ring + (size_t)ch.row0 * pl.kc;
      const float* src =
          P.w + (size_t)ch.col0 * P.k + (size_t)(P.q0 + ch.q) * pl.kc;
      if (P.k == pl.kc) {          // the rows are one range
        if (lane == 0) {
          expect_bytes(bar, bytes * ch.rows);
          bulk_copy(dst, src, bytes * ch.rows, bar);
        }
        continue;
      }
      if (lane == 0) expect_bytes(bar, bytes * ch.rows);
      __syncwarp();
      if (lane < ch.rows)
        bulk_copy(dst + (size_t)lane * pl.kc, src + (size_t)lane * P.k,
                  bytes, bar);
    }
    first += n;
  }
}

// Warp 0 copies rows [row0, row0 + 16) of a (batch, k), columns [k0, k0 +
// kc), into an A tile (rows kc floats apart), counted on bar; rows
// past batch are not copied. The rows were written by other blocks
// before a grid barrier, through the generic proxy.
__device__ void issue_tile(const Plan& pl, const float* a, int k, int row0,
                           int k0, int batch, float* tile, uint32_t bar) {
  const int lane = threadIdx.x % 32;
  const int rows = min(ROWS, batch - row0);
  const uint32_t bytes = (uint32_t)(pl.kc * sizeof(float));
  asm volatile("fence.proxy.async.global;" ::: "memory");
  if (k == pl.kc) {                // the rows are one range
    if (lane == 0) {
      expect_bytes(bar, bytes * rows);
      bulk_copy(tile, a + (size_t)row0 * k, bytes * rows, bar);
    }
    return;
  }
  if (lane == 0) expect_bytes(bar, bytes * rows);
  __syncwarp();
  if (lane < rows)
    bulk_copy(tile + (size_t)lane * pl.kc, a + (size_t)(row0 + lane) * k + k0,
              bytes, bar);
}

// All blocks of the grid meet here; writes before it are visible to
// every block after it. bar[0] counts arrivals: atom.inc wraps it to 0
// at the last one, which then advances the generation bar[1] that the
// others wait on. The count is 0 again after every barrier.
__device__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned gen;
    asm volatile("ld.relaxed.gpu.u32 %0, [%1];"
                 : "=r"(gen)
                 : "l"(bar + 1)
                 : "memory");
    // arrive, releasing this block's writes (bar.sync gathered them at
    // thread 0) and, at the last arrival, acquiring every block's
    unsigned old;
    asm volatile("atom.acq_rel.gpu.inc.u32 %0, [%1], %2;"
                 : "=r"(old)
                 : "l"(bar), "r"(gridDim.x - 1)
                 : "memory");
    if (old == gridDim.x - 1) {
      asm volatile("st.release.gpu.u32 [%0], %1;" ::"l"(bar + 1),
                   "r"(gen + 1)
                   : "memory");
    } else {
      unsigned now;
      do {
        asm volatile("ld.acquire.gpu.u32 %0, [%1];"
                     : "=r"(now)
                     : "l"(bar + 1)
                     : "memory");
      } while (now == gen);
    }
  }
  __syncthreads();
}

// A row's float4s are walked by lane L at L + 32 i, in order; the last
// may reach past k into the row's zero padding (the rows are pad64
// wide), which adds exact 0s to the mean, and (0 - mean)^2 to the sum of
// squares for each of its pad = 4 ceil(k / 4) - k columns, taken off
// after the lanes' sums are added (none where k is a multiple of 4).
__device__ __forceinline__ float row_var(float q, float mean, int k) {
  const int pad = (k + 3) / 4 * 4 - k;
  return (arcweld::warp_sum(q) - (float)pad * mean * mean) / (float)k;
}

// mean and 1 / sqrt(variance + eps) of rows [row0, row0 + 16) of a
// (batch, k), rows ld floats apart, rows w and w + 8 in warp w, read from
// L2 twice (the mean, then the squares), any k up to MAX_C; rows past
// batch are left out
__device__ void row_stats(const float* a, int ld, int row0, int batch, int k,
                          float* stats) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k4 = (k + 3) / 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = min(row0 + warp + 8 * h, batch - 1);
    const float4* src = reinterpret_cast<const float4*>(a + (size_t)row * ld);
    float s = 0.0f;
    for (int i = lane; i < k4; i += 32) {
      const float4 v = __ldcg(src + i);
      s += (v.x + v.y) + (v.z + v.w);
    }
    const float mean = arcweld::warp_sum(s) / (float)k;
    float q = 0.0f;
    for (int i = lane; i < k4; i += 32) {
      const float4 v = __ldcg(src + i);
      const float dx = v.x - mean, dy = v.y - mean, dz = v.z - mean,
                  dw = v.w - mean;
      q += (dx * dx + dy * dy) + (dz * dz + dw * dw);
    }
    const float var = row_var(q, mean, k);
    if (lane == 0) {
      stats[warp + 8 * h] = mean;
      stats[ROWS + warp + 8 * h] = 1.0f / sqrtf(var + 1e-5f);
    }
  }
}

// The same from an A tile holding the rows whole (ld = kc floats apart in
// shared memory, k <= kc), where the row tile's copy is all the product
// reads of them
__device__ void tile_stats(const float* tile, int row0, int batch, int ld,
                           int k, float* stats) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k4 = (k + 3) / 4;
  constexpr int VEC = MAX_KC / 128;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp + 8 * h;
    const float4* src = reinterpret_cast<const float4*>(tile + r * ld);
    float4 v[VEC];
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      v[i] = lane + 32 * i < k4 ? src[lane + 32 * i]
                                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      s += (v[i].x + v[i].y) + (v[i].z + v[i].w);
    }
    const float mean = arcweld::warp_sum(s) / (float)k;
    float q = 0.0f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      if (lane + 32 * i < k4) {
        const float dx = v[i].x - mean, dy = v[i].y - mean,
                    dz = v[i].z - mean, dw = v[i].w - mean;
        q += (dx * dx + dy * dy) + (dz * dz + dw * dw);
      }
    }
    const float var = row_var(q, mean, k);
    if (lane == 0 && row0 + r < batch) {
      stats[r] = mean;
      stats[ROWS + r] = 1.0f / sqrtf(var + 1e-5f);
    }
  }
}

// x split for a split-TF32 product: hi is x rounded to TF32's 10
// mantissa bits (half away from zero), lo = x - hi exactly; the tensor
// core reads the top 19 bits of each
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

#ifdef DECODE_PHASE_TIMES
// %globaltimer at a block's start and after each phase and barrier: a
// build for scripts/bench_decode_variants.py; the library leaves it out
constexpr int STAMPS = 11;
__device__ unsigned long long phase_ns[1024][STAMPS];
__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void stamp(int i) {
  if (threadIdx.x == 0 && blockIdx.x < 1024) phase_ns[blockIdx.x][i] = now_ns();
}
#else
__device__ __forceinline__ void stamp(int) {}
#endif

// The A tiles in order: tile t of the kernel is buffer t % NBUF
// (TILE_FLOATS apart in buf), parity (t / NBUF) % 2. Every thread counts
// them alike.
struct Tiles {
  float* buf;
  uint64_t* bars;      // the buffers' mbarriers

  __device__ float* at(int t) const { return buf + t % NBUF * TILE_FLOATS; }
  __device__ uint32_t bar(int t) const {
    return smem_u32(&bars[t % NBUF]);
  }
  __device__ void wait(int t) const {
    mbar_wait(bar(t), (uint32_t)((t / NBUF) & 1));
  }
};

// where the sequences of A tiles and of streamed chunks stand
struct Cursor {
  int tile;            // the next A tile's number
  int issued;          // chunks warp 0 has issued (streaming refills)
};

// One product of the block, out[row, col] = epilogue(sum_i A[row, i]
// w[col, i] + bias[col]) for every row and this block's columns:
//   A = a (batch, k), or LayerNorm(a) * ln_s + ln_b with LN;
//   QKV: columns < C to q (batch, C), the next C to row pos of the K
//        cache, the last C to row pos of the V cache;
//   RESIDUAL: out (batch, n) = resid + (sum + bias);
//   GELU: out (batch, n) = new_gelu(sum + bias).
// The product's first A tile was issued by the caller (`first_issued`)
// or is issued here; each tile's successor is issued before the tile is
// read. The epilogue's operands are loaded before the products. Returns
// the cursor after the product.
// HW: the head width the QKV epilogue writes the caches at, 0 for
// a.c / a.n_head read at run time.
template <Epilogue EPI, bool LN, int HW>
__device__ Cursor product(const Plan& pl, const DecodeArgs& a, int p,
                          const float* A, const float* ln_s,
                          const float* ln_b, const float* bias,
                          const float* resid, float* out, int pos,
                          float* ring, uint64_t* bars, Tiles tiles,
                          Cursor cur, bool first_issued, float* red,
                          float* stats, float* partial = nullptr) {
  const Product P = product_of(a, p, pl.kc, pl.n_rt);
  if (P.ncol == 0) {
    if (first_issued) {           // nobody reads it: let it land
      tiles.wait(cur.tile++);
      __syncthreads();
    }
    return cur;
  }
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  const int kw = pl.kc / WARPS;      // a warp's slice of a k piece
  // its 16-column blocks; where kw is an odd multiple of 8, the second
  // half of the last one is the next warp's, and tg 2, 3 take zeros there
  const int nkb = (kw + 15) / 16;
  const bool half = kw % 16 != 0 && tg >= 2;
  const int n = cols_of(a, p);
  // the rows' pitch of the stream (x, y, x_mid, the residuals) and of out
  const int cp = a.c;
  const int ldo = EPI == QKV ? a.c : EPI == GELU ? a.c4 : cp;
  constexpr int OUTS = MAX_CG * ROWS * NCOL / THREADS;   // a thread's
  // the product's tiles: lt = rt nq + q, the kernel's t0 + lt; the
  // first NBUF - 1 now, each later one while the tile NBUF - 1 before it
  // is read
  const int n_tiles = pl.n_rt * P.nq, t0 = cur.tile;
  if (warp == 0) {
    for (int lt = first_issued ? 1 : 0; lt < min(NBUF - 1, n_tiles); ++lt)
      issue_tile(pl, A, P.k, lt / P.nq % pl.n_rt * ROWS,
                 (P.q0 + lt % P.nq) * pl.kc, a.batch, tiles.at(t0 + lt),
                 tiles.bar(t0 + lt));
  }
  cur.tile = t0 + n_tiles;
  const int gn = P.ncg;
  for (int rt = 0; rt < pl.n_rt; ++rt) {
    const int row0 = rt * ROWS, lt0 = rt * P.nq;
    // the epilogue's bias and residual of this thread's outputs
    float eb[OUTS], er[OUTS];
#pragma unroll
    for (int o = 0; o < OUTS; ++o) {
      const int idx = tid + o * THREADS;
      const int row = min(row0 + idx / NCOL % ROWS, a.batch - 1);
      const int col =
          P.c0 + min(idx / NCOL / ROWS * NCOL + idx % NCOL,
                     P.ncol - 1);
      eb[o] = __ldg(bias + col);
      er[o] = 0.0f;
      if constexpr (EPI == RESIDUAL)
        er[o] = __ldcg(resid + (size_t)row * cp + col);
    }
    if (LN && P.nq > 1) {          // rows wider than a tile: from L2
      row_stats(A, P.k, row0, a.batch, a.c, stats);
      __syncthreads();
    }
    float acc[MAX_CG][2][4];
#pragma unroll
    for (int cg = 0; cg < MAX_CG; ++cg)
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[cg][i / 4][i % 4] = 0.0f;
    for (int q = 0; q < P.nq; ++q) {
      const int t = t0 + lt0 + q;
      // the tile NBUF - 1 ahead, into the buffer whose last reader
      // finished before the barrier that ended the previous piece
      const int j = lt0 + q + NBUF - 1;
      if (j < n_tiles && warp == 0)
        issue_tile(pl, A, P.k, j / P.nq % pl.n_rt * ROWS,
                   (P.q0 + j % P.nq) * pl.kc, a.batch, tiles.at(t0 + j),
                   tiles.bar(t0 + j));
      // this warp's k slice of the tile, as mma's A fragments: in each
      // 16-column block, thread tg's columns 4 tg .. 4 tg + 3 are its
      // fragment columns tg, tg + 4 of step 2 m (the first two) and of
      // step 2 m + 1; rows g and g + 8; LayerNorm applied, rows past
      // batch zero
      float4 av[KBLOCKS][2];
      const int kb = warp * kw + 4 * tg;
      {
        float4 lw[KBLOCKS], lb[KBLOCKS];
        if constexpr (LN) {
#pragma unroll
          for (int m = 0; m < KBLOCKS; ++m) {
            const int col = min((P.q0 + q) * pl.kc + kb +
                                    16 * min(m, nkb - 1), P.k - 4);
            lw[m] = __ldg(reinterpret_cast<const float4*>(ln_s + col));
            lb[m] = __ldg(reinterpret_cast<const float4*>(ln_b + col));
          }
        }
        tiles.wait(t);
        const float* tile = tiles.at(t);
        if (LN && P.nq == 1) {       // the tile holds the rows whole
          tile_stats(tile, row0, a.batch, pl.kc, a.c, stats);
          __syncthreads();
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = g + 8 * h;
          const bool live = row0 + r < a.batch;
          float mean = 0.0f, rstd = 0.0f;
          if constexpr (LN) {
            mean = stats[r];
            rstd = stats[ROWS + r];
          }
#pragma unroll
          for (int m = 0; m < KBLOCKS; ++m) {
            if (m < nkb) {
              float4 v = *reinterpret_cast<const float4*>(
                  tile + r * pl.kc + kb + 16 * m);
              if constexpr (LN) {
                v.x = (v.x - mean) * rstd * lw[m].x + lb[m].x;
                v.y = (v.y - mean) * rstd * lw[m].y + lb[m].y;
                v.z = (v.z - mean) * rstd * lw[m].z + lb[m].z;
                v.w = (v.w - mean) * rstd * lw[m].w + lb[m].w;
              }
              av[m][h] = live && !(half && m == nkb - 1)
                             ? v
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            }
          }
        }
      }
      // the piece's chunks of this group, each warp's row of them
      // (columns past a chunk's rows read its first row; their sums are
      // dropped)
      const float* wr[MAX_CG];
#pragma unroll
      for (int cg = 0; cg < MAX_CG; ++cg) {
        wr[cg] = ring;
        if (cg < gn) {
          const Chunk ch = locate(
              pl, P,
              pl.resident ? q * P.ncg + cg : (rt * P.nq + q) * gn + cg);
          mbar_wait(smem_u32(&bars[ch.bar]), ch.parity);
          wr[cg] = ring +
                   (size_t)(ch.row0 + (g < ch.rows ? g : 0)) * pl.kc + kb;
        }
      }
      // the chunks' products interleaved, two accumulators a chunk (one
      // per k8 step of a 16-column block), so that the tensor core's
      // dependent chains are short
#pragma unroll
      for (int m = 0; m < KBLOCKS; ++m) {
        if (m < nkb) {
          const float4 r0 = av[m][0], r8 = av[m][1];
          uint32_t ah[2][4], al[2][4];
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            split(s ? r0.z : r0.x, ah[s][0], al[s][0]);
            split(s ? r8.z : r8.x, ah[s][1], al[s][1]);
            split(s ? r0.w : r0.y, ah[s][2], al[s][2]);
            split(s ? r8.w : r8.y, ah[s][3], al[s][3]);
          }
#pragma unroll
          for (int cg = 0; cg < MAX_CG; ++cg) {
            if (cg < gn) {
              float4 w4 =
                  *reinterpret_cast<const float4*>(wr[cg] + 16 * m);
              if (half && m == nkb - 1)
                w4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
              for (int s = 0; s < 2; ++s) {
                uint32_t bh0, bl0, bh1, bl1;
                split(s ? w4.z : w4.x, bh0, bl0);
                split(s ? w4.w : w4.y, bh1, bl1);
                mma_tf32(acc[cg][s], al[s], bh0, bh1);
                mma_tf32(acc[cg][s], ah[s], bl0, bl1);
                mma_tf32(acc[cg][s], ah[s], bh0, bh1);
              }
            }
          }
        }
      }
      // every warp is done with this tile and this piece's ring slots
      __syncthreads();
      if (!pl.resident) {
        const int done =
            P.ubase + (rt * P.nq + q + 1) * gn;
        const int to = min(pl.total, done + pl.nslot);
        if (warp == 0 && to > cur.issued)
          issue(pl, a, ring, bars, cur.issued, to);
        cur.issued = max(cur.issued, to);
      }
    }
    // the warps' partial sums, added in a fixed order
#pragma unroll
    for (int cg = 0; cg < MAX_CG; ++cg) {
      if (cg < gn) {
        float* r = red + (warp * MAX_CG + cg) * ROWS * NCOL;
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = acc[cg][0][i] + acc[cg][1][i];
        r[g * NCOL + 2 * tg] = v[0];
        r[g * NCOL + 2 * tg + 1] = v[1];
        r[(g + 8) * NCOL + 2 * tg] = v[2];
        r[(g + 8) * NCOL + 2 * tg + 1] = v[3];
      }
    }
    __syncthreads();
#pragma unroll
    for (int o = 0; o < OUTS; ++o) {
      const int idx = tid + o * THREADS;
      const int cg = idx / (ROWS * NCOL), r = idx / NCOL % ROWS,
                cc = idx % NCOL;
      const int row = row0 + r, j = NCOL * cg + cc;
      if (cg >= gn || row >= a.batch || j >= P.ncol) continue;
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w)
        sum += red[(w * MAX_CG + cg) * ROWS * NCOL + r * NCOL + cc];
      const int col = P.c0 + j;
      const float y = sum + eb[o];
      if constexpr (EPI == QKV) {
        if (col < a.c) {
          out[(size_t)row * ldo + col] = y;
        } else {
          const int cc2 = (col - a.c) % a.c, hd = HW ? HW : a.c / a.n_head;
          float* dst = col < 2 * a.c ? a.kc : a.vc;
          dst[row * a.sb + (cc2 / hd) * a.sh + pos * a.st + cc2 % hd] = y;
        }
      } else if constexpr (EPI == RESIDUAL) {
        if (P.nsplit > 1)             // this piece's share, no bias
          partial[((size_t)P.q0 * a.batch + row) * n + col] = sum;
        else
          out[(size_t)row * ldo + col] = er[o] + y;
      } else {
        out[(size_t)row * ldo + col] = arcweld::new_gelu(y);
      }
    }
    __syncthreads();
  }
  if (P.nsplit > 1) {
    // the last block of the column range to finish adds the partial
    // sums, the pieces in order; it returns the range's count to 0
    unsigned* count = a.barrier + 2 + P.grp;
    int* last = reinterpret_cast<int*>(red);
    if (tid == 0) {
      __threadfence();
      const bool done = atomicAdd(count, 1u) == (unsigned)P.nsplit - 1;
      if (done) {
        atomicExch(count, 0u);
        __threadfence();
      }
      *last = done;
    }
    __syncthreads();
    if (*last) {
      for (int idx = tid; idx < a.batch * P.ncol; idx += THREADS) {
        const int row = idx / P.ncol, col = P.c0 + idx % P.ncol;
        float sum = 0.0f;
        for (int s = 0; s < P.nsplit; ++s)
          sum += __ldcg(partial + ((size_t)s * a.batch + row) * n + col);
        out[(size_t)row * ldo + col] =
            __ldcg(resid + (size_t)row * cp + col) + (sum + __ldg(bias + col));
      }
    }
  }
  return cur;
}
// ---------------------------------------------------------------------------
// The general form: any C up to MAX_C in any heads, any MLP width.
//
// Each product's depth k (pad64 of its input width) is walked in pieces
// of PIECE_K floats, the last one shorter (any multiple of 64): at C 1,800
// qkv, c_proj and c_fc take 4 pieces and m_proj 15. Where `packed`, the
// weights come packed by the wrapper in the order the kernel reads them
// (ops/fused_decode.py::_packed): for piece q, chunk j (output columns
// 8 j .. 8 j + 7) lies at 8 n8 PIECE_K q + 8 j kq floats, its 8 rows kq
// apart (kq the piece's extent, n8 the product's chunks), so that every
// ring slot, one chunk x one piece, is filled by one bulk copy of its
// rows (the rows past n, in the last chunk, are not copied). Else each
// of a chunk's rows is a copy of its own (one copy a chunk where the
// product has one piece), 3-8% slower (PERF.md). A block
// owns a run of whole chunks of every product (c0 a multiple of 8),
// walked in column groups of up to MAX_CG chunks. In a piece, warp w
// takes the 16-column blocks w, w + 8, w + 16, ... (a thread's 4 columns
// of each permuted as in the first form), so that only a short piece
// leaves warps without a block, never lanes; every warp adds its blocks
// in order over the pieces, and the warps' sums are added in order. The
// shares of the products are worked out once at the launch's start into
// a table in shared memory (gshares), so that the refills of the ring
// cost little. m_proj is split over the grid by ranges of its pieces
// where a block's columns then stay one group (mp_ranges): 2 ranges at C
// 1,800, 4 at 512; the last block of a column range to finish adds the
// ranges' partial sums in order.
// ---------------------------------------------------------------------------

// the general form's k piece (ops/fused_decode.py::PIECE packs the
// weights in the same pieces): 256 was 1.4x slower, 64 3.3-4.5x (PERF.md)
constexpr int PIECE_K = MAX_KC;
// a warp's 16-column blocks of a piece, at most
constexpr int GKB = (PIECE_K / 16 + WARPS - 1) / WARPS;
// the general form's A tiles in flight: a third one was no faster
// (scripts/bench_decode_variants.py); its room goes to the ring
constexpr int GNBUF = 2;
// Tiles' sequence over the general form's GNBUF buffers
struct GTiles {
  float* buf;
  uint64_t* bars;      // the buffers' mbarriers

  __device__ float* at(int t) const { return buf + t % GNBUF * TILE_FLOATS; }
  __device__ uint32_t bar(int t) const {
    return smem_u32(&bars[t % GNBUF]);
  }
  __device__ void wait(int t) const {
    mbar_wait(bar(t), (uint32_t)((t / GNBUF) & 1));
  }
};
// the keys a group of Attend has in flight in the general form (at 12 or
// 16 its registers spill)
constexpr int GUNROLL = 8;

__host__ __device__ inline int n_pieces(int k) {
  return (k + PIECE_K - 1) / PIECE_K;
}
__host__ __device__ inline int piece_k(int k, int q) {
  return min(PIECE_K, k - PIECE_K * q);
}

// the ranges of m_proj's pieces split over the grid: the most, up to its
// pieces, with which a block's share of the n8 chunks stays one column
// group; 1 where none does
__host__ __device__ inline int mp_ranges(int nqt, int n8, int grid) {
  for (int s = nqt; s >= 2; --s) {
    const int per = grid / s;
    if (per >= 1 && (n8 + per - 1) / per <= MAX_CG) return s;
  }
  return 1;
}

// One product's share in this block: chunks j0 .. j0 + ncg - 1 (columns
// [c0, c0 + ncol), c0 = 8 j0) of w, packed, its pieces q0 .. q0 + nq - 1
// of k. Resident: chunk (q, cg) has slot cbase + q ncg + cg. Streaming:
// its use at row tile rt in column group gi is the ring's use ubase + gi
// n_rt nq MAX_CG + (rt nq + q) gn + cgl (cg = MAX_CG gi + cgl, gn the
// group's chunks). m_proj split in nsplit ranges: this block's range s
// and its column range grp.
struct GProduct {
  const float* w;
  int k, n8, j0, c0, ncol, ncg, q0, nq;
  int cbase, ubase;
  int nsplit, s, grp;
};

struct GPlan {
  int np;           // products: 2 (#12) or 4 (#13)
  int ks;           // a ring slot's k extent (rows ks floats apart at most)
  int n_rt;         // row tiles
  bool resident;    // every chunk on chip at once
  int nslot;        // ring slots of NCOL rows x ks
  int total;        // chunks (resident) or chunk uses (streaming)
  bool packed;      // the weights packed, else in rows of k floats
};

// the general form's shared memory: mbarriers | the products' shares and
// the plan (worked out once by thread 0; read where used, so that they
// hold no registers over the phases) | weight ring | GNBUF A tiles |
// partial sums (Attend's partial outputs there too) | LN statistics
constexpr size_t SHARE_BYTES =
    (sizeof(GProduct) * N_PRODUCTS + sizeof(GPlan) + 127) / 128 * 128;
constexpr size_t GRING =
    (SMEM - BAR_BYTES - SHARE_BYTES -
     sizeof(float) * (GNBUF * TILE_FLOATS + RED_FLOATS + STAT_FLOATS)) /
    128 * 128;
static_assert(ATT_FLOATS <= RED_FLOATS, "Attend's floats in the sums' room");

// every product's share of this block, its bases summed over the
// products before it
__device__ void gshares(const DecodeArgs& a, int n_rt, GProduct* out) {
  int cbase = 0, ubase = 0;
  const int grid = (int)gridDim.x, b = (int)blockIdx.x;
  for (int i = 0; i < N_PRODUCTS; ++i) {
    GProduct P{};
    const int n = cols_of(a, i);
    P.w = i == 0 ? a.w_qkv : i == 1 ? a.w_proj : i == 2 ? a.w_fc : a.w_mp;
    P.k = k_of(a, i);
    P.n8 = (n + NCOL - 1) / NCOL;
    const int nqt = n_pieces(P.k);
    P.nsplit = i == 3 ? mp_ranges(nqt, P.n8, grid) : 1;
    int j1;
    P.q0 = 0;
    P.nq = nqt;
    if (P.nsplit > 1) {
      const int per = grid / P.nsplit;
      P.s = b / per;
      P.grp = b % per;
      if (P.s < P.nsplit) {
        P.j0 = P.n8 * P.grp / per;
        j1 = P.n8 * (P.grp + 1) / per;
        P.q0 = nqt * P.s / P.nsplit;
        P.nq = nqt * (P.s + 1) / P.nsplit - P.q0;
      } else {                           // past the ranges: idle
        P.j0 = j1 = 0;
      }
    } else {
      P.j0 = P.n8 * b / grid;
      j1 = P.n8 * (b + 1) / grid;
    }
    P.c0 = NCOL * P.j0;
    P.ncol = j1 > P.j0 ? min(NCOL * j1, n) - P.c0 : 0;
    P.ncg = P.ncol > 0 ? j1 - P.j0 : 0;
    P.cbase = cbase;
    P.ubase = ubase;
    cbase += P.nq * P.ncg;
    ubase += n_rt * P.nq * P.ncg;
    out[i] = P;
  }
}

__device__ GPlan gmake_plan(const DecodeArgs& a, bool mlp,
                            const GProduct* sh) {
  GPlan pl;
  pl.np = mlp ? 4 : 2;
  pl.n_rt = (a.batch + ROWS - 1) / ROWS;
  int kmax = 64;
  for (int p = 0; p < pl.np; ++p) kmax = max(kmax, sh[p].k);
  pl.ks = min(PIECE_K, kmax);
  const GProduct& end = sh[N_PRODUCTS - 1];   // #12: no chunks (c4 0)
  const int chunks = end.cbase + end.nq * end.ncg;
  const int uses = end.ubase + pl.n_rt * end.nq * end.ncg;
  const int fit = (int)(GRING / (sizeof(float) * NCOL * pl.ks));
  pl.nslot = fit < MAX_BARS ? fit : MAX_BARS;
  pl.resident = chunks <= pl.nslot;
  pl.total = pl.resident ? chunks : uses;
  pl.packed = a.packed != 0;
  return pl;
}

// Where chunk i of product P lands (resident: i = q ncg + cg; streaming:
// the product's use as above): its chunk, rows, piece, extent and slot
struct GChunk {
  int j, rows, q, kq, slot;
};

__device__ __forceinline__ GChunk glocate(const GPlan& pl, const GProduct& P,
                                          int i) {
  GChunk ch;
  int cg;
  if (pl.resident) {
    cg = i % P.ncg;
    ch.q = i / P.ncg;
    ch.slot = P.cbase + i;
  } else {
    const int per_g = pl.n_rt * P.nq * MAX_CG, gi = i / per_g;
    const int gn = min(MAX_CG, P.ncg - MAX_CG * gi), rem = i % per_g;
    cg = MAX_CG * gi + rem % gn;
    ch.q = rem / gn % P.nq;
    ch.slot = (P.ubase + i) % pl.nslot;
  }
  ch.j = P.j0 + cg;
  ch.rows = min(NCOL, P.ncol - NCOL * cg);
  ch.kq = piece_k(P.k, P.q0 + ch.q);
  return ch;
}

// A warp issues the chunks [from, to) of the plan, counted over all
// products in order, whose number is `mine` modulo `warps`: lane 0 arms
// the slot's mbarrier with the bytes to come and copies the chunk's rows
// in one bulk copy where they are one range (packed, or a product of one
// piece), else lane r copies row r
__device__ void gissue(const GPlan& pl, const GProduct* sh, float* ring,
                       uint64_t* bars, int from, int to, int mine = 0,
                       int warps = 1) {
  const int lane = threadIdx.x % 32;
  // the ring's slots were last read through the generic proxy
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  int first = 0;
  for (int p = 0; p < pl.np && first < to; ++p) {
    const GProduct& P = sh[p];
    const int n = P.nq * P.ncg * (pl.resident ? 1 : pl.n_rt);
    for (int i = max(from, first); i < min(to, first + n); ++i) {
      if (i % warps != mine) continue;
      const GChunk ch = glocate(pl, P, i - first);
      const uint32_t bar = smem_u32(&bars[ch.slot]);
      float* dst = ring + (size_t)ch.slot * NCOL * pl.ks;
      const size_t q = P.q0 + ch.q;
      const float* src =
          pl.packed ? P.w + NCOL * (P.n8 * PIECE_K * q + (size_t)ch.j * ch.kq)
                    : P.w + (size_t)NCOL * ch.j * P.k + PIECE_K * q;
      const uint32_t bytes = (uint32_t)(ch.kq * sizeof(float));
      if (pl.packed || ch.kq == P.k) {
        if (lane == 0) {
          expect_bytes(bar, bytes * ch.rows);
          bulk_copy(dst, src, bytes * ch.rows, bar);
        }
        continue;
      }
      if (lane == 0) expect_bytes(bar, bytes * ch.rows);
      __syncwarp();
      if (lane < ch.rows)
        bulk_copy(dst + (size_t)lane * ch.kq, src + (size_t)lane * P.k, bytes,
                  bar);
    }
    first += n;
  }
}

// Warp 0 copies rows [row0, row0 + 16) of a (batch, k), piece q, into an
// A tile (rows kq floats apart), counted on bar; rows past batch are not
// copied. One copy where the piece is the whole row. The rows were
// written by other blocks before a grid barrier, through the generic
// proxy: warp 0 fences the async proxy once after it (gproduct).
__device__ void gissue_tile(const float* a, int k, int row0, int q, int batch,
                            float* tile, uint32_t bar) {
  const int lane = threadIdx.x % 32;
  const int rows = min(ROWS, batch - row0), kq = piece_k(k, q);
  const uint32_t bytes = (uint32_t)(kq * sizeof(float));
  if (k == kq) {
    if (lane == 0) {
      expect_bytes(bar, bytes * rows);
      bulk_copy(tile, a + (size_t)row0 * k, bytes * rows, bar);
    }
    return;
  }
  if (lane == 0) expect_bytes(bar, bytes * rows);
  __syncwarp();
  if (lane < rows)
    bulk_copy(tile + (size_t)lane * kq,
              a + (size_t)(row0 + lane) * k + (size_t)PIECE_K * q, bytes,
              bar);
}

// The general form's product: the function of product() above, its k in
// pieces of PIECE_K (see the section's note). The rows' pitch of the
// stream (x, y, x_mid, the residuals) is pad64(C), of g pad64(c4).
template <Epilogue EPI, bool LN, int HW>
__device__ Cursor gproduct(const GPlan& pl, const GProduct* sh,
                           const DecodeArgs& a, int p, const float* A,
                           const float* ln_s, const float* ln_b,
                           const float* bias, const float* resid, float* out,
                           int pos, float* ring, uint64_t* bars,
                           GTiles tiles, Cursor cur, bool first_issued,
                           float* red, float* stats,
                           float* partial = nullptr) {
  const GProduct& P = sh[p];     // read from shared memory where used
  if (P.ncol == 0) {
    if (first_issued) {           // nobody reads it: let it land
      tiles.wait(cur.tile++);
      __syncthreads();
    }
    return cur;
  }
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  const int n = cols_of(a, p);
  const int cp = pad64(a.c), c4p = pad64(a.c4);
  const int ldo = EPI == QKV ? a.c : EPI == GELU ? c4p : cp;
  constexpr int OUTS = MAX_CG * ROWS * NCOL / THREADS;   // a thread's
  const int ngr = (P.ncg + MAX_CG - 1) / MAX_CG;          // column groups
  const int per_g = pl.n_rt * P.nq * MAX_CG;   // a group's streamed uses
  // the product's tiles: lt = (gi n_rt + rt) nq + q, the kernel's t0 +
  // lt; the first GNBUF - 1 now, each later one while the tile GNBUF - 1
  // before it is read
  const int n_tiles = ngr * pl.n_rt * P.nq, t0 = cur.tile;
  if (warp == 0) {
    // A was written before the last grid barrier (x: before the launch)
    asm volatile("fence.proxy.async.global;" ::: "memory");
    for (int lt = first_issued ? 1 : 0; lt < min(GNBUF - 1, n_tiles); ++lt)
      gissue_tile(A, P.k, lt / P.nq % pl.n_rt * ROWS, P.q0 + lt % P.nq,
                  a.batch, tiles.at(t0 + lt), tiles.bar(t0 + lt));
  }
  cur.tile = t0 + n_tiles;
  for (int gi = 0; gi < ngr; ++gi) {
    const int cg0 = MAX_CG * gi, gn = min(MAX_CG, P.ncg - cg0);
    for (int rt = 0; rt < pl.n_rt; ++rt) {
      const int row0 = rt * ROWS, lt0 = (gi * pl.n_rt + rt) * P.nq;
      // the epilogue's bias and residual of this thread's outputs
      float eb[OUTS], er[OUTS];
#pragma unroll
      for (int o = 0; o < OUTS; ++o) {
        const int idx = tid + o * THREADS;
        const int row = min(row0 + idx / NCOL % ROWS, a.batch - 1);
        const int col =
            P.c0 + min(NCOL * cg0 + idx / NCOL / ROWS * NCOL + idx % NCOL,
                       P.ncol - 1);
        eb[o] = __ldg(bias + col);
        er[o] = 0.0f;
        if constexpr (EPI == RESIDUAL)
          er[o] = __ldcg(resid + (size_t)row * cp + col);
      }
      // rows wider than a piece: the statistics from L2, once a product
      // where it has one row tile (they stay in `stats`)
      if (LN && P.nq > 1 && (gi == 0 || pl.n_rt > 1)) {
        row_stats(A, P.k, row0, a.batch, a.c, stats);
        __syncthreads();
      }
      float acc[MAX_CG][2][4];
#pragma unroll
      for (int cg = 0; cg < MAX_CG; ++cg)
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[cg][i / 4][i % 4] = 0.0f;
      for (int q = 0; q < P.nq; ++q) {
        const int t = t0 + lt0 + q, kq = piece_k(P.k, P.q0 + q);
        // the tile GNBUF - 1 ahead, into the buffer whose last reader
        // finished before the barrier that ended the previous piece
        const int jt = lt0 + q + GNBUF - 1;
        if (jt < n_tiles && warp == 0)
          gissue_tile(A, P.k, jt / P.nq % pl.n_rt * ROWS, P.q0 + jt % P.nq,
                      a.batch, tiles.at(t0 + jt), tiles.bar(t0 + jt));
        // this warp's 16-column blocks of the piece, w + 8 m, as mma's A
        // fragments (thread tg's columns 4 tg .. 4 tg + 3 of a block are
        // its fragment columns tg, tg + 4 of two k8 steps); rows g and g
        // + 8; LayerNorm applied, rows past batch zero
        const int nkb = min(GKB, (kq / 16 - warp + WARPS - 1) / WARPS);
        float4 av[GKB][2];
        {
          float4 lw[GKB], lb[GKB];
          if constexpr (LN) {
#pragma unroll
            for (int m = 0; m < GKB; ++m) {
              if (m < nkb) {
                const int col =
                    PIECE_K * (P.q0 + q) + 16 * (warp + WARPS * m) + 4 * tg;
                lw[m] = __ldg(reinterpret_cast<const float4*>(ln_s + col));
                lb[m] = __ldg(reinterpret_cast<const float4*>(ln_b + col));
              }
            }
          }
          tiles.wait(t);
          const float* tile = tiles.at(t);
          if (LN && P.nq == 1) {       // the tile holds the rows whole
            tile_stats(tile, row0, a.batch, kq, a.c, stats);
            __syncthreads();
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = g + 8 * h;
            const bool live = row0 + r < a.batch;
            float mean = 0.0f, rstd = 0.0f;
            if constexpr (LN) {
              mean = stats[r];
              rstd = stats[ROWS + r];
            }
#pragma unroll
            for (int m = 0; m < GKB; ++m) {
              if (m < nkb) {
                float4 v = *reinterpret_cast<const float4*>(
                    tile + r * kq + 16 * (warp + WARPS * m) + 4 * tg);
                if constexpr (LN) {
                  v.x = (v.x - mean) * rstd * lw[m].x + lb[m].x;
                  v.y = (v.y - mean) * rstd * lw[m].y + lb[m].y;
                  v.z = (v.z - mean) * rstd * lw[m].z + lb[m].z;
                  v.w = (v.w - mean) * rstd * lw[m].w + lb[m].w;
                }
                av[m][h] = live ? v : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
              }
            }
          }
        }
        // the piece's chunks of this group, each warp's row of them
        // (columns past a chunk's rows read its first row; their sums are
        // dropped): their slots follow glocate's order, use u0 + cg
        const int u0 = pl.resident
                           ? P.cbase + q * P.ncg + cg0
                           : P.ubase + gi * per_g + (rt * P.nq + q) * gn;
        const float* wr[MAX_CG];
#pragma unroll
        for (int cg = 0; cg < MAX_CG; ++cg) {
          wr[cg] = ring;
          if (cg < gn) {
            const int u = u0 + cg;
            const int slot = pl.resident ? u : u % pl.nslot;
            mbar_wait(smem_u32(&bars[slot]),
                      pl.resident ? 0u : (uint32_t)((u / pl.nslot) & 1));
            const int rows = min(NCOL, P.ncol - NCOL * (cg0 + cg));
            wr[cg] = ring + (size_t)slot * NCOL * pl.ks +
                     (g < rows ? g : 0) * kq + 16 * warp + 4 * tg;
          }
        }
        // the chunks' products interleaved, two accumulators a chunk (one
        // per k8 step of a 16-column block)
#pragma unroll
        for (int m = 0; m < GKB; ++m) {
          if (m < nkb) {
            const float4 r0 = av[m][0], r8 = av[m][1];
            uint32_t ah[2][4], al[2][4];
#pragma unroll
            for (int s = 0; s < 2; ++s) {
              split(s ? r0.z : r0.x, ah[s][0], al[s][0]);
              split(s ? r8.z : r8.x, ah[s][1], al[s][1]);
              split(s ? r0.w : r0.y, ah[s][2], al[s][2]);
              split(s ? r8.w : r8.y, ah[s][3], al[s][3]);
            }
#pragma unroll
            for (int cg = 0; cg < MAX_CG; ++cg) {
              if (cg < gn) {
                const float4 w4 = *reinterpret_cast<const float4*>(
                    wr[cg] + 16 * WARPS * m);
#pragma unroll
                for (int s = 0; s < 2; ++s) {
                  uint32_t bh0, bl0, bh1, bl1;
                  split(s ? w4.z : w4.x, bh0, bl0);
                  split(s ? w4.w : w4.y, bh1, bl1);
                  mma_tf32(acc[cg][s], al[s], bh0, bh1);
                  mma_tf32(acc[cg][s], ah[s], bl0, bl1);
                  mma_tf32(acc[cg][s], ah[s], bh0, bh1);
                }
              }
            }
          }
        }
        // every warp is done with this tile and this piece's ring slots
        __syncthreads();
        if (!pl.resident) {
          const int done = P.ubase + gi * per_g + (rt * P.nq + q + 1) * gn;
          const int to = min(pl.total, done + pl.nslot);
          if (warp == 0 && to > cur.issued)
            gissue(pl, sh, ring, bars, cur.issued, to);
          cur.issued = max(cur.issued, to);
        }
      }
      // the warps' partial sums, added in a fixed order
#pragma unroll
      for (int cg = 0; cg < MAX_CG; ++cg) {
        if (cg < gn) {
          float* r = red + (warp * MAX_CG + cg) * ROWS * NCOL;
          float v[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) v[i] = acc[cg][0][i] + acc[cg][1][i];
          r[g * NCOL + 2 * tg] = v[0];
          r[g * NCOL + 2 * tg + 1] = v[1];
          r[(g + 8) * NCOL + 2 * tg] = v[2];
          r[(g + 8) * NCOL + 2 * tg + 1] = v[3];
        }
      }
      __syncthreads();
#pragma unroll
      for (int o = 0; o < OUTS; ++o) {
        const int idx = tid + o * THREADS;
        const int cg = idx / (ROWS * NCOL), r = idx / NCOL % ROWS,
                  cc = idx % NCOL;
        const int row = row0 + r, j = NCOL * (cg0 + cg) + cc;
        if (cg >= gn || row >= a.batch || j >= P.ncol) continue;
        float sum = 0.0f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w)
          sum += red[(w * MAX_CG + cg) * ROWS * NCOL + r * NCOL + cc];
        const int col = P.c0 + j;
        const float y = sum + eb[o];
        if constexpr (EPI == QKV) {
          if (col < a.c) {
            out[(size_t)row * ldo + col] = y;
          } else {
            const int cc2 = (col - a.c) % a.c, hd = HW ? HW : a.c / a.n_head;
            float* dst = col < 2 * a.c ? a.kc : a.vc;
            dst[row * a.sb + (cc2 / hd) * a.sh + pos * a.st + cc2 % hd] = y;
          }
        } else if constexpr (EPI == RESIDUAL) {
          if (P.nsplit > 1)             // this range's share, no bias
            partial[((size_t)P.s * a.batch + row) * n + col] = sum;
          else
            out[(size_t)row * ldo + col] = er[o] + y;
        } else {
          out[(size_t)row * ldo + col] = arcweld::new_gelu(y);
        }
      }
      __syncthreads();
    }
  }
  if (P.nsplit > 1) {
    // the last block of the column range to finish adds the partial
    // sums, the ranges in order; it returns the range's count to 0
    unsigned* count = a.barrier + 2 + P.grp;
    int* last = reinterpret_cast<int*>(red);
    if (tid == 0) {
      __threadfence();
      const bool done = atomicAdd(count, 1u) == (unsigned)P.nsplit - 1;
      if (done) {
        atomicExch(count, 0u);
        __threadfence();
      }
      *last = done;
    }
    __syncthreads();
    if (*last) {
      for (int idx = tid; idx < a.batch * P.ncol; idx += THREADS) {
        const int row = idx / P.ncol, col = P.c0 + idx % P.ncol;
        float sum = 0.0f;
        for (int s = 0; s < P.nsplit; ++s)
          sum += __ldcg(partial + ((size_t)s * a.batch + row) * n + col);
        out[(size_t)row * ldo + col] =
            __ldcg(resid + (size_t)row * cp + col) + (sum + __ldg(bias + col));
      }
    }
    __syncthreads();
  }
  return cur;
}
// The attention's split of a head over lanes: LPK lanes a key, a float4
// of the head each (LPK = 16: heads up to 64 wide, 32: up to 128), NG =
// THREADS / LPK keys in flight a round of the block. PAD: the real head
// width hd = C / n_head is below 4 LPK (any hd, so the rows are read a
// float at a time and the lanes past hd hold zeros); without it hd is 4
// LPK = 64, the bench model's head, read as float4s.
template <int LPK, bool PAD>
struct Attend {
  static constexpr int NG = THREADS / LPK;
  static constexpr int HDP = 4 * LPK;
  static_assert(NG * HDP + 2 * NG <= ATT_FLOATS, "the attention's floats");
};

// floats e .. e + 3 of a row at p, zero from hd on
__device__ __forceinline__ float4 ld_head4(const float* p, int e, int hd) {
  return make_float4(e < hd ? __ldcg(p) : 0.0f,
                     e + 1 < hd ? __ldcg(p + 1) : 0.0f,
                     e + 2 < hd ? __ldcg(p + 2) : 0.0f,
                     e + 3 < hd ? __ldcg(p + 3) : 0.0f);
}

// A group's keys j0 + NG u + kg (u < UN) of a (sample, head): their K
// and V rows, zero past key n - 1 and at key `skip`
template <int UN>
struct KeysN {
  float4 k[UN], v[UN];
};
using Keys = KeysN<UNROLL>;

template <int LPK, bool PAD, int UN = UNROLL>
__device__ __forceinline__ void load_keys(const DecodeArgs& a, int item,
                                          int j0, int n, int skip,
                                          KeysN<UN>& r) {
  constexpr int NG = Attend<LPK, PAD>::NG;
  const int hw = threadIdx.x / LPK, l = threadIdx.x % LPK;
  const int hd = PAD ? a.c / a.n_head : 4 * LPK;
  const long long base = (item / a.n_head) * a.sb +
                         (item % a.n_head) * a.sh + 4 * l;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int u = 0; u < UN; ++u) {
    const int j = j0 + NG * u + hw;
    const long long at = base + (long long)j * a.st;
    const bool ok = j < n && j != skip;
    if (PAD) {
      r.k[u] = ok ? ld_head4(a.kc + at, 4 * l, hd) : zero;
      r.v[u] = ok ? ld_head4(a.vc + at, 4 * l, hd) : zero;
    } else {
      r.k[u] = ok ? __ldcg(reinterpret_cast<const float4*>(a.kc + at)) : zero;
      r.v[u] = ok ? __ldcg(reinterpret_cast<const float4*>(a.vc + at)) : zero;
    }
  }
}

// y[b, h*hd ..] = softmax(q . K[:pos+1]^T * sm_scale) V[:pos+1] for the
// (sample, head) pairs blockIdx.x, + gridDim.x, ...; a group of LPK
// lanes takes a key, a float4 of its hd floats a lane, and loads UN
// keys' K and V rows at once (q after the first of them). r comes
// holding the first round of keys of the block's first pair but row
// pos, loaded before the grid barrier that makes row pos and q visible.
// Each group keeps its keys' softmax online (a running max, the sum and
// P@V rescaled when the max grows), and the NG groups are merged in a
// fixed order at the end. q (batch, C), y (batch, ldy). UN: the keys a
// group has in flight (the general form's fewer, its registers being
// wanted elsewhere).
template <int LPK, bool PAD, int UN = UNROLL>
__device__ void attention(const DecodeArgs& a, int pos, const float* q,
                          float* y, int ldy, float* part, float* ml,
                          KeysN<UN>& r) {
  constexpr int NG = Attend<LPK, PAD>::NG, HDP = Attend<LPK, PAD>::HDP;
  const int tid = threadIdx.x, hw = tid / LPK, l = tid % LPK;
  const int hd = PAD ? a.c / a.n_head : HDP;
  const int n = pos + 1;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int item = blockIdx.x; item < a.batch * a.n_head;
       item += gridDim.x) {
    const int b = item / a.n_head, h = item % a.n_head;
    float4 qv = zero;
    float m = -INFINITY, sum = 0.0f;
    float4 acc = zero;
    // every thread walks the same steps: the shuffles need all lanes
    for (int j0 = 0; j0 < n; j0 += NG * UN) {
      if (item != blockIdx.x || j0 > 0) {
        load_keys<LPK, PAD, UN>(a, item, j0, n, -1, r);
      } else if (pos < NG * UN) {              // row pos joins the first
        const long long at = b * a.sb + h * a.sh + 4 * l +
                             (long long)pos * a.st;
#pragma unroll
        for (int u = 0; u < UN; ++u) {
          if (NG * u + hw == pos) {
            if (PAD) {
              r.k[u] = ld_head4(a.kc + at, 4 * l, hd);
              r.v[u] = ld_head4(a.vc + at, 4 * l, hd);
            } else {
              r.k[u] = __ldcg(reinterpret_cast<const float4*>(a.kc + at));
              r.v[u] = __ldcg(reinterpret_cast<const float4*>(a.vc + at));
            }
          }
        }
      }
      if (j0 == 0)
        qv = PAD ? ld_head4(q + (size_t)b * a.c + h * hd + 4 * l, 4 * l, hd)
                 : __ldcg(reinterpret_cast<const float4*>(
                              q + (size_t)b * a.c + h * HDP) + l);
    float s[UN];
      float m_new = m;
#pragma unroll
      for (int u = 0; u < UN; ++u) {
        float d = qv.x * r.k[u].x + qv.y * r.k[u].y + qv.z * r.k[u].z +
                  qv.w * r.k[u].w;
#pragma unroll
        for (int o = LPK / 2; o > 0; o >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, o);
        s[u] = j0 + NG * u + hw < n ? d * a.sm_scale : -INFINITY;
        m_new = fmaxf(m_new, s[u]);
      }
      if (m_new == -INFINITY) continue;      // none of this group's
      const float alpha = expf(m - m_new);   // 0 while m is -inf
      sum *= alpha;
      acc.x *= alpha;
      acc.y *= alpha;
      acc.z *= alpha;
      acc.w *= alpha;
#pragma unroll
      for (int u = 0; u < UN; ++u) {
        const float pj = expf(s[u] - m_new);
        sum += pj;
        acc.x += pj * r.v[u].x;
        acc.y += pj * r.v[u].y;
        acc.z += pj * r.v[u].z;
        acc.w += pj * r.v[u].w;
      }
      m = m_new;
    }
    *reinterpret_cast<float4*>(part + hw * HDP + 4 * l) = acc;
    if (l == 0) {
      ml[hw] = m;
      ml[NG + hw] = sum;
    }
    __syncthreads();
    if (tid < hd) {
      float mx = ml[0];
#pragma unroll
      for (int i = 1; i < NG; ++i) mx = fmaxf(mx, ml[i]);
      float o = 0.0f, den = 0.0f;
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        const float w = expf(ml[i] - mx);      // 0 for a group of no key
        o += w * part[i * HDP + tid];
        den += w * ml[NG + i];
      }
      y[(size_t)b * ldy + h * hd + tid] = o / den;
    }
    __syncthreads();
  }
}
// floats e .. e + 3 of a row at p + e, zero from hd on: one float4 load
// where vec (the rows 16-byte aligned and hd a multiple of 4), else a
// float at a time
__device__ __forceinline__ float4 ld4(const float* p, int e, int hd,
                                      bool vec) {
  if (!vec) return ld_head4(p + e, e, hd);
  return e < hd ? __ldcg(reinterpret_cast<const float4*>(p + e))
                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// The attention for heads wider than MAX_HD (the general form), the same
// function as attention() above, its keys spread over warps and, where
// the (sample, head) items are fewer than half the grid, over blocks:
//
//  - An item's keys 0..pos go in wide_ranges() key ranges, range r the
//    keys [n r / R, n (r + 1) / R); a block takes the units (item, range)
//    blockIdx.x, + gridDim.x, ... (R = 1 where the items fill the grid).
//  - In a unit, warp w takes its keys w, w + 8, w + 16, ... in order, two
//    at a time (WIDE_U), each score formed by the warp over the whole
//    head (lane L the float4s at columns 4 L + 128 i, in order of i,
//    then a butterfly), and keeps its own online softmax: a running max
//    m, the sum l and P@V o rescaled when the max grows, o a float4 of
//    every 128 columns a lane. Heads past WIDE_PASS = 512 columns take o
//    in passes of WIDE_PASS (the registers of more would spill), the
//    scores kept in shared memory from the first pass where the unit has
//    up to WIDE_KEYS keys (else formed again).
//  - The warps' (m, l, o) are merged in order through shared memory: M =
//    the largest m, o = sum_w exp(m_w - M) o_w, l likewise. With one range
//    y = o / l; else the unit writes (M, l, o) to the scratch, and the
//    last block of the item to finish (a count per item in the barrier's
//    words, returned to 0) merges the ranges in order the same way.
//
// Every sum runs in a fixed order. sm: the A tiles' room; part: the
// scratch's units, hd + 2 floats each.
constexpr int WIDE_PASS = 512;            // columns of o a pass
constexpr int WIDE_V4 = WIDE_PASS / 128;  // its float4s a lane
constexpr int WIDE_U = 2;                 // keys a warp takes at once
constexpr int WIDE_KEYS = 1024;           // scores kept over the passes
constexpr int MAX_RANGES = 16;            // key ranges of an item, at most
constexpr int MIN_RANGE_KEYS = 16;        // keys of a range, at least
static_assert(MAX_C + WIDE_KEYS + WARPS * WIDE_PASS + 2 * WARPS + 1 <=
                  GNBUF * TILE_FLOATS,
              "the wide attention's floats in the A tiles' room");

// the key ranges of each of `items` (sample, head) items over keys 0..n-1
__host__ __device__ inline int wide_ranges(int items, int n, int grid) {
  int r = min(MAX_RANGES, grid / max(items, 1));
  r = min(r, n / MIN_RANGE_KEYS);
  return max(r, 1);
}

// the floats of the wide attention's units in the scratch: (M, l, o) of
// every unit, where the items may be split (fewer than the largest grid)
__host__ __device__ inline size_t wide_unit_floats(int batch, int n_head,
                                                   int c) {
  const int hd = c / n_head, items = batch * n_head;
  if (hd <= MAX_HD || items >= MAX_GRID) return 0;
  return (size_t)min(items * MAX_RANGES, MAX_GRID) * (hd + 2);
}

__device__ void attention_wide(const DecodeArgs& a, int pos, const float* q,
                               float* y, float* sm, float* part) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int hd = a.c / a.n_head, n = pos + 1, items = a.batch * a.n_head;
  const int ranges = wide_ranges(items, n, (int)gridDim.x);
  const int npass = (hd + WIDE_PASS - 1) / WIDE_PASS, ldy = pad64(a.c);
  const bool vec = hd % 4 == 0 && (a.sb | a.sh | a.st) % 4 == 0;
  float* qs = sm;                           // q, zero to a multiple of 128
  float* sc = qs + MAX_C;                   // the unit's scores
  float* ow = sc + WIDE_KEYS;               // the warps' o of a pass
  float* ml = ow + WARPS * WIDE_PASS;       // their m, then their l
  int* last = reinterpret_cast<int*>(ml + 2 * WARPS);
  for (int unit = blockIdx.x; unit < items * ranges; unit += gridDim.x) {
    const int item = unit / ranges, r = unit % ranges;
    const int b = item / a.n_head, h = item % a.n_head;
    const int k0 = n * r / ranges, nk = n * (r + 1) / ranges - k0;
    const bool kept = nk <= WIDE_KEYS;
    const float* qrow = q + (size_t)b * a.c + h * hd;
    for (int e = tid; e < (hd + 127) / 128 * 128; e += THREADS)
      qs[e] = e < hd ? __ldcg(qrow + e) : 0.0f;
    const long long base = b * a.sb + h * a.sh + k0 * a.st;
    float* pu = part + (size_t)unit * (hd + 2);
    __syncthreads();
    for (int p = 0; p < npass; ++p) {
      const int e0 = WIDE_PASS * p;
      float m = -INFINITY, l = 0.0f;
      float4 o[WIDE_V4];
#pragma unroll
      for (int i = 0; i < WIDE_V4; ++i)
        o[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      // every lane of a warp walks the same keys: the shuffles need all
      for (int jj = warp; jj < nk; jj += WARPS * WIDE_U) {
        // the keys' V rows of the pass, loaded before their scores, so
        // that their reads overlap the K rows'
        float4 vv[WIDE_U][WIDE_V4];
#pragma unroll
        for (int u = 0; u < WIDE_U; ++u) {
          const int j = jj + WARPS * u;
          const float* vr = a.vc + base + (long long)j * a.st;
#pragma unroll
          for (int i = 0; i < WIDE_V4; ++i) {
            const int e = e0 + 4 * lane + 128 * i;
            vv[u][i] = j < nk && e < hd
                           ? ld4(vr, e, hd, vec)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          }
        }
        float s[WIDE_U];
        if (p > 0 && kept) {
#pragma unroll
          for (int u = 0; u < WIDE_U; ++u) {
            const int j = jj + WARPS * u;
            s[u] = j < nk ? sc[j] : -INFINITY;
          }
        } else {
          float d[WIDE_U];
#pragma unroll
          for (int u = 0; u < WIDE_U; ++u) d[u] = 0.0f;
#pragma unroll 2
          for (int e = 4 * lane; e < hd; e += 128) {
            const float4 qv = *reinterpret_cast<const float4*>(qs + e);
#pragma unroll
            for (int u = 0; u < WIDE_U; ++u) {
              const int j = jj + WARPS * u;
              if (j < nk) {
                const float4 kv =
                    ld4(a.kc + base + (long long)j * a.st, e, hd, vec);
                d[u] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z +
                        qv.w * kv.w;
              }
            }
          }
#pragma unroll
          for (int u = 0; u < WIDE_U; ++u) {
            const int j = jj + WARPS * u;
            const float sj = arcweld::warp_sum(d[u]) * a.sm_scale;
            s[u] = j < nk ? sj : -INFINITY;
            if (kept && lane == 0 && j < nk) sc[j] = sj;
          }
        }
        float m_new = m;
#pragma unroll
        for (int u = 0; u < WIDE_U; ++u) m_new = fmaxf(m_new, s[u]);
        const float alpha = expf(m - m_new);     // 0 while m is -inf
        l *= alpha;
#pragma unroll
        for (int i = 0; i < WIDE_V4; ++i) {
          o[i].x *= alpha;
          o[i].y *= alpha;
          o[i].z *= alpha;
          o[i].w *= alpha;
        }
#pragma unroll
        for (int u = 0; u < WIDE_U; ++u) {
          const int j = jj + WARPS * u;
          if (j >= nk) continue;
          const float pj = expf(s[u] - m_new);
          l += pj;
#pragma unroll
          for (int i = 0; i < WIDE_V4; ++i) {
            o[i].x += pj * vv[u][i].x;
            o[i].y += pj * vv[u][i].y;
            o[i].z += pj * vv[u][i].z;
            o[i].w += pj * vv[u][i].w;
          }
        }
        m = m_new;
      }
      // the warps merged in order
#pragma unroll
      for (int i = 0; i < WIDE_V4; ++i)
        *reinterpret_cast<float4*>(ow + warp * WIDE_PASS + 4 * lane +
                                   128 * i) = o[i];
      if (lane == 0) {
        ml[warp] = m;
        ml[WARPS + warp] = l;
      }
      __syncthreads();
      float mx = ml[0];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) mx = fmaxf(mx, ml[w]);
      float wt[WARPS], lv = 0.0f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        wt[w] = expf(ml[w] - mx);              // 0 for a warp of no key
        lv += wt[w] * ml[WARPS + w];
      }
      for (int c = tid; c < min(WIDE_PASS, hd - e0); c += THREADS) {
        float ov = 0.0f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) ov += wt[w] * ow[w * WIDE_PASS + c];
        if (ranges == 1)
          y[(size_t)b * ldy + h * hd + e0 + c] = ov / lv;
        else
          pu[2 + e0 + c] = ov;
      }
      if (ranges > 1 && tid == 0) {
        pu[0] = mx;
        pu[1] = lv;
      }
      __syncthreads();      // ow and ml are read before the next pass's
    }
    if (ranges > 1) {
      // the last block of the item to finish merges its ranges in order
      // and returns the item's count to 0
      if (tid == 0) {
        unsigned* count = a.barrier + 2 + item;
        __threadfence();
        const bool done = atomicAdd(count, 1u) == (unsigned)ranges - 1;
        if (done) {
          atomicExch(count, 0u);
          __threadfence();
        }
        *last = done;
      }
      __syncthreads();
      if (*last) {
        const float* pi = part + (size_t)item * ranges * (hd + 2);
        float mx = __ldcg(pi);
        for (int i = 1; i < ranges; ++i)
          mx = fmaxf(mx, __ldcg(pi + (size_t)i * (hd + 2)));
        float lv = 0.0f;
        for (int i = 0; i < ranges; ++i) {
          const float* pr = pi + (size_t)i * (hd + 2);
          lv += expf(__ldcg(pr) - mx) * __ldcg(pr + 1);
        }
        for (int c = tid; c < hd; c += THREADS) {
          float ov = 0.0f;
          for (int i = 0; i < ranges; ++i) {
            const float* pr = pi + (size_t)i * (hd + 2);
            ov += expf(__ldcg(pr) - mx) * __ldcg(pr + 2 + c);
          }
          y[(size_t)b * ldy + h * hd + c] = ov / lv;
        }
      }
      __syncthreads();      // `last` is read before the next unit's
    }
  }
  // sm lies in the A tiles' buffers, which TMA fills next
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
// LPK, PAD: the attention's split (Attend); the head width 64 runs at
// <16, false>. The first form: the code of the shapes it took before the
// general form (C and c4 multiples of 64, heads up to MAX_HD, a
// product's columns one group a block), which keep its bits and its
// time: it compiles to the instructions it did before the general form
// was split out of it (decode_general).
template <bool MLP, int LPK, bool PAD>
__global__ void __launch_bounds__(THREADS, 1)
decode_kernel(const DecodeArgs a, const float* __restrict__ x,
              float* __restrict__ out, int pos) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* ring = reinterpret_cast<float*>(smem + BAR_BYTES);
  float* tile_buf = reinterpret_cast<float*>(smem + BAR_BYTES + RING);
  float* red = tile_buf + NBUF * TILE_FLOATS;
  float* stats = red + RED_FLOATS;
  float* part = stats + STAT_FLOATS;

  // the scratch: q (batch, C), y and x_mid (batch, C), g (batch, c4),
  // then m_proj's partial sums
  const int cp = a.c;
  const size_t bcp = (size_t)a.batch * cp;
  float* q = a.scratch;
  float* y = q + (size_t)a.batch * a.c;
  float* x_mid = MLP ? y + bcp : out;
  float* g = y + 2 * bcp;

  const Plan pl = make_plan(a, MLP);
  const Tiles tiles{tile_buf, bars + MAX_BARS};
  if (threadIdx.x == 0) {
    const int n_bars = pl.resident ? pl.total : pl.nslot;
    for (int i = 0; i < n_bars; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       smem_u32(&bars[i]))
                   : "memory");
    for (int i = 0; i < NBUF; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       tiles.bar(i))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  stamp(0);
  // x's first tile, then every weight the block's share can hold (the
  // ring's first fill where it cannot), the warps sharing the copies: a
  // copy holds the issuing warp about as long as its bytes take to come,
  // so when the weights are issued moves time between the phases but
  // not the launch's (scripts/bench_decode_variants.py)
  Cursor cur{0, pl.resident ? pl.total : min(pl.total, pl.nslot)};
  if (threadIdx.x < 32)
    issue_tile(pl, x, cp, 0, 0, a.batch, tiles.at(0), tiles.bar(0));
  issue(pl, a, ring, bars, 0, cur.issued, threadIdx.x / 32, WARPS);
  stamp(1);

  cur = product<QKV, true, PAD ? 0 : 4 * LPK>(
      pl, a, 0, x, a.ln1_s, a.ln1_b, a.b_qkv, nullptr, q, pos, ring, bars,
      tiles, cur, true, red, stats);
  // the attention's first keys (all but row pos, which the qkv product
  // has just written) fly over the barrier
  Keys keys;
  if ((int)blockIdx.x < a.batch * a.n_head)
    load_keys<LPK, PAD>(a, blockIdx.x, 0, pos + 1, pos, keys);
  stamp(2);
  grid_sync(a.barrier);
  stamp(3);
  attention<LPK, PAD>(a, pos, q, y, cp, part,
                      part + Attend<LPK, PAD>::NG * Attend<LPK, PAD>::HDP,
                      keys);
  stamp(4);
  grid_sync(a.barrier);
  stamp(5);
  cur = product<RESIDUAL, false, 64>(
      pl, a, 1, y, nullptr, nullptr, a.b_proj, x, x_mid, pos, ring, bars,
      tiles, cur, false, red, stats);
  stamp(6);
  if constexpr (MLP) {
    grid_sync(a.barrier);
    stamp(7);
    cur = product<GELU, true, 64>(
        pl, a, 2, x_mid, a.ln2_s, a.ln2_b, a.b_fc, nullptr, g, pos, ring,
        bars, tiles, cur, false, red, stats);
    stamp(8);
    grid_sync(a.barrier);
    stamp(9);
    product<RESIDUAL, false, 64>(
        pl, a, 3, g, nullptr, nullptr, a.b_mp, x_mid, out, pos, ring, bars,
        tiles, cur, false, red, stats, g + (size_t)a.batch * a.c4);
    stamp(10);
  }
}

// The general form (see its section): every shape the first form does not
// take, and packed weights; LPK, PAD as decode_kernel's, LPK WIDE for
// heads past MAX_HD (attention_wide).
template <bool MLP, int LPK, bool PAD>
__global__ void __launch_bounds__(THREADS, 1)
decode_general(const DecodeArgs a, const float* __restrict__ x,
               float* __restrict__ out, int pos) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  GProduct* shares = reinterpret_cast<GProduct*>(smem + BAR_BYTES);
  GPlan* plan = reinterpret_cast<GPlan*>(shares + N_PRODUCTS);
  float* ring =
      reinterpret_cast<float*>(smem + BAR_BYTES + SHARE_BYTES);
  float* tile_buf = ring + GRING / sizeof(float);
  float* red = tile_buf + GNBUF * TILE_FLOATS;
  float* stats = red + RED_FLOATS;

  // the scratch: q (batch, C), y and x_mid (batch, cp), g (batch,
  // c4p), the wide attention's units, then m_proj's partial sums
  const int cp = pad64(a.c), c4p = pad64(a.c4);
  const size_t bcp = (size_t)a.batch * cp;
  float* q = a.scratch;
  float* y = q + (size_t)a.batch * a.c;
  float* x_mid = MLP ? y + bcp : out;
  float* g = y + 2 * bcp;
  float* units = g + (size_t)a.batch * c4p;
  float* mp_part = units + wide_unit_floats(a.batch, a.n_head, a.c);

  if (threadIdx.x == 0) {
    gshares(a, (a.batch + ROWS - 1) / ROWS, shares);
    *plan = gmake_plan(a, MLP, shares);
  }
  __syncthreads();
  const GPlan& pl = *plan;
  const GTiles tiles{tile_buf, bars + MAX_BARS};
  if (threadIdx.x == 0) {
    const int n_bars = pl.resident ? pl.total : pl.nslot;
    for (int i = 0; i < n_bars; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       smem_u32(&bars[i]))
                   : "memory");
    for (int i = 0; i < GNBUF; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       tiles.bar(i))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  stamp(0);
  // x's first tile, then the ring's first fill, the warps sharing it
  Cursor cur{0, pl.resident ? pl.total : min(pl.total, pl.nslot)};
  if (threadIdx.x < 32) {
    asm volatile("fence.proxy.async.global;" ::: "memory");
    gissue_tile(x, cp, 0, 0, a.batch, tiles.at(0), tiles.bar(0));
  }
  gissue(pl, shares, ring, bars, 0, cur.issued, threadIdx.x / 32, WARPS);
  stamp(1);

  cur = gproduct<QKV, true, PAD ? 0 : 4 * LPK>(
      pl, shares, a, 0, x, a.ln1_s, a.ln1_b, a.b_qkv, nullptr, q, pos,
      ring, bars, tiles, cur, true, red, stats);
  if constexpr (LPK == WIDE) {
    stamp(2);
    grid_sync(a.barrier);
    stamp(3);
    attention_wide(a, pos, q, y, tile_buf, units);
  } else {
    // as the first form; Attend's partial outputs in the sums' room
    KeysN<GUNROLL> keys;
    if ((int)blockIdx.x < a.batch * a.n_head)
      load_keys<LPK, PAD, GUNROLL>(a, blockIdx.x, 0, pos + 1, pos, keys);
    stamp(2);
    grid_sync(a.barrier);
    stamp(3);
    attention<LPK, PAD, GUNROLL>(
        a, pos, q, y, cp, red,
        red + Attend<LPK, PAD>::NG * Attend<LPK, PAD>::HDP, keys);
  }
  stamp(4);
  grid_sync(a.barrier);
  stamp(5);
  cur = gproduct<RESIDUAL, false, 64>(
      pl, shares, a, 1, y, nullptr, nullptr, a.b_proj, x, x_mid, pos, ring,
      bars, tiles, cur, false, red, stats);
  stamp(6);
  if constexpr (MLP) {
    grid_sync(a.barrier);
    stamp(7);
    cur = gproduct<GELU, true, 64>(
        pl, shares, a, 2, x_mid, a.ln2_s, a.ln2_b, a.b_fc, nullptr, g, pos,
        ring, bars, tiles, cur, false, red, stats);
    stamp(8);
    grid_sync(a.barrier);
    stamp(9);
    gproduct<RESIDUAL, false, 64>(
        pl, shares, a, 3, g, nullptr, nullptr, a.b_mp, x_mid, out, pos,
        ring, bars, tiles, cur, false, red, stats, mp_part);
    stamp(10);
  }
}

// the shapes the kernel takes: C from 1 to MAX_C in any heads, any c4
// up to 4 MAX_C (#13)
bool valid(const DecodeArgs& a, int pos, bool mlp, int grid) {
  if (a.batch < 1 || a.n_head < 1 || a.c < 1 || a.c > MAX_C ||
      a.c % a.n_head != 0 || pos < 0 || pos >= a.t || grid < 1 ||
      grid > MAX_GRID)
    return false;
  if (mlp ? a.c4 < 1 || a.c4 > 4 * MAX_C : a.c4 != 0) return false;
  for (int p = 0; p < (mlp ? 4 : 2); ++p)
    if ((long long)cols_of(a, p) * grid >= (1LL << 31)) return false;
  return true;
}

// whether the kernel's first form takes the shape: C and c4 multiples of
// 64, heads up to MAX_HD and one column group of every product a block;
// the general form takes every other, and packed weights
// (decode_general_form tells the wrapper which)
bool first_form(const DecodeArgs& a, bool mlp, int grid) {
  if (a.c % 64 != 0 || a.c4 % 64 != 0 || a.c / a.n_head > MAX_HD)
    return false;
  for (int p = 0; p < (mlp ? 4 : 2); ++p)
    if ((cols_of(a, p) + grid - 1) / grid > MAX_COLS) return false;
  return true;
}

// the kernels' grid on device dev: one block per SM
cudaError_t grid_on(int dev, int* grid) {
  return cudaDeviceGetAttribute(grid, cudaDevAttrMultiProcessorCount, dev);
}

// the kernel of a form: decode_kernel's first form, or decode_general
template <bool MLP, int LPK, bool PAD, bool GENERAL>
constexpr auto kernel_of() {
  if constexpr (GENERAL)
    return decode_general<MLP, LPK, PAD>;
  else
    return decode_kernel<MLP, LPK, PAD>;
}

// once per device and kernel: the shared memory attribute, and the grid
// (one block per SM, checked against the occupancy the card reports)
template <bool MLP, int LPK, bool PAD, bool GENERAL>
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
    err[dev] = grid_on(dev, &sms);
    if (err[dev] == cudaSuccess)
      err[dev] = cudaFuncSetAttribute(
          kernel_of<MLP, LPK, PAD, GENERAL>(),
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (err[dev] == cudaSuccess)
      err[dev] = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel_of<MLP, LPK, PAD, GENERAL>(), THREADS, SMEM);
    if (err[dev] == cudaSuccess && per_sm < 1)
      err[dev] = cudaErrorCooperativeLaunchTooLarge;
    blocks[dev] = sms;
  });
  *grid = blocks[dev];
  return err[dev];
}

template <bool MLP, int LPK, bool PAD, bool GENERAL>
int launch_form(const DecodeArgs* a, const void* x, void* out, int pos,
                void* stream) {
  int grid;
  cudaError_t e = grid_of<MLP, LPK, PAD, GENERAL>(&grid);
  if (e != cudaSuccess) return e;
  DecodeArgs args = *a;
  const float* xp = static_cast<const float*>(x);
  float* op = static_cast<float*>(out);
  void* params[] = {&args, &xp, &op, &pos};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel_of<MLP, LPK, PAD, GENERAL>()),
      dim3(grid), dim3(THREADS), params, SMEM,
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// the first form where it takes the shape and the weights are in rows,
// else the general one
template <bool MLP, int LPK, bool PAD>
int launch_at(const DecodeArgs* a, const void* x, void* out, int pos,
              void* stream) {
  int grid;
  cudaError_t e = grid_of<MLP, LPK, PAD, true>(&grid);
  if (e != cudaSuccess) return e;
  if (!valid(*a, pos, MLP, grid)) return cudaErrorInvalidValue;
  if constexpr (LPK != WIDE)
    if (!a->packed && first_form(*a, MLP, grid))
      return launch_form<MLP, LPK, PAD, false>(a, x, out, pos, stream);
  return launch_form<MLP, LPK, PAD, true>(a, x, out, pos, stream);
}

// the instantiation of the block's head width: 64 on <16, false>, up
// to 64 padded on 16 lanes a key, up to 128 on 32, wider on the block
// (attention_wide)
template <bool MLP>
int launch(const DecodeArgs* a, const void* x, void* out, int pos,
           void* stream) {
  if (a == nullptr || a->n_head < 1) return cudaErrorInvalidValue;
  const int hd = a->c / a->n_head;
  if (hd == 64) return launch_at<MLP, 16, false>(a, x, out, pos, stream);
  if (hd < 64) return launch_at<MLP, 16, true>(a, x, out, pos, stream);
  if (hd <= MAX_HD) return launch_at<MLP, 32, true>(a, x, out, pos, stream);
  return launch_at<MLP, WIDE, true>(a, x, out, pos, stream);
}

}  // namespace

// Kernel #12. x, out (batch, cp) f32, cp = pad64(C), zero past C; the
// caches (batch, n_head, t, hd), hd = C / n_head, row `pos` written in
// place; the scratch as ops/fused_decode.py::_scratch sizes it. One
// cooperative launch.
extern "C" int decode_attn_f32(const DecodeArgs* a, const void* x, void* out,
                               int pos, void* stream) {
  return launch<false>(a, x, out, pos, stream);
}

// Kernel #13. As #12 with the caches (batch, t, C) time-major, then the
// MLP.
extern "C" int block_decode_f32(const DecodeArgs* a, const void* x, void* out,
                                int pos, void* stream) {
  return launch<true>(a, x, out, pos, stream);
}

// 1 where the kernels (#13 where mlp, else #12) run the general form at
// a's C, c4 and heads on device dev, 0 where the first form; minus a CUDA
// error
extern "C" int decode_general_form(const DecodeArgs* a, int mlp, int dev) {
  if (a == nullptr || a->n_head < 1) return -(int)cudaErrorInvalidValue;
  int grid;
  const cudaError_t e = grid_on(dev, &grid);
  if (e != cudaSuccess) return -(int)e;
  return first_form(*a, mlp != 0, grid) ? 0 : 1;
}

#ifdef DECODE_PHASE_TIMES
// the last launch's stamps of the first `blocks` blocks, [block][stamp]
extern "C" int decode_phase_times(unsigned long long* host, int blocks) {
  return cudaMemcpyFromSymbol(host, phase_ns,
                              sizeof(unsigned long long) * STAMPS * blocks);
}
#endif
