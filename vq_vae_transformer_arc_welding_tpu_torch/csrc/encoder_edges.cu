// encoder_entry_f32 and encoder_exit_f32: the first and the last group
// of encoder resblocks with the ends of the encoder inside the kernel.
//
// Replace vq_vae_transformer_arc_welding_tpu/ops/pallas_encoder.py::
// fused_encoder_entry_eval (pallas_call at :404) and
// fused_encoder_exit_eval (pallas_call at :436).
//
//   entry: x = patches (N, P) @ w_pe (P, C) + b_pe, then the group's
//          resblocks -> (N, C) f32
//   exit:  the group's resblocks, z = x @ w_sep (C, D) + b_sep,
//          d = (sum z^2 + sum e^2) - 2 z.e over the (K, D) codebook,
//          the first index among the minima -> (N,) int32
//
// Both are the split-TF32 tile of encoder_tc.cuh (#1's, with its
// persistent walk of 64-row tiles and its TMA ring of W stages) with a
// prologue or an epilogue on each tile (`Entry`, `Exit`), so the
// patch-embed output, z and the (N, K) distances never reach device
// memory. What bounds them is #1's: the resblocks' TF32 products. The
// ends are plain FP32 FMAs on the consumer threads, under 2% of the
// work (per row 12.8 K FMAs for the patch-embed and 24.6 K for sep_conv
// with the distances at D = 32, K = 256, against 524 K a resblock).
//
// Shared memory is the tile's: the ring is not free during an end (the
// producer is already loading the next tile's stages into it), so the
// ends use the A tile. The entry stages the tile's BM x P patch values
// there, writes the patch-embed rows to `out` (block 0's residual
// source) and load_a then reads them back as A = gelu(x). The exit's
// last epilogue leaves x in A; its rows give z, and z and the codebook
// in chunks with their squared norms then take the A tile over
// (code_scan.cuh: any K, D up to 256). The exit's residual stream
// between its resblocks lives in an (N, C) buffer of its caller, as
// #1's output does.
//
// Exactness: every dot product of the ends is summed in index order
// with FMAs, the squared norms as rounded products added in index
// order, and d keeps the reference's order (zsq + esq) - 2 * cross.
// The scan keeps the first index among equal minima across lanes and
// chunks, as the reference's argmin (code_scan.cuh). No finite
// distance (a non-finite row) gives code 0.
//
// Both ends are __noinline__ and take scalars only: code inlined after
// the chain changes the register allocation of its products. So they
// find the A tile themselves (a_tile()), which keeps its loads and
// stores shared-memory ones, and read the operands through the read-only
// path (__ldg): behind a pointer argument either would be a generic
// access.
#include "code_scan.cuh"
#include "encoder_tc.cuh"

namespace {

using namespace arcweld::enc_tc;
using arcweld::gemm90::aligned;
namespace scan = arcweld::code_scan;

// patch-embed rows a thread computes in one pass (of its BM / RSTEP)
constexpr int EMBED_ROWS = 8;
static_assert(scan::ROWS == BM && scan::THREADS == CONSUMERS,
              "the exit's scan runs on the tile's rows and consumers");

// out[tile rows] = patches[tile rows] @ w_pe + b_pe, then a barrier of
// the consumers; out and w_pe rows of cw floats (as float4s where V4,
// encoder_tc.cuh::row4). The tile's BM x P patch
// values are staged in the A tile (zeros past n_rows); thread ct takes
// columns 4 (ct % TPR) .. + 3 of rows ct / TPR, + RSTEP, ..., the rows
// and columns it later loads as A (load_a), so it reads back only its
// own stores. k runs in index order; rows past n_rows and columns from
// cw on are not written.
template <int C, bool V4>
__device__ __noinline__ void embed_rows(const float* __restrict__ patches,
                                        const float* __restrict__ w_pe,
                                        const float* __restrict__ b_pe,
                                        float* __restrict__ out, int row0,
                                        int n_rows, int cw, int patch,
                                        int ct) {
  constexpr int TPR = Tile<C>::TPR, RSTEP = Tile<C>::RSTEP;
  static_assert(BM % (RSTEP * EMBED_ROWS) == 0, "a thread's rows");
  float* const a_s = a_tile<C>();
  const int staged = BM * patch;
  for (int i = ct; i < staged; i += CONSUMERS)
    a_s[i] = row0 + i / patch < n_rows
                 ? __ldg(patches + (size_t)row0 * patch + i) : 0.0f;
  named_sync(1, CONSUMERS);
  const int col = 4 * (ct % TPR);
  const float4 b = row4<V4>(b_pe, col, cw);
  for (int r = ct / TPR; r < BM; r += RSTEP * EMBED_ROWS) {
    float4 acc[EMBED_ROWS];
#pragma unroll
    for (int q = 0; q < EMBED_ROWS; ++q)
      acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < patch; ++k) {
      const float4 w = row4<V4>(w_pe + (size_t)k * cw, col, cw);
#pragma unroll
      for (int q = 0; q < EMBED_ROWS; ++q) {
        const float p = a_s[(r + RSTEP * q) * patch + k];
        acc[q].x = fmaf(p, w.x, acc[q].x);
        acc[q].y = fmaf(p, w.y, acc[q].y);
        acc[q].z = fmaf(p, w.z, acc[q].z);
        acc[q].w = fmaf(p, w.w, acc[q].w);
      }
    }
#pragma unroll
    for (int q = 0; q < EMBED_ROWS; ++q) {
      const int row = row0 + r + RSTEP * q;
      if (row < n_rows)
        put4<V4>(out + (size_t)row * cw, col, cw,
                 make_float4(acc[q].x + b.x, acc[q].y + b.y,
                             acc[q].z + b.z, acc[q].w + b.w));
    }
  }
  named_sync(1, CONSUMERS);  // the patches are read; load_a writes A
}

// z for D up to 64 (one slice): thread ct takes column ct % DP of rows
// ct / DP, + 256 / DP, ... and keeps them in registers until x in the A
// tile is consumed, then stores them (plus b_sep) in z_s (BM x DP).
// EXACT: d_emb == DP and cw a multiple of the chunk, so w_sep's rows are
// read at a compile-time stride with no bound to test.
template <int C, int DP, bool EXACT>
__device__ __forceinline__ void z_one_slice(const float* __restrict__ w_sep,
                                            const float* __restrict__ b_sep,
                                            float* z_s, int cw, int d_emb,
                                            int ct) {
  constexpr int RSTEP = CONSUMERS / DP;  // rows between a thread's z rows
  constexpr int NZ = BM / RSTEP;         // its z rows
  // k of w_sep a thread holds in registers, the next chunk's loads in
  // flight while it multiplies this one's
  constexpr int Z_CHUNK = 32;
  float* const a_s = a_tile<C>();
  const int dcol = ct % DP;
  const int r0 = ct / DP;
  // row r0 + i RSTEP of A at k: a_at's swizzle is r0's, flipped in
  // bit 4 for odd i where RSTEP is 4
  const float* const x0 = a_s + r0 * C;
  const int sw = (r0 & 7) << 2;
  const int stride = EXACT ? DP : d_emb;
  const bool live = EXACT || dcol < d_emb;
  float zacc[NZ];
#pragma unroll
  for (int i = 0; i < NZ; ++i) zacc[i] = 0.0f;
  // the chain's weights have swept w_sep out of L1, so its rows come
  // from L2: Z_CHUNK k of them in registers and the next chunk's loads
  // in flight behind the products (the last round reloads chunk 0,
  // unused); rows from cw on are zeros, as A's columns are
  float w[Z_CHUNK], wn[Z_CHUNK];
#pragma unroll
  for (int j = 0; j < Z_CHUNK; ++j)
    w[j] = EXACT || (live && j < cw) ? __ldg(w_sep + j * stride + dcol)
                                     : 0.0f;
  for (int k0 = 0; k0 < cw; k0 += Z_CHUNK) {
    const int kn = k0 + Z_CHUNK < cw ? k0 + Z_CHUNK : 0;
#pragma unroll
    for (int j = 0; j < Z_CHUNK; ++j)
      wn[j] = EXACT || (live && kn + j < cw)
                  ? __ldg(w_sep + (kn + j) * stride + dcol) : 0.0f;
#pragma unroll
    for (int kk = 0; kk < Z_CHUNK; kk += 4) {
      const int ke = k0 + (kk ^ sw), ko = k0 + (kk ^ sw ^ 16);
#pragma unroll
      for (int i = 0; i < NZ; ++i) {
        const int k = RSTEP % 8 == 0 || i % 2 == 0 ? ke : ko;
        const float4 xv = ld4(x0 + i * RSTEP * C + k);
        zacc[i] = fmaf(xv.x, w[kk], zacc[i]);
        zacc[i] = fmaf(xv.y, w[kk + 1], zacc[i]);
        zacc[i] = fmaf(xv.z, w[kk + 2], zacc[i]);
        zacc[i] = fmaf(xv.w, w[kk + 3], zacc[i]);
      }
    }
#pragma unroll
    for (int j = 0; j < Z_CHUNK; ++j) w[j] = wn[j];
  }
  named_sync(1, CONSUMERS);  // x in A is consumed
  const float bias = live ? __ldg(b_sep + dcol) : 0.0f;
#pragma unroll
  for (int i = 0; i < NZ; ++i)
    z_s[(r0 + i * RSTEP) * DP + dcol] = zacc[i] + bias;
}

// ids[tile rows] = the nearest code of x @ w_sep + b_sep, for the
// tile's rows x in the A tile (swizzled, a_at; zeros past n_rows), with
// a (K, D) codebook, w_sep (cw, D): z sums x's first cw columns (A is
// zero past them). D is padded to DP (code_scan::padded), a template
// constant, so that z's loops are unrolled and every shared address
// past a thread's first is an immediate offset: with D a runtime value
// the z loop ran several times slower on an H100.
// z in slices of DS = min(DP, 64) columns: thread ct takes column
// ct % DS of rows ct / DS, + 256 / DS, ... of each slice. Up to DP = 64
// (one slice) all its z values stay in registers until x is consumed,
// w_sep's rows double-buffered in registers. With more slices (DP 128
// and 256) z is made in four parts of the rows, each stored once every
// thread has read its x rows, 8 of K at a time and w_sep's rows not
// prefetched: the registers of 64 z values, or of a prefetch a slice,
// spilled. The A tile allows it where a z row (DP floats) is no longer
// than an x row (C): part h's z rows then land on x rows parts 0 .. h
// have consumed. z goes to the A tile's front (past the A tile at
// C = 128, DP = 256, in the rest of the exit's EXIT_FLOATS), and the
// codebook streams through what follows it (code_scan::scan_codes).
template <int C, int DP>
__device__ __forceinline__ void nearest_rows_d(
    const float* __restrict__ w_sep, const float* __restrict__ b_sep,
    const float* __restrict__ codebook, int* __restrict__ ids, int row0,
    int n_rows, int cw, int d_emb, int k_codes, int ct) {
  constexpr int DS = DP < 64 ? DP : 64;  // z columns a slice
  constexpr int S = DP / DS;             // slices
  constexpr int RSTEP = CONSUMERS / DS;  // rows between a thread's z rows
  constexpr int NZ = BM / RSTEP;         // its z rows a slice
  constexpr int Z_AT = DP <= C ? 0 : Tile<C>::A_FLOATS;   // z's place
  static_assert(NZ * RSTEP == BM && DP % 8 == 0, "z's rows");
  static_assert(Z_AT + BM * DP < EXIT_FLOATS, "z within the exit's tile");
  float* const a_s = a_tile<C>();
  float* const z_s = a_s + Z_AT;
  if constexpr (S == 1) {
    // the rows of w_sep as z's loop reads them: at D = DP and a width of
    // whole chunks (the bench model's) a compile-time stride and no
    // bound to test, as the loop had before it took other shapes
    if (d_emb == DP && cw % 32 == 0)
      z_one_slice<C, DP, true>(w_sep, b_sep, z_s, cw, d_emb, ct);
    else
      z_one_slice<C, DP, false>(w_sep, b_sep, z_s, cw, d_emb, ct);
  } else {
    constexpr int PARTS = 4;
    constexpr int NH = NZ / PARTS;       // a thread's z rows a part
    static_assert(RSTEP == 4 && NH * PARTS == NZ && NH % 2 == 0,
                  "a part keeps the swizzle");
    const int dcol = ct % DS;
    const int r0 = ct / DS;
    // row r0 + i RSTEP of A at k: a_at's swizzle is r0's, flipped in
    // bit 4 for odd i
    const float* const x0 = a_s + r0 * C;
    const int sw = (r0 & 7) << 2;
#pragma unroll 1
    for (int h = 0; h < PARTS; ++h) {
      const float* const xh = x0 + h * NH * RSTEP * C;
      float zacc[S][NH];
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int i = 0; i < NH; ++i) zacc[s][i] = 0.0f;
      for (int k0 = 0; k0 < cw; k0 += 8) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int col = s * DS + dcol;
          const bool live = col < d_emb;
          float w[8];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            w[j] = live && k0 + j < cw
                       ? __ldg(w_sep + (k0 + j) * d_emb + col) : 0.0f;
#pragma unroll
          for (int kk = 0; kk < 8; kk += 4) {
            const int ke = (k0 + kk) ^ sw, ko = ke ^ 16;
#pragma unroll
            for (int i = 0; i < NH; ++i) {
              const float4 xv = ld4(xh + i * RSTEP * C + (i % 2 ? ko : ke));
              zacc[s][i] = fmaf(xv.x, w[kk], zacc[s][i]);
              zacc[s][i] = fmaf(xv.y, w[kk + 1], zacc[s][i]);
              zacc[s][i] = fmaf(xv.z, w[kk + 2], zacc[s][i]);
              zacc[s][i] = fmaf(xv.w, w[kk + 3], zacc[s][i]);
            }
          }
        }
      }
      named_sync(1, CONSUMERS);  // this part's x rows are consumed
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int col = s * DS + dcol;
        const float bias = col < d_emb ? __ldg(b_sep + col) : 0.0f;
#pragma unroll
        for (int i = 0; i < NH; ++i)
          z_s[(r0 + (h * NH + i) * RSTEP) * DP + col] = zacc[s][i] + bias;
      }
    }
  }
  scan::scan_codes<DP>(z_s, z_s + BM * DP,
                       scan::chunk_codes(DP, EXIT_FLOATS - Z_AT), codebook,
                       ids, row0, n_rows, d_emb, k_codes, ct);
}

// nearest_rows_d for the exit's padded D: one call site in the tile's
// body
template <int C>
__device__ __noinline__ void nearest_rows(const float* __restrict__ w_sep,
                                          const float* __restrict__ b_sep,
                                          const float* __restrict__ codebook,
                                          int* __restrict__ ids, int row0,
                                          int n_rows, int cw, int d_emb,
                                          int k_codes, int ct) {
  switch (scan::padded(d_emb)) {  // d_emb 1 .. 256 (encoder_exit_f32)
    case 8:
      return nearest_rows_d<C, 8>(w_sep, b_sep, codebook, ids, row0, n_rows,
                                  cw, d_emb, k_codes, ct);
    case 16:
      return nearest_rows_d<C, 16>(w_sep, b_sep, codebook, ids, row0,
                                   n_rows, cw, d_emb, k_codes, ct);
    case 32:
      return nearest_rows_d<C, 32>(w_sep, b_sep, codebook, ids, row0,
                                   n_rows, cw, d_emb, k_codes, ct);
    case 64:
      return nearest_rows_d<C, 64>(w_sep, b_sep, codebook, ids, row0,
                                   n_rows, cw, d_emb, k_codes, ct);
    case 128:
      return nearest_rows_d<C, 128>(w_sep, b_sep, codebook, ids, row0,
                                    n_rows, cw, d_emb, k_codes, ct);
    default:
      return nearest_rows_d<C, 256>(w_sep, b_sep, codebook, ids, row0,
                                    n_rows, cw, d_emb, k_codes, ct);
  }
}

// the entry's prologue: the tile's rows are patch-embed rows
template <int C>
struct Entry {
  static constexpr bool ENTRY = true, EXIT = false;
  const float* patches;
  const float* w_pe;
  const float* b_pe;
  int patch;
  template <bool V4>
  __device__ __forceinline__ void embed(float* out, int row0, int n_rows,
                                        int cw, int ct) const {
    embed_rows<C, V4>(patches, w_pe, b_pe, out, row0, n_rows, cw, patch,
                      ct);
  }
  __device__ __forceinline__ void search(int, int, int, int) const {}
};

// the exit's epilogue: sep_conv and the nearest code of the tile's rows
template <int C>
struct Exit {
  static constexpr bool ENTRY = false, EXIT = true;
  const float* w_sep;
  const float* b_sep;
  const float* codebook;
  int* ids;
  int d_emb, k_codes;
  template <bool V4>
  __device__ __forceinline__ void embed(float*, int, int, int, int) const {}
  __device__ __forceinline__ void search(int row0, int n_rows, int cw,
                                         int ct) const {
    nearest_rows<C>(w_sep, b_sep, codebook, ids, row0, n_rows, cw, d_emb,
                    k_codes, ct);
  }
};

template <int C, bool V4>
__global__ void __launch_bounds__(THREADS, 1)
encoder_entry_kernel(const __grid_constant__ CUtensorMap tm_w,
                     const float* __restrict__ x,
                     const float* __restrict__ vecs, float* out, int n_rows,
                     int cw, int n_blocks, int use_bn, const Entry<C> ends) {
  encoder_tc<C, V4>(&tm_w, x, vecs, out, n_rows, cw, n_blocks, use_bn, ends);
}

template <int C, bool V4>
__global__ void __launch_bounds__(THREADS, 1)
encoder_exit_kernel(const __grid_constant__ CUtensorMap tm_w,
                    const float* __restrict__ x,
                    const float* __restrict__ vecs, float* out, int n_rows,
                    int cw, int n_blocks, int use_bn, const Exit<C> ends) {
  encoder_tc<C, V4>(&tm_w, x, vecs, out, n_rows, cw, n_blocks, use_bn, ends);
}

template <int C>
cudaError_t launch_entry(const void* patches, const void* w_pe,
                         const void* b_pe, const void* split,
                         const void* vecs, void* out, int n_rows, int patch,
                         int c, int n_blocks, int use_bn,
                         cudaStream_t stream) {
  // the staged patch values must fit the A tile
  if (patch > Tile<C>::A_FLOATS / BM) return cudaErrorInvalidValue;
  const Entry<C> ends{static_cast<const float*>(patches),
                      static_cast<const float*>(w_pe),
                      static_cast<const float*>(b_pe), patch};
  return launch<C>(rows_v4(c, vecs) ? encoder_entry_kernel<C, true>
                                    : encoder_entry_kernel<C, false>,
                   Tile<C>::SMEM, nullptr,
                   static_cast<const float*>(split),
                   static_cast<const float*>(vecs), static_cast<float*>(out),
                   n_rows, c, n_blocks, use_bn, stream, ends);
}

template <int C>
cudaError_t launch_exit(const void* x, const void* split, const void* vecs,
                        const void* w_sep, const void* b_sep,
                        const void* codebook, void* resid, void* ids,
                        int n_rows, int c, int n_blocks, int use_bn,
                        int d_emb, int k_codes, cudaStream_t stream) {
  const Exit<C> ends{static_cast<const float*>(w_sep),
                     static_cast<const float*>(b_sep),
                     static_cast<const float*>(codebook),
                     static_cast<int*>(ids), d_emb, k_codes};
  return launch<C>(rows_v4(c, vecs) ? encoder_exit_kernel<C, true>
                                    : encoder_exit_kernel<C, false>,
                   Tile<C>::SMEM_EXIT,
                   static_cast<const float*>(x),
                   static_cast<const float*>(split),
                   static_cast<const float*>(vecs), static_cast<float*>(resid),
                   n_rows, c, n_blocks, use_bn, stream, ends);
}

}  // namespace

// patches (N, patch); w_pe (patch, c) and b_pe (c,), 16-byte aligned;
// split (2 n_blocks, 2 W W) and c (1 to 512) as encoder_chain_f32's;
// out (N, c)
extern "C" int encoder_entry_f32(const void* patches, const void* w_pe,
                                 const void* b_pe, const void* split,
                                 const void* vecs, void* out, int n_rows,
                                 int patch, int c, int n_blocks, int use_bn,
                                 void* stream) {
  if (!width_ok(c) || patch < 1) return cudaErrorInvalidValue;
  if (!aligned(w_pe, 16) || !aligned(b_pe, 16))
    return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile_width(c)) {
    case 128:
      return launch_entry<128>(patches, w_pe, b_pe, split, vecs, out, n_rows,
                               patch, c, n_blocks, use_bn, s);
    case 256:
      return launch_entry<256>(patches, w_pe, b_pe, split, vecs, out, n_rows,
                               patch, c, n_blocks, use_bn, s);
    default:
      return launch_entry<512>(patches, w_pe, b_pe, split, vecs, out, n_rows,
                               patch, c, n_blocks, use_bn, s);
  }
}

// x (N, c); split as the entry's; w_sep (c, D), b_sep (D,); codebook
// (K, D), any K and D from 1 to 256, 16-byte aligned; resid (N, c), the
// residual stream between the group's resblocks; ids (N,) int32
extern "C" int encoder_exit_f32(const void* x, const void* split,
                                const void* vecs, const void* w_sep,
                                const void* b_sep, const void* codebook,
                                void* resid, void* ids, int n_rows, int c,
                                int n_blocks, int use_bn, int d_emb,
                                int k_codes, void* stream) {
  if (!width_ok(c) || d_emb < 1 || d_emb > scan::MAX_D || k_codes < 1)
    return cudaErrorInvalidValue;
  if (!aligned(codebook, 16)) return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile_width(c)) {
    case 128:
      return launch_exit<128>(x, split, vecs, w_sep, b_sep, codebook, resid,
                              ids, n_rows, c, n_blocks, use_bn, d_emb,
                              k_codes, s);
    case 256:
      return launch_exit<256>(x, split, vecs, w_sep, b_sep, codebook, resid,
                              ids, n_rows, c, n_blocks, use_bn, d_emb,
                              k_codes, s);
    default:
      return launch_exit<512>(x, split, vecs, w_sep, b_sep, codebook, resid,
                              ids, n_rows, c, n_blocks, use_bn, d_emb,
                              k_codes, s);
  }
}
