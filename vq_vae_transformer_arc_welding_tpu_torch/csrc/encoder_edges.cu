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
// last epilogue leaves x in A; its rows give z, and z, the codebook and
// its squared norms then take the A tile over. The exit's residual
// stream between its resblocks lives in an (N, C) buffer of its
// caller, as #1's output does.
//
// Exactness: every dot product of the ends is summed in index order
// with FMAs, the squared norms as rounded products added in index
// order, and d keeps the reference's order (zsq + esq) - 2 * cross.
// Each lane scans its codes in increasing order with d < best, and the
// reduction over lanes takes the smaller d and, on equal d, the smaller
// index: the first index among equal minima, as the reference's argmin.
// No finite distance (a non-finite row) gives code 0.
//
// Both ends are __noinline__ and take scalars only: code inlined after
// the chain changes the register allocation of its products. So they
// find the A tile themselves (a_tile()), which keeps its loads and
// stores shared-memory ones, and read the operands through the read-only
// path (__ldg): behind a pointer argument either would be a generic
// access.
#include "encoder_tc.cuh"

namespace {

using namespace arcweld::enc_tc;
using arcweld::gemm90::aligned;

// patch-embed rows a thread computes in one pass (of its BM / RSTEP)
constexpr int EMBED_ROWS = 8;
// k of w_sep a thread holds in registers, the next chunk's loads in
// flight while it multiplies this one's
constexpr int Z_CHUNK = 32;
static_assert(64 % Z_CHUNK == 0, "w_sep's chunks: whole chunks a width");
// rows a consumer warp scans the codebook for
constexpr int WARP_ROWS = BM / CONSUMER_WARPS;   // 8
static_assert(WARP_ROWS * CONSUMER_WARPS == BM, "a warp's rows");

// A codebook row in shared memory: D + 4 floats, so that rows stay
// 16-byte aligned and the float4 reads of eight lanes on neighbouring
// codes fall in different banks for every D of 8, 16, 32 or 64.
__host__ __device__ constexpr int code_pitch(int d_emb) { return d_emb + 4; }

// floats from the A tile's start the exit's epilogue takes: z, the
// padded codebook, its norms (at most EXIT_FLOATS)
__host__ __device__ constexpr int exit_floats(int d_emb, int k_codes) {
  return BM * d_emb + k_codes * (code_pitch(d_emb) + 1);
}

// out[tile rows] = patches[tile rows] @ w_pe + b_pe, then a barrier of
// the consumers; out and w_pe rows of cw floats. The tile's BM x P patch
// values are staged in the A tile (zeros past n_rows); thread ct takes
// columns 4 (ct % TPR) .. + 3 of rows ct / TPR, + RSTEP, ..., the rows
// and columns it later loads as A (load_a), so it reads back only its
// own stores. k runs in index order; rows past n_rows and columns from
// cw on are not written.
template <int C>
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
  const bool in_row = col < cw;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 b =
      in_row ? __ldg(reinterpret_cast<const float4*>(b_pe + col)) : zero;
  for (int r = ct / TPR; r < BM; r += RSTEP * EMBED_ROWS) {
    float4 acc[EMBED_ROWS];
#pragma unroll
    for (int q = 0; q < EMBED_ROWS; ++q)
      acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < patch; ++k) {
      const float4 w =
          in_row ? __ldg(reinterpret_cast<const float4*>(
                       w_pe + (size_t)k * cw + col))
                 : zero;
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
      if (row < n_rows && in_row)
        *reinterpret_cast<float4*>(out + (size_t)row * cw + col) =
            make_float4(acc[q].x + b.x, acc[q].y + b.y, acc[q].z + b.z,
                        acc[q].w + b.w);
    }
  }
  named_sync(1, CONSUMERS);  // the patches are read; load_a writes A
}

// ids[tile rows] = the nearest code of x @ w_sep + b_sep, for the
// tile's rows x in the A tile (swizzled, a_at; zeros past n_rows), with
// a (K, D) codebook, exit_floats(D, K) <= EXIT_FLOATS, w_sep (cw, D):
// z sums x's first cw columns (A is zero past them). D is a template
// constant, so that z's loops are unrolled and every shared address
// past a thread's first is an immediate offset: with D a runtime value
// the z loop ran several times slower on an H100.
// z: thread ct takes column ct % D of rows ct / D, + 256 / D, ... (D / 4
// rows); then z (BM x D) goes to the front of the A tile, the codebook
// (rows of code_pitch(D)) and its K squared norms after it, and each
// consumer warp scans the codebook for its WARP_ROWS rows.
template <int C, int D>
__device__ __forceinline__ void nearest_rows_d(
    const float* __restrict__ w_sep, const float* __restrict__ b_sep,
    const float* __restrict__ codebook, int* __restrict__ ids, int row0,
    int n_rows, int cw, int k_codes, int ct) {
  constexpr int RSTEP = CONSUMERS / D;   // rows between a thread's z rows
  constexpr int NZ = BM / RSTEP;         // its z rows
  constexpr int DP = code_pitch(D);
  static_assert(NZ * RSTEP == BM && D % 8 == 0, "z's rows");
  float* const a_s = a_tile<C>();
  const int dcol = ct % D;
  const int r0 = ct / D;
  // row r0 + i RSTEP of A at k: a_at's swizzle is r0's, flipped in
  // bit 4 for odd i where RSTEP is 4
  const float* const x0 = a_s + r0 * C;
  const int sw = (r0 & 7) << 2;
  float zacc[NZ];
#pragma unroll
  for (int i = 0; i < NZ; ++i) zacc[i] = 0.0f;
  // the chain's weights have swept w_sep out of L1, so its rows come
  // from L2: Z_CHUNK k of them in registers and the next chunk's loads
  // in flight behind the products (the last round reloads chunk 0,
  // unused)
  float w[Z_CHUNK], wn[Z_CHUNK];
#pragma unroll
  for (int j = 0; j < Z_CHUNK; ++j) w[j] = __ldg(w_sep + j * D + dcol);
  for (int k0 = 0; k0 < cw; k0 += Z_CHUNK) {
    const int kn = k0 + Z_CHUNK < cw ? k0 + Z_CHUNK : 0;
#pragma unroll
    for (int j = 0; j < Z_CHUNK; ++j)
      wn[j] = __ldg(w_sep + (kn + j) * D + dcol);
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

  float* const z_s = a_s;
  float* const cb_s = a_s + BM * D;
  float* const esq_s = cb_s + k_codes * DP;
  const float bias = __ldg(b_sep + dcol);
#pragma unroll
  for (int i = 0; i < NZ; ++i)
    z_s[(r0 + i * RSTEP) * D + dcol] = zacc[i] + bias;
  // D is a multiple of 8: a float4 never straddles two codes
  const float4* cb4 = reinterpret_cast<const float4*>(codebook);
#pragma unroll 4
  for (int i = ct; i < k_codes * (D / 4); i += CONSUMERS) {
    const int e = 4 * i;
    *reinterpret_cast<float4*>(cb_s + (e / D) * DP + e % D) = __ldg(cb4 + i);
  }
  named_sync(1, CONSUMERS);  // z_s and cb_s are complete
  for (int k = ct; k < k_codes; k += CONSUMERS) {
    float s = 0.0f;
#pragma unroll 8
    for (int dd = 0; dd < D; ++dd) {
      const float e = cb_s[k * DP + dd];
      s = __fadd_rn(s, __fmul_rn(e, e));
    }
    esq_s[k] = s;
  }
  const int warp = ct / 32;
  const int lane = ct % 32;
  const float* z_w = z_s + warp * WARP_ROWS * D;   // the warp's rows
  float zsq[WARP_ROWS];
#pragma unroll
  for (int q = 0; q < WARP_ROWS; ++q) {
    float s = 0.0f;
#pragma unroll 8
    for (int dd = 0; dd < D; ++dd) {
      const float zv = z_w[q * D + dd];
      s = __fadd_rn(s, __fmul_rn(zv, zv));
    }
    zsq[q] = s;
  }
  named_sync(1, CONSUMERS);  // esq_s is complete

  float best[WARP_ROWS];
  int best_k[WARP_ROWS];
#pragma unroll
  for (int q = 0; q < WARP_ROWS; ++q) {
    best[q] = INFINITY;
    best_k[q] = k_codes;
  }
  for (int k = lane; k < k_codes; k += 32) {
    const float* e = cb_s + k * DP;
    float cross[WARP_ROWS];
#pragma unroll
    for (int q = 0; q < WARP_ROWS; ++q) cross[q] = 0.0f;
    // not unrolled: the warp's z rows (8 D floats) are the same for every
    // code, and an unrolled loop hoists their loads out of the scan into
    // registers, which spill
#pragma unroll 1
    for (int dd = 0; dd < D; dd += 4) {
      const float4 ev = ld4(e + dd);
#pragma unroll
      for (int q = 0; q < WARP_ROWS; ++q) {
        const float4 zv = ld4(z_w + q * D + dd);
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
        best_k[q] = k;
      }
    }
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

// nearest_rows_d for the exit's D: one call site in the tile's body
template <int C>
__device__ __noinline__ void nearest_rows(const float* __restrict__ w_sep,
                                          const float* __restrict__ b_sep,
                                          const float* __restrict__ codebook,
                                          int* __restrict__ ids, int row0,
                                          int n_rows, int cw, int d_emb,
                                          int k_codes, int ct) {
  switch (d_emb) {  // 8, 16, 32 or 64 (encoder_exit_f32 checks)
    case 8:
      return nearest_rows_d<C, 8>(w_sep, b_sep, codebook, ids, row0, n_rows,
                                  cw, k_codes, ct);
    case 16:
      return nearest_rows_d<C, 16>(w_sep, b_sep, codebook, ids, row0,
                                   n_rows, cw, k_codes, ct);
    case 32:
      return nearest_rows_d<C, 32>(w_sep, b_sep, codebook, ids, row0,
                                   n_rows, cw, k_codes, ct);
    default:
      return nearest_rows_d<C, 64>(w_sep, b_sep, codebook, ids, row0,
                                   n_rows, cw, k_codes, ct);
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
  __device__ __forceinline__ void embed(float* out, int row0, int n_rows,
                                        int cw, int ct) const {
    embed_rows<C>(patches, w_pe, b_pe, out, row0, n_rows, cw, patch, ct);
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
  __device__ __forceinline__ void embed(float*, int, int, int, int) const {}
  __device__ __forceinline__ void search(int row0, int n_rows, int cw,
                                         int ct) const {
    nearest_rows<C>(w_sep, b_sep, codebook, ids, row0, n_rows, cw, d_emb,
                    k_codes, ct);
  }
};

template <int C>
__global__ void __launch_bounds__(THREADS, 1)
encoder_entry_kernel(const __grid_constant__ CUtensorMap tm_w,
                     const float* __restrict__ x,
                     const float* __restrict__ vecs, float* out, int n_rows,
                     int cw, int n_blocks, int use_bn, const Entry<C> ends) {
  encoder_tc<C>(&tm_w, x, vecs, out, n_rows, cw, n_blocks, use_bn, ends);
}

template <int C>
__global__ void __launch_bounds__(THREADS, 1)
encoder_exit_kernel(const __grid_constant__ CUtensorMap tm_w,
                    const float* __restrict__ x,
                    const float* __restrict__ vecs, float* out, int n_rows,
                    int cw, int n_blocks, int use_bn, const Exit<C> ends) {
  encoder_tc<C>(&tm_w, x, vecs, out, n_rows, cw, n_blocks, use_bn, ends);
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
  return launch<C>(encoder_entry_kernel<C>, Tile<C>::SMEM, nullptr,
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
  return launch<C>(encoder_exit_kernel<C>, Tile<C>::SMEM_EXIT,
                   static_cast<const float*>(x),
                   static_cast<const float*>(split),
                   static_cast<const float*>(vecs), static_cast<float*>(resid),
                   n_rows, c, n_blocks, use_bn, stream, ends);
}

}  // namespace

// patches (N, patch); w_pe (patch, c) and b_pe (c,), 16-byte aligned;
// split (2 n_blocks, 2 W W) and c as encoder_chain_f32's; out (N, c)
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
// (K, D), 16-byte aligned; resid (N, c), the residual stream between the
// group's resblocks; ids (N,) int32
extern "C" int encoder_exit_f32(const void* x, const void* split,
                                const void* vecs, const void* w_sep,
                                const void* b_sep, const void* codebook,
                                void* resid, void* ids, int n_rows, int c,
                                int n_blocks, int use_bn, int d_emb,
                                int k_codes, void* stream) {
  if (!width_ok(c) ||
      (d_emb != 8 && d_emb != 16 && d_emb != 32 && d_emb != 64) ||
      k_codes < 1 || exit_floats(d_emb, k_codes) > EXIT_FLOATS)
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
