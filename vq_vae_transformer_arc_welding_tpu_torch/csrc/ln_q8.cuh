// ln_q8: LayerNorm and int8 quantization of rows, the first and the last
// launch of kernel #2's attention half (int8_block.cu::launch_attn_half,
// replacing the `_q8(_ln(x))` steps of
// vq_vae_transformer_arc_welding_tpu/ops/pallas_block_quant.py):
//
//   out[r, :] = q8((x[r, :] - mean) / sqrt(var + 1e-5) * scale + bias,
//                  *qscale)
//
// with the mean and then the biased variance in two passes over the row,
// every rounding where the plain version has one (common.cuh), and, where
// rail_rows is given, rail_rows[r] = the count of out[r, :] at +-127: the
// numerator of the in-path saturation monitor's site on h8 (JAX's
// models/quantized.py::_row_clip_frac_prequant).
//
// What bounds it: bytes. At batch 80 (25,680 rows of 512) it reads 52.6 MB
// of f32 and writes 13.1 MB of int8, 0.0196 ms at 3.35 TB/s. The kernel
// before this one took 2.6x that: one f32 load and one byte store a lane
// per 32 columns, and 32 scalar loads of scale and bias a row; a copy of
// the same bytes with 16-byte loads takes 1.5x the bound on the card, and
// the exact division a value adds about 7%
// (scripts/bench_ln_q8_variants.py). So:
//  - one warp a row, eight rows a block; a lane owns V neighbouring
//    columns of every 32 V (V = 4, or 2 where C is an odd multiple of 64)
//    and loads them, and the matching scale and bias, 16 (8) bytes at a
//    time, all of the row's loads issued before the first sum;
//  - the q8 outputs leave as one 4-byte (2-byte) store a lane per 32 V
//    columns, a warp writing 128 neighbouring bytes at once;
//  - C is a template constant (every multiple of 64 up to TEMPLATE_C has
//    its instantiation), so a lane holds exactly its row's share in registers;
//  - the sums keep the earlier kernel's order, lane L adding the columns
//    L + 32 i in order before the warp adds the lanes' sums pairwise: the
//    row goes through shared memory once to reach the lanes in that
//    order. h8 is bit for bit what it was, and with it everything
//    downstream (an h8 step of another order moves the int8 attention's
//    per-head scales, and from there whole rows).
//
// Any other C up to MAX_ANY_C (a width off the multiples of 64, above
// TEMPLATE_C, or rows not aligned for the wide loads) takes
// ln_q8_any_kernel: C a runtime value, one warp a row, the row staged
// once in shared memory by lane L at columns L + 32 i, each lane reading
// back its own columns. Its sums run in the order above, so where the template runs
// it writes the same bits. Its output rows lie pitch16(C) bytes apart
// (the int8 GEMM's operand pitch, int8_gemm_sm90.cuh), a byte a store.
#pragma once

#include "common.cuh"

namespace arcweld {
namespace lnq8 {

constexpr int TEMPLATE_C = 1024; // widest row of the template
constexpr int WARPS = 8;         // rows a block
constexpr int MAX_ANY_C = 4096;  // widest row of ln_q8_any_kernel
constexpr int ANY_WARPS = 4;     // its rows a block: 64 KB at MAX_ANY_C

template <int V>
__device__ __forceinline__ void load(const float* p, float (&d)[V]) {
  if constexpr (V == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    d[0] = f.x, d[1] = f.y, d[2] = f.z, d[3] = f.w;
  } else {
    const float2 f = *reinterpret_cast<const float2*>(p);
    d[0] = f.x, d[1] = f.y;
  }
}

template <int V>
__device__ __forceinline__ void store_f32(float* p, const float (&d)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(d[0], d[1], d[2], d[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(d[0], d[1]);
}

template <int V>
__device__ __forceinline__ void store(int8_t* p, const int (&q)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<char4*>(p) = make_char4(q[0], q[1], q[2], q[3]);
  else
    *reinterpret_cast<char2*>(p) = make_char2(q[0], q[1]);
}

// C = 32 V N; rail_rows may be null
template <int V, int N>
__global__ void __launch_bounds__(32 * WARPS)
ln_q8_kernel(const float* __restrict__ x, const float* __restrict__ scale,
             const float* __restrict__ bias, const float* __restrict__ qscale,
             int8_t* __restrict__ out, int* __restrict__ rail_rows,
             int rows) {
  constexpr int C = 32 * V * N, PER = C / 32;
  __shared__ __align__(16) float tile[WARPS][C];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int row = blockIdx.x * WARPS + warp;
  if (row >= rows) return;
  const float* xr = x + (size_t)row * C;
  float v[N][V];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    load<V>(xr + V * (32 * i + lane), v[i]);
    store_f32<V>(tile[warp] + V * (32 * i + lane), v[i]);
  }
  __syncwarp();
  float vs[PER];  // columns lane + 32 i
#pragma unroll
  for (int i = 0; i < PER; ++i) vs[i] = tile[warp][32 * i + lane];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) s = __fadd_rn(s, vs[i]);
  const float mean = __fdiv_rn(warp_sum(s), (float)C);
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const float d = __fsub_rn(vs[i], mean);
    q = __fadd_rn(q, __fmul_rn(d, d));
  }
  const float var = __fdiv_rn(warp_sum(q), (float)C);
  const float sd = sqrtf(__fadd_rn(var, 1e-5f));
  const float qs = *qscale;
  int8_t* const orow = out + (size_t)row * C;
  int rails = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int col = V * (32 * i + lane);
    float sc[V], bi[V];
    load<V>(scale + col, sc);
    load<V>(bias + col, bi);
    int o[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float y = __fdiv_rn(__fsub_rn(v[i][j], mean), sd);
      o[j] = q8_of(__fmul_rn(__fadd_rn(__fmul_rn(y, sc[j]), bi[j]), qs));
      rails += (o[j] == 127) | (o[j] == -127);
    }
    store<V>(orow + col, o);
  }
  if (rail_rows != nullptr) {
    rails = __reduce_add_sync(0xffffffffu, rails);
    if (lane == 0) rail_rows[row] = rails;
  }
}

template <int V, int N>
cudaError_t launch_c(const float* x, const float* scale, const float* bias,
                     const float* qscale, int8_t* out, int* rail_rows,
                     int rows, cudaStream_t s) {
  ln_q8_kernel<V, N><<<(rows + WARPS - 1) / WARPS, 32 * WARPS, 0, s>>>(
      x, scale, bias, qscale, out, rail_rows, rows);
  return cudaGetLastError();
}

// any c up to MAX_ANY_C; out rows `pitch` bytes apart; dynamic shared
// memory ANY_WARPS * c floats
__global__ void __launch_bounds__(32 * ANY_WARPS)
ln_q8_any_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                 const float* __restrict__ bias,
                 const float* __restrict__ qscale, int8_t* __restrict__ out,
                 int* __restrict__ rail_rows, int rows, int c, int pitch) {
  extern __shared__ float rows_s[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int row = blockIdx.x * ANY_WARPS + warp;
  if (row >= rows) return;
  float* const t = rows_s + (size_t)warp * c;
  const float* xr = x + (size_t)row * c;
  float s = 0.f;
  for (int i = lane; i < c; i += 32) {
    const float v = xr[i];
    t[i] = v;
    s = __fadd_rn(s, v);
  }
  const float mean = __fdiv_rn(warp_sum(s), (float)c);
  float q = 0.f;
  for (int i = lane; i < c; i += 32) {
    const float d = __fsub_rn(t[i], mean);
    q = __fadd_rn(q, __fmul_rn(d, d));
  }
  const float var = __fdiv_rn(warp_sum(q), (float)c);
  const float sd = sqrtf(__fadd_rn(var, 1e-5f));
  const float qs = *qscale;
  int8_t* const orow = out + (size_t)row * pitch;
  int rails = 0;
  for (int i = lane; i < c; i += 32) {
    const float y = __fdiv_rn(__fsub_rn(t[i], mean), sd);
    const int o =
        q8_of(__fmul_rn(__fadd_rn(__fmul_rn(y, scale[i]), bias[i]), qs));
    rails += (o == 127) | (o == -127);
    orow[i] = (int8_t)o;
  }
  if (rail_rows != nullptr) {
    rails = __reduce_add_sync(0xffffffffu, rails);
    if (lane == 0) rail_rows[row] = rails;
  }
}

inline bool aligned_to(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// x (rows, c) f32, scale and bias (c,) f32, out (rows, c) int8 in rows
// pitch16(c) bytes apart, rail_rows (rows,) int32 or null (written,
// not added to); c from 1 to MAX_ANY_C. A multiple of 64 up to TEMPLATE_C
// with x, scale and bias 16-byte aligned (8 where c % 128 != 0) and out
// 4-byte (2) takes its template, any other row ln_q8_any_kernel.
inline cudaError_t launch(const float* x, const float* scale,
                         const float* bias, const float* qscale, int8_t* out,
                         int* rail_rows, int rows, int c, cudaStream_t s) {
  if (rows < 1 || c < 1 || c > MAX_ANY_C) return cudaErrorInvalidValue;
  const bool v4 = c % 128 == 0;
  const size_t al = v4 ? 16 : 8;
  if (c % 64 != 0 || c > TEMPLATE_C || !aligned_to(x, al) ||
      !aligned_to(scale, al) || !aligned_to(bias, al) ||
      !aligned_to(out, al / 4)) {
    const size_t smem = sizeof(float) * ANY_WARPS * c;
    cudaError_t e = cudaFuncSetAttribute(
        ln_q8_any_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    ln_q8_any_kernel<<<(rows + ANY_WARPS - 1) / ANY_WARPS, 32 * ANY_WARPS,
                       smem, s>>>(x, scale, bias, qscale, out, rail_rows,
                                  rows, c, pitch16(c));
    return cudaGetLastError();
  }
  switch (c / 64) {
#define ARCWELD_LN_Q8_C(k, v, n) \
  case k:                        \
    return launch_c<v, n>(x, scale, bias, qscale, out, rail_rows, rows, s);
    ARCWELD_LN_Q8_C(1, 2, 1) ARCWELD_LN_Q8_C(2, 4, 1)
    ARCWELD_LN_Q8_C(3, 2, 3) ARCWELD_LN_Q8_C(4, 4, 2)
    ARCWELD_LN_Q8_C(5, 2, 5) ARCWELD_LN_Q8_C(6, 4, 3)
    ARCWELD_LN_Q8_C(7, 2, 7) ARCWELD_LN_Q8_C(8, 4, 4)
    ARCWELD_LN_Q8_C(9, 2, 9) ARCWELD_LN_Q8_C(10, 4, 5)
    ARCWELD_LN_Q8_C(11, 2, 11) ARCWELD_LN_Q8_C(12, 4, 6)
    ARCWELD_LN_Q8_C(13, 2, 13) ARCWELD_LN_Q8_C(14, 4, 7)
    ARCWELD_LN_Q8_C(15, 2, 15) ARCWELD_LN_Q8_C(16, 4, 8)
#undef ARCWELD_LN_Q8_C
  }
  return cudaErrorInvalidValue;
}

}  // namespace lnq8
}  // namespace arcweld
