#!/usr/bin/env python3
"""Where the time of the LN+q8 rows kernel goes, on an NVIDIA GPU.

    python3 scripts/bench_ln_q8_variants.py [--reps 20]

LN+q8 (`out[r] = q8(LayerNorm(x[r]) * scale + bias, qscale)`, launched
twice a block by kernel #2) is bound by bytes: 25,680 rows of 512 f32
in, int8 out at batch 80. The variants below are built with nvcc from
one source beside the committed kernel (`final`:
vq_vae_transformer_arc_welding_tpu_torch/csrc/ln_q8.cuh) and timed in
turns at that shape:

- `parent`: the kernel as it was before the redesign (one row a warp,
  eight warps a block; one f32 load and one byte store a lane per 32
  columns; scale and bias loaded one value at a time);
- `vec_w8`: the same plan with 16-byte loads of x, scale and bias and
  4-byte stores of h8 (a lane owns four neighbouring columns), for any
  C up to 1024 (a lane holds registers for 1024 / 32 values);
- `vec_w4`, `vec_w16`: `vec_w8` with four or sixteen warps a block;
- `vec_r2`: `vec_w8` with two rows a warp, loaded together;
- `vec_persist`: `vec_w8` on a grid of as many blocks as the card holds
  at once, each warp walking rows with the next row's loads issued
  before the current row's arithmetic, scale and bias held in registers;
- `vec_n4`: `vec_w8` with C = 512 a constant (a lane holds its 16
  values and no more); `vec_n4_occ8`: the same, held to eight blocks an
  SM (32 registers a thread);
- `parent_order_smem`, `parent_order_twice`: `vec_n4` whose sums take
  the parent's order (lane L adds the columns L + 32 i), the row read
  back strided from shared memory, or loaded twice (strided for the
  sums, 16 bytes at a time for the outputs): the parent's h8 bit for
  bit;
- `copy`, `copy_occ8`: the bytes alone (x read with 16-byte loads, its
  low byte stored; the second held to eight blocks an SM), the floor of
  this access plan on this card;
- `no_div`: `vec_w8` with the division by the standard deviation
  replaced by a product with its reciprocal (another function: timed
  only), to show what the exact division costs;
- `plain`: the plain PyTorch version, `quantize_act(layer_norm(x,
  scale, bias), qscale)` (several launches; no single PyTorch call
  computes LayerNorm and q8 together).

Each launch is timed alone between two CUDA events, after a 64 MB
write that evicts its operands from L2, as kernel #2 finds x_mid after
the c_proj GEMM wrote it (52.6 MB); the events are enqueued ahead of
the card, so the host's launch does not count. Every variant that
computes LN+q8 is held against the plain version (one step in at most
1e-3 of h8) and its rail counts against the plain count of its own h8;
`final` and the `parent_order` variants must give the parent kernel's
h8 bit for bit.
Prints one line per variant with its bound (bytes over 3.35 TB/s) and,
last, one JSON object with the card's name and power limit. Needs a
CUDA device and the CUDA toolkit; imports no jax.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
CSRC = REPO / "vq_vae_transformer_arc_welding_tpu_torch" / "csrc"
ROWS, C = 80 * 321, 512
PEAK_BYTES = 3.35e12
FLUSH_BYTES = 64 << 20

SOURCE = r"""
#include "ln_q8.cuh"

namespace {
using namespace arcweld;

// the kernel before the redesign, as it was
constexpr int P_WARPS = 8;
constexpr int P_MAX_PER_LANE = 1024 / 32;
__global__ void __launch_bounds__(32 * P_WARPS)
parent_kernel(const float* __restrict__ x, const float* __restrict__ scale,
              const float* __restrict__ bias, const float* __restrict__ qscale,
              int8_t* __restrict__ out, int rows, int c) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * P_WARPS + threadIdx.x / 32;
  if (row >= rows) return;
  const float* xr = x + (size_t)row * c;
  const int per = c / 32;
  float v[P_MAX_PER_LANE];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < P_MAX_PER_LANE; ++i)
    if (i < per) {
      v[i] = xr[i * 32 + lane];
      s += v[i];
    }
  const float mean = __fdiv_rn(warp_sum(s), (float)c);
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < P_MAX_PER_LANE; ++i)
    if (i < per) {
      const float d = __fsub_rn(v[i], mean);
      q = __fadd_rn(q, __fmul_rn(d, d));
    }
  const float var = __fdiv_rn(warp_sum(q), (float)c);
  const float qs = *qscale;
  int8_t* orow = out + (size_t)row * c;
#pragma unroll
  for (int i = 0; i < P_MAX_PER_LANE; ++i)
    if (i < per) {
      const int col = i * 32 + lane;
      orow[col] = q8(norm_affine(v[i], mean, var, scale[col], bias[col]), qs);
    }
}

// candidates: a lane owns four neighbouring columns of every 128
constexpr int NV = 1024 / 128;

__device__ __forceinline__ void ld4(const float* p, float (&d)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  d[0] = f.x; d[1] = f.y; d[2] = f.z; d[3] = f.w;
}

template <bool NO_DIV>
__device__ __forceinline__ void finish_row(
    const float (&v)[NV][4], const float (&sc)[NV][4], const float (&bi)[NV][4],
    bool sb_in_regs, const float* scale, const float* bias, float qs,
    int8_t* orow, int* rail_rows, int row, int n, int c, int lane) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (i < n)
#pragma unroll
      for (int j = 0; j < 4; ++j) s = __fadd_rn(s, v[i][j]);
  const float mean = __fdiv_rn(warp_sum(s), (float)c);
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (i < n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float d = __fsub_rn(v[i][j], mean);
        q = __fadd_rn(q, __fmul_rn(d, d));
      }
  const float var = __fdiv_rn(warp_sum(q), (float)c);
  const float sd = sqrtf(__fadd_rn(var, 1e-5f));
  const float inv = __frcp_rn(sd);
  int rails = 0;
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (i < n) {
      const int col = 4 * (32 * i + lane);
      float s4[4], b4[4];
      if (sb_in_regs) {
#pragma unroll
        for (int j = 0; j < 4; ++j) { s4[j] = sc[i][j]; b4[j] = bi[i][j]; }
      } else {
        ld4(scale + col, s4);
        ld4(bias + col, b4);
      }
      int8_t o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float d = __fsub_rn(v[i][j], mean);
        const float y = NO_DIV ? __fmul_rn(d, inv) : __fdiv_rn(d, sd);
        const int r = q8_of(__fmul_rn(__fadd_rn(__fmul_rn(y, s4[j]), b4[j]), qs));
        rails += (r == 127) | (r == -127);
        o[j] = (int8_t)r;
      }
      *reinterpret_cast<char4*>(orow + col) = make_char4(o[0], o[1], o[2], o[3]);
    }
  rails = __reduce_add_sync(0xffffffffu, rails);
  if (lane == 0) rail_rows[row] = rails;
}

template <int WARPS, int R, bool NO_DIV>
__global__ void __launch_bounds__(32 * WARPS)
vec_kernel(const float* __restrict__ x, const float* __restrict__ scale,
           const float* __restrict__ bias, const float* __restrict__ qscale,
           int8_t* __restrict__ out, int* __restrict__ rail_rows, int rows,
           int c) {
  const int lane = threadIdx.x % 32;
  const int n = c / 128;
  const int row0 = (blockIdx.x * WARPS + threadIdx.x / 32) * R;
  float v[R][NV][4];
  float none[NV][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (i < n && row0 + r < rows)
        ld4(x + (size_t)(row0 + r) * c + 4 * (32 * i + lane), v[r][i]);
  const float qs = *qscale;
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (row0 + r < rows)
      finish_row<NO_DIV>(v[r], none, none, false, scale, bias, qs,
                         out + (size_t)(row0 + r) * c, rail_rows, row0 + r, n,
                         c, lane);
}

constexpr int PW = 8;
__global__ void __launch_bounds__(32 * PW)
persist_kernel(const float* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ bias, const float* __restrict__ qscale,
               int8_t* __restrict__ out, int* __restrict__ rail_rows, int rows,
               int c) {
  const int lane = threadIdx.x % 32;
  const int n = c / 128;
  const int stride = gridDim.x * PW;
  float sc[NV][4], bi[NV][4], cur[NV][4], nxt[NV][4];
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (i < n) {
      ld4(scale + 4 * (32 * i + lane), sc[i]);
      ld4(bias + 4 * (32 * i + lane), bi[i]);
    }
  int row = blockIdx.x * PW + threadIdx.x / 32;
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (i < n && row < rows) ld4(x + (size_t)row * c + 4 * (32 * i + lane), nxt[i]);
  const float qs = *qscale;
  for (; row < rows; row += stride) {
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) cur[i][j] = nxt[i][j];
    const int next = row + stride;
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (i < n && next < rows)
        ld4(x + (size_t)next * c + 4 * (32 * i + lane), nxt[i]);
    finish_row<false>(cur, sc, bi, true, scale, bias, qs,
                      out + (size_t)row * c, rail_rows, row, n, c, lane);
  }
}

// a lane owns four neighbouring columns of each 128 (NA of them, c =
// 128 NA exactly), MINB blocks an SM asked of ptxas
template <int NA, int MINB>
__global__ void __launch_bounds__(256, MINB)
exact_n_kernel(const float* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ bias, const float* __restrict__ qscale,
               int8_t* __restrict__ out, int* __restrict__ rail_rows, int rows,
               int c) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  if (row >= rows) return;
  float v[NV][4];
#pragma unroll
  for (int i = 0; i < NA; ++i)
    ld4(x + (size_t)row * c + 4 * (32 * i + lane), v[i]);
  float none[NV][4];
  finish_row<false>(v, none, none, false, scale, bias, *qscale,
                    out + (size_t)row * c, rail_rows, row, NA, c, lane);
}

// the parent's sums, bit for bit: lane L adds the columns L + 32 i in
// order, as the parent kernel did; MODE 0 loads the row with 16-byte
// loads and reads it back strided from shared memory, MODE 1 loads it
// strided from device memory and again with 16-byte loads for the
// outputs (from L1)
template <int NA, int MODE>
__global__ void __launch_bounds__(256)
parent_order_kernel(const float* __restrict__ x,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias,
                    const float* __restrict__ qscale, int8_t* __restrict__ out,
                    int* __restrict__ rail_rows, int rows, int c) {
  constexpr int PER = 4 * NA;
  __shared__ float tile[MODE == 0 ? 8 * 128 * NA : 1];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int row = blockIdx.x * 8 + warp;
  if (row >= rows) return;
  const float* xr = x + (size_t)row * c;
  float v[NV][4], vs[PER];
  if (MODE == 0) {
    float* t = tile + warp * 128 * NA;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      ld4(xr + 4 * (32 * i + lane), v[i]);
      *reinterpret_cast<float4*>(t + 4 * (32 * i + lane)) =
          make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < PER; ++i) vs[i] = t[32 * i + lane];
  } else {
#pragma unroll
    for (int i = 0; i < PER; ++i) vs[i] = xr[32 * i + lane];
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) s += vs[i];
  const float mean = __fdiv_rn(warp_sum(s), (float)c);
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const float d = __fsub_rn(vs[i], mean);
    q = __fadd_rn(q, __fmul_rn(d, d));
  }
  const float var = __fdiv_rn(warp_sum(q), (float)c);
  if (MODE == 1) {
#pragma unroll
    for (int i = 0; i < NA; ++i) ld4(xr + 4 * (32 * i + lane), v[i]);
  }
  const float sd = sqrtf(__fadd_rn(var, 1e-5f));
  const float qs = *qscale;
  int rails = 0;
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const int col = 4 * (32 * i + lane);
    float s4[4], b4[4];
    ld4(scale + col, s4);
    ld4(bias + col, b4);
    int8_t o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float y = __fdiv_rn(__fsub_rn(v[i][j], mean), sd);
      const int r = q8_of(__fmul_rn(__fadd_rn(__fmul_rn(y, s4[j]), b4[j]), qs));
      rails += (r == 127) | (r == -127);
      o[j] = (int8_t)r;
    }
    *reinterpret_cast<char4*>(out + (size_t)row * c + col) =
        make_char4(o[0], o[1], o[2], o[3]);
  }
  rails = __reduce_add_sync(0xffffffffu, rails);
  if (lane == 0) rail_rows[row] = rails;
}

template <int MINB>
__global__ void __launch_bounds__(256, MINB)
copy_occ_kernel(const float* __restrict__ x, int8_t* __restrict__ out,
                int rows, int c) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  if (row >= rows) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 f = *reinterpret_cast<const float4*>(
        x + (size_t)row * c + 4 * (32 * i + lane));
    *reinterpret_cast<char4*>(out + (size_t)row * c + 4 * (32 * i + lane)) =
        make_char4((int8_t)__float_as_int(f.x), (int8_t)__float_as_int(f.y),
                   (int8_t)__float_as_int(f.z), (int8_t)__float_as_int(f.w));
  }
}

constexpr int CW = 8;
__global__ void __launch_bounds__(32 * CW)
copy_kernel(const float* __restrict__ x, int8_t* __restrict__ out, int rows,
            int c) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * CW + threadIdx.x / 32;
  if (row >= rows) return;
  const int n = c / 128;
  float v[NV][4];
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (i < n) ld4(x + (size_t)row * c + 4 * (32 * i + lane), v[i]);
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (i < n)
      *reinterpret_cast<char4*>(out + (size_t)row * c + 4 * (32 * i + lane)) =
          make_char4((int8_t)__float_as_int(v[i][0]), (int8_t)__float_as_int(v[i][1]),
                     (int8_t)__float_as_int(v[i][2]), (int8_t)__float_as_int(v[i][3]));
}

template <int WARPS, int R, bool NO_DIV>
cudaError_t run_vec(const float* x, const float* s, const float* b,
                    const float* qs, int8_t* o, int* rails, int rows, int c,
                    cudaStream_t st) {
  const int per = WARPS * R;
  vec_kernel<WARPS, R, NO_DIV><<<(rows + per - 1) / per, 32 * WARPS, 0, st>>>(
      x, s, b, qs, o, rails, rows, c);
  return cudaGetLastError();
}
}  // namespace

extern "C" int run(int which, const void* xp, const void* sp, const void* bp,
                   const void* qp, void* op, void* rp, int rows, int c,
                   void* stream) {
  const float *x = (const float*)xp, *s = (const float*)sp, *b = (const float*)bp,
              *qs = (const float*)qp;
  int8_t* o = (int8_t*)op;
  int* r = (int*)rp;
  cudaStream_t st = (cudaStream_t)stream;
  switch (which) {
    case 0:
      return arcweld::lnq8::launch(x, s, b, qs, o, r, rows, c, st);
    case 1:
      parent_kernel<<<(rows + P_WARPS - 1) / P_WARPS, 32 * P_WARPS, 0, st>>>(
          x, s, b, qs, o, rows, c);
      return cudaGetLastError();
    case 2: return run_vec<8, 1, false>(x, s, b, qs, o, r, rows, c, st);
    case 3: return run_vec<4, 1, false>(x, s, b, qs, o, r, rows, c, st);
    case 4: return run_vec<16, 1, false>(x, s, b, qs, o, r, rows, c, st);
    case 5: return run_vec<8, 2, false>(x, s, b, qs, o, r, rows, c, st);
    case 6: {
      int dev, sms, per_sm;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, persist_kernel,
                                                    32 * PW, 0);
      int grid = sms * per_sm, need = (rows + PW - 1) / PW;
      persist_kernel<<<grid < need ? grid : need, 32 * PW, 0, st>>>(
          x, s, b, qs, o, r, rows, c);
      return cudaGetLastError();
    }
    case 7:
      copy_kernel<<<(rows + CW - 1) / CW, 32 * CW, 0, st>>>(x, o, rows, c);
      return cudaGetLastError();
    case 8: return run_vec<8, 1, true>(x, s, b, qs, o, r, rows, c, st);
    case 9:
      exact_n_kernel<4, 1><<<(rows + 7) / 8, 256, 0, st>>>(x, s, b, qs, o, r,
                                                          rows, c);
      return cudaGetLastError();
    case 10:
      exact_n_kernel<4, 8><<<(rows + 7) / 8, 256, 0, st>>>(x, s, b, qs, o, r,
                                                          rows, c);
      return cudaGetLastError();
    case 11:
      parent_order_kernel<4, 0><<<(rows + 7) / 8, 256, 0, st>>>(
          x, s, b, qs, o, r, rows, c);
      return cudaGetLastError();
    case 12:
      parent_order_kernel<4, 1><<<(rows + 7) / 8, 256, 0, st>>>(
          x, s, b, qs, o, r, rows, c);
      return cudaGetLastError();
    case 13:
      copy_occ_kernel<8><<<(rows + 7) / 8, 256, 0, st>>>(x, o, rows, c);
      return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}
"""
# name: (index in `run`, computes LN+q8 with rail counts)
VARIANTS = {"final": (0, True), "parent": (1, False), "vec_w8": (2, True),
            "vec_w4": (3, True), "vec_w16": (4, True), "vec_r2": (5, True),
            "vec_persist": (6, True), "copy": (7, False),
            "no_div": (8, False), "vec_n4": (9, True),
            "vec_n4_occ8": (10, True), "parent_order_smem": (11, True),
            "parent_order_twice": (12, True), "copy_occ8": (13, False)}
# these must give the parent's h8 bit for bit
PARENT_BITS = ("final", "parent_order_smem", "parent_order_twice")
TIMED_ONLY = ("copy", "copy_occ8", "no_div")
KERNELS = ("ln_q8_kernel", "parent_kernel", "vec_kernel", "persist_kernel",
           "copy_kernel", "exact_n_kernel", "parent_order_kernel",
           "copy_occ_kernel")


def build(tmp: Path):
    """nvcc the variants into one library (-Xptxas -v): (library, what
    ptxas said of each kernel)."""
    from vq_vae_transformer_arc_welding_tpu_torch import kernels
    src = tmp / "ln_q8_variants.cu"
    src.write_text(SOURCE)
    so = tmp / "ln_q8_variants.so"
    proc = subprocess.run(
        [kernels.nvcc(), *kernels.NVCC_FLAGS, "-shared", "-Xptxas", "-v",
         "-I", str(CSRC), "-o", str(so), str(src)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc: {proc.stderr[-3000:]}")
    said, kernel = [], None
    for line in proc.stderr.splitlines():
        if "Compiling entry function" in line:
            kernel = next((k for k in KERNELS if k in line), None)
            name = line.split("'")[1] if kernel else None
        elif kernel and ("spill" in line or "Used" in line):
            said.append(f"{name[:60]}: "
                        + line.replace("ptxas info    :", "").strip())
    lib = ctypes.CDLL(str(so))
    lib.run.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                        + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.run.restype = ctypes.c_int
    return lib, said


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch
    from vq_vae_transformer_arc_welding_tpu_torch.ops.int8 import quantize_act
    from vq_vae_transformer_arc_welding_tpu_torch.ops.norm import layer_norm
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(ROWS, C, generator=g) * 2 + 0.3).to(dev)
    scale = (torch.rand(C, generator=g) + 0.5).to(dev)
    bias = (torch.randn(C, generator=g) * 0.1).to(dev)
    qscale = torch.tensor(40.0, device=dev)       # clips about 1% of h8
    ref = quantize_act(layer_norm(x, scale, bias), qscale)
    out = torch.empty((ROWS, C), dtype=torch.int8, device=dev)
    rails = torch.zeros(ROWS, dtype=torch.int32, device=dev)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    bound_ms = ROWS * C * (4 + 1) / PEAK_BYTES * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        lib, said = build(Path(tmp))

        def launch(which):
            err = lib.run(which, x.data_ptr(), scale.data_ptr(),
                          bias.data_ptr(), qscale.data_ptr(), out.data_ptr(),
                          rails.data_ptr(), ROWS, C, stream)
            if err:
                raise RuntimeError(f"CUDA error {err}")

        notes = {}
        launch(VARIANTS["parent"][0])
        parent_h8 = out.clone()
        for name, (which, counts) in VARIANTS.items():
            if name in TIMED_ONLY:
                continue
            out.zero_()
            rails.fill_(-1)
            launch(which)
            torch.cuda.synchronize()
            d = (out.int() - ref.int()).abs()
            frac, step = float(d.ne(0).float().mean()), int(d.max())
            note = (f"h8 differs from plain in {frac:.3e} of entries, step "
                    f"{step}, from the parent kernel's in "
                    f"{int((out != parent_h8).sum())}")
            if frac > 1e-3 or step > 1:
                print(f"{name} disagrees with the plain version: {note}",
                      file=sys.stderr)
                return 1
            if name in PARENT_BITS and not torch.equal(out, parent_h8):
                print(f"{name}: h8 is not the parent kernel's",
                      file=sys.stderr)
                return 1
            if counts:
                want = (out.int().abs() == 127).sum(1, dtype=torch.int32)
                if not torch.equal(rails, want):
                    print(f"{name}: rail counts differ from its h8's",
                          file=sys.stderr)
                    return 1
                note += (f"; rail counts exact ({int(want.sum())} of "
                         f"{ROWS * C})")
            notes[name] = note
        def run(name):
            if name == "plain":
                return quantize_act(layer_norm(x, scale, bias), qscale)
            return launch(VARIANTS[name][0])

        times = {name: [] for name in (*VARIANTS, "plain")}
        order = list(times)
        for _ in range(3):
            for name in order:
                run(name)
        for i in range(args.reps):
            pairs = []
            for name in order if i % 2 == 0 else order[::-1]:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                flush.bitwise_not_()
                start.record()
                run(name)
                end.record()
                pairs.append((name, start, end))
            torch.cuda.synchronize()
            for name, start, end in pairs:
                times[name].append(start.elapsed_time(end))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"LN+q8 at {ROWS} x {C}: bound {bound_ms:.4f} ms by bytes "
          f"({ROWS * C * 5 / 1e6:.1f} MB at {PEAK_BYTES / 1e12} TB/s); "
          f"gpu {smi}")
    for line in said:
        print(f"ptxas {line}")
    for name, ts in times.items():
        q1, med, q3 = statistics.quantiles(ts, n=4)
        print(f"{name}: {med:.4f} ms a launch (quartiles {q1:.4f}-{q3:.4f}),"
              f" {bound_ms / med:.1%} of the bound"
              + (f"; {notes[name]}" if name in notes else ""))
    print(json.dumps({"gpu": smi, "bound_ms": bound_ms, "ms": {
        name: statistics.median(ts) for name, ts in times.items()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
