// Device helpers shared by the port's kernels.
//
// Rounding rules that keep the kernels comparable with the plain
// PyTorch versions and with the JAX reference:
//  - exact-erf GELU with erff, torch's formula (x * 0.5) * (1 + erf(x / sqrt 2));
//  - tanh GELU (new_gelu) with tanhf, which is within 2 ulp of the
//    libraries' tanh: a g8 value at a rounding boundary may flip by one;
//  - int8 quantization rounds half to even (rintf), never roundf;
//  - a product followed by a sum that the reference computes as two
//    roundings is written with __fmul_rn / __fadd_rn, which nvcc never
//    contracts into one FMA.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <utility>

namespace arcweld {

// the row pitch in bytes of an int8 matrix n values wide: a tensor map's
// rows must lie a multiple of 16 bytes apart (int8_gemm_sm90.cuh)
__host__ __device__ constexpr int pitch16(int n) { return (n + 15) / 16 * 16; }

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752440f));
}

// GPT-2 tanh GELU in the reference's order, one rounding per op:
// (0.5 * x) * (1 + tanh(sqrt(2/pi) * (x + ((0.044715 * x) * x) * x)))
// The constants are the f32 roundings of the Python floats.
__device__ __forceinline__ float new_gelu(float x) {
  const float x3 = __fmul_rn(__fmul_rn(__fmul_rn(0x1.6e4e26p-5f, x), x), x);
  const float u = __fmul_rn(0x1.988454p-1f, __fadd_rn(x, x3));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, tanhf(u)));
}

// clip(round_half_even(v * s), -127, 127)
__device__ __forceinline__ int8_t q8(float v, float s) {
  float r = rintf(__fmul_rn(v, s));
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return static_cast<int8_t>(r);
}

// q8 of a product p = v * s already formed, for finite p, with one
// conversion: cvt.rni rounds half to even as rintf does, and the clamp
// runs on the integer
__device__ __forceinline__ int q8_of(float p) {
  return max(-127, min(127, __float2int_rn(p)));
}

// (v - mean) / sqrt(var + eps) * scale + bias, in the reference's order
__device__ __forceinline__ float norm_affine(float v, float mean, float var,
                                             float scale, float bias) {
  float y = __fdiv_rn(__fsub_rn(v, mean), sqrtf(__fadd_rn(var, 1e-5f)));
  return __fadd_rn(__fmul_rn(y, scale), bias);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// kernel<<<grid, threads, smem, s>>>(args...) in clusters of `cluster`
// blocks along x (grid.x a multiple of it), by cudaLaunchKernelEx. Errors
// come back as they are; cudaErrorLaunchOutOfResources where no cluster
// of that size fits on the card at this shared memory.
template <class... P, class... A>
inline cudaError_t launch_cluster(void (*kernel)(P...), dim3 grid,
                                  int threads, size_t smem, int cluster,
                                  cudaStream_t s, A&&... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int fits = 0;
  e = cudaOccupancyMaxActiveClusters(&fits, kernel, &cfg);
  if (e != cudaSuccess) return e;
  if (fits < 1) return cudaErrorLaunchOutOfResources;
  e = cudaLaunchKernelEx(&cfg, kernel, std::forward<A>(args)...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace arcweld
