// Device helpers shared by the port's kernels.
//
// Rounding rules that keep the kernels comparable with the plain
// PyTorch versions and with the JAX reference:
//  - exact-erf GELU with erff, torch's formula (x * 0.5) * (1 + erf(x / sqrt 2));
//  - int8 quantization rounds half to even (rintf), never roundf;
//  - a product followed by a sum that the reference computes as two
//    roundings is written with __fmul_rn / __fadd_rn, which nvcc never
//    contracts into one FMA.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace arcweld {

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752440f));
}

// clip(round_half_even(v * s), -127, 127)
__device__ __forceinline__ int8_t q8(float v, float s) {
  float r = rintf(__fmul_rn(v, s));
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return static_cast<int8_t>(r);
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

}  // namespace arcweld
