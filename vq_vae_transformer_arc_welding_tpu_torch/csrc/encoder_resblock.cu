// resblock_f32: one eval-mode VQ-VAE encoder resblock on a row tile.
//
// Replaces vq_vae_transformer_arc_welding_tpu/ops/pallas_encoder.py::
// fused_resblock_eval (pallas_call at :106): x (N, C) f32, the block's
// two center-tap matrices (C, C) in (in, out) layout given apart, and
// its (10, C) vector rows; the same rows after the block out.
//
// It is the tile of encoder_chain.cuh with exactly one block in its
// body, so what bounds it is the same FP32 FMA rate, plus one round
// trip of the residual stream through device memory per resblock
// (2 x N x C x 4 bytes, 105 MB at 25,600 x 512), which the chain
// kernel pays once per group.
#include "encoder_chain.cuh"

namespace {

using namespace arcweld::enc;

template <int C>
__global__ void __launch_bounds__(THREADS, 1)
resblock_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                const float* __restrict__ w2, const float* __restrict__ vec,
                float* __restrict__ out, int n_rows, int use_bn) {
  using T = Tile<C>;
  extern __shared__ float4 smem4[];
  float* a_s = reinterpret_cast<float*>(smem4);
  float* w_s = a_s + T::A_FLOATS;

  const int tid = threadIdx.x;
  const int rg = tid / 64;
  const int cg = tid % 64;
  const int row0 = blockIdx.x * BM + rg * ROWS;

  float xr[ROWS][T::COLS];
  float acc[ROWS][T::COLS];
  load_rows<C>(x, xr, row0, cg, n_rows);
  resblock<C>(xr, acc, a_s, w_s, w1, w2, vec, use_bn, rg, cg, tid);
  store_rows<C>(out, xr, row0, cg, n_rows);
}

}  // namespace

extern "C" int resblock_f32(const void* x, const void* w1, const void* w2,
                            const void* vec, void* out, int n_rows, int c,
                            int use_bn, void* stream) {
  // hidden 512 only, as encoder_chain_f32
  if (c != 512) return cudaErrorInvalidValue;
  return launch_rows<512>(
      resblock_kernel<512>, n_rows, static_cast<cudaStream_t>(stream),
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(w2), static_cast<const float*>(vec),
      static_cast<float*>(out), n_rows, use_bn);
}
