// encoder_chain_f32: n eval-mode VQ-VAE encoder resblocks on a row tile.
//
// Replaces vq_vae_transformer_arc_welding_tpu/ops/pallas_encoder.py::
// fused_encoder_eval (pallas_call at :311). The resblock, what bounds
// it on an H100 (FP32 FMA rate) and the tile's design are in
// encoder_chain.cuh, which the other encoder kernels share: x (N, C)
// f32 in, the same rows after n resblocks out; the residual stream
// crosses device memory once per call, whatever n is.
#include "encoder_chain.cuh"

namespace {

using namespace arcweld::enc;

template <int C>
__global__ void __launch_bounds__(THREADS, 1)
encoder_chain_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ vecs, float* __restrict__ out,
                     int n_rows, int n_blocks, int use_bn) {
  using T = Tile<C>;
  extern __shared__ float4 smem4[];
  float* a_s = reinterpret_cast<float*>(smem4);   // BM x C
  float* w_s = a_s + T::A_FLOATS;                  // 2 x BK x C

  const int tid = threadIdx.x;
  const int rg = tid / 64;   // uniform across a warp: A reads broadcast
  const int cg = tid % 64;
  const int row0 = blockIdx.x * BM + rg * ROWS;

  float xr[ROWS][T::COLS];
  load_rows<C>(x, xr, row0, cg, n_rows);
  resblock_chain<C>(xr, a_s, w_s, w, vecs, n_blocks, use_bn, rg, cg, tid);
  store_rows<C>(out, xr, row0, cg, n_rows);
}

}  // namespace

extern "C" int encoder_chain_f32(const void* x, const void* weights,
                                 const void* vecs, void* out, int n_rows,
                                 int c, int n_blocks, int use_bn,
                                 void* stream) {
  // hidden 512, the bench model's width; another width needs its own
  // instantiation (C a multiple of 256)
  if (c != 512) return cudaErrorInvalidValue;
  return launch_rows<512>(
      encoder_chain_kernel<512>, n_rows, static_cast<cudaStream_t>(stream),
      static_cast<const float*>(x), static_cast<const float*>(weights),
      static_cast<const float*>(vecs), static_cast<float*>(out), n_rows,
      n_blocks, use_bn);
}

extern "C" const char* arcweld_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
