// encoder_chain_f32: n eval-mode VQ-VAE encoder resblocks on a row tile,
// on the tensor cores in split TF32.
//
// Replaces vq_vae_transformer_arc_welding_tpu/ops/pallas_encoder.py::
// fused_encoder_eval (pallas_call at :311). The resblock, what bounds
// it on an H100 (the TF32 products, then L2) and the tile's design are
// in encoder_tc.cuh, which #3 (encoder_resblock.cu) and the encoder's
// ends #4 and #5 (encoder_edges.cu) share: x (N, C) f32 and the split
// weights in, the same rows after n resblocks out.
#include "encoder_tc.cuh"

namespace {

using namespace arcweld::enc_tc;

__global__ void __launch_bounds__(THREADS, 1)
encoder_chain_kernel(const __grid_constant__ CUtensorMap tm_w,
                     const float* __restrict__ x,
                     const float* __restrict__ vecs, float* out, int n_rows,
                     int n_blocks, int use_bn) {
  encoder_tc(&tm_w, x, vecs, out, n_rows, n_blocks, use_bn);
}

}  // namespace

// split: (2 n_blocks, 2, C, C) f32, per matrix hi then lo in (out, in)
// layout (ops/fused_encoder.py::split_weights); vecs (10 n_blocks, C)
extern "C" int encoder_chain_f32(const void* x, const void* split,
                                 const void* vecs, void* out, int n_rows,
                                 int c, int n_blocks, int use_bn,
                                 void* stream) {
  // hidden 512, the bench model's width; another width needs its own tile
  if (c != C) return cudaErrorInvalidValue;
  return launch(encoder_chain_kernel, static_cast<const float*>(x),
                static_cast<const float*>(split),
                static_cast<const float*>(vecs), static_cast<float*>(out),
                n_rows, n_blocks, use_bn, static_cast<cudaStream_t>(stream));
}

extern "C" const char* arcweld_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
