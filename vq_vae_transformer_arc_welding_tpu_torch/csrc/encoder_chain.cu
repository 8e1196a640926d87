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

template <int C, bool V4>
__global__ void __launch_bounds__(THREADS, 1)
encoder_chain_kernel(const __grid_constant__ CUtensorMap tm_w,
                     const float* __restrict__ x,
                     const float* __restrict__ vecs, float* out, int n_rows,
                     int cw, int n_blocks, int use_bn) {
  encoder_tc<C, V4>(&tm_w, x, vecs, out, n_rows, cw, n_blocks, use_bn);
}

template <int C>
cudaError_t launch_chain(const void* x, const void* split, const void* vecs,
                         void* out, int n_rows, int c, int n_blocks,
                         int use_bn, cudaStream_t stream) {
  return launch<C>(rows_v4(c, vecs) ? encoder_chain_kernel<C, true>
                                    : encoder_chain_kernel<C, false>,
                   Tile<C>::SMEM, static_cast<const float*>(x),
                   static_cast<const float*>(split),
                   static_cast<const float*>(vecs), static_cast<float*>(out),
                   n_rows, c, n_blocks, use_bn, stream);
}

}  // namespace

// x, out (N, c), c from 1 to 512, on the tile of tile_width(c); split: (2 n_blocks, 2, W, W) f32 at that width W, per
// matrix hi then lo in (out, in) layout, zero past c
// (ops/fused_encoder.py::split_weights); vecs (10 n_blocks, c)
extern "C" int encoder_chain_f32(const void* x, const void* split,
                                 const void* vecs, void* out, int n_rows,
                                 int c, int n_blocks, int use_bn,
                                 void* stream) {
  if (!width_ok(c)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile_width(c)) {
    case 128:
      return launch_chain<128>(x, split, vecs, out, n_rows, c, n_blocks,
                               use_bn, s);
    case 256:
      return launch_chain<256>(x, split, vecs, out, n_rows, c, n_blocks,
                               use_bn, s);
    default:
      return launch_chain<512>(x, split, vecs, out, n_rows, c, n_blocks,
                               use_bn, s);
  }
}

extern "C" const char* arcweld_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
