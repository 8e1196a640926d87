// resblock_f32: one eval-mode VQ-VAE encoder resblock on a row tile,
// on the tensor cores in split TF32.
//
// Replaces vq_vae_transformer_arc_welding_tpu/ops/pallas_encoder.py::
// fused_resblock_eval (pallas_call at :106): x (N, C) f32, the block's
// two matrices split as (2, 2, C, C) (ops/fused_encoder.py::
// split_weights) and its (10, C) vector rows; the same rows after the
// block out.
//
// It is the tile of encoder_tc.cuh with exactly one block in its body,
// so what bounds it is the same TF32 rate, plus one round trip of the
// residual stream through device memory per resblock (2 x N x C x 4
// bytes, 105 MB at 25,600 x 512), which the chain kernel pays once per
// group.
#include "encoder_tc.cuh"

namespace {

using namespace arcweld::enc_tc;

template <int C, bool V4>
__global__ void __launch_bounds__(THREADS, 1)
resblock_kernel(const __grid_constant__ CUtensorMap tm_w,
                const float* __restrict__ x, const float* __restrict__ vec,
                float* out, int n_rows, int cw, int n_blocks, int use_bn) {
  encoder_tc<C, V4>(&tm_w, x, vec, out, n_rows, cw, n_blocks, use_bn);
}

template <int C>
cudaError_t launch_resblock(const void* x, const void* split,
                            const void* vec, void* out, int n_rows, int c,
                            int use_bn, cudaStream_t stream) {
  return launch<C>(rows_v4(c, vec) ? resblock_kernel<C, true>
                                   : resblock_kernel<C, false>,
                   Tile<C>::SMEM, static_cast<const float*>(x),
                   static_cast<const float*>(split),
                   static_cast<const float*>(vec), static_cast<float*>(out),
                   n_rows, c, 1, use_bn, stream);
}

}  // namespace

// the widths and the split of encoder_chain_f32, one resblock
extern "C" int resblock_f32(const void* x, const void* split,
                            const void* vec, void* out, int n_rows, int c,
                            int use_bn, void* stream) {
  if (!width_ok(c)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile_width(c)) {
    case 128:
      return launch_resblock<128>(x, split, vec, out, n_rows, c, use_bn, s);
    case 256:
      return launch_resblock<256>(x, split, vec, out, n_rows, c, use_bn, s);
    default:
      return launch_resblock<512>(x, split, vec, out, n_rows, c, use_bn, s);
  }
}
