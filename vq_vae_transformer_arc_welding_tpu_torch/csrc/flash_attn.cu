// flash_attn: causal softmax(Q K^T / sqrt(D)) V in f32, per (batch, head),
// with no score tensor in device memory.
//
// Replaces vq_vae_transformer_arc_welding_tpu/ops/pallas_attn.py
// (flash_causal_attention: _forward's pallas_call at :73, _attn_kernel).
// The TPU kernel holds one (T, T) score tile per (batch, head) in VMEM,
// pads T to a multiple of 8 and takes four (batch, head) pairs per
// program. Here the tile is attention_tc.cuh's, instantiated for f32
// operands read through strides and an f32 output written through
// strides: 128 query rows a block (16 a warp) laid from the end of T,
// keys and values double-buffered through shared memory by cp.async,
// Q K^T as FP32 FMA chains in a plain GEMM's order, P@V in split TF32 on
// the tensor cores, the row max kept online and the division by the row
// sum after P@V. Any T: the ragged edge is masked.
//
// Any head width up to 128: 64 on the tile's 64 instantiation, another
// on 32, 64 or 128 with its columns past hd zero in shared memory
// (attention_tc.cuh).
//
// bf16 operands (flash_attention_bf16): the JAX kernel reads q, k and v in
// the caller's dtype, computes in f32 and writes q's dtype. Here the same
// tile stages the bf16 rows in shared memory as they come and widens each
// value where it is read (attention_tc.cuh), so the scores and P@V are
// the f32 tile's on the widened operands; the output y / l is rounded to
// bf16 to nearest even, as JAX's astype rounds.
//
// What bounds it on an H100 at the bench shape: operations, 4.2 GFLOP of
// FP32 score FMAs (0.063 ms) and 3 x 4.2 GFLOP of TF32 products (0.026
// ms), against 210 MB of q, k, v and output (0.063 ms). The score loop
// reads nine floats of shared memory for every sixteen FMAs, so shared
// memory, not the FP32 units, sets its pace.
#include "attention_tc.cuh"

namespace {

using namespace arcweld::attn_tc;

// o[b, h, row, col .. col + 1] = y / l, element (b, h, i, e) at
// b*sb + h*sh + i*st + e
struct StoreF32 {
  float* o;
  long long sb, sh, st;
  __device__ __forceinline__ void operator()(int b, int h, int row, int col,
                                             float y0, float y1,
                                             float l) const {
    *reinterpret_cast<float2*>(o + b * sb + h * sh + row * st + col) =
        make_float2(y0 / l, y1 / l);
  }
  __device__ __forceinline__ void one(int b, int h, int row, int col, float y,
                                      float l) const {
    o[b * sb + h * sh + row * st + col] = y / l;
  }
};

// the same in bf16, rounded to nearest even; a pair is one 4-byte store
struct StoreBF16 {
  __nv_bfloat16* o;
  long long sb, sh, st;
  __device__ __forceinline__ void operator()(int b, int h, int row, int col,
                                             float y0, float y1,
                                             float l) const {
    *reinterpret_cast<__nv_bfloat162*>(o + b * sb + h * sh + row * st +
                                       col) =
        __floats2bfloat162_rn(y0 / l, y1 / l);
  }
  __device__ __forceinline__ void one(int b, int h, int row, int col, float y,
                                      float l) const {
    o[b * sb + h * sh + row * st + col] = __float2bfloat16_rn(y / l);
  }
};

// __grid_constant__: the tile takes its operands by reference, which
// would otherwise copy the parameters to the stack
template <int HD, bool PAD, class T, class Store>
__global__ void __launch_bounds__(THREADS, (Shape<HD, T>::MIN_BLOCKS))
flash_attention_kernel(const __grid_constant__ OperandsT<T> in,
                       const __grid_constant__ Store out) {
  causal_attention_tile<HD, PAD>(in, out);
}

template <int HD, bool PAD, class T, class Store>
cudaError_t launch(const OperandsT<T>& in, const Store& out, int batch,
                   int n_head, cudaStream_t stream) {
  constexpr size_t SMEM = Shape<HD, T>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel<HD, PAD, T, Store>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (e != cudaSuccess) return e;
  flash_attention_kernel<HD, PAD, T, Store>
      <<<grid(batch, n_head, in.t), THREADS, SMEM, stream>>>(in, out);
  return cudaGetLastError();
}

// the instantiation of head width hd, as flash_attention_f32 picks it
template <class T, class Store>
cudaError_t launch_any(const OperandsT<T>& in, const Store& out, int batch,
                       int n_head, cudaStream_t s) {
  switch (padded_head(in.hd)) {
    case 32:
      return launch<32, true>(in, out, batch, n_head, s);
    case 64:
      return in.hd == 64 ? launch<64, false>(in, out, batch, n_head, s)
                         : launch<64, true>(in, out, batch, n_head, s);
    default:
      return launch<128, true>(in, out, batch, n_head, s);
  }
}

}  // namespace

// q, k, v (batch, n_head, t, hd) f32, hd <= 128, read through the strides
// (sb, sh, st) in floats, the last axis contiguous; o written through
// (sob, soh, sot), even offsets from an 8-byte-aligned pointer where hd
// is 64 (every other width is written a float at a time). sm_scale:
// 1/sqrt(hd). Head width 64 runs the tile at 64; any other on the
// smallest of 32, 64 and 128 that holds it, padded with zero columns.
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* o, int batch, int n_head, int t,
                                   int hd, long long sb, long long sh,
                                   long long st, long long sob, long long soh,
                                   long long sot, float sm_scale,
                                   void* stream) {
  if (batch < 1 || batch > 65535 || n_head < 1 || t < 1 || hd < 1 ||
      hd > MAX_HD ||
      (hd == 64 && ((sob | soh | sot) % 2 != 0 ||
                    reinterpret_cast<uintptr_t>(o) % 8 != 0)))
    return cudaErrorInvalidValue;
  const Operands in{static_cast<const float*>(q),
                    static_cast<const float*>(k),
                    static_cast<const float*>(v),
                    sb, sh, st, t, sm_scale,
                    rows_aligned16(q, k, v, sb, sh, st, hd), hd};
  const StoreF32 out{static_cast<float*>(o), sob, soh, sot};
  return launch_any(in, out, batch, n_head, static_cast<cudaStream_t>(stream));
}

// The same on bf16 q, k, v and o (strides in elements), o written in
// bf16; where hd is 64 the output's offsets are even from a 4-byte-aligned
// pointer. Rows are copied 16 bytes at a time where the pointers are
// 16-byte aligned and the strides (and a padded hd) multiples of 8, else
// an element at a time.
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int batch,
                                    int n_head, int t, int hd, long long sb,
                                    long long sh, long long st, long long sob,
                                    long long soh, long long sot,
                                    float sm_scale, void* stream) {
  if (batch < 1 || batch > 65535 || n_head < 1 || t < 1 || hd < 1 ||
      hd > MAX_HD ||
      (hd == 64 && ((sob | soh | sot) % 2 != 0 ||
                    reinterpret_cast<uintptr_t>(o) % 4 != 0)))
    return cudaErrorInvalidValue;
  const OperandsT<__nv_bfloat16> in{
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), sb, sh, st, t, sm_scale,
      rows_aligned16<__nv_bfloat16>(q, k, v, sb, sh, st, hd), hd};
  const StoreBF16 out{static_cast<__nv_bfloat16*>(o), sob, soh, sot};
  return launch_any(in, out, batch, n_head, static_cast<cudaStream_t>(stream));
}
