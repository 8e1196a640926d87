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
// (attention_tc.cuh); wider heads, up to 4,096, on its wide tile, a
// block for each 128 output columns, launched in clusters of 2, 4 or 8
// (cudaLaunchKernelEx) that form each stage's scores once and share them
// through distributed shared memory. flash_attention_cluster reads back
// the cluster size of an entry's last launch.
//
// What bounds it on an H100 at the bench shape: operations, 4.2 GFLOP of
// FP32 score FMAs (0.063 ms) and 3 x 4.2 GFLOP of TF32 products (0.026
// ms), against 210 MB of q, k, v and output (0.063 ms). The score loop
// reads nine floats of shared memory for every sixteen FMAs, so shared
// memory, not the FP32 units, sets its pace.
//
// bf16 operands (flash_attention_bf16): the JAX kernel reads q, k and v in
// the caller's dtype, computes in f32 and writes q's dtype. That form has
// a tile of its own, attention_bf16.cuh: 64 query rows a block, Q K^T and
// P@V as bf16 mma.sync products with f32 sums (a product of two bf16
// values is exact in f32; P, which is f32, in three bf16 terms), P kept
// in registers between the two, the softmax in f32 and the output y / l
// rounded to bf16 to nearest even, as JAX's astype rounds. Head widths up
// to 128 on its 16, 32, 64 and 128 instantiations, wider ones (up to
// 4,096) on its wide forms, a block for each 128 output columns in
// clusters (attention_bf16.cuh: up to 4 pieces the score tile split as
// the f32 tile's, from 5 whole chunks a block). At (16,
// 8, 321, 64) its bound is the 21 MB of q, k, v and the output (0.0063
// ms).
#include "attention_bf16.cuh"
#include "attention_tc.cuh"

namespace {

using namespace arcweld::attn_tc;
namespace attn_bf16 = arcweld::attn_bf16;

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

// __grid_constant__: the tile takes its operands by reference, which
// would otherwise copy the parameters to the stack
template <int HD, bool PAD>
__global__ void __launch_bounds__(THREADS, Shape<HD>::MIN_BLOCKS)
flash_attention_kernel(const __grid_constant__ Operands in,
                       const __grid_constant__ StoreF32 out) {
  causal_attention_tile<HD, PAD>(in, out);
}

template <int HD, bool PAD>
cudaError_t launch(const Operands& in, const StoreF32& out, int batch,
                   int n_head, cudaStream_t stream) {
  constexpr size_t SMEM = Shape<HD>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel<HD, PAD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (e != cudaSuccess) return e;
  flash_attention_kernel<HD, PAD>
      <<<grid(batch, n_head, in.t), THREADS, SMEM, stream>>>(in, out);
  return cudaGetLastError();
}

template <int N, bool QRES>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_wide_kernel(const __grid_constant__ Operands in,
                            const __grid_constant__ StoreF32 out) {
  causal_attention_tile_wide<N, QRES>(in, out);
}

template <int N, bool QRES>
cudaError_t launch_wide_at(const Operands& in, const StoreF32& out, int batch,
                           int n_head, cudaStream_t stream) {
  return arcweld::launch_cluster(flash_attention_wide_kernel<N, QRES>,
                                 wide_grid(batch, n_head, in.t, in.hd),
                                 THREADS, Wide<N, QRES>::SMEM, N, stream, in,
                                 out);
}

// the wide tile in clusters of wide_cluster(hd)
cudaError_t launch_wide(const Operands& in, const StoreF32& out, int batch,
                        int n_head, cudaStream_t stream) {
  switch (wide_cluster(in.hd)) {
    case 2:
      return launch_wide_at<2, true>(in, out, batch, n_head, stream);
    case 4:
      return launch_wide_at<4, true>(in, out, batch, n_head, stream);
    default:
      return wide_resident(in.hd)
                 ? launch_wide_at<8, true>(in, out, batch, n_head, stream)
                 : launch_wide_at<8, false>(in, out, batch, n_head, stream);
  }
}

// the cluster size of each entry's last launch (0: a narrow tile's, or
// none), read back by flash_attention_cluster
int last_cluster[2] = {0, 0};

template <int HD>
__global__ void __launch_bounds__(attn_bf16::THREADS,
                                  attn_bf16::Shape<HD>::MIN_BLOCKS)
flash_attention_bf16_kernel(const __grid_constant__ attn_bf16::Operands in,
                            const __grid_constant__ attn_bf16::Output out) {
  attn_bf16::causal_attention_bf16_tile<HD>(in, out);
}

template <int HD>
cudaError_t launch_bf16(const attn_bf16::Operands& in,
                        const attn_bf16::Output& out, int batch, int n_head,
                        cudaStream_t stream) {
  constexpr size_t SMEM = attn_bf16::Shape<HD>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_bf16_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (e != cudaSuccess) return e;
  flash_attention_bf16_kernel<HD>
      <<<attn_bf16::grid(batch, n_head, in.t), attn_bf16::THREADS, SMEM,
         stream>>>(in, out);
  return cudaGetLastError();
}

template <int N>
__global__ void __launch_bounds__(attn_bf16::THREADS, 1)
flash_attention_bf16_wide_kernel(
    const __grid_constant__ attn_bf16::Operands in,
    const __grid_constant__ attn_bf16::Output out) {
  attn_bf16::causal_attention_bf16_tile_wide<N>(in, out);
}

template <int N>
cudaError_t launch_bf16_wide_at(const attn_bf16::Operands& in,
                                const attn_bf16::Output& out, int batch,
                                int n_head, cudaStream_t stream) {
  return arcweld::launch_cluster(
      flash_attention_bf16_wide_kernel<N>,
      attn_bf16::wide_grid(batch, n_head, in.t, in.hd), attn_bf16::THREADS,
      attn_bf16::Wide<N>::SMEM, N, stream, in, out);
}

__global__ void __launch_bounds__(attn_bf16::THREADS, 1)
flash_attention_bf16_chunks_kernel(
    const __grid_constant__ attn_bf16::Operands in,
    const __grid_constant__ attn_bf16::Output out) {
  attn_bf16::causal_attention_bf16_tile_chunks(in, out);
}

// the bf16 wide tile in clusters of wide_cluster(hd): up to 4 pieces the
// blocks split the score tile, past them each takes whole chunks
cudaError_t launch_bf16_wide(const attn_bf16::Operands& in,
                             const attn_bf16::Output& out, int batch,
                             int n_head, cudaStream_t stream) {
  switch (attn_bf16::wide_cluster(in.hd)) {
    case 2:
      return launch_bf16_wide_at<2>(in, out, batch, n_head, stream);
    case 4:
      return launch_bf16_wide_at<4>(in, out, batch, n_head, stream);
    default:
      return arcweld::launch_cluster(
          flash_attention_bf16_chunks_kernel,
          attn_bf16::wide_grid(batch, n_head, in.t, in.hd),
          attn_bf16::THREADS,
          attn_bf16::Chunks::smem(attn_bf16::Chunks::seg(in.hd)),
          attn_bf16::Chunks::N, stream, in, out);
  }
}

}  // namespace

// q, k, v (batch, n_head, t, hd) f32, hd <= 4,096, read through the
// strides (sb, sh, st) in floats, the last axis contiguous; o written
// through (sob, soh, sot), even offsets from an 8-byte-aligned pointer
// where hd is 64 (every other width is written a float at a time).
// sm_scale: 1/sqrt(hd). Head width 64 runs the tile at 64; any other up
// to 128 on the smallest of 32, 64 and 128 that holds it, padded with
// zero columns; a wider one on the wide tile.
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* o, int batch, int n_head, int t,
                                   int hd, long long sb, long long sh,
                                   long long st, long long sob, long long soh,
                                   long long sot, float sm_scale,
                                   void* stream) {
  if (batch < 1 || batch > 65535 || n_head < 1 || t < 1 || hd < 1 ||
      hd > MAX_WIDE_HD ||
      (hd == 64 && ((sob | soh | sot) % 2 != 0 ||
                    reinterpret_cast<uintptr_t>(o) % 8 != 0)))
    return cudaErrorInvalidValue;
  const Operands in{static_cast<const float*>(q),
                    static_cast<const float*>(k),
                    static_cast<const float*>(v),
                    sb, sh, st, t, sm_scale,
                    rows_aligned16(q, k, v, sb, sh, st, hd), hd};
  const StoreF32 out{static_cast<float*>(o), sob, soh, sot};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  last_cluster[0] = 0;
  if (hd > MAX_HD) {
    const cudaError_t e = launch_wide(in, out, batch, n_head, s);
    if (e == cudaSuccess) last_cluster[0] = wide_cluster(hd);
    return e;
  }
  switch (padded_head(hd)) {
    case 32:
      return launch<32, true>(in, out, batch, n_head, s);
    case 64:
      return hd == 64 ? launch<64, false>(in, out, batch, n_head, s)
                      : launch<64, true>(in, out, batch, n_head, s);
    default:
      return launch<128, true>(in, out, batch, n_head, s);
  }
}

// The same on bf16 q, k, v and o (strides in elements), o written in
// bf16: the tile of attention_bf16.cuh at the smallest of 16, 32, 64 and
// 128 that holds hd, a wider hd (up to 4,096) on its wide tile. Rows are
// read 16 bytes at a time where the pointers are 16-byte aligned and the
// strides and hd multiples of 8, else an element at a time; o is written
// two elements at a time where hd and its offsets are even from a
// 4-byte-aligned pointer, else one.
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int batch,
                                    int n_head, int t, int hd, long long sb,
                                    long long sh, long long st, long long sob,
                                    long long soh, long long sot,
                                    float sm_scale, void* stream) {
  if (batch < 1 || batch > 65535 || n_head < 1 || t < 1 || hd < 1 ||
      hd > attn_bf16::MAX_WIDE_HD)
    return cudaErrorInvalidValue;
  const attn_bf16::Operands in{
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), sb, sh, st, t, sm_scale,
      attn_bf16::rows_aligned16(q, k, v, sb, sh, st, hd), hd};
  const attn_bf16::Output out{
      static_cast<__nv_bfloat16*>(o), sob, soh, sot,
      (hd | sob | soh | sot) % 2 == 0 &&
          reinterpret_cast<uintptr_t>(o) % 4 == 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  last_cluster[1] = 0;
  if (hd > attn_bf16::MAX_HD) {
    const cudaError_t e = launch_bf16_wide(in, out, batch, n_head, s);
    if (e == cudaSuccess) last_cluster[1] = attn_bf16::wide_cluster(hd);
    return e;
  }
  switch (attn_bf16::padded_head(hd)) {
    case 16:
      return launch_bf16<16>(in, out, batch, n_head, s);
    case 32:
      return launch_bf16<32>(in, out, batch, n_head, s);
    case 64:
      return launch_bf16<64>(in, out, batch, n_head, s);
    default:
      return launch_bf16<128>(in, out, batch, n_head, s);
  }
}

// the cluster size of the last launch of flash_attention_f32 (bf16 = 0)
// or flash_attention_bf16 (bf16 = 1): wide_cluster(hd) where the wide
// tile ran, else 0
extern "C" int flash_attention_cluster(int bf16) {
  return last_cluster[bf16 != 0];
}
