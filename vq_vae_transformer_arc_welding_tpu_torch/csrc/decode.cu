// decode: one token of KV-cached sampling through a transformer block,
// the attention half (#12) or the whole block (#13).
//
// Replaces vq_vae_transformer_arc_welding_tpu/ops/pallas_decode.py:
//   fused_decode_attn  (pallas_call at :149, _decode_body):
//     h = LN1(x); q, k, v = h Wqkv + b; K/V row `pos` written in place;
//     y = softmax(q K[:pos+1]^T / sqrt(D)) V[:pos+1] per head;
//     x_mid = x + y Wproj + b.              caches (B, H, T, D)
//   fused_block_decode (pallas_call at :371, _block_decode_body):
//     the same, then x_out = x_mid + new_gelu(LN2(x_mid) Wfc + b) Wmp + b.
//                                           caches (B, T, C), time-major
// x is (B, 1, C): one row per stream.
//
// The TPU kernels run one program per sample, each streaming every
// weight of the block through VMEM. On an H100 this work is bound by
// bytes (12.6 MB of f32 weights and 2 B (pos + 1) C 4 bytes of cache per
// block and token at C = 512, against 0.1 GFLOP at B = 16), so the
// weights are read once by the whole card: the output columns of each
// product are split over the blocks, the (up to 16) activation rows lie
// in shared memory, and every block computes all rows for its columns.
// LayerNorm of 16 rows is cheap enough to redo in every block. The
// attention is one block per (sample, head) and reads only rows 0..pos
// of K and V. The stages depend on each other across the whole grid, so
// one TPU kernel becomes a sequence of launches on one stream inside one
// C entry: five for #13 (qkv, attention, c_proj, LN2 + c_fc + GELU,
// m_proj), the first three for #12. A cooperative kernel with grid-wide
// barriers would save the launches but needs every block resident at
// once, which the 128 KB of activations of the last product does not
// allow together with the attention's blocks; plain launches are also
// what a CUDA graph around the token loop can capture later.
// #12 and #13 differ only in the caches' layout, which the kernels take
// as strides, so both entries share every kernel of this file.
//
// What the TPU shaped and this port drops: the 128-row DMA chunks (any T
// is taken), the token row padded to 8 rows, the 8-row write-back window
// (only row `pos` of K and V is written; every other row stays as it
// was), and the bias folded into the product through a ones column (the
// bias is added after the sum). FMA contraction is allowed: the contract
// with the plain version is a tolerance, not bits.
#include "common.cuh"

namespace {

constexpr int ROWS = 16;          // activation rows per block
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int HD = 64;            // head width the attention is written for

enum Prologue { COPY, LAYER_NORM };
enum Epilogue { QKV, RESIDUAL, GELU };

// Row `pos` of K and V: element (b, h, pos, e) at b*sb + h*sh + pos*st + e.
struct CacheRow {
  float* k;
  float* v;
  long long sb, sh, st;
  int pos;
};

// out[row, col] = epilogue(sum_i act[row, i] * w[col, i] + bias[col]) for
// all `batch` rows (16 per block along grid.y) and the block's columns.
//   act = a (COPY) or LayerNorm(a) * ln_s + ln_b (LAYER_NORM), (batch, k);
//   w (n, k), torch's Linear layout, so a column's weights are contiguous.
//   QKV: n = 3C; columns < C go to out (batch, C), the next C to row `pos`
//        of the K cache, the last C to row `pos` of the V cache;
//   RESIDUAL: out (batch, n) = resid + (sum + bias);
//   GELU: out (batch, n) = new_gelu(sum + bias).
// A warp holds two columns and 16 rows of partial sums; `kw` warps share
// a column pair and split k between them, so a block of 8 warps computes
// 16 / kw columns. Their partial sums are added in a fixed order.
template <Prologue PRO, Epilogue EPI>
__global__ void __launch_bounds__(THREADS)
rows_gemm_kernel(const float* __restrict__ a, const float* __restrict__ ln_s,
                 const float* __restrict__ ln_b, const float* __restrict__ w,
                 const float* __restrict__ bias,
                 const float* __restrict__ resid, float* __restrict__ out,
                 CacheRow cache, int batch, int n, int k, int kw) {
  extern __shared__ float4 sm4[];
  float* act = reinterpret_cast<float*>(sm4);    // ROWS x k
  float* red = act + (size_t)ROWS * k;           // WARPS x 2 x ROWS
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = blockIdx.y * ROWS;

  for (int r = warp; r < ROWS; r += WARPS) {
    float* dst = act + (size_t)r * k;
    const int row = row0 + r;
    if (row >= batch) {
      for (int i = lane; i < k; i += 32) dst[i] = 0.0f;
      continue;
    }
    const float* src = a + (size_t)row * k;
    if (PRO == COPY) {
      for (int i = lane; i < k; i += 32) dst[i] = src[i];
    } else {
      float s = 0.0f;
      for (int i = lane; i < k; i += 32) s += src[i];
      const float mean = arcweld::warp_sum(s) / (float)k;
      float q = 0.0f;
      for (int i = lane; i < k; i += 32) {
        const float d = src[i] - mean;
        q += d * d;
      }
      const float var = arcweld::warp_sum(q) / (float)k;
      for (int i = lane; i < k; i += 32)
        dst[i] = arcweld::norm_affine(src[i], mean, var, ln_s[i], ln_b[i]);
    }
  }
  __syncthreads();

  const int pairs = WARPS / kw;                  // column pairs per block
  const int pair = warp / kw, part = warp % kw;
  const int k4 = k / 4, slice4 = k4 / kw;
  const int col0 = (blockIdx.x * pairs + pair) * 2;
  const float4* w0 =
      reinterpret_cast<const float4*>(w + (size_t)col0 * k) + part * slice4;
  const float4* w1 = w0 + k4;
  const float4* a4 = reinterpret_cast<const float4*>(act) + part * slice4;
  float acc0[ROWS], acc1[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc0[r] = acc1[r] = 0.0f;
  for (int i = lane; i < slice4; i += 32) {
    const float4 u = w0[i], v = w1[i];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float4 x = a4[r * k4 + i];
      acc0[r] += x.x * u.x + x.y * u.y + x.z * u.z + x.w * u.w;
      acc1[r] += x.x * v.x + x.y * v.y + x.z * v.z + x.w * v.w;
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    acc0[r] = arcweld::warp_sum(acc0[r]);
    acc1[r] = arcweld::warp_sum(acc1[r]);
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      red[(warp * 2 + 0) * ROWS + r] = acc0[r];
      red[(warp * 2 + 1) * ROWS + r] = acc1[r];
    }
  }
  __syncthreads();

  if (tid >= pairs * 2 * ROWS) return;
  const int p = tid / (2 * ROWS), j = (tid / ROWS) % 2, r = tid % ROWS;
  const int row = row0 + r;
  if (row >= batch) return;
  float sum = 0.0f;
  for (int i = 0; i < kw; ++i) sum += red[((p * kw + i) * 2 + j) * ROWS + r];
  const int col = (blockIdx.x * pairs + p) * 2 + j;
  const float y = sum + bias[col];
  if (EPI == QKV) {
    const int c = n / 3;
    if (col < c) {
      out[(size_t)row * c + col] = y;
    } else {
      const int cc = (col - c) % c;
      float* dst = col < 2 * c ? cache.k : cache.v;
      dst[row * cache.sb + (cc / HD) * cache.sh + cache.pos * cache.st +
          cc % HD] = y;
    }
  } else if (EPI == RESIDUAL) {
    out[(size_t)row * n + col] = resid[(size_t)row * n + col] + y;
  } else {
    out[(size_t)row * n + col] = arcweld::new_gelu(y);
  }
}

// max or sum over the block's 8 warps; `red` holds 8 floats
template <bool MAX>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  v = MAX ? arcweld::warp_max(v) : arcweld::warp_sum(v);
  __syncthreads();               // the previous use of red is over
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int i = 1; i < WARPS; ++i) r = MAX ? fmaxf(r, red[i]) : r + red[i];
  return r;
}

// One block per (head, sample): y[b, h*64 ..] = softmax(q . K[:pos+1]^T *
// sm_scale) V[:pos+1], reading only rows 0..pos of the caches. A half
// warp takes a key: 16 lanes x float4 are the key's 64 floats. q, y
// (batch, C).
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const float* __restrict__ q,
                        const float* __restrict__ kc,
                        const float* __restrict__ vc, long long sb,
                        long long sh, long long st, float* __restrict__ y,
                        int pos, int c, float sm_scale) {
  extern __shared__ float4 sm4[];
  float* part = reinterpret_cast<float*>(sm4);   // 16 x 64 partial outputs
  float* red = part + 16 * HD;                   // 8
  float* s = red + WARPS;                        // pos + 1 scores
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, hw = tid / 16, l = tid % 16;
  const long long base = b * sb + h * sh + 4 * l;
  const float4 qv =
      *reinterpret_cast<const float4*>(q + (size_t)b * c + h * HD + 4 * l);

  // every thread walks the same number of steps: the shuffles below
  // need all 32 lanes of a warp
  for (int j0 = 0; j0 <= pos; j0 += 16) {
    const int j = j0 + hw;
    float d = 0.0f;
    if (j <= pos) {
      const float4 kv = *reinterpret_cast<const float4*>(kc + base + j * st);
      d = qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
    if (j <= pos && l == 0) s[j] = d * sm_scale;
  }
  __syncthreads();
  float m = -INFINITY;
  for (int j = tid; j <= pos; j += THREADS) m = fmaxf(m, s[j]);
  m = block_reduce<true>(m, red);
  float sum = 0.0f;
  for (int j = tid; j <= pos; j += THREADS) {
    const float p = expf(s[j] - m);
    s[j] = p;
    sum += p;
  }
  sum = block_reduce<false>(sum, red);   // its barriers also publish s

  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int j = hw; j <= pos; j += 16) {
    const float p = s[j];
    const float4 vv = *reinterpret_cast<const float4*>(vc + base + j * st);
    acc.x += p * vv.x;
    acc.y += p * vv.y;
    acc.z += p * vv.z;
    acc.w += p * vv.w;
  }
  *reinterpret_cast<float4*>(part + hw * HD + 4 * l) = acc;
  __syncthreads();
  if (tid < HD) {
    float o = 0.0f;
#pragma unroll
    for (int g = 0; g < 16; ++g) o += part[g * HD + tid];
    y[(size_t)b * c + h * HD + tid] = o / sum;
  }
}

template <Prologue PRO, Epilogue EPI>
cudaError_t launch_rows_gemm(const float* a, const float* ln_s,
                             const float* ln_b, const float* w,
                             const float* bias, const float* resid, float* out,
                             CacheRow cache, int batch, int n, int k,
                             cudaStream_t s) {
  // enough blocks for the card's 132 SMs at C = 512: 192, 128, 128 and
  // 128 blocks for the four products of a block
  int kw = n >= 2048 ? 1 : n >= 1024 ? 2 : 4;
  while (kw > 1 && k % (4 * kw) != 0) kw /= 2;
  const int cols = 2 * (WARPS / kw);
  if (k % 4 != 0 || n % cols != 0) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)ROWS * k + WARPS * 2 * ROWS);
  cudaError_t e = cudaFuncSetAttribute(
      rows_gemm_kernel<PRO, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(n / cols, (batch + ROWS - 1) / ROWS);
  rows_gemm_kernel<PRO, EPI><<<grid, THREADS, smem, s>>>(
      a, ln_s, ln_b, w, bias, resid, out, cache, batch, n, k, kw);
  return cudaGetLastError();
}

// The attention half: q to scratch and the K/V row into the caches,
// attention over rows 0..pos, then x_mid = x + y Wproj + b.
cudaError_t launch_attn_half(const float* x, const float* ln1_s,
                             const float* ln1_b, const float* w_qkv,
                             const float* b_qkv, const float* w_proj,
                             const float* b_proj, CacheRow cache, float* q,
                             float* y, float* x_mid, int batch, int t, int c,
                             int n_head, float sm_scale, cudaStream_t s) {
  if (batch < 1 || c != n_head * HD || cache.pos < 0 || cache.pos >= t)
    return cudaErrorInvalidValue;
  cudaError_t e = launch_rows_gemm<LAYER_NORM, QKV>(
      x, ln1_s, ln1_b, w_qkv, b_qkv, nullptr, q, cache, batch, 3 * c, c, s);
  if (e != cudaSuccess) return e;
  const size_t smem =
      sizeof(float) * (16 * HD + WARPS + (size_t)cache.pos + 1);
  e = cudaFuncSetAttribute(decode_attention_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  decode_attention_kernel<<<dim3(n_head, batch), THREADS, smem, s>>>(
      q, cache.k, cache.v, cache.sb, cache.sh, cache.st, y, cache.pos, c,
      sm_scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return launch_rows_gemm<COPY, RESIDUAL>(y, nullptr, nullptr, w_proj, b_proj,
                                          x, x_mid, cache, batch, c, c, s);
}

inline const float* f(const void* p) { return static_cast<const float*>(p); }

}  // namespace

// Kernel #12. x (batch, C) f32; ln1_s, ln1_b (C,); w_qkv (3C, C), b_qkv
// (3C,), w_proj (C, C), b_proj (C,); kc, vc (batch, n_head, t, 64),
// row `pos` written in place; scratch 2 * batch * C floats; x_mid
// (batch, C). C = n_head * 64, 0 <= pos < t.
extern "C" int decode_attn_f32(const void* x, const void* ln1_s,
                               const void* ln1_b, const void* w_qkv,
                               const void* b_qkv, const void* w_proj,
                               const void* b_proj, void* kc, void* vc,
                               void* scratch, void* x_mid, int batch, int t,
                               int c, int n_head, int pos, float sm_scale,
                               void* stream) {
  float* q = static_cast<float*>(scratch);
  const CacheRow cache{static_cast<float*>(kc), static_cast<float*>(vc),
                       (long long)n_head * t * HD, (long long)t * HD, HD, pos};
  return launch_attn_half(f(x), f(ln1_s), f(ln1_b), f(w_qkv), f(b_qkv),
                          f(w_proj), f(b_proj), cache, q,
                          q + (size_t)batch * c, static_cast<float*>(x_mid),
                          batch, t, c, n_head, sm_scale,
                          static_cast<cudaStream_t>(stream));
}

// Kernel #13. As #12 with the caches (batch, t, C) time-major, then the
// MLP: ln2_s, ln2_b (C,); w_fc (c4, C), b_fc (c4,), w_mp (C, c4), b_mp
// (C,); scratch batch * (3 C + c4) floats; out (batch, C).
extern "C" int block_decode_f32(
    const void* x, const void* ln1_s, const void* ln1_b, const void* w_qkv,
    const void* b_qkv, const void* w_proj, const void* b_proj,
    const void* ln2_s, const void* ln2_b, const void* w_fc, const void* b_fc,
    const void* w_mp, const void* b_mp, void* kc, void* vc, void* scratch,
    void* out, int batch, int t, int c, int c4, int n_head, int pos,
    float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* q = static_cast<float*>(scratch);
  float* y = q + (size_t)batch * c;
  float* x_mid = y + (size_t)batch * c;
  float* g = x_mid + (size_t)batch * c;
  const CacheRow cache{static_cast<float*>(kc), static_cast<float*>(vc),
                       (long long)t * c, HD, c, pos};
  cudaError_t e = launch_attn_half(f(x), f(ln1_s), f(ln1_b), f(w_qkv),
                                   f(b_qkv), f(w_proj), f(b_proj), cache, q, y,
                                   x_mid, batch, t, c, n_head, sm_scale, s);
  if (e != cudaSuccess) return e;
  e = launch_rows_gemm<LAYER_NORM, GELU>(x_mid, f(ln2_s), f(ln2_b), f(w_fc),
                                         f(b_fc), nullptr, g, cache, batch, c4,
                                         c, s);
  if (e != cudaSuccess) return e;
  return launch_rows_gemm<COPY, RESIDUAL>(g, nullptr, nullptr, f(w_mp),
                                          f(b_mp), x_mid,
                                          static_cast<float*>(out), cache,
                                          batch, c, c4, s);
}
