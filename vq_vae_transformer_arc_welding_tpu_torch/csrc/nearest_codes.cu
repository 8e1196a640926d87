// nearest_codes_f32: nearest codebook row of every latent row.
//
// Replaces vq_vae_transformer_arc_welding_tpu/ops/pallas_vq.py::
// nearest_codes_pallas (pallas_call at :59): z (N, D) f32 and the
// (K, D) codebook -> (N,) int32, the first index among the minima of
// d = sum e^2 - 2 z.e (the row-constant sum z^2 is left out, as in the
// TPU kernel). The (N, K) distances never reach device memory.
//
// What bounds it on an H100: at N = 25,600, K = 256, D = 32 it is 0.42
// GFLOP of FP32 FMAs over 3.4 MB, 6.3 us at 67 TFLOP/s. Beside the FMAs,
// the codebook's shared-memory reads: a 16-byte read of a warp costs the
// SM's shared memory about four cycles whether or not its lanes read
// the same address, so that one thread per row, reading four codebook
// floats for four FMAs (the first version), spends four times the FMAs'
// time on the reads.
//
// Per code the arithmetic is fixed: z.e as FMAs in index order over D
// padded with zeros to DP (8, 16, 32, 64, 128 or 256; exact zeros added),
// sum e^2 as rounded products added in index order, d = esq + (-2 x
// cross) with one rounding each. So every layout of the work gives the
// same ids.
//
// Design: a lane holds rows_of(DP) rows of z in registers (4, 2 at D = 64, 1
// at D = 128; at D = 256 the row sits in shared memory),
// so that each codebook float it reads feeds that many FMAs; LANES = 4 lanes
// share the rows, lane l scanning the codes l, l + 4, ... with d < best (the
// first index among its equal minima), and a shuffle reduction over the 4 lanes
// then keeps, per row, the smaller d and, on equal d, the smaller index: the
// first index among the row's minima. A row whose distances are none finite
// keeps code 0, as a scan from 0 with best = +inf does. The grid is persistent,
// one block an SM: the rows are shared out evenly (at 25,600 rows 115 blocks of
// 224 threads and 224 rows, each block's rows in one pass), and each block
// loads the codebook once and computes its K norms, its first rows of z on
// their way meanwhile (16-byte loads of both where D allows). The codebook sits
// in shared memory in rows of DP + 4 floats where that fits, so that the 4
// codes a warp reads at once lie on distinct banks; the rows of a warp read the
// same codes (broadcasts).
//
// A codebook that does not fit (K (DP + 5) x 4 bytes above 227 KB: K above
// 830 at D = 64, above 437 at D = 128, any at D = 256) streams through shared
// memory (`nearest_codes_chunked`): chunks of as many codes as two fit beside
// z, double-buffered by cp.async, each chunk's norms computed as it lands, the
// chunks scanned in increasing order with d < best and the lane rule unchanged,
// so that the first index among equal minima survives a chunk boundary. A
// codebook that fits (the bench model's K = 256, D = 32 among them) runs the
// resident kernel as before.
#include <mutex>

#include "common.cuh"

namespace {

constexpr int LANES = 4;          // lanes sharing a group of rows
constexpr int MAX_THREADS = 1024;
constexpr int BLOCKS_PER_SM = 1;  // blocks an SM, each with its codebook
constexpr size_t MAX_SMEM = 227 * 1024;
static_assert(32 % LANES == 0, "a row group's lanes lie in one warp");

// rows of z a lane holds: its registers hold 4 rows up to D = 32
__host__ __device__ constexpr int rows_of(int dp) {
  return dp <= 32 ? 4 : dp <= 64 ? 2 : 1;
}

// the codebook's row stride in shared memory: DP + 4 floats where the
// padded rows fit, DP otherwise (the limit the kernel has always had)
template <int DP>
int stride_for(int k_codes) {
  return (size_t)k_codes * (DP + 5) * sizeof(float) <= MAX_SMEM ? DP + 4
                                                                 : DP;
}

// rows first .. first + R - 1 of z into registers, zeros past n_rows and
// past d_emb; 16-byte loads where `vec` (d_emb a multiple of 4, z
// aligned)
template <int DP, int R>
__device__ __forceinline__ void load_rows(float (&zr)[R][DP],
                                          const float* __restrict__ z,
                                          int first, int n_rows, int d_emb,
                                          bool vec) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool live = first + r < n_rows;
    const float* row = z + (size_t)(first + r) * d_emb;
    if (vec) {
#pragma unroll
      for (int q = 0; q < DP / 4; ++q) {
        const float4 v = live && 4 * q < d_emb
                             ? *reinterpret_cast<const float4*>(row + 4 * q)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
        zr[r][4 * q] = v.x;
        zr[r][4 * q + 1] = v.y;
        zr[r][4 * q + 2] = v.z;
        zr[r][4 * q + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int dd = 0; dd < DP; ++dd)
        zr[r][dd] = live && dd < d_emb ? row[dd] : 0.0f;
    }
  }
}

template <int DP>
__global__ void nearest_codes_kernel(const float* __restrict__ z,
                     const float* __restrict__ codebook,
                     int* __restrict__ ids, int n_rows, int d_emb,
                     int k_codes, int stride) {
  extern __shared__ float4 smem4[];
  float* cb_s = reinterpret_cast<float*>(smem4);   // K x stride
  float* esq_s = cb_s + k_codes * stride;           // K
  const int tid = threadIdx.x, threads = blockDim.x;
  constexpr int R = rows_of(DP);
  const int lane = tid % LANES, rows = threads / LANES * R;
  // the block's first rows of z are on their way while the codebook comes
  const bool vec =
      d_emb % 4 == 0 && reinterpret_cast<uintptr_t>(z) % 16 == 0;
  float zr[R][DP];
  load_rows(zr, z, blockIdx.x * rows + tid / LANES * R, n_rows, d_emb, vec);
  if (d_emb % 4 == 0 && stride % 4 == 0 &&
      reinterpret_cast<uintptr_t>(codebook) % 16 == 0) {
    // four loads in flight a thread before their stores
    const int q4 = d_emb / 4;
    const float4* cb4 = reinterpret_cast<const float4*>(codebook);
    for (int i0 = tid; i0 < k_codes * q4; i0 += 4 * threads) {
      float4 e[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * threads;
        if (i < k_codes * q4) e[u] = cb4[i];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * threads;
        if (i < k_codes * q4)
          *reinterpret_cast<float4*>(cb_s + (i / q4) * stride + 4 * (i % q4)) =
              e[u];
      }
    }
    const int pad = stride - d_emb;
    for (int i = tid; i < k_codes * pad; i += threads)
      cb_s[(i / pad) * stride + d_emb + i % pad] = 0.0f;
  } else {
    for (int i = tid; i < k_codes * stride; i += threads) {
      const int dd = i % stride;
      cb_s[i] = dd < d_emb ? codebook[(size_t)(i / stride) * d_emb + dd]
                           : 0.0f;
    }
  }
  __syncthreads();
  for (int k = tid; k < k_codes; k += threads) {
    float s = 0.0f;
    for (int dd = 0; dd < d_emb; ++dd) {
      const float e = cb_s[k * stride + dd];
      s = __fadd_rn(s, __fmul_rn(e, e));
    }
    esq_s[k] = s;
  }
  __syncthreads();

  for (int row0 = blockIdx.x * rows; row0 < n_rows;
       row0 += gridDim.x * rows) {
    const int first = row0 + tid / LANES * R;
    if (row0 != (int)blockIdx.x * rows)
      load_rows(zr, z, first, n_rows, d_emb, vec);
    float best[R];
    int best_k[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      best[r] = INFINITY;
      best_k[r] = 0;
    }
#pragma unroll 2
    for (int k = lane; k < k_codes; k += LANES) {
      const float4* e4 = reinterpret_cast<const float4*>(cb_s + k * stride);
      float cross[R];
#pragma unroll
      for (int r = 0; r < R; ++r) cross[r] = 0.0f;
#pragma unroll
      for (int q = 0; q < DP / 4; ++q) {
        const float4 e = e4[q];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          cross[r] = fmaf(zr[r][4 * q + 0], e.x, cross[r]);
          cross[r] = fmaf(zr[r][4 * q + 1], e.y, cross[r]);
          cross[r] = fmaf(zr[r][4 * q + 2], e.z, cross[r]);
          cross[r] = fmaf(zr[r][4 * q + 3], e.w, cross[r]);
        }
      }
      const float esq = esq_s[k];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float dist = __fadd_rn(esq, __fmul_rn(-2.0f, cross[r]));
        if (dist < best[r]) {
          best[r] = dist;
          best_k[r] = k;
        }
      }
    }
    // a row group's lanes are LANES neighbours of one warp
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int o = 1; o < LANES; o <<= 1) {
        const float od = __shfl_xor_sync(0xffffffffu, best[r], o);
        const int ok = __shfl_xor_sync(0xffffffffu, best_k[r], o);
        if (od < best[r] || (od == best[r] && ok < best_k[r])) {
          best[r] = od;
          best_k[r] = ok;
        }
      }
      if (lane == r % LANES && first + r < n_rows) ids[first + r] = best_k[r];
    }
  }
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group %0;\n" ::"n"(N)
               : "memory");
}

// the floats of the chunked kernel's two chunk buffers and their norms,
// rounded up so that z's rows after them start on 16 bytes
__host__ __device__ constexpr int chunk_floats(int chunk, int pitch) {
  return (2 * chunk * (pitch + 1) + 3) / 4 * 4;
}

// The codebook in chunks of `chunk` codes (rows of DP + 4 floats), two
// buffers: chunk c + 1 is on its way by cp.async while chunk c's norms
// are made and its codes scanned. ZS (DP = 256): z's row of a row group
// in shared memory (rows of DP + 4 after the buffers) in place of
// registers. The rows, lanes, arithmetic and reduction are the
// resident kernel's.
template <int DP>
__global__ void nearest_codes_chunked(const float* __restrict__ z,
                                      const float* __restrict__ codebook,
                                      int* __restrict__ ids, int n_rows,
                                      int d_emb, int k_codes, int chunk) {
  constexpr int PITCH = DP + 4;
  constexpr bool ZS = DP > 128;
  constexpr int R = ZS ? 1 : rows_of(DP);
  extern __shared__ float4 smem4[];
  float* const sm = reinterpret_cast<float*>(smem4);
  float* const z_s = sm + chunk_floats(chunk, PITCH);
  const int tid = threadIdx.x, threads = blockDim.x;
  const int lane = tid % LANES, rows = threads / LANES * R;
  const bool vec_z =
      d_emb % 4 == 0 && reinterpret_cast<uintptr_t>(z) % 16 == 0;
  const bool vec_cb =
      d_emb % 4 == 0 && reinterpret_cast<uintptr_t>(codebook) % 16 == 0;
  // the columns past d_emb stay zero: the copies write below d_emb only
  const int pad = DP - d_emb;
  for (int i = tid; i < 2 * chunk * pad; i += threads)
    sm[(i / pad) * PITCH + d_emb + i % pad] = 0.0f;
  // codes c0 .. c0 + chunk - 1 (those below k_codes) into buffer b
  auto issue = [&](int c0, int b) {
    float* cb = sm + b * chunk * PITCH;
    const int kc = k_codes - c0 < chunk ? k_codes - c0 : chunk;
    const float* src = codebook + (size_t)c0 * d_emb;
    if (vec_cb) {
      const int q4 = d_emb / 4;
      for (int i = tid; i < kc * q4; i += threads)
        cp_async16(cb + (i / q4) * PITCH + 4 * (i % q4), src + 4 * i);
    } else {
      for (int i = tid; i < kc * d_emb; i += threads)
        cp_async4(cb + (i / d_emb) * PITCH + i % d_emb, src + i);
    }
  };
  float zr[R][ZS ? 4 : DP];
  for (int row0 = blockIdx.x * rows; row0 < n_rows;
       row0 += gridDim.x * rows) {
    const int first = row0 + tid / LANES * R;
    const float* zrow = z_s + (tid / LANES) * PITCH;
    if constexpr (ZS) {
      // the row group's LANES threads write its row and read only it
      for (int dd = lane; dd < DP; dd += LANES)
        z_s[(tid / LANES) * PITCH + dd] =
            first < n_rows && dd < d_emb ? z[(size_t)first * d_emb + dd]
                                         : 0.0f;
    } else {
      load_rows(zr, z, first, n_rows, d_emb, vec_z);
    }
    float best[R];
    int best_k[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      best[r] = INFINITY;
      best_k[r] = 0;
    }
    issue(0, 0);
    for (int c = 0, c0 = 0; c0 < k_codes; ++c, c0 += chunk) {
      if (c0 + chunk < k_codes) {
        cp_async_wait<0>();        // chunk c (the only group) has landed
        __syncthreads();           // for every thread's copies
        issue(c0 + chunk, (c + 1) & 1);
      } else {
        cp_async_wait<0>();
        __syncthreads();
      }
      const float* cb = sm + (c & 1) * chunk * PITCH;
      float* esq = sm + 2 * chunk * PITCH + (c & 1) * chunk;
      const int kc = k_codes - c0 < chunk ? k_codes - c0 : chunk;
      for (int k = tid; k < kc; k += threads) {
        float s = 0.0f;
        for (int dd = 0; dd < d_emb; ++dd) {
          const float e = cb[k * PITCH + dd];
          s = __fadd_rn(s, __fmul_rn(e, e));
        }
        esq[k] = s;
      }
      __syncthreads();  // the chunk's norms are complete
#pragma unroll 2
      for (int k = lane; k < kc; k += LANES) {
        const float4* e4 = reinterpret_cast<const float4*>(cb + k * PITCH);
        float cross[R];
#pragma unroll
        for (int r = 0; r < R; ++r) cross[r] = 0.0f;
        if constexpr (ZS) {
          const float4* z4 = reinterpret_cast<const float4*>(zrow);
#pragma unroll 8
          for (int q = 0; q < DP / 4; ++q) {
            const float4 e = e4[q], zv = z4[q];
            cross[0] = fmaf(zv.x, e.x, cross[0]);
            cross[0] = fmaf(zv.y, e.y, cross[0]);
            cross[0] = fmaf(zv.z, e.z, cross[0]);
            cross[0] = fmaf(zv.w, e.w, cross[0]);
          }
        } else {
#pragma unroll
          for (int q = 0; q < DP / 4; ++q) {
            const float4 e = e4[q];
#pragma unroll
            for (int r = 0; r < R; ++r) {
              cross[r] = fmaf(zr[r][4 * q + 0], e.x, cross[r]);
              cross[r] = fmaf(zr[r][4 * q + 1], e.y, cross[r]);
              cross[r] = fmaf(zr[r][4 * q + 2], e.z, cross[r]);
              cross[r] = fmaf(zr[r][4 * q + 3], e.w, cross[r]);
            }
          }
        }
        const float es = esq[k];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float dist = __fadd_rn(es, __fmul_rn(-2.0f, cross[r]));
          if (dist < best[r]) {
            best[r] = dist;
            best_k[r] = c0 + k;
          }
        }
      }
      // chunk c's buffer is read before chunk c + 2 is issued into it
      // (after the next chunk's wait and barrier), and its norms before
      // chunk c + 2's are written
    }
    // a row group's lanes are LANES neighbours of one warp
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int o = 1; o < LANES; o <<= 1) {
        const float od = __shfl_xor_sync(0xffffffffu, best[r], o);
        const int ok = __shfl_xor_sync(0xffffffffu, best_k[r], o);
        if (od < best[r] || (od == best[r] && ok < best_k[r])) {
          best[r] = od;
          best_k[r] = ok;
        }
      }
      if (lane == r % LANES && first + r < n_rows) ids[first + r] = best_k[r];
    }
    __syncthreads();  // the last chunk and z_s are read: the next pass
  }
}

// per device and kernel: the SM count and the threads a block may have,
// asked once, and the dynamic shared memory the kernel may use, raised
// as a call needs more (the host's share of a call stays small)
template <auto Kernel>
cudaError_t device_limits(size_t smem, int* sms, int* max_threads) {
  constexpr int MAX_DEVICES = 64;
  static std::once_flag once[MAX_DEVICES];
  static int sm_count[MAX_DEVICES], threads[MAX_DEVICES];
  static int attr_smem[MAX_DEVICES];
  static cudaError_t err[MAX_DEVICES];
  static std::mutex mu;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::call_once(once[dev], [dev] {
    cudaFuncAttributes fa = {};
    attr_smem[dev] = -1;
    err[dev] = cudaDeviceGetAttribute(&sm_count[dev],
                                      cudaDevAttrMultiProcessorCount, dev);
    if (err[dev] == cudaSuccess)
      err[dev] = cudaFuncGetAttributes(&fa, Kernel);
    const int most = fa.maxThreadsPerBlock < MAX_THREADS
                         ? fa.maxThreadsPerBlock
                         : MAX_THREADS;
    threads[dev] = most - most % 32;
  });
  if (err[dev] != cudaSuccess) return err[dev];
  {
    // only ever raised, so that a call never lowers what another needs
    std::lock_guard<std::mutex> lock(mu);
    if ((int)smem > attr_smem[dev]) {
      e = cudaFuncSetAttribute(Kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
      if (e != cudaSuccess) return e;
      attr_smem[dev] = (int)smem;
    }
  }
  *sms = sm_count[dev];
  *max_threads = threads[dev];
  return cudaSuccess;
}

template <int DP>
cudaError_t launch(const float* z, const float* codebook, int* ids,
                   int n_rows, int d_emb, int k_codes, cudaStream_t stream) {
  const int stride = stride_for<DP>(k_codes);
  const size_t smem = sizeof(float) * (size_t)k_codes * (stride + 1);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  int sms, max_threads;
  const cudaError_t e =
      device_limits<nearest_codes_kernel<DP>>(smem, &sms, &max_threads);
  if (e != cudaSuccess) return e;
  // the rows shared out evenly over one block an SM, a block's rows in
  // one pass where it holds that many threads
  constexpr int R = rows_of(DP);
  const int blocks = sms * BLOCKS_PER_SM;
  const int per_block = (n_rows + blocks - 1) / blocks;
  int threads = ((per_block + R - 1) / R * LANES + 31) / 32 * 32;
  if (threads > max_threads) threads = max_threads;
  const int rows = threads / LANES * R;
  const int grid = (n_rows + rows - 1) / rows < blocks
                       ? (n_rows + rows - 1) / rows
                       : blocks;
  nearest_codes_kernel<DP><<<grid, threads, smem, stream>>>(
      z, codebook, ids, n_rows, d_emb, k_codes, stride);
  return cudaGetLastError();
}

// codes a chunk, z's rows beside two chunks where ZS
template <int DP>
int chunk_for(int threads) {
  constexpr int PITCH = DP + 4;
  const int zs = DP > 128 ? threads / LANES * PITCH : 0;
  return (int)((MAX_SMEM / sizeof(float) - zs - 4) / (2 * (PITCH + 1)));
}

template <int DP>
cudaError_t launch_chunked(const float* z, const float* codebook, int* ids,
                           int n_rows, int d_emb, int k_codes,
                           cudaStream_t stream) {
  constexpr int PITCH = DP + 4;
  constexpr bool ZS = DP > 128;
  constexpr int R = ZS ? 1 : rows_of(DP);
  // z's rows in shared memory take 1 KB a row group: at most 256 threads
  constexpr int MOST = ZS ? 256 : MAX_THREADS;
  int sms, max_threads;
  cudaError_t e = device_limits<nearest_codes_chunked<DP>>(MAX_SMEM, &sms,
                                                          &max_threads);
  if (e != cudaSuccess) return e;
  const int blocks = sms * BLOCKS_PER_SM;
  const int per_block = (n_rows + blocks - 1) / blocks;
  int threads = ((per_block + R - 1) / R * LANES + 31) / 32 * 32;
  if (threads > max_threads) threads = max_threads;
  if (threads > MOST) threads = MOST;
  const int rows = threads / LANES * R;
  const int grid = (n_rows + rows - 1) / rows < blocks
                       ? (n_rows + rows - 1) / rows
                       : blocks;
  int chunk = chunk_for<DP>(threads);
  if (chunk > k_codes) chunk = k_codes;
  if (chunk < 1) return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)chunk_floats(chunk, PITCH) +
                       (ZS ? (size_t)threads / LANES * PITCH : 0));
  nearest_codes_chunked<DP><<<grid, threads, smem, stream>>>(
      z, codebook, ids, n_rows, d_emb, k_codes, chunk);
  return cudaGetLastError();
}

// the resident kernel where the codebook fits, else the chunked one
template <int DP>
cudaError_t dispatch(const float* z, const float* codebook, int* ids,
                     int n_rows, int d_emb, int k_codes, cudaStream_t stream) {
  if constexpr (DP <= 128) {
    if ((size_t)k_codes * (DP + 1) * sizeof(float) <= MAX_SMEM)
      return launch<DP>(z, codebook, ids, n_rows, d_emb, k_codes, stream);
  }
  return launch_chunked<DP>(z, codebook, ids, n_rows, d_emb, k_codes,
                            stream);
}

}  // namespace

// z (N, d_emb), codebook (K, d_emb): any K, d_emb from 1 to 256
extern "C" int nearest_codes_f32(const void* z, const void* codebook,
                                 void* ids, int n_rows, int d_emb,
                                 int k_codes, void* stream) {
  const float* zf = static_cast<const float*>(z);
  const float* cb = static_cast<const float*>(codebook);
  int* out = static_cast<int*>(ids);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d_emb < 1 || k_codes < 1 || n_rows < 1) return cudaErrorInvalidValue;
  if (d_emb <= 8) return dispatch<8>(zf, cb, out, n_rows, d_emb, k_codes, s);
  if (d_emb <= 16)
    return dispatch<16>(zf, cb, out, n_rows, d_emb, k_codes, s);
  if (d_emb <= 32)
    return dispatch<32>(zf, cb, out, n_rows, d_emb, k_codes, s);
  if (d_emb <= 64)
    return dispatch<64>(zf, cb, out, n_rows, d_emb, k_codes, s);
  if (d_emb <= 128)
    return dispatch<128>(zf, cb, out, n_rows, d_emb, k_codes, s);
  if (d_emb <= 256)
    return dispatch<256>(zf, cb, out, n_rows, d_emb, k_codes, s);
  return cudaErrorInvalidValue;
}
