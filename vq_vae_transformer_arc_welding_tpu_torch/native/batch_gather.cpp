// Threaded batch gather for the streaming training path.
//
// The reference's host-side input pipeline is torch DataLoader worker
// processes doing per-sample __getitem__ and collate. The streaming
// trainer (train/loop.py, Trainer(streaming=True)) keeps the dataset as
// one flat memory-mapped float32 region and gathers each micro-batch with
// one parallel row gather into a contiguous pinned buffer, which is then
// copied to the card without blocking: no per-sample Python, no worker
// processes. The port's own copy of the JAX package's
// native/batch_gather.cpp.
//
// C ABI for ctypes:
//   gather_rows_f32(src, row_elems, idx[n], n, out) -> n (or -1)
//     out[i*row_elems : (i+1)*row_elems] = src[idx[i]*row_elems : ...]

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>

extern "C" int64_t gather_rows_f32(const float* src, int64_t row_elems,
                                   const int64_t* idx, int64_t n_idx,
                                   float* out) {
  if (src == nullptr || idx == nullptr || out == nullptr ||
      row_elems <= 0 || n_idx < 0) {
    return -1;
  }
  const size_t row_bytes = static_cast<size_t>(row_elems) * sizeof(float);

  // small batches: the copy is memcpy-bound; threads only help once
  // there is real volume to move
  const int64_t rows_per_thread = 64;
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  int n_threads = static_cast<int>(
      std::min<int64_t>(hw > 0 ? hw : 1,
                        std::max<int64_t>(1, n_idx / rows_per_thread)));

  auto worker = [&](int64_t begin, int64_t end) {
    for (int64_t i = begin; i < end; ++i) {
      std::memcpy(out + i * row_elems, src + idx[i] * row_elems, row_bytes);
    }
  };

  if (n_threads <= 1) {
    worker(0, n_idx);
    return n_idx;
  }
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  const int64_t chunk = (n_idx + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    const int64_t b = t * chunk;
    const int64_t e = std::min<int64_t>(n_idx, b + chunk);
    if (b >= e) break;
    threads.emplace_back(worker, b, e);
  }
  for (auto& th : threads) th.join();
  return n_idx;
}
