// The port's native data-loader core, its own copy of the JAX package's
// dimsum_tpu/native/batch_gather.cpp: an mmap'd latent store with a
// multi-threaded row gather into one contiguous batch buffer.
//
// The reference's input pipeline is torch's multiprocess DataLoader over a
// np.memmap (datasets_prep/latent_datasets.py:31-51).  Here the hot path --
// gathering a shuffled batch of rows from a (N, *) fp32 memmap into one
// contiguous buffer, which the loader then copies to the card from pinned
// memory -- runs in C++ worker threads (no GIL, one sequential copy per
// row), called through ctypes by dimsum_torch/data/native.py, which builds
// this file with g++ at first use.
//
// API (C, stable):
//   bg_open(path, row_bytes)            -> handle (0 on failure)
//   bg_num_rows(handle)                 -> rows in the file
//   bg_gather(handle, idx*, n, out*, nthreads) -> 0 ok / -1 error
//   bg_close(handle)

#include <atomic>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Store {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t file_bytes = 0;
  size_t row_bytes = 0;
  int64_t rows = 0;
};

}  // namespace

extern "C" {

void* bg_open(const char* path, int64_t row_bytes) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  void* base = ::mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  ::madvise(base, st.st_size, MADV_RANDOM);
  auto* s = new Store;
  s->fd = fd;
  s->base = static_cast<const uint8_t*>(base);
  s->file_bytes = static_cast<size_t>(st.st_size);
  s->row_bytes = static_cast<size_t>(row_bytes);
  s->rows = static_cast<int64_t>(s->file_bytes / s->row_bytes);
  return s;
}

int64_t bg_num_rows(void* handle) {
  return handle ? static_cast<Store*>(handle)->rows : -1;
}

int bg_gather(void* handle, const int64_t* indices, int64_t n, uint8_t* out,
              int nthreads) {
  if (!handle) return -1;
  auto* s = static_cast<Store*>(handle);
  for (int64_t i = 0; i < n; ++i) {
    if (indices[i] < 0 || indices[i] >= s->rows) return -1;
  }
  if (nthreads < 1) nthreads = 1;
  if (nthreads > n) nthreads = static_cast<int>(n);
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1, std::memory_order_relaxed);
      if (i >= n) return;
      std::memcpy(out + static_cast<size_t>(i) * s->row_bytes,
                  s->base + static_cast<size_t>(indices[i]) * s->row_bytes,
                  s->row_bytes);
    }
  };
  if (nthreads == 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    threads.reserve(nthreads);
    for (int t = 0; t < nthreads; ++t) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
  }
  return 0;
}

void bg_close(void* handle) {
  if (!handle) return;
  auto* s = static_cast<Store*>(handle);
  ::munmap(const_cast<uint8_t*>(s->base), s->file_bytes);
  ::close(s->fd);
  delete s;
}

}  // extern "C"
