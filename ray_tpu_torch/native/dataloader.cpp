// Native token data loader: the C++ input pipeline of the PyTorch port's
// training loop (ray_tpu_torch/train/dataloader.py).
//
// The port's own copy of native/dataloader/dataloader.cpp (the JAX
// package's loader), kept identical in behaviour so that the same file,
// seed and shard give the same batches in both:
// a memory-mapped binary token file is sliced into fixed-length windows,
// shuffled by a seeded Fisher-Yates permutation, gathered into dense
// [batch, seq+1] uint32 batches, and (optionally) double-buffered by a
// background thread so the host gather overlaps device compute.
//
// File format: a flat array of little-endian uint16 or uint32 token ids
// (the standard .bin corpus dump). Sharding for data parallelism is a
// (rank, world) stride over the shuffled window permutation.
//
// Exposed as a flat C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstring>
#include <cerrno>

#include <condition_variable>
#include <mutex>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Loader {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t file_bytes = 0;
  int dtype_bytes = 4;       // 2 (uint16) or 4 (uint32)
  uint64_t n_tokens = 0;
  uint64_t window = 0;       // tokens per sample (seq + 1)
  uint64_t n_windows = 0;
  std::vector<uint64_t> perm;

  // Prefetch state (one background gather in flight).
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv;
  std::vector<uint32_t> ready_buf;
  uint64_t cursor = 0;       // next permutation index to gather
  uint64_t batch = 0;
  uint64_t rank = 0, world_size = 1;
  bool buf_full = false;
  bool stop = false;
  bool prefetching = false;
};

inline uint32_t token_at(const Loader* L, uint64_t i) {
  if (L->dtype_bytes == 2) {
    uint16_t v;
    memcpy(&v, L->base + i * 2, 2);
    return v;
  }
  uint32_t v;
  memcpy(&v, L->base + i * 4, 4);
  return v;
}

// Gather one batch at permutation offset `start` (strided by the shard),
// returning rows actually filled (< batch only at epoch end).
uint64_t gather(Loader* L, uint64_t start, uint64_t batch, uint32_t* out) {
  uint64_t rows = 0;
  for (uint64_t b = 0; b < batch; b++) {
    uint64_t p = (start + b) * L->world_size + L->rank;
    if (p >= L->n_windows) break;
    uint64_t w = L->perm[p];
    const uint64_t off = w * L->window;
    uint32_t* dst = out + b * L->window;
    if (L->dtype_bytes == 4) {
      memcpy(dst, L->base + off * 4, L->window * 4);
    } else {
      for (uint64_t t = 0; t < L->window; t++) dst[t] = token_at(L, off + t);
    }
    rows++;
  }
  return rows;
}

void prefetch_loop(Loader* L) {
  std::unique_lock<std::mutex> lk(L->mu);
  while (!L->stop) {
    if (L->buf_full) {
      L->cv.wait(lk);
      continue;
    }
    uint64_t start = L->cursor;
    uint64_t batch = L->batch;
    lk.unlock();
    std::vector<uint32_t> buf(batch * L->window);
    uint64_t rows = gather(L, start, batch, buf.data());
    buf.resize(rows * L->window);
    lk.lock();
    if (L->stop) break;
    L->ready_buf = std::move(buf);
    L->buf_full = true;
    L->cursor += batch;
    L->cv.notify_all();
    if (rows == 0) {
      // Epoch exhausted: park until the consumer takes the empty
      // sentinel and stops this prefetch run.
      while (!L->stop && L->buf_full) L->cv.wait(lk);
    }
  }
}

}  // namespace

extern "C" {

// Open a token file. dtype_bytes: 2 or 4. window = seq_len + 1.
// Returns an opaque handle or null.
void* dl_open(const char* path, int dtype_bytes, uint64_t window) {
  if ((dtype_bytes != 2 && dtype_bytes != 4) || window == 0) return nullptr;
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size <= 0) { close(fd); return nullptr; }
  void* mem = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (mem == MAP_FAILED) { close(fd); return nullptr; }
  madvise(mem, st.st_size, MADV_WILLNEED);
  Loader* L = new Loader;
  L->fd = fd;
  L->base = static_cast<const uint8_t*>(mem);
  L->file_bytes = st.st_size;
  L->dtype_bytes = dtype_bytes;
  L->n_tokens = st.st_size / dtype_bytes;
  L->window = window;
  L->n_windows = L->n_tokens / window;
  L->perm.resize(L->n_windows);
  for (uint64_t i = 0; i < L->n_windows; i++) L->perm[i] = i;
  return L;
}

uint64_t dl_num_windows(void* handle) {
  return static_cast<Loader*>(handle)->n_windows;
}

// Seeded Fisher-Yates shuffle of the window permutation (one epoch).
// splitmix64 PRNG: deterministic across platforms. Refused (-EBUSY)
// while a prefetch thread is running: gather() reads perm unlocked.
int dl_shuffle(void* handle, uint64_t seed) {
  Loader* L = static_cast<Loader*>(handle);
  // Hold the mutex for the WHOLE shuffle: a concurrent
  // dl_prefetch_start (ctypes releases the GIL) then blocks here until
  // perm is consistent, instead of racing gather() against the swaps.
  std::lock_guard<std::mutex> lk(L->mu);
  if (L->prefetching) return -EBUSY;
  uint64_t x = seed + 0x9E3779B97F4A7C15ULL;
  auto next = [&x]() {
    x += 0x9E3779B97F4A7C15ULL;
    uint64_t z = x;
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return z ^ (z >> 31);
  };
  for (uint64_t i = L->n_windows; i > 1; i--) {
    uint64_t j = next() % i;
    std::swap(L->perm[i - 1], L->perm[j]);
  }
  return 0;
}

// Synchronous gather of `batch` windows starting at shard-local
// permutation offset `start`; fills out[batch * window] (uint32).
// Returns rows filled.
uint64_t dl_fill(void* handle, uint64_t start, uint64_t batch,
                 uint32_t* out) {
  return gather(static_cast<Loader*>(handle), start, batch, out);
}

// Configure the shard (data parallelism): this loader sees permutation
// entries rank, rank+world, rank+2*world, ... Refused (-EBUSY) while
// prefetching (gather() reads these unlocked).
int dl_set_shard(void* handle, uint64_t rank, uint64_t world_size) {
  Loader* L = static_cast<Loader*>(handle);
  std::lock_guard<std::mutex> lk(L->mu);
  if (L->prefetching) return -EBUSY;
  L->rank = rank;
  L->world_size = world_size ? world_size : 1;
  return 0;
}

// ---- background prefetch (double buffering) -------------------------
int dl_prefetch_start(void* handle, uint64_t batch) {
  Loader* L = static_cast<Loader*>(handle);
  std::lock_guard<std::mutex> lk(L->mu);
  if (L->prefetching) return -EBUSY;
  L->batch = batch;
  L->cursor = 0;
  L->buf_full = false;
  L->stop = false;
  L->prefetching = true;
  L->worker = std::thread(prefetch_loop, L);
  return 0;
}

// Blocks until the next prefetched batch is ready; copies it into
// out[batch * window] and wakes the worker for the next one.
// Returns rows filled (0 = epoch exhausted).
uint64_t dl_next(void* handle, uint32_t* out) {
  Loader* L = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv.wait(lk, [L] { return L->buf_full || L->stop; });
  if (L->stop) return 0;
  uint64_t rows = L->ready_buf.size() / L->window;
  memcpy(out, L->ready_buf.data(), L->ready_buf.size() * 4);
  L->buf_full = false;
  L->cv.notify_all();
  return rows;
}

void dl_prefetch_stop(void* handle) {
  Loader* L = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->stop = true;
    L->cv.notify_all();
  }
  if (L->worker.joinable()) L->worker.join();
  std::lock_guard<std::mutex> lk(L->mu);
  L->prefetching = false;
}

void dl_close(void* handle) {
  Loader* L = static_cast<Loader*>(handle);
  if (L->prefetching) dl_prefetch_stop(L);
  munmap(const_cast<uint8_t*>(L->base), L->file_bytes);
  close(L->fd);
  delete L;
}

}  // extern "C"
