// Native block reader for the port's out-of-core streams.
//
// The host half of dask_ml_tpu_torch/parallel/streaming.py's BlockStream
// on a sequential pass over a float32 np.memmap: br_next copies the next
// fixed-height block of rows of the backing file straight into the
// caller's buffer (the stream's pinned staging slot), split by rows over
// up to `threads` threads, so each block crosses host memory once. The
// reader maps the file read-only once and keeps the mapping until
// br_close, so a stream's later passes (br_rewind) copy through page
// tables that are already filled. Before each block the file's size is
// checked: a file cut short under the reader ends the pass with -1 (an
// IOError in Python) instead of a fault on the mapping's missing pages
// (a file cut while a block is being copied still faults, as a numpy
// memmap does).
//
// The C interface of the JAX package's native/block_reader.cpp, whose
// reader thread pread()s each block into a ring of its own, from which
// br_next copies it out: two copies a block. Here br_open's last
// argument is the copy's thread count where that one took the ring's
// depth, and br_rewind is new. The reader holds no buffer; its threads
// and mapping end with br_close.
//
// Built with the host C++ compiler by dask_ml_tpu_torch/ops/_build.py
// and bound with ctypes in dask_ml_tpu_torch/io/native.py:
//   void* br_open(path, offset, row_bytes, n_rows, block_rows, threads)
//   int64 br_next(handle, out_buf)   -> rows copied, 0 at end, -1 error
//   void  br_rewind(handle)          -> the next br_next reads block 0
//   void  br_close(handle)

#include <algorithm>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

// A thread copies at least this much of a block: below it, waking the
// thread costs more than the share of the copy it would take.
constexpr int64_t kMinShare = 1 << 20;

struct Reader {
  int fd = -1;
  char *map = nullptr;     // the mapping, from a page boundary
  size_t map_bytes = 0;
  int64_t head = 0;        // bytes from the mapping's start to row 0
  int64_t offset = 0;      // file offset of row 0
  int64_t row_bytes = 0;
  int64_t n_rows = 0;
  int64_t block_rows = 0;
  int64_t next = 0;        // the next block's index

  // The copy's helpers: helper i copies share i + 1 of each block (the
  // caller copies share 0). They live as long as the reader: starting
  // threads for every block cost more than the copy on the H100 host.
  std::vector<std::thread> helpers;
  std::mutex mu;
  std::condition_variable cv_go, cv_done;
  int64_t round = 0;       // bumped for each block's copy
  int64_t busy = 0;        // helpers still copying this round's shares
  bool stop = false;
  char *dst = nullptr;
  const char *src = nullptr;
  int64_t bytes = 0, step = 0;

  void help(int64_t share) {
    int64_t seen = 0;
    std::unique_lock<std::mutex> lk(mu);
    while (true) {
      cv_go.wait(lk, [&] { return stop || round != seen; });
      if (stop) return;
      seen = round;
      int64_t a = share * step;
      if (a < bytes) {
        char *d = dst;
        const char *s = src;
        int64_t n = std::min(step, bytes - a);
        lk.unlock();
        std::memcpy(d + a, s + a, (size_t)n);
        lk.lock();
      }
      if (--busy == 0) cv_done.notify_one();
    }
  }
};

}  // namespace

extern "C" {

void br_close(void *h);

void *br_open(const char *path, int64_t offset, int64_t row_bytes,
              int64_t n_rows, int64_t block_rows, int32_t threads) {
  if (offset < 0 || row_bytes <= 0 || n_rows <= 0 || block_rows <= 0)
    return nullptr;
  int fd = open(path, O_RDONLY | O_CLOEXEC);
  if (fd < 0) return nullptr;
  int64_t page = sysconf(_SC_PAGESIZE);
  int64_t base = offset / page * page;
  size_t bytes = (size_t)(offset - base + n_rows * row_bytes);
  void *m = mmap(nullptr, bytes, PROT_READ, MAP_SHARED, fd, base);
  if (m == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  auto *r = new Reader();
  r->fd = fd;
  r->map = static_cast<char *>(m);
  r->map_bytes = bytes;
  r->head = offset - base;
  r->offset = offset;
  r->row_bytes = row_bytes;
  r->n_rows = n_rows;
  r->block_rows = block_rows;
  try {
    for (int64_t i = 1; i < threads; ++i)
      r->helpers.emplace_back([r, i] { r->help(i); });
  } catch (...) {
    br_close(r);
    return nullptr;
  }
  return r;
}

int64_t br_next(void *h, char *out) {
  auto *r = static_cast<Reader *>(h);
  if (!r) return -1;
  int64_t lo = r->next * r->block_rows;
  if (lo >= r->n_rows) return 0;
  int64_t rows = std::min(r->block_rows, r->n_rows - lo);
  int64_t bytes = rows * r->row_bytes;
  struct stat st;
  if (fstat(r->fd, &st) != 0 ||
      st.st_size < r->offset + lo * r->row_bytes + bytes)
    return -1;
  const char *src = r->map + r->head + lo * r->row_bytes;
  int64_t t = (int64_t)r->helpers.size() + 1;
  int64_t step = std::max((bytes + t - 1) / t, kMinShare);
  if (step < bytes) {
    std::lock_guard<std::mutex> lk(r->mu);
    r->dst = out;
    r->src = src;
    r->bytes = bytes;
    r->step = step;
    r->busy = t - 1;
    ++r->round;
  }
  if (step < bytes) r->cv_go.notify_all();
  std::memcpy(out, src, (size_t)std::min(step, bytes));
  if (step < bytes) {
    std::unique_lock<std::mutex> lk(r->mu);
    r->cv_done.wait(lk, [&] { return r->busy == 0; });
  }
  ++r->next;
  return rows;
}

void br_rewind(void *h) {
  if (h) static_cast<Reader *>(h)->next = 0;
}

void br_close(void *h) {
  auto *r = static_cast<Reader *>(h);
  if (!r) return;
  {
    std::lock_guard<std::mutex> lk(r->mu);
    r->stop = true;
  }
  r->cv_go.notify_all();
  for (auto &th : r->helpers) th.join();
  munmap(r->map, r->map_bytes);
  close(r->fd);
  delete r;
}

}  // extern "C"
