// Host copy rates behind scripts/host_copy_rates.py: each function moves
// `bytes` with T threads (one contiguous share each) and returns seconds.
//   t_pread   pread from a file in calls of at most `chunk` bytes
//   t_mmap    memcpy out of a read-only shared mapping of the file
//   t_memcpy  memcpy between two buffers
#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <thread>
#include <unistd.h>
#include <vector>
extern "C" {
double t_pread(const char* path, char* buf, int64_t bytes, int T, int64_t chunk) {
  int fd = open(path, O_RDONLY);
  auto t0 = std::chrono::steady_clock::now();
  std::vector<std::thread> th;
  int64_t step = (bytes + T - 1) / T;
  for (int i = 0; i < T; ++i) th.emplace_back([&, i] {
    int64_t a = i * step, e = std::min(bytes, a + step);
    while (a < e) { ssize_t r = pread(fd, buf + a, std::min(chunk, e - a), a); if (r <= 0) break; a += r; }
  });
  for (auto& t : th) t.join();
  double s = std::chrono::duration<double>(std::chrono::steady_clock::now() - t0).count();
  close(fd);
  return s;
}
double t_mmap(const char* path, char* buf, int64_t bytes, int T) {
  int fd = open(path, O_RDONLY);
  char* m = (char*)mmap(nullptr, bytes, PROT_READ, MAP_SHARED, fd, 0);
  auto t0 = std::chrono::steady_clock::now();
  std::vector<std::thread> th;
  int64_t step = (bytes + T - 1) / T;
  for (int i = 0; i < T; ++i) th.emplace_back([&, i] {
    int64_t a = i * step, e = std::min(bytes, a + step);
    if (a < e) memcpy(buf + a, m + a, e - a);
  });
  for (auto& t : th) t.join();
  double s = std::chrono::duration<double>(std::chrono::steady_clock::now() - t0).count();
  munmap(m, bytes); close(fd);
  return s;
}
double t_memcpy(char* dst, const char* src, int64_t bytes, int T) {
  auto t0 = std::chrono::steady_clock::now();
  std::vector<std::thread> th;
  int64_t step = (bytes + T - 1) / T;
  for (int i = 0; i < T; ++i) th.emplace_back([&, i] {
    int64_t a = i * step, e = std::min(bytes, a + step);
    if (a < e) memcpy(dst + a, src + a, e - a);
  });
  for (auto& t : th) t.join();
  return std::chrono::duration<double>(std::chrono::steady_clock::now() - t0).count();
}
unsigned hw() { return std::thread::hardware_concurrency(); }
}
