// The hashing of the text vectorizers (feature_extraction/text.py), a host
// library with a plain C interface, loaded with ctypes.
//
// th_hash_tokens: a batch of tokens, UTF-8 bytes separated by one NUL byte
// (the caller checks that no token holds one), each hashed with signed
// MurmurHash3 x86_32 (seed 0, the hash of scikit-learn's FeatureHasher):
// its column abs(h) % n_features (h = -2^31 maps where scikit-learn maps
// it) and its sign, +1 for h >= 0 and -1 below. Tokens split across
// threads; each writes its own range, so the output is the same for any
// thread count.
//
// th_normalize_f32 / th_normalize_f64: scikit-learn's in-place row
// normalization of a CSR matrix (sklearn/utils/sparsefuncs_fast.pyx,
// _inplace_csr_row_normalize_l1 and _l2): a row's norm summed in double,
// in entry order, each entry divided by it in double; an all-zero row is
// left as it is. norm 1 is l1, 2 is l2.

#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline uint32_t rotl32(uint32_t x, int8_t r) {
  return (x << r) | (x >> (32 - r));
}

inline uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

// MurmurHash3_x86_32 (Austin Appleby's public-domain reference)
int32_t murmur3_32(const uint8_t* data, int64_t len, uint32_t seed) {
  const int64_t nblocks = len / 4;
  uint32_t h1 = seed;
  const uint32_t c1 = 0xcc9e2d51u;
  const uint32_t c2 = 0x1b873593u;
  for (int64_t i = 0; i < nblocks; ++i) {
    uint32_t k1;
    std::memcpy(&k1, data + 4 * i, 4);  // little-endian, as the reference
    k1 *= c1;
    k1 = rotl32(k1, 15);
    k1 *= c2;
    h1 ^= k1;
    h1 = rotl32(h1, 13);
    h1 = h1 * 5 + 0xe6546b64u;
  }
  const uint8_t* tail = data + nblocks * 4;
  uint32_t k1 = 0;
  switch (len & 3) {
    case 3: k1 ^= uint32_t(tail[2]) << 16; [[fallthrough]];
    case 2: k1 ^= uint32_t(tail[1]) << 8; [[fallthrough]];
    case 1:
      k1 ^= tail[0];
      k1 *= c1;
      k1 = rotl32(k1, 15);
      k1 *= c2;
      h1 ^= k1;
  }
  h1 ^= uint32_t(len);
  return int32_t(fmix32(h1));
}

template <typename T>
void normalize_rows(T* data, const int64_t* indptr, int64_t n_rows,
                    int norm) {
  for (int64_t i = 0; i < n_rows; ++i) {
    double sum = 0.0;
    for (int64_t j = indptr[i]; j < indptr[i + 1]; ++j) {
      if (norm == 1) {
        sum += std::fabs(double(data[j]));
      } else {
        const T sq = data[j] * data[j];  // in T, as the Cython loop
        sum += double(sq);
      }
    }
    if (sum == 0.0) continue;
    if (norm == 2) sum = std::sqrt(sum);
    for (int64_t j = indptr[i]; j < indptr[i + 1]; ++j)
      data[j] = T(double(data[j]) / sum);
  }
}

}  // namespace

extern "C" {

int32_t th_murmur3_32(const uint8_t* data, int64_t len, uint32_t seed) {
  return murmur3_32(data, len, seed);
}

// buf: n_tokens tokens separated by single NUL bytes (buf_len bytes in
// all); cols (n_tokens,) int32 and signs (n_tokens,) int8 are written.
// Returns the number of tokens found, n_tokens when the buffer is well
// formed.
int64_t th_hash_tokens(const uint8_t* buf, int64_t buf_len, int64_t n_tokens,
                       int64_t n_features, int32_t* cols, int8_t* signs,
                       int32_t n_threads) {
  if (n_tokens <= 0) return 0;
  // token starts, found once (a memchr walk)
  std::vector<int64_t> start(n_tokens + 1);
  int64_t t = 0, pos = 0;
  start[0] = 0;
  while (t < n_tokens) {
    const void* nul = std::memchr(buf + pos, 0, size_t(buf_len - pos));
    const int64_t end = nul ? static_cast<const uint8_t*>(nul) - buf : buf_len;
    ++t;
    start[t] = end + 1;
    pos = end + 1;
    if (!nul) break;
  }
  if (t != n_tokens || start[n_tokens] != buf_len + 1) return t;
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const int64_t len = start[i + 1] - 1 - start[i];
      const int32_t h = murmur3_32(buf + start[i], len, 0u);
      int64_t col;
      if (h == INT32_MIN) {
        col = (2147483647LL - (n_features - 1)) % n_features;
      } else {
        col = int64_t(h < 0 ? -h : h) % n_features;
      }
      cols[i] = int32_t(col);
      signs[i] = h >= 0 ? 1 : -1;
    }
  };
  int64_t nt = n_threads > 0 ? n_threads : 1;
  if (n_tokens < (1 << 16)) nt = 1;
  if (nt == 1) {
    work(0, n_tokens);
    return n_tokens;
  }
  std::vector<std::thread> pool;
  const int64_t step = (n_tokens + nt - 1) / nt;
  for (int64_t k = 0; k < nt; ++k) {
    const int64_t lo = k * step, hi = std::min(n_tokens, lo + step);
    if (lo < hi) pool.emplace_back(work, lo, hi);
  }
  for (auto& th : pool) th.join();
  return n_tokens;
}

void th_normalize_f32(float* data, const int64_t* indptr, int64_t n_rows,
                      int32_t norm) {
  normalize_rows(data, indptr, n_rows, norm);
}

void th_normalize_f64(double* data, const int64_t* indptr, int64_t n_rows,
                      int32_t norm) {
  normalize_rows(data, indptr, n_rows, norm);
}

}  // extern "C"
