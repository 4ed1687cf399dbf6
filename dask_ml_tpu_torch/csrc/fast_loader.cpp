// Host-side data loader: multithreaded CSV -> float32 parser.
//
// A copy of the JAX package's native/fast_loader.cpp, with the same C
// interface (csv_dims, csv_parse_f32). It mmaps the file, splits it at
// newline boundaries into per-thread byte ranges, and parses rows into
// a caller-provided float32 buffer. Built with the host C++ compiler by
// dask_ml_tpu_torch/ops/_build.py and bound with ctypes in
// dask_ml_tpu_torch/io/native.py.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Mapped {
    const char* data = nullptr;
    size_t size = 0;
    int fd = -1;
    bool ok() const { return data != nullptr; }
};

Mapped map_file(const char* path) {
    Mapped m;
    m.fd = open(path, O_RDONLY);
    if (m.fd < 0) return m;
    struct stat st;
    if (fstat(m.fd, &st) != 0 || st.st_size == 0) {
        close(m.fd);
        m.fd = -1;
        return m;
    }
    void* p = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, m.fd, 0);
    if (p == MAP_FAILED) {
        close(m.fd);
        m.fd = -1;
        return m;
    }
    madvise(p, st.st_size, MADV_SEQUENTIAL);
    m.data = static_cast<const char*>(p);
    m.size = st.st_size;
    return m;
}

void unmap(Mapped& m) {
    if (m.data) munmap(const_cast<char*>(m.data), m.size);
    if (m.fd >= 0) close(m.fd);
}

// Count '\n'-terminated rows in [begin, end).
int64_t count_rows(const char* begin, const char* end) {
    int64_t n = 0;
    for (const char* p = begin; p < end; ++p)
        if (*p == '\n') ++n;
    if (end > begin && end[-1] != '\n') ++n;  // unterminated last row
    return n;
}

// Parse rows from [begin, end) into out (row-major, n_cols floats/row).
// Returns rows parsed, or -1 on malformed row (wrong column count).
int64_t parse_range(const char* begin, const char* end, int64_t n_cols,
                    float* out) {
    const char* p = begin;
    int64_t row = 0;
    while (p < end) {
        const char* line_end = static_cast<const char*>(
            memchr(p, '\n', end - p));
        if (!line_end) line_end = end;
        if (line_end > p) {  // skip empty lines
            int64_t col = 0;
            const char* q = p;
            while (q < line_end && col < n_cols) {
                char* next = nullptr;
                out[row * n_cols + col] = strtof(q, &next);
                if (next == q) return -1;  // not a number
                col++;
                q = next;
                while (q < line_end && (*q == ',' || *q == ' ' ||
                                        *q == '\t' || *q == '\r'))
                    ++q;
            }
            if (col != n_cols) return -1;
            ++row;
        }
        p = line_end + 1;
    }
    return row;
}

}  // namespace

extern "C" {

// Scan the file: returns row count, writes column count of the first row
// to *n_cols_out. Returns -1 on open failure, -2 on empty/invalid.
int64_t csv_dims(const char* path, int64_t* n_cols_out) {
    Mapped m = map_file(path);
    if (!m.ok()) return -1;
    // columns of first non-empty line = commas+1 (spaces also separate)
    const char* p = m.data;
    const char* end = m.data + m.size;
    while (p < end && *p == '\n') ++p;
    const char* line_end = static_cast<const char*>(
        memchr(p, '\n', end - p));
    if (!line_end) line_end = end;
    int64_t cols = 0;
    bool in_field = false;
    for (const char* q = p; q < line_end; ++q) {
        bool sep = (*q == ',' || *q == ' ' || *q == '\t' || *q == '\r');
        if (!sep && !in_field) { ++cols; in_field = true; }
        if (sep) in_field = false;
    }
    if (cols == 0) { unmap(m); return -2; }
    *n_cols_out = cols;
    int64_t rows = count_rows(p, end);
    unmap(m);
    return rows;
}

// Parse the whole file into out (preallocated n_rows*n_cols float32,
// row-major) using n_threads. Returns rows parsed, negative on error.
int64_t csv_parse_f32(const char* path, float* out, int64_t n_rows,
                      int64_t n_cols, int32_t n_threads) {
    Mapped m = map_file(path);
    if (!m.ok()) return -1;
    const char* begin = m.data;
    const char* end = m.data + m.size;
    if (n_threads < 1) n_threads = 1;
    if (n_threads > 64) n_threads = 64;

    // split into n_threads ranges aligned to newline boundaries
    std::vector<const char*> starts{begin};
    for (int t = 1; t < n_threads; ++t) {
        const char* guess = begin + (m.size * t) / n_threads;
        const char* nl = static_cast<const char*>(
            memchr(guess, '\n', end - guess));
        starts.push_back(nl ? nl + 1 : end);
    }
    starts.push_back(end);

    // row offsets per range (prefix counts) so threads write disjointly
    std::vector<int64_t> range_rows(n_threads);
    for (int t = 0; t < n_threads; ++t)
        range_rows[t] = count_rows(starts[t], starts[t + 1]);
    std::vector<int64_t> offsets(n_threads + 1, 0);
    for (int t = 0; t < n_threads; ++t)
        offsets[t + 1] = offsets[t] + range_rows[t];
    if (offsets[n_threads] > n_rows) {
        unmap(m);
        return -3;  // buffer too small
    }

    std::vector<int64_t> results(n_threads, 0);
    std::vector<std::thread> threads;
    for (int t = 0; t < n_threads; ++t) {
        threads.emplace_back([&, t] {
            results[t] = parse_range(starts[t], starts[t + 1], n_cols,
                                     out + offsets[t] * n_cols);
        });
    }
    for (auto& th : threads) th.join();
    unmap(m);
    int64_t total = 0;
    for (int t = 0; t < n_threads; ++t) {
        if (results[t] < 0) return -4;  // malformed row
        total += results[t];
    }
    return total;
}

}  // extern "C"
