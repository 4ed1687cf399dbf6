// Fused one-vs-rest GLM value and gradient: C problems in one read of X.
//
// Replaces dask_ml_tpu/ops/pallas_fused.py::fused_glm_multi_value_grad (the
// Pallas body _glm_multi_value_grad_kernel). For rows r < n_valid and
// classes c < C it computes
//   loss = sum_r sum_c pointwise(eta_rc, y_rc),  grad_c = sum_r resid_rc x_r,
// with eta_rc = x_r . B_c, y_rc = (code_r == c) built here from the integer
// class codes, and resid_rc = mean(eta_rc) - y_rc (glm_family.cuh).
//
// Bound on an H100: device memory at the main shape. X is read once
// (n d itemsize bytes) for 4 n d C flops: at C = 10 in f32 that is 10
// flops a byte. On the CUDA cores the two products were bound by shared
// memory loads, not by bytes; they now run on the tensor cores, for the
// resident kernel and its streamed flavour (kernels 4 and 7).
//
// The resident kernel (glm_multi_mma): one CTA of 16 warps per SM walks
// tiles of 64 rows. A tile's rows are copied by 16-byte cp.async into a
// ring of shared-memory buffers (the next copy lands while this one is
// computed), each row from its aligned start, so any d and an unaligned
// row take whole 16-byte copies (zero-filled past d, past n_valid and to
// the chunk's width). The classes go in groups of 16 (C = 10 pads to 16;
// 8 or fewer take one n8 tile), and each group walks all of the CTA's
// tiles, so X is read once per group and the gradient of a group stays
// in registers across tiles. Rows of up to 264 features are one chunk;
// per tile:
//   - eta = X_tile B^T: warp (h, p) takes rows 32 h .. 32 h + 31 (two m16
//     tiles) and the k-steps p, p + 8, ... of the chunk, each staged value
//     gathered and split once; B is split once per group (f32: into (big,
//     small) pairs in shared memory; bf16: into registers). The 8 k-parts'
//     partials go to shared memory and are added in order by the family
//     stage;
//   - the family stage, a thread per (row, class) on the CUDA cores,
//     writes the residual tile transposed (classes x rows) as the
//     gradient's A operand (split once, or rounded to bf16);
//   - the gradient resid^T X_tile: warp (h, q) takes rows 32 h .. 32 h +
//     31 and the n8 feature tiles q, q + 8, ... (up to five independent
//     accumulators) of the same staged copy; a tile's sums are added into
//     the warp's f32 sums by rounded adds (the tensor cores truncate).
// At the end of a group the two row halves' sums meet in shared memory
// and each word of the CTA's partial is written once. Wider rows are cut
// into chunks of 256 features and take two walks over (chunk, tile) per
// group, each through a ring (two buffers for f32, four for bf16):
// one for eta, B's fragments split once per chunk, each tile's eta sums
// over the chunks so far parked in rscr (a device scratch, a tile's sums
// read and written by the same threads), the last chunk's family stage
// parking the tile's residuals there in the shared tile's layout; then
// one for the gradient, each chunk's copy joined by the copy of its
// tile's residuals, the sums written out once per chunk. X is read twice
// there.
// f32 X takes the 3xTF32 split of tf32x3.cuh (mma.sync m16n8k8, about
// 2^-21 relative error a product, inside GLM_GRAD_RTOL = 1e-4); its
// staged row stride is 8 mod 32 floats with 16-byte groups swapped in rows
// whose bit 2 is set, so both gathers (x[r][k], x[k][f]) are free of bank
// conflicts. bf16 X follows the JAX contract: B is rounded to bf16 for eta
// (by the wrapper), the residual is rounded to bf16 before the gradient,
// every sum is f32; both products' operands are then exact bf16 values, so
// one mma.sync m16n8k16 bf16 computes each. No two threads ever add into
// one word at once, so there are no float atomics; each CTA writes a
// (1 + C d) partial and glm::reduce_partials adds the partials in a fixed
// order: two runs give bit-equal results. Rows at or past n_valid are
// never read. What holds it back: its phases (eta, the family stage, the
// gradient) take turns behind barriers in the one CTA an SM holds (a
// tile's buffers fill its shared memory), so the tensor cores idle
// through the family stage and the CUDA cores through the products; past
// 16 classes every group reads X again.
//
// The streamed flavour (glm_multi_stream) replaces
// dask_ml_tpu/ops/pallas_fused.py::fused_glm_multi_stream (the Pallas body
// _glm_multi_stream_kernel), kinds "val" and "vg", on the same tensor-core
// walks (glm_multi_mma with its MmaOpts): the class codes are the stream's
// f32 targets (compared exactly with each class index, as the Pallas iota
// compare), the (C,) intercept row b0 is added to eta before the family
// stage, the per-class sums of the (unrounded) residuals are column d of
// a gradient of row stride d + 1 (the intercepts' gradient: each thread
// sums its own (row, class) residuals, the 32 threads of a class added
// in thread order when the group's gradient is written), the gradient
// walk is skipped for "val", and the bf16 operands of the JAX "mxu" policy
// come from f32 X: each staged f32 tile is rounded into a bf16 tile in
// shared memory after its copy lands, and kernel 4's bf16 products read
// it. Its reduce pass adds the block's sums into the pass's accumulators.
// A 262,144-row block is 4,096 tiles, about 31 a CTA. What holds it back
// is kernel 4's: the phases take turns in the one CTA an SM holds; the
// bf16 flavour's rounding pass adds a barrier and a shared-memory copy
// per tile.
//
// The SGD flavour (sgd_many_block_grad) replaces
// dask_ml_tpu/ops/pallas_fused.py::fused_sgd_many_block_grad (the Pallas
// body _sgd_many_grad_kernel) on the same tensor-core walks, with kernel
// 7's instantiations (f32 X, f32 codes; f32 or bf16 products) and two
// more options of MmaOpts: N weight rows take the place of the C classes,
// b0 (N,) = W[:, d] * iflags is made by the wrapper, and
//   - shared_y (a cohort of N models): every weight row's target is the
//     data row's y; else (the C one-vs-rest rows of a multiclass model)
//     the f32 class codes are compared exactly with the row index;
//   - loss_col: column d + 1 of each gradient row (stride d + 2) gets that
//     row's loss sum, as column d gets its unrounded residuals' sum: each
//     thread sums the losses of its own (row, class) terms, and the 32
//     threads of a class are added in thread order.
// The SGD losses are glm_family.cuh's families (log_loss logistic,
// squared_error normal, hinge with a residual of 0 at a margin of exactly
// 1, as the Pallas kernel). Its second pass writes the block's sums
// (glm::reduce_partials). A block of count 0 takes one CTA, which writes
// zeros. SGD's resident blocks are row views of X: at a d that is not a
// multiple of 4 a block starts off 16 bytes, and its rows are copied from
// their aligned starts like every row (the bytes before the first one lie
// in the same allocation). Bound at N = 16 (and C = 10): device memory, X
// read once. At N = 128 (the widest cohort) each group of 16 weight rows
// walks the CTA's tiles again, so X is read 8 times (0.31 ms of bytes at
// 250,000 x 128 against the 0.102 ms operations bound at the 3xTF32
// peak). That walk is kept: a group's gradient stays in registers across
// the CTA's tiles, which 128 rows' could not, and on an H100 it takes
// about 1.21 ms against the plain version's 1.48 (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "glm_family.cuh"
#include "tf32x3.cuh"

namespace {

// ---------------------------------------------------------------------------
// The resident kernel (glm_multi_value_grad) on the tensor cores.
// ---------------------------------------------------------------------------

constexpr int kMTR = 64;          // rows per tile
constexpr int kMWarps = 16;       // eta: 2 row halves x 8 k-parts
constexpr int kMThreads = kMWarps * 32;
constexpr int kKParts = 8;        // also the gradient's column groups
constexpr int kMCls = 16;         // classes per group (two n8 / one m16)
constexpr int kMaxKs = 5;         // eta k-steps of a chunk per warp, at most
constexpr int kMaxNt = 5;         // gradient n8 tiles of a chunk per warp
constexpr int kRtLd = 68;         // f32 residual tile stride, 4 mod 32
constexpr int kRtLdH = 72;        // bf16 residual tile stride (144 bytes)

template <typename T>
__device__ __forceinline__ int shift0(const T* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) / sizeof(T)) &
               (16 / sizeof(T) - 1));
}

// Copy rows [row0, row0 + rows) x features [f0, f0 + fw) of x into xs
// (kMTR rows of stride S), a warp per row: 16-byte cp.async from each
// row's aligned start (X is 16-byte aligned, so the bytes before a row's
// start belong to the row before it), zero-filled past fw and past rows,
// up to fch features. Row r's element f lands at r S + (sh(r) + f), with
// sh(r) its start's offset in 16 bytes; f32 rows whose bit 2 is set swap
// their 16-byte groups pairwise (the column XOR 4), which with a stride of
// 8 mod 32 floats keeps both fragment gathers free of bank conflicts.
template <typename T>
__device__ __forceinline__ void stage_chunk(T* xs, int S, const T* x,
                                            long long row0, int rows, int d,
                                            int f0, int fw, int fch) {
  constexpr int kPer = 16 / (int)sizeof(T);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nq = fch / kPer + 1;
  const T* base = x + row0 * (long long)d + f0;
  const int sh0 = shift0(base);
  for (int r = warp; r < kMTR; r += kMWarps) {
    const int sh = (sh0 + r * d) & (kPer - 1);
    const T* row = base + (long long)r * d - sh;
    const int swz = sizeof(T) == 4 ? ((r >> 2) & 1) << 2 : 0;
    for (int q = lane; q < nq; q += 32) {
      const int valid = r < rows ? min(max(fw + sh - q * kPer, 0), kPer) : 0;
      tf32x3::cp_async16(xs + r * S + ((q * kPer) ^ swz),
                         valid > 0 ? row + q * kPer : x,
                         valid * (int)sizeof(T));
    }
  }
}

template <typename T>
struct MmaOps;

// f32 X: 3xTF32 products, k-steps of 8
template <>
struct MmaOps<float> {
  static constexpr int kK = 8;
  static constexpr int kPer = 4;
  // B's (big, small) pairs in shared memory: (16 classes, SB), SB = fch +
  // 4 (4 mod 8), which keeps the 8-byte fragment loads conflict-free
  struct BFrag {
    const float2* pairs;
    int SB;
  };
  // a lane's gather offsets for one staged tile: eta rows 16 m + g + 8 h
  // of its half at k-offsets t and t + 4, gradient rows t and t + 4
  struct Offsets {
    int eta[2][2][2];
    int grad[2];
  };

  static __device__ __forceinline__ Offsets offsets(int S, int sh0, int d,
                                                    int mh, int g, int t) {
    Offsets o;
    const int swz = ((g >> 2) & 1) << 2;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 32 * mh + 16 * m + g + 8 * h;
        const int sh = (sh0 + r * d) & 3;
        o.eta[m][h][0] = r * S + ((sh + t) ^ swz);
        o.eta[m][h][1] = r * S + ((sh + t + 4) ^ swz);
      }
    const int sh = (sh0 + t * d) & 3;
    o.grad[0] = t * S + sh + g;
    o.grad[1] = (t + 4) * S + ((sh + g) ^ 4);
    return o;
  }

  // B[c0 + c][f0 + k] split once per CTA (zero past nc, fw) into the
  // shared pairs, by all threads; the caller's barrier publishes them
  static __device__ __forceinline__ void fill_b(float2* pairs, int SB,
                                                const float* B, int d, int c0,
                                                int nc, int f0, int fw,
                                                int fch) {
    // every load is issued before the first split: one trip to L2
    constexpr int kPerThread = (kMCls * 264 + kMThreads - 1) / kMThreads;
    float v[kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int e = threadIdx.x + i * kMThreads, c = e / fch, k = e - c * fch;
      v[i] = e < kMCls * fch && c < nc && k < fw
                 ? __ldg(B + (long long)(c0 + c) * d + f0 + k)
                 : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int e = threadIdx.x + i * kMThreads, c = e / fch, k = e - c * fch;
      if (e >= kMCls * fch) break;
      uint32_t big, small;
      tf32x3::split(v[i], big, small);
      pairs[c * SB + k] = make_float2(__uint_as_float(big),
                                      __uint_as_float(small));
    }
  }

  // eta[r][c] += x[r][k] B[c][k] over the warp's k-steps kp + 8 q
  static __device__ __forceinline__ void eta(const float* xs, const Offsets& o,
                                             const BFrag& b, int nks, int nn,
                                             float (&acc)[2][2][4], int kp,
                                             int g, int t) {
#pragma unroll
    for (int q = 0; q < kMaxKs; ++q) {
      const int ks = kp + kKParts * q;
      if (ks >= nks) break;
      const int k0 = ks * kK;
      uint32_t ab[2][4], as[2][4], bb[2][2], bs[2][2];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float av[4] = {xs[o.eta[m][0][0] + k0], xs[o.eta[m][1][0] + k0],
                             xs[o.eta[m][0][1] + k0], xs[o.eta[m][1][1] + k0]};
        tf32x3::split(av, ab[m], as[m]);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 v = b.pairs[(8 * n + g) * b.SB + k0 + t + 4 * h];
          bb[n][h] = __float_as_uint(v.x);
          bs[n][h] = __float_as_uint(v.y);
        }
      // the three products interleaved over the warp's fragments
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 2; ++n)
          if (n < nn) tf32x3::mma_tf32(acc[m][n], as[m], bb[n]);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 2; ++n)
          if (n < nn) tf32x3::mma_tf32(acc[m][n], ab[m], bs[n]);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 2; ++n)
          if (n < nn) tf32x3::mma_tf32(acc[m][n], ab[m], bb[n]);
    }
  }

  // gt[p][c][f] = sum over the tile's rows 32 kh .. 32 kh + 31 of
  // resid[r][c] x[r][f], for the warp's n8 tiles nt = ng + 8 p; rt: the
  // residuals as (classes, rows), big then small
  static __device__ __forceinline__ void grad(const float* xs, int S,
                                              const Offsets& o,
                                              const void* rt, int nnt,
                                              float (&gt)[kMaxNt][4],
                                              int kh, int ng, int g, int t) {
    const float* rb = static_cast<const float*>(rt);
    const float* rsm = rb + kMCls * kRtLd;
#pragma unroll
    for (int k0 = 32 * kh; k0 < 32 * kh + 32; k0 += kK) {
      const int e0 = g * kRtLd + k0 + t, e1 = e0 + 8 * kRtLd;
      const uint32_t ab[4] = {__float_as_uint(rb[e0]), __float_as_uint(rb[e1]),
                              __float_as_uint(rb[e0 + 4]),
                              __float_as_uint(rb[e1 + 4])};
      const uint32_t as[4] = {
          __float_as_uint(rsm[e0]), __float_as_uint(rsm[e1]),
          __float_as_uint(rsm[e0 + 4]), __float_as_uint(rsm[e1 + 4])};
      uint32_t bb[kMaxNt][2], bs[kMaxNt][2];
#pragma unroll
      for (int p = 0; p < kMaxNt; ++p) {
        const bool live = ng + kKParts * p < nnt;
        const int col = (ng + kKParts * p) * 8 + k0 * S;
        tf32x3::split(live ? xs[o.grad[0] + col] : 0.f, bb[p][0], bs[p][0]);
        tf32x3::split(live ? xs[o.grad[1] + col] : 0.f, bb[p][1], bs[p][1]);
      }
#pragma unroll
      for (int p = 0; p < kMaxNt; ++p)
        if (ng + kKParts * p < nnt) tf32x3::mma_tf32(gt[p], as, bb[p]);
#pragma unroll
      for (int p = 0; p < kMaxNt; ++p)
        if (ng + kKParts * p < nnt) tf32x3::mma_tf32(gt[p], ab, bs[p]);
#pragma unroll
      for (int p = 0; p < kMaxNt; ++p)
        if (ng + kKParts * p < nnt) tf32x3::mma_tf32(gt[p], ab, bb[p]);
    }
  }

  // the residual of (row r, class k) into the gradient's A operand
  static __device__ __forceinline__ void put_resid(void* rt, int k, int r,
                                                   float v) {
    float* rb = static_cast<float*>(rt);
    uint32_t big, small;
    tf32x3::split(v, big, small);
    rb[k * kRtLd + r] = __uint_as_float(big);
    rb[kMCls * kRtLd + k * kRtLd + r] = __uint_as_float(small);
  }
};

// bf16 X: the JAX contract's operands (B rounded to bf16 by the wrapper,
// the residual rounded to bf16 here) are exact bf16 values, so one
// m16n8k16 bf16 product with f32 accumulation computes them exactly
template <>
struct MmaOps<__nv_bfloat16> {
  static constexpr int kK = 16;
  static constexpr int kPer = 8;
  struct BFrag {
    uint32_t h[kMaxKs][2][2];
  };
  // eta rows 16 m + g + 8 h of the warp's half (at k-offset 2t), gradient
  // rows 2t, 2t + 1, 2t + 8, 2t + 9
  struct Offsets {
    int eta[2][2];
    int grad[4];
  };

  static __device__ __forceinline__ Offsets offsets(int S, int sh0, int d,
                                                    int mh, int g, int t) {
    Offsets o;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 32 * mh + 16 * m + g + 8 * h;
        o.eta[m][h] = r * S + ((sh0 + r * d) & 7) + 2 * t;
      }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = 2 * t + (j & 1) + 8 * (j >> 1);
      o.grad[j] = r * S + ((sh0 + r * d) & 7) + g;
    }
    return o;
  }

  static __device__ __forceinline__ unsigned short bits(float v) {
    return __bfloat16_as_ushort(__float2bfloat16(v));
  }

  static __device__ __forceinline__ void load_b(BFrag& b, const float* B,
                                                int d, int c0, int nc, int f0,
                                                int fw, int kp, int g,
                                                int t) {
#pragma unroll
    for (int q = 0; q < kMaxKs; ++q)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = (kp + kKParts * q) * kK + 8 * h + 2 * t, c = 8 * n + g;
          const float* bp = B + (long long)(c0 + c) * d + f0 + k;
          const bool ok = c < nc;
          b.h[q][n][h] = tf32x3::pack_bf16(
              bits(ok && k < fw ? __ldg(bp) : 0.f),
              bits(ok && k + 1 < fw ? __ldg(bp + 1) : 0.f));
        }
  }

  static __device__ __forceinline__ uint32_t pair(const unsigned short* xs,
                                                  int e) {
    return tf32x3::pack_bf16(xs[e], xs[e + 1]);
  }

  static __device__ __forceinline__ void eta(const __nv_bfloat16* x16,
                                             const Offsets& o,
                                             const BFrag& b, int nks, int nn,
                                             float (&acc)[2][2][4], int kp,
                                             int, int) {
    const unsigned short* xs = reinterpret_cast<const unsigned short*>(x16);
#pragma unroll
    for (int q = 0; q < kMaxKs; ++q) {
      const int ks = kp + kKParts * q;
      if (ks >= nks) break;
      const int k0 = ks * kK;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const uint32_t a[4] = {pair(xs, o.eta[m][0] + k0),
                               pair(xs, o.eta[m][1] + k0),
                               pair(xs, o.eta[m][0] + k0 + 8),
                               pair(xs, o.eta[m][1] + k0 + 8)};
#pragma unroll
        for (int n = 0; n < 2; ++n)
          if (n < nn) tf32x3::mma_bf16(acc[m][n], a, b.h[q][n]);
      }
    }
  }

  static __device__ __forceinline__ void grad(const __nv_bfloat16* x16, int S,
                                              const Offsets& o,
                                              const void* rt, int nnt,
                                              float (&gt)[kMaxNt][4],
                                              int kh, int ng, int g, int t) {
    const unsigned short* xs = reinterpret_cast<const unsigned short*>(x16);
    const uint32_t* rw = static_cast<const uint32_t*>(rt);
#pragma unroll
    for (int k0 = 32 * kh; k0 < 32 * kh + 32; k0 += kK) {
      // words of the (classes, rows) bf16 tile: row g, rows k0 + 2t, + 1
      const int e0 = (g * kRtLdH + k0) / 2 + t, e1 = e0 + 8 * kRtLdH / 2;
      const uint32_t a[4] = {rw[e0], rw[e1], rw[e0 + 4], rw[e1 + 4]};
#pragma unroll
      for (int p = 0; p < kMaxNt; ++p) {
        if (ng + kKParts * p >= nnt) break;
        const int col = (ng + kKParts * p) * 8 + k0 * S;
        const uint32_t bw[2] = {
            tf32x3::pack_bf16(xs[o.grad[0] + col], xs[o.grad[1] + col]),
            tf32x3::pack_bf16(xs[o.grad[2] + col], xs[o.grad[3] + col])};
        tf32x3::mma_bf16(gt[p], a, bw);
      }
    }
  }

  static __device__ __forceinline__ void put_resid(void* rt, int k, int r,
                                                   float v) {
    static_cast<unsigned short*>(rt)[k * kRtLdH + r] = bits(v);
  }
};

// Bytes of one residual tile as the gradient's A operand (f32: big and
// small (kMCls, kRtLd); bf16: (kMCls, kRtLdH)), a multiple of 16
__host__ __device__ constexpr int rt_bytes(bool bf16) {
  return bf16 ? kMCls * kRtLdH * 2 : 2 * kMCls * kRtLd * 4;
}

// Device scratch of a tile of rows when rows take several chunks: its
// residual tile (rt_bytes, in the shared tile's layout), written by the
// eta walk and copied back by the gradient walk, then its eta sums over
// the chunks so far (kMTR x kMCls f32)
__host__ __device__ constexpr int mma_tile_scratch(bool bf16) {
  return rt_bytes(bf16) + kMTR * kMCls * 4;
}

// Stages of the ring of staged tiles: two where two buffers fill shared
// memory (rows of one chunk; f32 chunks of wider rows), four for bf16
// chunks of wider rows (three copies in flight while one is computed).
__host__ __device__ constexpr int mma_stages(bool single, bool bf16) {
  return single || !bf16 ? 2 : 4;
}

// Shared memory of glm_multi_mma, offsets in bytes: xs (stages, kMTR, S)
// of X's type, the ring of staged tiles | with round: xr (kMTR, SR) bf16,
// the staged tile rounded | red (kKParts, kMTR, kMCls) f32, the k-parts'
// eta partials | rt, one residual tile (with several chunks, one per
// stage: the gradient walk's ring) | loss_s (kMWarps) | f32 products: B's
// split pairs (kMCls, fch + 4) float2. bf16: the products take bf16
// operands; round: X is f32 in memory and rounded to bf16 in shared
// memory (the streamed mxu policy). fch (features per chunk), S and SR
// (row strides) come from ops/fused.py::multi_mma_geometry; the launch
// takes its size from here.
struct MmaLayout {
  int xr, red, rt, loss, pairs, bytes;
};

__host__ __device__ inline MmaLayout mma_layout(bool bf16, bool round,
                                                int fch, int S, int SR,
                                                bool single) {
  MmaLayout l;
  const bool ring16 = bf16 && !round;
  l.xr = (mma_stages(single, ring16) * kMTR * S * (ring16 ? 2 : 4) + 15) &
         ~15;
  l.red = l.xr + (round ? (kMTR * SR * 2 + 15) & ~15 : 0);
  l.rt = l.red + kKParts * kMTR * kMCls * 4;
  l.loss = l.rt + (single ? 1 : mma_stages(false, ring16)) * rt_bytes(bf16);
  l.pairs = l.loss + kMWarps * 4;
  l.bytes = l.pairs + (bf16 ? 0 : kMCls * (fch + 4) * 8);
  return l;
}

// The streamed flavour's options (glm_multi_stream): b0 (C,) intercepts
// added to eta, or null; ldg, the row stride of the gradient in the
// partials (d + 1 with b0: column d gets the per-class sums of the
// unrounded residuals, the intercepts' gradient; d + 2 with loss_col;
// else d); grad ("vg", else "val": no gradient walk). The SGD flavour's
// (sgd_many_block_grad) too: shared_y, every class's target is the row's
// code (one y shared by a cohort of models), else (code == class);
// loss_col (with b0), column d + 1 gets the per-class loss sums. The
// resident kernel's: {null, d, 1, 0, 0}; kernel 7's: {b0, d + 1 or d, grad,
// 0, 0}.
struct MmaOpts {
  const float* b0;
  int ldg;
  int grad;
  int shared_y;
  int loss_col;
};

// the floats of red that write_grad hands between row halves; the
// threads' residual sums follow them, then their loss sums (loss_col)
constexpr int kHand = kKParts * 32 * kMaxNt * 4;
static_assert(kHand + 2 * kMThreads <= kKParts * kMTR * kMCls,
              "red holds the hand-off and the threads' column sums");

// T: the products' operand type; X: X's type in memory (f32 X with bf16
// products is rounded as it is staged); Code: the class codes' type (int32
// resident, the stream's f32 targets compared exactly). rscr: with several
// chunks (d > fch), mma_tile_scratch bytes per tile of rows, else unused.
template <typename T, typename X, typename Code>
__global__ void __launch_bounds__(kMThreads, 1)
glm_multi_mma(const X* __restrict__ x, const Code* __restrict__ codes,
              const float* __restrict__ B, long long n_valid, int d, int C,
              int family, int fch, int S, int SR,
              unsigned char* __restrict__ rscr, float* __restrict__ partials,
              MmaOpts o) {
  using Ops = MmaOps<T>;
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr bool kRound = sizeof(X) != sizeof(T);
  constexpr int kRt = rt_bytes(!kF32);
  constexpr int kScr = mma_tile_scratch(!kF32);
  extern __shared__ __align__(16) unsigned char mma_smem[];
  const int n_fc = (d + fch - 1) / fch;
  const bool single = n_fc == 1;
  const MmaLayout lay = mma_layout(!kF32, kRound, fch, S, SR, single);
  X* xs0 = reinterpret_cast<X*>(mma_smem);
  T* xr = reinterpret_cast<T*>(mma_smem + lay.xr);
  float* red = reinterpret_cast<float*>(mma_smem + lay.red);
  unsigned char* rt0 = mma_smem + lay.rt;
  float* loss_s = reinterpret_cast<float*>(mma_smem + lay.loss);
  float2* pairs = reinterpret_cast<float2*>(mma_smem + lay.pairs);
  const int SB = fch + 4;
  const bool want_rs = o.grad && o.b0 != nullptr;
  float* part = partials + (long long)blockIdx.x *
                               (o.grad ? 1 + (long long)C * o.ldg : 1);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // eta: row half mh, k-part kp; gradient: row half kh, column group ng
  const int mh = warp / kKParts, kp = warp % kKParts;
  const int kh = warp / kKParts, ng = warp % kKParts;
  typename Ops::BFrag bf;
  // B's fragments for classes c0.. and features f0..: split into the
  // shared pairs (f32; a barrier must follow) or into registers (bf16)
  auto load_b = [&](int c0, int nc, int f0, int fw) {
    if constexpr (kF32) {
      Ops::fill_b(pairs, SB, B, d, c0, nc, f0, fw, fch);
      bf = {pairs, SB};
    } else {
      Ops::load_b(bf, B, d, c0, nc, f0, fw, kp, g, t);
    }
  };
  float gacc[kMaxNt][4];
#pragma unroll
  for (int p = 0; p < kMaxNt; ++p)
#pragma unroll
    for (int e = 0; e < 4; ++e) gacc[p][e] = 0.f;
  float loss = 0.f;  // this thread's
  // this thread's sums of unrounded residuals (want_rs) and of losses
  // (loss_col) of class tid % kMCls
  float rsum = 0.f, lsum = 0.f;
  const long long n_tiles = (n_valid + kMTR - 1) / kMTR;
  auto tile_rows = [&](long long tl) {
    return (int)min((long long)kMTR, n_valid - tl * kMTR);
  };
  auto xslot = [&](int slot) { return xs0 + slot * kMTR * S; };

  // a tile's gradient sums into gacc (rounded adds; the tensor cores
  // truncate, so only a tile's rows are summed inside them)
  auto add_tile = [&](const float (&gt)[kMaxNt][4]) {
#pragma unroll
    for (int p = 0; p < kMaxNt; ++p)
#pragma unroll
      for (int e = 0; e < 4; ++e) gacc[p][e] += gt[p][e];
  };
  // the warps' gradient sums into the CTA's partial (classes c0 .. c0 +
  // nc, features f0 .. f0 + fw), then zeroed: row half 1 hands its sums
  // to half 0 through red, which stores each word once as h0 + h1. red is
  // free: the family stage, its last reader, is behind a barrier. With
  // rs, column d too: the threads' residual sums of each class, added in
  // thread order (and with loss_col their loss sums, column d + 1).
  auto write_grad = [&](int c0, int nc, int f0, int fw, bool rs) {
    float* hand = red + (ng * 32 + lane) * (kMaxNt * 4);
    if (kh == 1) {
#pragma unroll
      for (int p = 0; p < kMaxNt; ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e) hand[4 * p + e] = gacc[p][e];
    }
    if (rs) red[kHand + tid] = rsum;
    if (rs && o.loss_col) red[kHand + kMThreads + tid] = lsum;
    __syncthreads();
    if (kh == 0) {
#pragma unroll
      for (int p = 0; p < kMaxNt; ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = g + 8 * (e >> 1);
          const int f = (ng + kKParts * p) * 8 + 2 * t + (e & 1);
          if (c < nc && f < fw)
            part[1 + (long long)(c0 + c) * o.ldg + f0 + f] =
                gacc[p][e] + hand[4 * p + e];
        }
    }
    if (rs && tid < nc) {
      float a = 0.f;
      for (int j = tid; j < kMThreads; j += kMCls) a += red[kHand + j];
      part[1 + (long long)(c0 + tid) * o.ldg + d] = a;
      if (o.loss_col) {
        float l = 0.f;
        for (int j = tid; j < kMThreads; j += kMCls)
          l += red[kHand + kMThreads + j];
        part[1 + (long long)(c0 + tid) * o.ldg + d + 1] = l;
      }
    }
    if (rs) rsum = lsum = 0.f;
#pragma unroll
    for (int p = 0; p < kMaxNt; ++p)
#pragma unroll
      for (int e = 0; e < 4; ++e) gacc[p][e] = 0.f;
    __syncthreads();
  };
  // the family at each (row, class) of the group from the k-parts' eta
  // partials, added in order (after eta_in's, the chunks before, where
  // given); the residuals into the tile rt (shared or global memory). With
  // eta_out (a chunk before the last) the sums go there instead.
  auto family_stage = [&](long long row0, int rows, int c0, int nc,
                          void* rt, const float* eta_in, float* eta_out) {
    for (int e = tid; e < kMTR * kMCls; e += kMThreads) {
      const int r = e / kMCls, k = e % kMCls;
      if (eta_out != nullptr) {
        float eta = eta_in != nullptr ? eta_in[e] : 0.f;
#pragma unroll
        for (int w = 0; w < kKParts; ++w)
          eta += red[(w * kMTR + r) * kMCls + k];
        eta_out[e] = eta;
        continue;
      }
      float resid = 0.f;
      if (r < rows && k < nc) {
        float eta = eta_in != nullptr ? eta_in[e] : 0.f;
#pragma unroll
        for (int w = 0; w < kKParts; ++w)
          eta += red[(w * kMTR + r) * kMCls + k];
        if (o.b0 != nullptr) eta += o.b0[c0 + k];
        const Code code = codes[row0 + r];
        const float yv = o.shared_y ? static_cast<float>(code)
                         : code == static_cast<Code>(c0 + k) ? 1.f
                                                              : 0.f;
        float per;
        glm::family_terms(family, eta, yv, &per, &resid);
        loss += per;
        if (want_rs) rsum += resid;
        if (o.loss_col) lsum += per;
      }
      if (o.grad) Ops::put_resid(rt, k, r, resid);
    }
  };
  auto write_red = [&](const float (&acc)[2][2][4]) {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 32 * mh + 16 * m + g + 8 * h, c = 8 * n + 2 * t;
          *reinterpret_cast<float2*>(red + (kp * kMTR + r) * kMCls + c) =
              make_float2(acc[m][n][2 * h], acc[m][n][2 * h + 1]);
        }
  };
  // the staged rows of f32 X, rounded to bf16 into xr, each row from
  // feature 0 (so xr's rows start unshifted)
  auto round_tile = [&](const X* src, long long row0, int f0) {
    if constexpr (kRound) {
      const int sh0 = shift0(x + row0 * (long long)d + f0);
      const int half = fch / 2;
      for (int e = tid; e < kMTR * half; e += kMThreads) {
        const int r = e / half, f = 2 * (e - r * half);
        const int sh = (sh0 + r * d) & 3, swz = ((r >> 2) & 1) << 2;
        const float* sr = src + r * S;
        *reinterpret_cast<uint32_t*>(xr + r * SR + f) = tf32x3::pack_bf16(
            Ops::bits(sr[(sh + f) ^ swz]), Ops::bits(sr[(sh + f + 1) ^ swz]));
      }
      __syncthreads();
    }
  };
  // the tile the products read: the staged slot, or its rounded copy
  auto tile = [&](int slot) -> const T* {
    if constexpr (kRound)
      return xr;
    else
      return xslot(slot);
  };
  auto offsets = [&](long long row0, int f0) {
    if constexpr (kRound)
      return Ops::offsets(SR, 0, 0, mh, g, t);
    else
      return Ops::offsets(S, shift0(x + row0 * (long long)d + f0), d, mh, g,
                          t);
  };
  auto chunk_w = [&](int fc) { return min(fch, d - fc * fch); };
  auto stage = [&](int slot, long long tl, int fc) {
    stage_chunk(xslot(slot), S, x, tl * kMTR, tile_rows(tl), d, fc * fch,
                chunk_w(fc), fch);
  };

  // Every walk below is a ring of staged buffers: at the top of an item
  // its copy has landed and, behind the barrier, every read of the buffer
  // of the item before it is done, so the copy of the item a ring ahead
  // goes there while this one is computed.
  if (single) {
    // two buffers; the walk runs on across groups of classes
    int it = 0;
    // per group of classes, the CTA's tiles: eta, the family stage and
    // the gradient from one staged copy, the gradient summed in registers
    const int nks = (d + Ops::kK - 1) / Ops::kK, nnt = (d + 7) / 8;
    if (blockIdx.x < n_tiles) stage(0, blockIdx.x, 0);
    tf32x3::cp_async_commit();
    for (int c0 = 0; c0 < C; c0 += kMCls) {
      const int nc = min(kMCls, C - c0), nn = nc > 8 ? 2 : 1;
      __syncthreads();  // every read of the pairs is done
      load_b(c0, nc, 0, d);
      __syncthreads();  // the pairs are in
      for (long long tl = blockIdx.x; tl < n_tiles; tl += gridDim.x, ++it) {
        const long long row0 = tl * kMTR, tn = tl + gridDim.x;
        tf32x3::cp_async_wait<0>();
        __syncthreads();
        if (tn < n_tiles)
          stage((it + 1) & 1, tn, 0);
        else if (c0 + kMCls < C)
          stage((it + 1) & 1, blockIdx.x, 0);  // the next group's first tile
        tf32x3::cp_async_commit();
        round_tile(xslot(it & 1), row0, 0);
        const T* xs = tile(it & 1);
        const auto of = offsets(row0, 0);
        float acc[2][2][4] = {};
        Ops::eta(xs, of, bf, nks, nn, acc, kp, g, t);
        write_red(acc);
        __syncthreads();
        family_stage(row0, tile_rows(tl), c0, nc, rt0, nullptr, nullptr);
        if (!o.grad) continue;
        __syncthreads();
        float gt[kMaxNt][4] = {};
        Ops::grad(xs, kRound ? SR : S, of, rt0, nnt, gt, kh, ng, g, t);
        add_tile(gt);
      }
      if (o.grad) write_grad(c0, nc, 0, d, want_rs);
    }
  } else {
    // rows wider than a chunk, per group of classes: a walk over (tile,
    // chunk) for eta and the family stage, which writes each tile's
    // residuals to its tile of rscr; then a walk over (chunk, tile) for
    // the gradient, each chunk's copy joined by the copy of its tile's
    // residuals, the warps' sums written out once per chunk. X is read
    // twice, the gradient's partial written once.
    constexpr int kN = mma_stages(false, !kF32 && !kRound);
    const long long my =
        blockIdx.x < n_tiles ? (n_tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
    const long long n_items = my * n_fc;
    auto tile_of = [&](long long j) { return blockIdx.x + j * gridDim.x; };
    // item i of both walks: chunk i / my, tile i % my; the gradient walk
    // copies the tile's residuals too
    auto stage_item = [&](long long i, bool resid) {
      if (i < n_items) {
        const int slot = (int)(i % kN);
        const long long tl = tile_of(i % my);
        stage(slot, tl, (int)(i / my));
        unsigned char* dst = rt0 + slot * kRt;
        for (int q = tid; resid && q < kRt / 16; q += kMThreads)
          tf32x3::cp_async16(dst + 16 * q, rscr + tl * kScr + 16 * q, 16);
      }
      tf32x3::cp_async_commit();
    };
    for (int c0 = 0; c0 < C; c0 += kMCls) {
      const int nc = min(kMCls, C - c0), nn = nc > 8 ? 2 : 1;
      __syncthreads();  // every read of the ring is done
      for (int p = 0; p < kN - 1; ++p) stage_item(p, false);
      for (int fc = 0; fc < n_fc; ++fc) {
        const int f0 = fc * fch, fw = chunk_w(fc);
        __syncthreads();  // every read of the pairs is done
        load_b(c0, nc, f0, fw);
        if constexpr (kF32) __syncthreads();
        for (long long j = 0; j < my; ++j) {
          const long long i = fc * my + j, tl = tile_of(j);
          tf32x3::cp_async_wait<kN - 2>();
          __syncthreads();
          stage_item(i + kN - 1, false);
          round_tile(xslot((int)(i % kN)), tl * kMTR, f0);
          float acc[2][2][4] = {};
          Ops::eta(tile((int)(i % kN)), offsets(tl * kMTR, f0), bf,
                   (fw + Ops::kK - 1) / Ops::kK, nn, acc, kp, g, t);
          write_red(acc);
          __syncthreads();
          unsigned char* scr = rscr + tl * kScr;
          float* eta_scr = reinterpret_cast<float*>(scr + kRt);
          family_stage(tl * kMTR, tile_rows(tl), c0, nc, scr,
                       fc > 0 ? eta_scr : nullptr,
                       fc + 1 < n_fc ? eta_scr : nullptr);
        }
      }
      if (!o.grad) continue;
      // the residual tiles are written before they are copied back
      tf32x3::cp_async_wait<0>();
      __threadfence();
      __syncthreads();
      for (int p = 0; p < kN - 1; ++p) stage_item(p, true);
      for (int fc = 0; fc < n_fc; ++fc) {
        const int f0 = fc * fch, fw = chunk_w(fc);
        for (long long j = 0; j < my; ++j) {
          const long long i = fc * my + j;
          const int slot = (int)(i % kN);
          tf32x3::cp_async_wait<kN - 2>();
          __syncthreads();
          stage_item(i + kN - 1, true);
          round_tile(xslot(slot), tile_of(j) * kMTR, f0);
          float gt[kMaxNt][4] = {};
          Ops::grad(tile(slot), kRound ? SR : S,
                    offsets(tile_of(j) * kMTR, f0), rt0 + slot * kRt,
                    (fw + 7) / 8, gt, kh, ng, g, t);
          add_tile(gt);
        }
        write_grad(c0, nc, f0, fw, want_rs && fc == 0);
      }
    }
  }
  tf32x3::cp_async_wait<0>();
  loss = glm::warp_sum(loss);
  if (lane == 0) loss_s[warp] = loss;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < kMWarps; ++w) s += loss_s[w];
    part[0] = s;
  }
}

template <typename T, typename X, typename Code>
cudaError_t launch_mma(const X* x, const Code* codes, const float* B,
                       long long n_valid, int d, int C, int family, int fch,
                       int S, int SR, unsigned char* rscr, float* partials,
                       int n_part, MmaOpts o, cudaStream_t s) {
  const int smem = mma_layout(sizeof(T) == 2, sizeof(X) != sizeof(T), fch,
                              S, SR, d <= fch)
                       .bytes;
  cudaError_t err = cudaFuncSetAttribute(
      glm_multi_mma<T, X, Code>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  glm_multi_mma<T, X, Code><<<n_part, kMThreads, smem, s>>>(
      x, codes, B, n_valid, d, C, family, fch, S, SR, rscr, partials, o);
  return cudaGetLastError();
}

}  // namespace

// Bytes of glm_multi_value_grad's rscr scratch per tile of 64 rows, which
// rows wider than one chunk (d > fch) need; bf16: x is bf16.
extern "C" int glm_multi_mma_tile_scratch(int x_bf16) {
  return mma_tile_scratch(x_bf16 != 0);
}

// x: (n, d) row-major, 16-byte aligned, f32 (x_bf16 == 0) or bf16 (x_bf16
// == 1); codes: (n,) int32 class codes; B: (C, d) f32, already rounded to
// bf16 values when x is bf16; rscr: with d > fch, ceil(n_valid / 64)
// tiles of glm_multi_mma_tile_scratch bytes, else unused; partials:
// (n_part, 1 + C d) f32 scratch; out: (1 + C d) f32 = [loss, grad (C, d)
// row-major]. fch (features per staged chunk) and S (row stride of a
// staged tile, in elements) come from ops/fused.py::multi_mma_geometry.
// Returns cudaGetLastError() of the launches.
extern "C" int glm_multi_value_grad(const void* x, int x_bf16,
                                    const int* codes, const float* B,
                                    long long n_valid, int d, int C,
                                    int family, int fch, int S, void* rscr,
                                    float* partials, int n_part, float* out,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned char* scr = static_cast<unsigned char*>(rscr);
  const MmaOpts o{nullptr, d, 1, 0, 0};
  const cudaError_t err =
      x_bf16 ? launch_mma<__nv_bfloat16>(
                   static_cast<const __nv_bfloat16*>(x), codes, B, n_valid,
                   d, C, family, fch, S, 0, scr, partials, n_part, o, s)
             : launch_mma<float>(static_cast<const float*>(x), codes, B,
                                 n_valid, d, C, family, fch, S, 0, scr,
                                 partials, n_part, o, s);
  if (err != cudaSuccess) return (int)err;
  const long long width = 1 + (long long)C * d;
  glm::reduce_partials<<<(unsigned)((width + 255) / 256), 256, 0, s>>>(
      partials, n_part, width, out);
  return (int)cudaGetLastError();
}

// The streamed flavour (glm_multi_mma with MmaOpts): x (n, d) f32
// row-major, 16-byte aligned; round: bf16 products (the mxu policy: x
// rounded to bf16 as it is staged, B already rounded to bf16 values, the
// residual rounded before the gradient product); codes (n,) f32 class
// codes (the stream's targets); B (C, d) f32; b0 (C,) f32 intercepts or
// null; grad: "vg" (else "val"); fch, S (the staged f32 rows' stride)
// and SR (round: the rounded rows' stride): ops/fused.py::
// multi_stream_geometry; rscr: with d > fch, ceil(n_valid / 64) tiles of
// glm_multi_mma_tile_scratch(round) bytes, else unused; partials:
// (n_part, 1 + C ldg) ("vg", ldg = d + 1 with b0, else d) or (n_part,)
// ("val") f32 scratch; acc: [loss, grad (C, ldg) row-major] ("vg") or
// [loss] ("val"), which this call ADDS the block's sums into. Returns
// cudaGetLastError() of the launches.
extern "C" int glm_multi_stream(const float* x, int round, const float* codes,
                                const float* B, const float* b0,
                                long long n_valid, int d, int C, int family,
                                int grad, int fch, int S, int SR, void* rscr,
                                float* partials, int n_part, float* acc,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned char* scr = static_cast<unsigned char*>(rscr);
  const int ldg = b0 != nullptr ? d + 1 : d;
  const MmaOpts o{b0, ldg, grad, 0, 0};
  const cudaError_t err =
      round ? launch_mma<__nv_bfloat16>(x, codes, B, n_valid, d, C, family,
                                        fch, S, SR, scr, partials, n_part, o,
                                        s)
            : launch_mma<float>(x, codes, B, n_valid, d, C, family, fch, S,
                                SR, scr, partials, n_part, o, s);
  if (err != cudaSuccess) return (int)err;
  const long long width = grad ? 1 + (long long)C * ldg : 1;
  glm::reduce_partials_add<<<(unsigned)((width + 255) / 256), 256, 0, s>>>(
      partials, n_part, width, acc);
  return (int)cudaGetLastError();
}

// The SGD step of N weight rows on one block (glm_multi_mma with the SGD
// options): x (n, d) f32 row-major, rows < n_valid valid, at any 4-byte
// alignment (a row view of a larger X); round: bf16 products (rows
// rounded as staged, B already rounded to bf16 values, the residual
// rounded before the gradient product, the residual and loss sums
// unrounded); y (n,) f32: class codes (codes == 1, row c's target is y ==
// c) or targets shared by every row (codes == 0); B (N, d) f32; b0 (N,)
// f32 = W[:, d] * iflags; loss: a glm_family.cuh Family; fch, S, SR and
// smem (bytes of shared memory, checked against mma_layout): ops/fused.py
// ::multi_stream_geometry(d, round, loss_col=True); rscr: as
// glm_multi_stream's; partials: (n_part, 1 + N (d + 2)) f32 scratch; out:
// (1 + N (d + 2)) f32 = [loss sum, (N, d + 2) row-major: grad (d), sum of
// residuals, loss sum of the row], written. Returns cudaGetLastError() of
// the launches, or cudaErrorInvalidValue when smem is not the layout's.
extern "C" int sgd_many_block_grad(const float* x, int round, const float* y,
                                   int codes, const float* B, const float* b0,
                                   long long n_valid, int d, int N, int loss,
                                   int fch, int S, int SR, int smem,
                                   void* rscr, float* partials, int n_part,
                                   float* out, void* stream) {
  if (smem != mma_layout(round != 0, round != 0, fch, S, SR, d <= fch).bytes)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned char* scr = static_cast<unsigned char*>(rscr);
  const MmaOpts o{b0, d + 2, 1, codes ? 0 : 1, 1};
  const cudaError_t err =
      round ? launch_mma<__nv_bfloat16>(x, y, B, n_valid, d, N, loss, fch, S,
                                        SR, scr, partials, n_part, o, s)
            : launch_mma<float>(x, y, B, n_valid, d, N, loss, fch, S, SR,
                                scr, partials, n_part, o, s);
  if (err != cudaSuccess) return (int)err;
  const long long width = 1 + (long long)N * (d + 2);
  glm::reduce_partials<<<(unsigned)((width + 255) / 256), 256, 0, s>>>(
      partials, n_part, width, out);
  return (int)cudaGetLastError();
}
