// Fused GLM value and gradient: one read of X per call.
//
// Replaces dask_ml_tpu/ops/pallas_fused.py::fused_glm_value_grad (the
// Pallas body _glm_value_grad_kernel). For rows r < n_valid it computes
//   loss = sum_r pointwise(eta_r, y_r),  grad = sum_r resid_r * x_r,
// with eta_r = x_r . beta and resid_r = mean(eta_r) - y_r of the family.
// The streamed flavour (glm_stream: the modes kVal, kVg, kVgBf16) also
// replaces fused_glm_stream's kinds "val" and "vg" (_glm_stream_kernel):
// the intercept b0 = beta[d] added to eta, the sum of the residuals as
// one more output, the gradient skipped for "val", and the bf16 operands
// of the JAX "mxu" policy taken from f32 X (x and beta rounded to bf16
// where used, the residual rounded before the gradient product, the sum
// of the residuals unrounded); its second pass adds the block's sums into
// the pass's accumulators. The SGD step (sgd_block_grad) replaces
// fused_sgd_block_grad (_sgd_grad_kernel): the streamed "vg" flavour with
// the SGD losses (glm_family.cuh: log_loss the logistic family,
// squared_error the normal family, hinge its own terms), b0 = w[d] *
// iflag, and a second pass that writes the block's sums.
//
// Bound on an H100: device memory. X is read once (n * d * itemsize
// bytes) against about 4 flops an element. Every walk reads X from device
// memory once, sums in f32, writes a per-CTA partial that a second launch
// reduces in a fixed order (no float atomics: two runs are bit-equal),
// and never reads a row at or past n_valid. bf16 X follows the JAX
// contract: beta rounded to bf16 for the dot product, the residual
// rounded to bf16 before the gradient product, every sum in f32.
// ops/fused.py::glm_value_walk picks the walk from the
// shape; the times below are kernel times on an NVIDIA H100 80GB HBM3 at
// 700 W (chip_smoke.py and scripts/glm_walk_times.py, PERF.md section 6).
//
// registers (glm_block_registers; f32 X, 129 <= d <= 4096; the main
// paths: kernel 1 at d = 257, kernels 5 and 6 at d = 256):
// thread t owns the columns t, t + 256, ... (C of them) with its share of
// beta and of the gradient in registers. A CTA loads its R x C elements
// of a block of R rows into registers at once, sums each row across the
// CTA (halving shuffles, then the 8 warps in order), R threads apply the
// family, and every thread adds resid_r * x_rc from the same registers.
// About 1.51 ms at 4M x 257 (82 % of the byte bound). Unchanged.
//
// staged (glm_staged, glm_staged_wide; bf16 X at every d <= 12288, f32 from
// d = 4097, where it measured faster than the registers walk): tiles of
// whole rows (and their y) are copied into a ring of 3-4 stages in shared
// memory by 16-byte cp.async, each tile as one flat run from the 16-byte
// boundary at or before its first row (rows of any width or alignment,
// views included, no clone); the next tiles' copies are in flight while one
// is consumed. Thread t owns the columns t + 256 j with their beta and
// gradient in registers; a column slot only some warps fill (d = 257:
// column 256) is skipped by the others. Rows of at most 1024 features:
// tiles of 16 or 32 rows, taken 16 rows a pass with the pass's elements in
// registers (read from the tile once for eta and the gradient), as the
// registers walk does; wider rows: tiles of 1, 2 or 4 rows (at most 40 KB,
// 2 CTAs an SM where they fit), loads predicated on the column, each row's
// sum across the CTA and the family in every warp's lanes. What bounds it:
// not the copies (with the arithmetic cut the ring moves X at 86-95 % of
// the byte bound, scripts/glm_value_variants.py copy-only) but the latency
// of each tile's chain of loads, shuffles, barriers and family in 3 CTAs an
// SM. bf16 at 4M x 257: 1.358 ms (45 %; the walk it replaced 1.72 ms); f32
// at 500k x 4097 3.46 ms (71 %; the registers walk 5.64, plain 5.46).
//
// narrow (glm_narrow; f32 X, d <= 128: kernel 5 at the Incremental block,
// and every mode at that width): a group of narrow_lanes(d) lanes takes a
// row, each lane 16 bytes of it (a float4 where d % 4 == 0 and X is 16-byte
// aligned, else four floats), 8 rows a group at once (8 loads in flight a
// lane, y loaded beside them); eta by butterflies inside the group, the
// family in the group's lanes, the residuals by shuffles, the gradient in
// each lane's 4 registers: no barrier in the row loop. The warps' and then
// the CTAs' partials are added in a fixed order, the CTAs' by the second
// launch every walk shares (the last CTA reducing them by an integer
// ticket measured no faster beyond the run-to-run spread, and was
// dropped). 0.061-0.064 ms at 250,000 x 128 (60-63 % of the byte bound;
// the registers walk 0.086-0.115) for all three losses, f32 and bf16
// operands (scripts/glm_walk_times.py).
//
// stream (glm_block_stream; rows too wide to stage, d > 12288): a warp
// takes 4 rows, its lanes striding a row's features for eta; then thread
// f walks the block's rows again by column (from L1 or L2) into its
// entries of the CTA's partial in device memory. It was bf16's walk at
// every width before the staged walk (1.72 ms at 4M x 257, 36 %).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "glm_family.cuh"
#include "tf32x3.cuh"

namespace {

using glm::Elem;
using glm::family_terms;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxCols = 16;           // columns per thread in registers
constexpr int kStreamRowsPerWarp = 4;
constexpr int kStreamRows = kWarps * kStreamRowsPerWarp;

// What an instantiation computes: the resident kernel, or the streamed
// flavour's "val", "vg", or "vg" on bf16 operands (x, beta and the
// residual rounded to bf16 where used). A compile-time choice: with the
// rounding chosen at run time between the loads of a block, the
// streamed kernel measured 2.3 times the resident kernel's time on an
// H100 at every shape tried, its loads no longer issued back to back.
enum Mode { kResident = 0, kVal = 1, kVg = 2, kVgBf16 = 3 };

template <int kMode>
constexpr bool kStreamed = kMode != kResident;

template <int kMode>
constexpr bool kWantGrad = kMode != kVal;

template <typename T, int kMode>
__device__ __forceinline__ float load_x(const T* p) {
  const float v = Elem<T>::load(p);
  if constexpr (kMode == kVgBf16) return glm::round_bf16(v);
  return v;
}

template <typename T, int kMode>
__device__ __forceinline__ float round_op(float v) {
  if constexpr (kMode == kVgBf16) return glm::round_bf16(v);
  if constexpr (kStreamed<kMode>) return v;
  return Elem<T>::round(v);
}

// Floats of one CTA's partial: [loss, grad (d)] resident; streamed
// [loss, grad (d), sum of residuals] for "vg" and [loss] for "val".
template <int kMode>
__device__ __forceinline__ long long partial_width(int d) {
  if constexpr (kMode == kResident) return d + 1;
  if constexpr (kMode == kVal) return 1;
  return d + 2;
}

// partials: (gridDim.x, partial_width) of each CTA.
template <typename T, int C, int R, int kMode>
__global__ void __launch_bounds__(kThreads)
glm_block_registers(const T* __restrict__ x, const float* __restrict__ y,
                    const float* __restrict__ beta, long long n_valid, int d,
                    int family, float* __restrict__ partials, int intercept,
                    float b0_scale) {
  constexpr bool kStream = kStreamed<kMode>;
  constexpr bool want_grad = kWantGrad<kMode>;
  static_assert(R >= 1 && R <= 32 && (R & (R - 1)) == 0, "R: 1, 2, ..., 32");
  __shared__ float red_s[kWarps][R];
  __shared__ float resid_s[R];
  __shared__ float loss_s[R];
  __shared__ float gb_s[R];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float b0 = kStream && intercept ? beta[d] * b0_scale : 0.f;
  float b[C], g[C];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const int col = tid + kThreads * j;
    b[j] = col < d ? round_op<T, kMode>(beta[col]) : 0.f;
    g[j] = 0.f;
  }
  float loss = 0.f;  // threads < R, over the rows they finish
  float gsum = 0.f;  // the same rows' residuals (streamed)
  const long long n_blocks = (n_valid + R - 1) / R;
  for (long long blk = blockIdx.x; blk < n_blocks; blk += gridDim.x) {
    const long long row0 = blk * R;
    const int rows = (int)min((long long)R, n_valid - row0);
    float xv[R][C];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const int col = tid + kThreads * j;
        xv[r][j] = (r < rows && col < d)
                       ? load_x<T, kMode>(x + (row0 + r) * d + col)
                       : 0.f;
      }
    float p[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < C; ++j) s = fmaf(xv[r][j], b[j], s);
      p[r] = s;
    }
    // lane l ends with row l / (32 / R)
    glm::warp_sum_halving<R>(p, lane);
    constexpr int kLanesPerRow = 32 / R;
    if (lane % kLanesPerRow == 0) red_s[warp][lane / kLanesPerRow] = p[0];
    __syncthreads();
    if (tid < R) {
      float eta = 0.f;
      for (int w = 0; w < kWarps; ++w) eta += red_s[w][tid];
      if constexpr (kStream) eta += b0;
      float resid = 0.f;
      if (tid < rows) {
        float per;
        family_terms(family, eta, y[row0 + tid], &per, &resid);
        loss += per;
        if constexpr (kStream) gsum += resid;
      }
      resid_s[tid] = round_op<T, kMode>(resid);
    }
    __syncthreads();
    // red_s and resid_s are next written after the next block's loads
    // and the first barrier, by when every thread has read them
    if constexpr (want_grad) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float rr = resid_s[r];
#pragma unroll
        for (int j = 0; j < C; ++j) g[j] = fmaf(rr, xv[r][j], g[j]);
      }
    }
  }
  if (tid < R) {
    loss_s[tid] = loss;
    if constexpr (kStream) gb_s[tid] = gsum;
  }
  __syncthreads();
  float* out = partials + (long long)blockIdx.x * partial_width<kMode>(d);
  if constexpr (want_grad) {
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int col = tid + kThreads * j;
      if (col < d) out[1 + col] = g[j];
    }
  }
  if (tid == 0) {
    float s = 0.f;
    for (int r = 0; r < R; ++r) s += loss_s[r];
    out[0] = s;
    if constexpr (kStream && want_grad) {
      float sg = 0.f;
      for (int r = 0; r < R; ++r) sg += gb_s[r];
      out[1 + d] = sg;
    }
  }
}

// rows too wide to stage (ops/fused.py::glm_value_walk): the walk that
// reads each block of rows twice, the second time from L1 or L2
template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
glm_block_stream(const T* __restrict__ x, const float* __restrict__ y,
                 const float* __restrict__ beta, long long n_valid, int d,
                 int family, float* __restrict__ partials, int intercept,
                 float b0_scale) {
  constexpr bool kStream = kStreamed<kMode>;
  constexpr bool want_grad = kWantGrad<kMode>;
  __shared__ float resid_s[kStreamRows];
  __shared__ float loss_s[kWarps];
  __shared__ float gb_s[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float b0 = kStream && intercept ? beta[d] * b0_scale : 0.f;
  float* out = partials + (long long)blockIdx.x * partial_width<kMode>(d);
  float* g = out + 1;  // thread f owns g[f], g[f + kThreads], ...
  if constexpr (want_grad)
    for (int f = tid; f < d; f += kThreads) g[f] = 0.f;

  float loss = 0.f;  // this warp's, the same in every lane
  float gsum = 0.f;  // its residuals, the same in every lane
  const long long n_blocks = (n_valid + kStreamRows - 1) / kStreamRows;
  for (long long blk = blockIdx.x; blk < n_blocks; blk += gridDim.x) {
    const long long row0 = blk * kStreamRows;
#pragma unroll
    for (int i = 0; i < kStreamRowsPerWarp; ++i) {
      const int r = warp * kStreamRowsPerWarp + i;
      const long long row = row0 + r;
      float resid = 0.f;
      if (row < n_valid) {
        const T* xr = x + row * d;
        float eta = 0.f;
#pragma unroll 4
        for (int f = lane; f < d; f += 32)
          eta = fmaf(load_x<T, kMode>(xr + f),
                     round_op<T, kMode>(__ldg(beta + f)), eta);
        // butterfly: every lane ends with the same sum (a + b == b + a)
        for (int o = 16; o > 0; o >>= 1)
          eta += __shfl_xor_sync(0xffffffffu, eta, o);
        if constexpr (kStream) eta += b0;
        float per;
        family_terms(family, eta, y[row], &per, &resid);
        loss += per;
        if constexpr (kStream) gsum += resid;
      }
      if (lane == 0) resid_s[r] = round_op<T, kMode>(resid);
    }
    __syncthreads();
    const int rows = (int)min((long long)kStreamRows, n_valid - row0);
    if constexpr (want_grad) {
      for (int f = tid; f < d; f += kThreads) {
        const T* xc = x + row0 * d + f;
        float a = 0.f;
#pragma unroll 4
        for (int r = 0; r < rows; ++r)
          a = fmaf(resid_s[r], load_x<T, kMode>(xc + (long long)r * d), a);
        g[f] += a;
      }
    }
    __syncthreads();  // resid_s is read before the next block writes it
  }
  if (lane == 0) {
    loss_s[warp] = loss;
    if constexpr (kStream) gb_s[warp] = gsum;
  }
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += loss_s[w];
    out[0] = s;
    if constexpr (kStream && want_grad) {
      float sg = 0.f;
      for (int w = 0; w < kWarps; ++w) sg += gb_s[w];
      out[1 + d] = sg;
    }
  }
}

// ---------------------------------------------------------------------------
// The staged walk (glm_staged): bf16 X at every width, f32 rows from
// GLM_STAGED_F32_MIN_D (ops/fused.py::glm_value_walk).
// ---------------------------------------------------------------------------

constexpr int kMaxStages = 4;   // the ring's depth, at most
constexpr int kPassRows = 16;   // rows of a pass of the many-row path
// the wide rows: a thread's columns t, t + kThreads, ... (at most
// kWideMaxCols) with their beta and gradient in registers; wider rows
// take the stream walk
constexpr int kWideMaxCols = 48;

template <typename T>
struct Staged {
  static constexpr int kPer = 16 / (int)sizeof(T);
  // elements of a stage's X: `rows` whole rows as one flat run, copied
  // from the 16-byte boundary at or before the first row's start (fewer
  // than kPer elements before it), in whole 16-byte chunks
  static __host__ __device__ __forceinline__ int elems(int rows, int d) {
    return (rows * d + 2 * kPer - 2) / kPer * kPer;
  }
  // bytes of a stage: its X, then the rows' y in whole 16-byte chunks
  static __host__ __device__ __forceinline__ int bytes(int rows, int d) {
    return elems(rows, d) * (int)sizeof(T) + (4 * rows + 15) / 16 * 16;
  }
};

// elements between p and the 16-byte boundary at or before it
template <typename T>
__device__ __forceinline__ int flat_shift(const T* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) / sizeof(T)) &
               (16 / sizeof(T) - 1));
}

// Copy rows [row0, row0 + rows) of x into dst as one flat run of 16-byte
// cp.async chunks from the boundary at or before row0's start (element
// (r, f) lands at dst[flat_shift(x + row0 d) + r d + f]), and their y
// into ys. The bytes before row0 in the first chunk are the row before it
// (or, for the first row of a view, bytes of the same allocation);
// nothing past the last of the rows is read.
template <int kNT, typename T>
__device__ __forceinline__ void stage_rows(T* dst, float* ys, const T* x,
                                           const float* y, long long row0,
                                           int rows, int d) {
  constexpr int kPer = Staged<T>::kPer;
  const T* start = x + row0 * d;
  const int sh = flat_shift(start);
  const T* base = start - sh;
  const int total = sh + rows * d;
  for (int q = threadIdx.x; q * kPer < total; q += kNT) {
    const int valid = min(kPer, total - q * kPer);
    tf32x3::cp_async16(dst + q * kPer, base + q * kPer,
                       valid * (int)sizeof(T));
  }
  if ((int)threadIdx.x < rows)
    tf32x3::cp_async4(ys + threadIdx.x, y + row0 + threadIdx.x, true);
}

// cp.async.wait_group with a depth known at run time (0 .. kMaxStages - 2)
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if (n >= 2) tf32x3::cp_async_wait<2>();
  else if (n == 1) tf32x3::cp_async_wait<1>();
  else tf32x3::cp_async_wait<0>();
}

// a staged element as the arithmetic takes it (bf16 widened exactly; f32
// rounded to bf16 for the bf16 operands of kVgBf16)
template <typename T, int kMode>
__device__ __forceinline__ float staged_x(const T* tile, int p) {
  if constexpr (std::is_same<T, float>::value) {
    const float v = tile[p];
    if constexpr (kMode == kVgBf16) return glm::round_bf16(v);
    return v;
  } else {
    const unsigned short* h = reinterpret_cast<const unsigned short*>(tile);
    return __uint_as_float((uint32_t)h[p] << 16);
  }
}

// The many-row path (bf16 rows of at most 1024 features). partials:
// (gridDim.x, partial_width) of each CTA. A ring of `stages` tiles of
// tile_rows (16 or 32) rows and their y (dynamic shared memory: stages x
// Staged<T>::bytes(tile_rows, d)). Thread t owns the columns t + kThreads
// j, j < ceil(d / kThreads) <= kC: their beta and gradient sit in
// registers, and a column slot that only some warps fill (d = 257: column
// 256) is skipped by the other warps. A tile is taken 16 rows a pass: the
// pass's elements in registers, a row's sum across the CTA (halving
// shuffles, then the warps in order) and the family on 16 threads, whose
// residuals every thread reads back.
template <typename T, int kMode, int kC>
__global__ void __launch_bounds__(kThreads, 3)
glm_staged(const T* __restrict__ x, const float* __restrict__ y,
           const float* __restrict__ beta, long long n_valid, int d,
           int family, float* __restrict__ partials, int intercept,
           float b0_scale, int tile_rows, int stages) {
  constexpr bool kStream = kStreamed<kMode>;
  constexpr bool want_grad = kWantGrad<kMode>;
  extern __shared__ __align__(16) unsigned char staged_smem[];
  __shared__ float red_s[kWarps][kPassRows];
  __shared__ float resid_s[kPassRows];
  __shared__ float loss_s[kWarps];
  __shared__ float gb_s[kWarps];
  const int TR = tile_rows;
  const int stage = Staged<T>::bytes(TR, d);
  const int x_bytes = Staged<T>::elems(TR, d) * (int)sizeof(T);
  auto stage_x = [&](int i) {
    return reinterpret_cast<T*>(staged_smem + i * stage);
  };
  auto stage_y = [&](int i) {
    return reinterpret_cast<float*>(staged_smem + i * stage + x_bytes);
  };
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float b0 = kStream && intercept ? beta[d] * b0_scale : 0.f;
  // slot j holds column tid + kThreads j; the warp takes slot j when one
  // of its lanes' columns is below d (warp-uniform)
  const int cfull = d / kThreads, tail = d % kThreads;
  auto slot = [&](int j) {
    return j < cfull || (j == cfull && warp * 32 < tail);
  };
  float b[kC], g[kC];
#pragma unroll
  for (int j = 0; j < kC; ++j) {
    const int f = tid + kThreads * j;
    b[j] = f < d ? round_op<T, kMode>(beta[f]) : 0.f;
    g[j] = 0.f;
  }
  const long long n_tiles = (n_valid + TR - 1) / TR;
  const long long grid = gridDim.x;
  for (int k = 0; k < stages - 1; ++k) {
    const long long t = blockIdx.x + k * grid;
    if (t < n_tiles)
      stage_rows<kThreads>(stage_x(k), stage_y(k), x, y, t * TR,
                 (int)min((long long)TR, n_valid - t * TR), d);
    tf32x3::cp_async_commit();
  }
  float loss = 0.f;  // the rows this thread applied the family to
  float gsum = 0.f;  // their residuals (streamed)
  int k = 0;
  for (long long t = blockIdx.x; t < n_tiles; t += grid, ++k) {
    cp_async_wait_upto(stages - 2);
    // tile t is in; every thread is done with the stage the next copy
    // overwrites
    __syncthreads();
    {
      const long long tn = t + (stages - 1) * grid;
      if (tn < n_tiles) {
        const int i = (k + stages - 1) % stages;
        stage_rows<kThreads>(stage_x(i), stage_y(i), x, y, tn * TR,
                   (int)min((long long)TR, n_valid - tn * TR), d);
      }
      tf32x3::cp_async_commit();
    }
    const T* tile = stage_x(k % stages);
    const float* ys = stage_y(k % stages);
    const long long row0 = t * TR;
    const int rows = (int)min((long long)TR, n_valid - row0);
    const int sh = flat_shift(x + row0 * d);
    for (int pass = 0; pass < rows; pass += kPassRows) {
      const int prow = min(kPassRows, rows - pass);
      float xv[kPassRows][kC];
      float p[kPassRows];
#pragma unroll
      for (int r = 0; r < kPassRows; ++r) p[r] = 0.f;
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        if (!slot(j)) continue;
        const int f = tid + kThreads * j;
        const int p0 = sh + pass * d + f;
#pragma unroll
        for (int r = 0; r < kPassRows; ++r) {
          xv[r][j] = r < prow && f < d ? staged_x<T, kMode>(tile, p0 + r * d)
                                       : 0.f;
          p[r] = fmaf(xv[r][j], b[j], p[r]);
        }
      }
      // lane l ends with row l / (32 / kPassRows)'s sum over the warp's
      // columns
      glm::warp_sum_halving<kPassRows>(p, lane);
      constexpr int kLanesPerRow = 32 / kPassRows;
      if (lane % kLanesPerRow == 0) red_s[warp][lane / kLanesPerRow] = p[0];
      __syncthreads();
      if (tid < kPassRows) {
        float eta = 0.f;
        for (int w = 0; w < kWarps; ++w) eta += red_s[w][tid];
        float resid = 0.f;
        if (tid < prow) {
          if constexpr (kStream) eta += b0;
          float per;
          family_terms(family, eta, ys[pass + tid], &per, &resid);
          loss += per;
          if constexpr (kStream) gsum += resid;
        }
        resid_s[tid] = round_op<T, kMode>(resid);
      }
      // red_s and resid_s are next written after the next pass's (or
      // tile's) first barrier, when every thread is done with them
      __syncthreads();
      if constexpr (want_grad) {
#pragma unroll
        for (int r = 0; r < kPassRows; ++r) {
          const float rr = resid_s[r];
#pragma unroll
          for (int j = 0; j < kC; ++j)
            if (slot(j)) g[j] = fmaf(rr, xv[r][j], g[j]);
        }
      }
    }
  }
  tf32x3::cp_async_wait<0>();
  loss = glm::warp_sum(loss);
  gsum = glm::warp_sum(gsum);
  if (lane == 0) {
    loss_s[warp] = loss;
    gb_s[warp] = gsum;
  }
  __syncthreads();
  float* out = partials + (long long)blockIdx.x * partial_width<kMode>(d);
  if constexpr (want_grad) {
#pragma unroll
    for (int j = 0; j < kC; ++j)
      if (tid + kThreads * j < d) out[1 + tid + kThreads * j] = g[j];
  }
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += loss_s[w];
    out[0] = s;
    if constexpr (kStream && want_grad) {
      float sg = 0.f;
      for (int w = 0; w < kWarps; ++w) sg += gb_s[w];
      out[1 + d] = sg;
    }
  }
}

// The wide rows (more than 1024 features): thread t's columns t +
// kThreads j (j < kC) with their beta and gradient in registers, loads
// and products predicated on the column (no branch a slot: the loads of
// a row issue together); tiles of
// tile_rows (1, 2 or 4) rows in a ring of `stages` (dynamic shared memory:
// stages x Staged<T>::bytes(tile_rows, d)). A row's sum: each warp's
// butterfly, then the warps' sums in one warp's lanes (a butterfly again,
// a fixed order); lane r of every warp applies the family to row r, and
// warp 0 counts it.
template <typename T, int kMode, int kC>
__global__ void __launch_bounds__(kThreads, kC <= 24 ? 3 : 2)
glm_staged_wide(const T* __restrict__ x, const float* __restrict__ y,
                const float* __restrict__ beta, long long n_valid, int d,
                int family, float* __restrict__ partials, int intercept,
                float b0_scale, int tile_rows, int stages) {
  constexpr bool kStream = kStreamed<kMode>;
  constexpr bool want_grad = kWantGrad<kMode>;
  constexpr unsigned kAll = 0xffffffffu;
  extern __shared__ __align__(16) unsigned char staged_smem[];
  __shared__ float red_s[4][kWarps];
  __shared__ float loss_s[kWarps];
  __shared__ float gb_s[kWarps];
  const int TR = tile_rows;
  const int stage = Staged<T>::bytes(TR, d);
  const int x_bytes = Staged<T>::elems(TR, d) * (int)sizeof(T);
  auto stage_x = [&](int i) {
    return reinterpret_cast<T*>(staged_smem + i * stage);
  };
  auto stage_y = [&](int i) {
    return reinterpret_cast<float*>(staged_smem + i * stage + x_bytes);
  };
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float b0 = kStream && intercept ? beta[d] * b0_scale : 0.f;
  float b[kC], g[kC];
#pragma unroll
  for (int j = 0; j < kC; ++j) {
    const int f = tid + kThreads * j;
    b[j] = f < d ? round_op<T, kMode>(beta[f]) : 0.f;
    g[j] = 0.f;
  }
  const long long n_tiles = (n_valid + TR - 1) / TR;
  const long long grid = gridDim.x;
  for (int k = 0; k < stages - 1; ++k) {
    const long long t = blockIdx.x + k * grid;
    if (t < n_tiles)
      stage_rows<kThreads>(stage_x(k), stage_y(k), x, y, t * TR,
                               (int)min((long long)TR, n_valid - t * TR), d);
    tf32x3::cp_async_commit();
  }
  float loss = 0.f;  // warp 0's lanes < TR: the rows they applied it to
  float gsum = 0.f;  // their residuals (streamed)
  int k = 0;
  for (long long t = blockIdx.x; t < n_tiles; t += grid, ++k) {
    cp_async_wait_upto(stages - 2);
    // tile t is in; every thread is done with the stage the next copy
    // overwrites, and with red_s
    __syncthreads();
    {
      const long long tn = t + (stages - 1) * grid;
      if (tn < n_tiles) {
        const int i = (k + stages - 1) % stages;
        stage_rows<kThreads>(stage_x(i), stage_y(i), x, y, tn * TR,
                                 (int)min((long long)TR, n_valid - tn * TR),
                                 d);
      }
      tf32x3::cp_async_commit();
    }
    const T* tile = stage_x(k % stages);
    const float* ys = stage_y(k % stages);
    const long long row0 = t * TR;
    const int rows = (int)min((long long)TR, n_valid - row0);
    const int sh = flat_shift(x + row0 * d);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (r < TR) {
        float s = 0.f;
        if (r < rows) {
          const int p0 = sh + r * d + tid;
#pragma unroll
          for (int j = 0; j < kC; ++j)
            if (tid + kThreads * j < d)
              s = fmaf(staged_x<T, kMode>(tile, p0 + kThreads * j), b[j],
                       s);
        }
        s = glm::warp_sum(s);
        if (lane == 0) red_s[r][warp] = s;
      }
    }
    __syncthreads();
    float eta_l = 0.f;  // lane r: row r's eta
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (r < TR) {
        const float e = glm::warp_sum(lane < kWarps ? red_s[r][lane] : 0.f);
        if (lane == r) eta_l = e;
      }
    }
    float resid = 0.f;
    if (lane < rows) {
      if constexpr (kStream) eta_l += b0;
      float per;
      family_terms(family, eta_l, ys[lane], &per, &resid);
      if (warp == 0) {
        loss += per;
        if constexpr (kStream) gsum += resid;
      }
    }
    if constexpr (want_grad) {
      const float rq = round_op<T, kMode>(resid);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (r < rows) {
          const float rr = __shfl_sync(kAll, rq, r);
          const int p0 = sh + r * d + tid;
#pragma unroll
          for (int j = 0; j < kC; ++j)
            if (tid + kThreads * j < d)
              g[j] = fmaf(rr, staged_x<T, kMode>(tile, p0 + kThreads * j),
                          g[j]);
        }
      }
    }
  }
  tf32x3::cp_async_wait<0>();
  loss = glm::warp_sum(loss);
  gsum = glm::warp_sum(gsum);
  if (lane == 0) {
    loss_s[warp] = loss;
    gb_s[warp] = gsum;
  }
  __syncthreads();
  float* out = partials + (long long)blockIdx.x * partial_width<kMode>(d);
  if constexpr (want_grad) {
#pragma unroll
    for (int j = 0; j < kC; ++j)
      if (tid + kThreads * j < d) out[1 + tid + kThreads * j] = g[j];
  }
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += loss_s[w];
    out[0] = s;
    if constexpr (kStream && want_grad) {
      float sg = 0.f;
      for (int w = 0; w < kWarps; ++w) sg += gb_s[w];
      out[1 + d] = sg;
    }
  }
}

// ---------------------------------------------------------------------------
// The narrow walk (glm_narrow): f32 X, d <= kNarrowMaxD.
// ---------------------------------------------------------------------------

constexpr int kNarrowMaxD = 128;  // 32 lanes x 4 features
constexpr int kNarrowRows = 8;    // rows a lane group takes at once

// lanes a row takes: 4 features a lane, a power of two
inline int narrow_lanes(int d) {
  int l = 1;
  while (4 * l < d) l <<= 1;
  return l;
}

// A warp walks steps of (32 / lanes) groups x kNarrowRows rows; lane li of
// a group loads features 4 li .. 4 li + 3 of each of its group's rows (a
// float4 when kVec: d % 4 == 0 and X 16-byte aligned; else four floats).
// partials: (gridDim.x, partial_width) of each CTA.
template <int kMode, bool kVec>
__global__ void __launch_bounds__(kThreads, 3)
glm_narrow(const float* __restrict__ x, const float* __restrict__ y,
           const float* __restrict__ beta, long long n_valid, int d,
           int family, float* __restrict__ partials, int intercept,
           float b0_scale, int lanes) {
  constexpr bool kStream = kStreamed<kMode>;
  constexpr bool want_grad = kWantGrad<kMode>;
  constexpr int U = kNarrowRows;
  constexpr unsigned kAll = 0xffffffffu;
  __shared__ float gw_s[kWarps][kNarrowMaxD];
  __shared__ float loss_s[kWarps];
  __shared__ float gb_s[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int li = lane & (lanes - 1);  // lane within its group
  const int gi = lane / lanes;        // the group within the warp
  const int gbase = gi * lanes;
  const int c0 = 4 * li;
  const float b0 = kStream && intercept ? beta[d] * b0_scale : 0.f;
  float b[4], g[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    b[c] = c0 + c < d ? round_op<float, kMode>(beta[c0 + c]) : 0.f;
    g[c] = 0.f;
  }
  float loss = 0.f, gsum = 0.f;
  const long long step_rows = (long long)(32 / lanes) * U;
  const long long n_steps = (n_valid + step_rows - 1) / step_rows;
  const long long n_warps = (long long)gridDim.x * kWarps;
  for (long long st = (long long)blockIdx.x * kWarps + warp; st < n_steps;
       st += n_warps) {
    const long long r0 = st * step_rows + (long long)gi * U;
    // the group's y, loaded beside its rows: lane li < U holds row li's
    // (with lanes < U, every lane holds each row's)
    float yv[U];
    if (lanes >= U) {
      yv[0] = li < U && r0 + li < n_valid ? __ldg(y + r0 + li) : 0.f;
    } else {
#pragma unroll
      for (int u = 0; u < U; ++u)
        yv[u] = r0 + u < n_valid ? __ldg(y + r0 + u) : 0.f;
    }
    float xv[U][4];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long row = r0 + u;
      const bool ok = row < n_valid;
      if constexpr (kVec) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (ok && c0 < d)
          v = __ldg(reinterpret_cast<const float4*>(x + row * d + c0));
        xv[u][0] = v.x;
        xv[u][1] = v.y;
        xv[u][2] = v.z;
        xv[u][3] = v.w;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          xv[u][c] = ok && c0 + c < d ? __ldg(x + row * d + c0 + c) : 0.f;
      }
      if constexpr (kMode == kVgBf16) {
#pragma unroll
        for (int c = 0; c < 4; ++c) xv[u][c] = glm::round_bf16(xv[u][c]);
      }
    }
    float e[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) s = fmaf(xv[u][c], b[c], s);
      e[u] = s;
    }
    // butterflies inside the group: its every lane holds each row's eta
    for (int o = lanes >> 1; o > 0; o >>= 1) {
#pragma unroll
      for (int u = 0; u < U; ++u) e[u] += __shfl_xor_sync(kAll, e[u], o);
    }
    float rr[U];  // the group's rounded residuals
    if (lanes >= U) {
      // lane li < U applies the family to the group's row li
      float eta = e[0];
#pragma unroll
      for (int u = 1; u < U; ++u)
        if (li == u) eta = e[u];
      float resid = 0.f;
      if (li < U && r0 + li < n_valid) {
        if constexpr (kStream) eta += b0;
        float per;
        family_terms(family, eta, yv[0], &per, &resid);
        loss += per;
        if constexpr (kStream) gsum += resid;
      }
      if constexpr (want_grad) {
        const float rq = round_op<float, kMode>(resid);
#pragma unroll
        for (int u = 0; u < U; ++u) rr[u] = __shfl_sync(kAll, rq, gbase + u);
      }
    } else {
      // rows of 4 U features or fewer: every lane of the group applies the
      // family to each row, and the group's lane 0 counts it
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float resid = 0.f;
        if (r0 + u < n_valid) {
          float eta = e[u];
          if constexpr (kStream) eta += b0;
          float per;
          family_terms(family, eta, yv[u], &per, &resid);
          if (li == 0) {
            loss += per;
            if constexpr (kStream) gsum += resid;
          }
        }
        rr[u] = round_op<float, kMode>(resid);
      }
    }
    if constexpr (want_grad) {
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int c = 0; c < 4; ++c) g[c] = fmaf(rr[u], xv[u][c], g[c]);
    }
  }
  if constexpr (want_grad) {
    // the groups' sums of the same columns, added across the warp
    for (int o = lanes; o < 32; o <<= 1) {
#pragma unroll
      for (int c = 0; c < 4; ++c) g[c] += __shfl_xor_sync(kAll, g[c], o);
    }
    if (gi == 0) {
#pragma unroll
      for (int c = 0; c < 4; ++c) gw_s[warp][c0 + c] = g[c];
    }
  }
  loss = glm::warp_sum(loss);
  gsum = glm::warp_sum(gsum);
  if (lane == 0) {
    loss_s[warp] = loss;
    gb_s[warp] = gsum;
  }
  __syncthreads();
  float* part = partials + (long long)blockIdx.x * partial_width<kMode>(d);
  if constexpr (want_grad) {
    if (tid < d) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += gw_s[w][tid];
      part[1 + tid] = s;
    }
  }
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += loss_s[w];
    part[0] = s;
    if constexpr (kStream && want_grad) {
      float sg = 0.f;
      for (int w = 0; w < kWarps; ++w) sg += gb_s[w];
      part[1 + d] = sg;
    }
  }
}

// ---------------------------------------------------------------------------
// The walks' launcher: ops/fused.py::glm_value_walk picks the walk and
// its parameters; the second launch reduces the partials in CTA order.
// ---------------------------------------------------------------------------

enum Walk {
  kWalkRegisters = 0,
  kWalkStaged = 1,
  kWalkNarrow = 2,
  kWalkStream = 3
};

struct WalkArgs {
  int walk;
  int rows;  // staged: tile rows; narrow: lanes a row takes
  int smem;  // staged: bytes of its ring (whole stages)
};

// Launches the walk's kernel, which writes the per-CTA partials. Only the
// kernels that ops/fused.py::glm_value_walk picks are built: registers
// for f32 d <= 4096, staged for bf16 X (tiles of 16 or 32 rows up to d =
// 1024, wider rows beyond) and for f32 rows past 4096, narrow for f32 d
// <= 128, and stream past 12288. The wide staged kernel of f32 also takes
// rows of 1025-4096 features (the same instantiations), which
// scripts/glm_walk_times.py times against the registers walk for the cut.
template <typename T, int kMode>
cudaError_t launch_partials(const T* x, const float* y, const float* beta,
                            long long n_valid, int d, int family,
                            float* partials, int n_part, int intercept,
                            float b0_scale, WalkArgs w, cudaStream_t s) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  if (w.walk == kWalkRegisters) {
    if constexpr (!kF32) {
      return cudaErrorInvalidValue;
    } else {
      // C columns per thread, rounded up to a power of two; R rows per
      // block keep a thread's block of X at 64 registers or fewer
      const int c = (d + kThreads - 1) / kThreads;
      if (c > kMaxCols) return cudaErrorInvalidValue;
#define GLM_REGISTERS(C, R)                                        \
  glm_block_registers<T, C, R, kMode><<<n_part, kThreads, 0, s>>>( \
      x, y, beta, n_valid, d, family, partials, intercept, b0_scale)
      if (c <= 1) GLM_REGISTERS(1, 16);
      else if (c <= 2) GLM_REGISTERS(2, 16);
      else if (c <= 4) GLM_REGISTERS(4, 16);
      else if (c <= 8) GLM_REGISTERS(8, 8);
      else GLM_REGISTERS(16, 4);
#undef GLM_REGISTERS
    }
  } else if (w.walk == kWalkStaged) {
    // rows: 16 or 32 where a thread owns at most 4 columns (d <= 1024,
    // bf16 X only), else 1, 2 or 4; smem: 2 to kMaxStages stages
    const int stage = Staged<T>::bytes(w.rows, d);
    const int stages = w.smem / stage;
    const bool many = d <= 4 * kThreads;
    if ((kF32 && many) || d > kWideMaxCols * kThreads ||
        (many ? w.rows != 16 && w.rows != 32
              : w.rows != 1 && w.rows != 2 && w.rows != 4) ||
        stages < 2 || stages > kMaxStages || stages * stage != w.smem)
      return cudaErrorInvalidValue;
#define GLM_STAGED(K, C)                                                 \
  {                                                                      \
    const cudaError_t e = cudaFuncSetAttribute(                          \
        K<T, kMode, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,     \
        w.smem);                                                         \
    if (e != cudaSuccess) return e;                                      \
    K<T, kMode, C><<<n_part, kThreads, w.smem, s>>>(                     \
        x, y, beta, n_valid, d, family, partials, intercept, b0_scale,   \
        w.rows, stages);                                                 \
  }
    if constexpr (!kF32) {
      if (d <= kThreads) GLM_STAGED(glm_staged, 1)
      else if (d <= 2 * kThreads) GLM_STAGED(glm_staged, 2)
      else if (d <= 4 * kThreads) GLM_STAGED(glm_staged, 4)
    }
    if (!many) {
      if (d <= 24 * kThreads) GLM_STAGED(glm_staged_wide, 24)
      else GLM_STAGED(glm_staged_wide, kWideMaxCols)
    }
#undef GLM_STAGED
  } else if (w.walk == kWalkNarrow) {
    if constexpr (!kF32) {
      return cudaErrorInvalidValue;
    } else {
      if (d > kNarrowMaxD || w.rows != narrow_lanes(d))
        return cudaErrorInvalidValue;
      const bool vec =
          d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
      auto kern = vec ? glm_narrow<kMode, true> : glm_narrow<kMode, false>;
      kern<<<n_part, kThreads, 0, s>>>(x, y, beta, n_valid, d, family,
                                       partials, intercept, b0_scale, w.rows);
    }
  } else if (w.walk == kWalkStream) {
    glm_block_stream<T, kMode><<<n_part, kThreads, 0, s>>>(
        x, y, beta, n_valid, d, family, partials, intercept, b0_scale);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// walk, rows, smem: ops/fused.py::glm_value_walk's walk (0 registers, 1
// staged, 2 narrow, 3 stream), its rows (staged: tile rows; narrow: lanes
// a row takes) and its shared memory (staged). The second launch, which
// reduces the partials in CTA order, is made here, outside the
// launcher's template: made from inside it, the launch of
// glm::reduce_partials ended the process on an H100 (CUDA 12.8) with no
// error reported.

// x: (n, d) row-major, f32 (x_bf16 == 0) or bf16 (x_bf16 == 1); y: (n,)
// f32; beta: (d,) f32; partials: (n_part, d + 1) f32 scratch; out:
// (d + 1,) f32 = [loss, grad]. Returns cudaGetLastError() of the launches
// (cudaErrorInvalidValue for a walk that does not take the shape).
extern "C" int glm_value_grad(const void* x, int x_bf16, const float* y,
                              const float* beta, long long n_valid, int d,
                              int family, int walk, int rows, int smem,
                              float* partials, int n_part, float* out,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const WalkArgs w{walk, rows, smem};
  const cudaError_t err =
      x_bf16 ? launch_partials<__nv_bfloat16, kResident>(
                   static_cast<const __nv_bfloat16*>(x), y, beta, n_valid, d,
                   family, partials, n_part, 0, 0.f, w, s)
             : launch_partials<float, kResident>(
                   static_cast<const float*>(x), y, beta, n_valid, d, family,
                   partials, n_part, 0, 0.f, w, s);
  if (err != cudaSuccess) return (int)err;
  const int width = d + 1;
  glm::reduce_partials<<<(width + 255) / 256, 256, 0, s>>>(partials, n_part,
                                                           width, out);
  return (int)cudaGetLastError();
}

// The streamed flavour: x (n, d) f32 row-major; y (n,) f32; beta (d + 1,)
// with intercept (b0 = beta[d]) or (d,) without; grad: "vg" (else "val");
// round: bf16 operands ("vg" only); partials: (n_part, d + 2) ("vg") or
// (n_part,) ("val") f32 scratch; acc: [loss, grad (d), sum of residuals]
// ("vg") or [loss] ("val"), which this call ADDS the block's sums into.
// Returns cudaGetLastError() of the launches.
extern "C" int glm_stream(const float* x, int round, const float* y,
                          const float* beta, int intercept, long long n_valid,
                          int d, int family, int grad, int walk, int rows,
                          int smem, float* partials, int n_part, float* acc,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const WalkArgs w{walk, rows, smem};
  const cudaError_t err =
      !grad ? launch_partials<float, kVal>(x, y, beta, n_valid, d, family,
                                           partials, n_part, intercept, 1.f,
                                           w, s)
      : round ? launch_partials<float, kVgBf16>(
                    x, y, beta, n_valid, d, family, partials, n_part,
                    intercept, 1.f, w, s)
              : launch_partials<float, kVg>(x, y, beta, n_valid, d, family,
                                            partials, n_part, intercept, 1.f,
                                            w, s);
  if (err != cudaSuccess) return (int)err;
  const long long width = grad ? d + 2 : 1;
  glm::reduce_partials_add<<<(unsigned)((width + 255) / 256), 256, 0, s>>>(
      partials, n_part, width, acc);
  return (int)cudaGetLastError();
}

// The SGD step of one block: x (n, d) f32 row-major, rows < n_valid
// valid; round: bf16 operands (x and w[:d] rounded where used, the
// residual rounded before the gradient product, the sum of the residuals
// unrounded); y (n,) f32 targets; w_ext (d + 1,) f32, b0 = w_ext[d] *
// iflag; loss: a glm_family.cuh Family (kLogistic, kNormal or kHinge);
// partials: (n_part, d + 2) f32 scratch; out: (d + 2,) f32 = [loss sum,
// grad (d), sum of residuals], written. Returns cudaGetLastError() of the
// launches.
extern "C" int sgd_block_grad(const float* x, int round, const float* y,
                              const float* w_ext, float iflag,
                              long long n_valid, int d, int loss, int walk,
                              int rows, int smem, float* partials, int n_part,
                              float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const WalkArgs w{walk, rows, smem};
  const cudaError_t err =
      round ? launch_partials<float, kVgBf16>(x, y, w_ext, n_valid, d, loss,
                                              partials, n_part, 1, iflag, w,
                                              s)
            : launch_partials<float, kVg>(x, y, w_ext, n_valid, d, loss,
                                          partials, n_part, 1, iflag, w, s);
  if (err != cudaSuccess) return (int)err;
  const long long width = d + 2;
  glm::reduce_partials<<<(unsigned)((width + 255) / 256), 256, 0, s>>>(
      partials, n_part, width, out);
  return (int)cudaGetLastError();
}
