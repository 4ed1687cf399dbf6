// Fused GLM value and gradient: one read of X per call.
//
// Replaces dask_ml_tpu/ops/pallas_fused.py::fused_glm_value_grad (the
// Pallas body _glm_value_grad_kernel). For rows r < n_valid it computes
//   loss = sum_r pointwise(eta_r, y_r),  grad = sum_r resid_r * x_r,
// with eta_r = x_r . beta and resid_r = mean(eta_r) - y_r of the family.
//
// Bound on an H100: device memory. X is read once (n * d * itemsize
// bytes) and the arithmetic is 4 flops per element, far below the card's
// ratio of flops to bytes. Both designs below read X from device memory
// once and keep many loads in flight:
//
// glm_block_registers (f32 X, d <= 256 * kMaxCols): thread t owns the
// columns t, t + 256, ... (C of them); its share of beta and of the CTA's
// gradient sit in registers. A CTA walks blocks of R rows: every thread
// loads its R x C elements of the block into registers at once (all
// independent loads), forms its R partial dot products, and the CTA sums
// them per row (shuffles that halve the live values each step, then the
// 8 warps' sums in order); R threads apply the family and write the
// residuals to shared memory, and every thread adds resid_r * x_rc into
// its gradient registers from the same registers of X.
//
// glm_block_stream (bf16 X, or any d): a warp takes kStreamRowsPerWarp
// rows, its lanes striding a row's features for the dot product, and
// reduces eta with shuffles; then thread f walks the block's rows again by
// column (from L1 or L2) and adds into its own entries of the CTA's
// gradient, held in the CTA's row of the partials in device memory.
//
// No two threads ever add into one word, so there are no float atomics;
// each CTA writes a (1 + d) partial and a second small kernel reduces the
// partials in a fixed order: two runs give bit-equal results. Rows at or
// past n_valid are never read, so the ragged edge needs no padded copy of
// X.
//
// bf16 X follows the JAX contract: beta is rounded to bf16 for the dot
// product, the residual is rounded to bf16 before the gradient
// contraction, and every sum is kept in f32.
//
// The streamed flavour (glm_stream: the modes kVal, kVg, kVgBf16) also
// replaces dask_ml_tpu/ops/pallas_fused.py::fused_glm_stream for its
// kinds "val" and "vg" (the Pallas body _glm_stream_kernel): the same two designs,
// plus the intercept b0 = beta[d] added to eta, the sum of the residuals
// as one more output (the intercept's gradient), the gradient skipped for
// "val", and the bf16 operands of the JAX "mxu" policy taken from f32 X:
// x and beta rounded to bf16 where they are used, the residual rounded
// before the gradient product, the sum of the residuals unrounded. Its
// second pass adds the block's sums into the pass's accumulators.
//
// The SGD step (sgd_block_grad) replaces
// dask_ml_tpu/ops/pallas_fused.py::fused_sgd_block_grad (the Pallas body
// _sgd_grad_kernel): the streamed "vg" flavour with the SGD losses
// (glm_family.cuh: log_loss is the logistic family, squared_error the
// normal family, hinge its own terms), the intercept b0 = w[d] * iflag
// (iflag 0 or 1 zeroes it exactly as the Pallas kernel does), and its
// second pass writing the block's sums [loss, grad (d), sum of residuals]
// rather than adding them. The same two designs and the same bound:
// device memory, X read once, about 4 flops an element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "glm_family.cuh"

namespace {

using glm::Elem;
using glm::family_terms;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxCols = 32;           // columns per thread in registers
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

template <typename T, int kMode>
cudaError_t launch_partials(const T* x, const float* y, const float* beta,
                            long long n_valid, int d, int family,
                            float* partials, int n_part, int intercept,
                            float b0_scale, cudaStream_t s) {
  // C columns per thread, rounded up to a power of two; R rows per block
  // keep a thread's block of X at 64 registers or fewer (16 rows below).
  // bf16 X streams: two-byte loads leave a register block too few bytes
  // in flight (measured slower than streaming at every width tried).
  const int c = (d + kThreads - 1) / kThreads;
#define GLM_REGISTERS(C, R)                                     \
  glm_block_registers<T, C, R, kMode><<<n_part, kThreads, 0, s>>>( \
      x, y, beta, n_valid, d, family, partials, intercept, b0_scale)
  if constexpr (std::is_same<T, float>::value) {
    if (c <= kMaxCols) {
      if (c <= 1) GLM_REGISTERS(1, 16);
      else if (c <= 2) GLM_REGISTERS(2, 16);
      else if (c <= 4) GLM_REGISTERS(4, 16);
      else if (c <= 8) GLM_REGISTERS(8, 8);
      else if (c <= 16) GLM_REGISTERS(16, 4);
      else GLM_REGISTERS(32, 2);
      return cudaGetLastError();
    }
  }
  glm_block_stream<T, kMode><<<n_part, kThreads, 0, s>>>(
      x, y, beta, n_valid, d, family, partials, intercept, b0_scale);
#undef GLM_REGISTERS
  return cudaGetLastError();
}

}  // namespace

// x: (n, d) row-major, f32 (x_bf16 == 0) or bf16 (x_bf16 == 1); y: (n,)
// f32; beta: (d,) f32; partials: (n_part, d + 1) f32 scratch; out:
// (d + 1,) f32 = [loss, grad]. Returns cudaGetLastError() of the launches.
extern "C" int glm_value_grad(const void* x, int x_bf16, const float* y,
                              const float* beta, long long n_valid, int d,
                              int family, float* partials, int n_part,
                              float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      x_bf16 ? launch_partials<__nv_bfloat16, kResident>(
                   static_cast<const __nv_bfloat16*>(x), y, beta, n_valid, d,
                   family, partials, n_part, 0, 0.f, s)
             : launch_partials<float, kResident>(
                   static_cast<const float*>(x), y, beta, n_valid, d, family,
                   partials, n_part, 0, 0.f, s);
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
                          int d, int family, int grad, float* partials,
                          int n_part, float* acc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = x;
  const cudaError_t err =
      !grad ? launch_partials<float, kVal>(xf, y, beta, n_valid, d, family,
                                           partials, n_part, intercept, 1.f,
                                           s)
      : round ? launch_partials<float, kVgBf16>(xf, y, beta, n_valid, d,
                                                family, partials, n_part,
                                                intercept, 1.f, s)
              : launch_partials<float, kVg>(xf, y, beta, n_valid, d, family,
                                            partials, n_part, intercept, 1.f,
                                            s);
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
                              long long n_valid, int d, int loss,
                              float* partials, int n_part, float* out,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      round ? launch_partials<float, kVgBf16>(x, y, w_ext, n_valid, d, loss,
                                              partials, n_part, 1, iflag, s)
            : launch_partials<float, kVg>(x, y, w_ext, n_valid, d, loss,
                                          partials, n_part, 1, iflag, s);
  if (err != cudaSuccess) return (int)err;
  const long long width = d + 2;
  glm::reduce_partials<<<(unsigned)((width + 255) / 256), 256, 0, s>>>(
      partials, n_part, width, out);
  return (int)cudaGetLastError();
}
