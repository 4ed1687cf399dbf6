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

// partials: (gridDim.x, 1 + d) — [loss, grad[0..d)] of each CTA.
template <typename T, int C, int R>
__global__ void __launch_bounds__(kThreads)
glm_block_registers(const T* __restrict__ x, const float* __restrict__ y,
                    const float* __restrict__ beta, long long n_valid, int d,
                    int family, float* __restrict__ partials) {
  static_assert(R >= 1 && R <= 32 && (R & (R - 1)) == 0, "R: 1, 2, ..., 32");
  __shared__ float red_s[kWarps][R];
  __shared__ float resid_s[R];
  __shared__ float loss_s[R];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float b[C], g[C];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const int col = tid + kThreads * j;
    b[j] = col < d ? Elem<T>::round(beta[col]) : 0.f;
    g[j] = 0.f;
  }
  float loss = 0.f;  // threads < R, over the rows they finish
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
                       ? Elem<T>::load(x + (row0 + r) * d + col) : 0.f;
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
      float resid = 0.f;
      if (tid < rows) {
        float per;
        family_terms(family, eta, y[row0 + tid], &per, &resid);
        loss += per;
      }
      resid_s[tid] = Elem<T>::round(resid);
    }
    __syncthreads();
    // red_s and resid_s are next written after the next block's loads
    // and the first barrier, by when every thread has read them
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float rr = resid_s[r];
#pragma unroll
      for (int j = 0; j < C; ++j) g[j] = fmaf(rr, xv[r][j], g[j]);
    }
  }
  if (tid < R) loss_s[tid] = loss;
  __syncthreads();
  float* out = partials + (long long)blockIdx.x * (d + 1);
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const int col = tid + kThreads * j;
    if (col < d) out[1 + col] = g[j];
  }
  if (tid == 0) {
    float s = 0.f;
    for (int r = 0; r < R; ++r) s += loss_s[r];
    out[0] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
glm_block_stream(const T* __restrict__ x, const float* __restrict__ y,
                 const float* __restrict__ beta, long long n_valid, int d,
                 int family, float* __restrict__ partials) {
  __shared__ float resid_s[kStreamRows];
  __shared__ float loss_s[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* out = partials + (long long)blockIdx.x * (d + 1);
  float* g = out + 1;  // thread f owns g[f], g[f + kThreads], ...
  for (int f = tid; f < d; f += kThreads) g[f] = 0.f;

  float loss = 0.f;  // this warp's, the same in every lane
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
          eta = fmaf(Elem<T>::load(xr + f), Elem<T>::round(__ldg(beta + f)),
                     eta);
        // butterfly: every lane ends with the same sum (a + b == b + a)
        for (int o = 16; o > 0; o >>= 1)
          eta += __shfl_xor_sync(0xffffffffu, eta, o);
        float per;
        family_terms(family, eta, y[row], &per, &resid);
        loss += per;
      }
      if (lane == 0) resid_s[r] = Elem<T>::round(resid);
    }
    __syncthreads();
    const int rows = (int)min((long long)kStreamRows, n_valid - row0);
    for (int f = tid; f < d; f += kThreads) {
      const T* xc = x + row0 * d + f;
      float a = 0.f;
#pragma unroll 4
      for (int r = 0; r < rows; ++r)
        a = fmaf(resid_s[r], Elem<T>::load(xc + (long long)r * d), a);
      g[f] += a;
    }
    __syncthreads();  // resid_s is read before the next block writes it
  }
  if (lane == 0) loss_s[warp] = loss;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += loss_s[w];
    out[0] = s;
  }
}

template <typename T>
cudaError_t launch_partials(const T* x, const float* y, const float* beta,
                            long long n_valid, int d, int family,
                            float* partials, int n_part, cudaStream_t s) {
  // C columns per thread, rounded up to a power of two; R rows per block
  // keep a thread's block of X at 64 registers or fewer (16 rows below).
  // bf16 X streams: two-byte loads leave a register block too few bytes
  // in flight (measured slower than streaming at every width tried).
  const int c = (d + kThreads - 1) / kThreads;
#define GLM_REGISTERS(C, R)                                             \
  glm_block_registers<T, C, R><<<n_part, kThreads, 0, s>>>(x, y, beta,  \
                                                           n_valid, d,  \
                                                           family, partials)
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
  glm_block_stream<T><<<n_part, kThreads, 0, s>>>(x, y, beta, n_valid, d,
                                                  family, partials);
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
      x_bf16 ? launch_partials(static_cast<const __nv_bfloat16*>(x), y, beta,
                               n_valid, d, family, partials, n_part, s)
             : launch_partials(static_cast<const float*>(x), y, beta, n_valid,
                               d, family, partials, n_part, s);
  if (err != cudaSuccess) return (int)err;
  const int width = d + 1;
  glm::reduce_partials<<<(width + 255) / 256, 256, 0, s>>>(partials, n_part,
                                                           width, out);
  return (int)cudaGetLastError();
}
