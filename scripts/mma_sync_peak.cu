// The rate of mma.sync on the tensor cores, products per clock per SM.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//        -o "$TMPDIR/mma_sync_peak" scripts/mma_sync_peak.cu && \
//     "$TMPDIR/mma_sync_peak"
//
// Three loops, each over 16 independent accumulators a warp, 8 warps a
// CTA, 1 and 2 CTAs per SM: "tf32 reuse" (m16n8k8 TF32, the same A and B
// every product), "bf16 reuse" (m16n8k16 bf16, the same), and "tf32x3
// gathered" (the pattern of dask_ml_tpu_torch/csrc/glm_value_grad_hess.cu:
// per k-step, A and B fragments gathered from a shared-memory tile, split
// into TF32 pairs, then the three products round by round over 4 x 4
// accumulators). Prints the TFLOP/s of each (counting 2 flops a
// multiply-add) and the products a clock per SM at the card's clock.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>

#include "../dask_ml_tpu_torch/csrc/tf32x3.cuh"

using namespace tf32x3;

template <int KIND>
__global__ void __launch_bounds__(256) bench(float* out, int iters,
                                            uint32_t seed) {
  __shared__ float xs[32][264];
  for (int i = threadIdx.x; i < 32 * 264; i += 256)
    (&xs[0][0])[i] = (float)(i % 97) * 0.01f;
  __syncthreads();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int warp = threadIdx.x >> 5;
  uint32_t ab[4][4], as[4][4], bb[4][2], bs[4][2];
  for (int m = 0; m < 4; ++m)
    for (int i = 0; i < 4; ++i) {
      ab[m][i] = seed * (threadIdx.x + i + m);
      as[m][i] = ab[m][i] ^ 0x1234u;
    }
  for (int n = 0; n < 4; ++n)
    for (int i = 0; i < 2; ++i) {
      bb[n][i] = seed ^ (threadIdx.x * 7 + i + n);
      bs[n][i] = bb[n][i] ^ 0x777u;
    }
  float acc[4][4][4] = {};
  for (int it = 0; it < iters; ++it) {
    if (KIND < 2) {
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          if (KIND == 0)
            mma_tf32(acc[j / 4][j % 4], ab[0], bb[0]);
          else
            mma_bf16(acc[j / 4][j % 4], ab[0], bb[0]);
        }
      continue;
    }
    const int kk = (it & 3) * 8;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int jc = (warp & 3) * 32 + 8 * n + g;
      split(xs[kk + t][jc], bb[n][0], bs[n][0]);
      split(xs[kk + t + 4][jc], bb[n][1], bs[n][1]);
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int ic = (warp >> 2) * 64 + 16 * m + g;
      const float av[4] = {xs[kk + t][ic] * 1.5f, xs[kk + t][ic + 8] * 1.5f,
                           xs[kk + t + 4][ic] * 0.5f,
                           xs[kk + t + 4][ic + 8] * 0.5f};
      split(av, ab[m], as[m]);
    }
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) mma_tf32(acc[m][n], as[m], bb[n]);
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) mma_tf32(acc[m][n], ab[m], bs[n]);
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) mma_tf32(acc[m][n], ab[m], bb[n]);
  }
  float s = 0.f;
  for (int m = 0; m < 4; ++m)
    for (int n = 0; n < 4; ++n)
      for (int e = 0; e < 4; ++e) s += acc[m][n][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

int main() {
  int sms, clk;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  cudaDeviceGetAttribute(&clk, cudaDevAttrClockRate, 0);
  float* out;
  cudaMalloc(&out, (size_t)sms * 2 * 256 * sizeof(float));
  const char* names[3] = {"tf32 reuse", "bf16 reuse", "tf32x3 gathered"};
  const int iters = 2048;
  for (int kind = 0; kind < 3; ++kind)
    for (int per_sm = 1; per_sm <= 2; ++per_sm) {
      const int blocks = sms * per_sm;
      cudaEvent_t e0, e1;
      cudaEventCreate(&e0);
      cudaEventCreate(&e1);
      float ms = 0.f;
      for (int rep = 0; rep < 2; ++rep) {
        cudaEventRecord(e0);
        if (kind == 0)
          bench<0><<<blocks, 256>>>(out, iters, 3);
        else if (kind == 1)
          bench<1><<<blocks, 256>>>(out, iters, 3);
        else
          bench<2><<<blocks, 256>>>(out, iters, 3);
        cudaEventRecord(e1);
        cudaEventSynchronize(e1);
        cudaEventElapsedTime(&ms, e0, e1);
      }
      const double mmas = (double)blocks * 8 * iters * 48;
      const double flops = mmas * 16 * 8 * (kind == 1 ? 16 : 8) * 2;
      printf("%-16s %d CTA/SM: %.3f ms, %.1f TFLOP/s, %.3f products/clock/SM"
             " (%d SMs at %d kHz)\n",
             names[kind], per_sm, ms, flops / ms / 1e9,
             mmas / sms / (ms * 1e-3 * clk * 1e3), sms, clk);
    }
  const cudaError_t err = cudaGetLastError();
  printf("%s\n", cudaGetErrorString(err));
  return err == cudaSuccess ? 0 : 1;
}
