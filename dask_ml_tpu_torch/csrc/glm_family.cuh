// GLM family math shared by the GLM kernels (glm_value_grad.cu,
// glm_value_grad_hess.cu, glm_multi_value_grad.cu): the element loads of
// f32 and bf16 X, the bf16 rounding points, and the per-row terms of
// dask_ml_tpu/models/solvers/families.py. One copy, so the kernels cannot
// drift apart. The SGD kernels (fused_sgd_block_grad,
// fused_sgd_many_block_grad) take the same terms: the SGD loss log_loss is
// the logistic family, squared_error the normal family, and hinge a fourth
// "family" here (dask_ml_tpu/ops/pallas_fused.py::sgd_objective_terms).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace glm {
namespace {

enum Family { kNormal = 0, kLogistic = 1, kPoisson = 2, kHinge = 3 };

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float load(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(__ldg(p));
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16(v));
  }
};

// An f32 value rounded to the nearest bf16 (the streamed kernels' bf16
// operands: X arrives f32 from the host and is rounded where it is used).
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float softplus(float e) {
  // log(1 + exp(e)) in the stable form of jax.nn.softplus
  return fmaxf(e, 0.f) + log1pf(expf(-fabsf(e)));
}

__device__ __forceinline__ float sigmoid(float e) {
  if (e >= 0.f) return 1.f / (1.f + expf(-e));
  const float z = expf(e);
  return z / (1.f + z);
}

// Per-row negative log-likelihood and residual d per / d eta (for the
// GLM families mean(eta) - y).
//
// Hinge, with sign = 2 y - 1 and margin m = sign * eta: per = max(0, 1 - m)
// and residual -sign where m < 1, else 0. The tie rule is the Pallas
// kernel's: at m == 1 exactly the residual is 0 (strict <). The JAX
// package's autodiff step differentiates max(0, 1 - m) and gives half of
// -sign there; the port follows the kernel.
__device__ __forceinline__ void family_terms(int family, float eta, float y,
                                             float* per, float* resid) {
  if (family == kNormal) {
    const float r = eta - y;
    *per = 0.5f * r * r;
    *resid = r;
  } else if (family == kLogistic) {
    *per = softplus(eta) - y * eta;
    *resid = sigmoid(eta) - y;
  } else if (family == kHinge) {
    const float sign = 2.f * y - 1.f;
    const float m = sign * eta;
    *per = fmaxf(0.f, 1.f - m);
    *resid = m < 1.f ? -sign : 0.f;
  } else {
    const float mu = expf(eta);
    *per = mu - y * eta;
    *resid = mu - y;
  }
}

// The Newton weight d2 NLL / d eta2 (families.py hess_weight).
__device__ __forceinline__ float hess_weight(int family, float eta) {
  if (family == kNormal) return 1.f;
  if (family == kLogistic) {
    const float p = sigmoid(eta);
    return p * (1.f - p);
  }
  return expf(eta);
}

// Sum over a warp's 32 lanes; every lane ends with the same sum.
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum R values across a warp's lanes, R a power of two <= 32: while more
// than one value is live, a lane keeps one half of them (by its bit o) and
// adds its partner's copy of that half; then plain butterflies. Lane l ends
// with the sum of value l / (32 / R) in p[0], and every lane of a group of
// 32 / R holds the same sum.
template <int R>
__device__ __forceinline__ void warp_sum_halving(float (&p)[R], int lane) {
  static_assert(R >= 1 && R <= 32 && (R & (R - 1)) == 0, "R: 1, 2, ..., 32");
  int live = R;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    if (live > 1) {
      const bool up = (lane & o) != 0;
#pragma unroll
      for (int i = 0; i < R / 2; ++i) {
        if (i < live / 2) {
          const float send = up ? p[i] : p[i + live / 2];
          const float keep = up ? p[i + live / 2] : p[i];
          p[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
        }
      }
      live >>= 1;
    } else {
      p[0] += __shfl_xor_sync(0xffffffffu, p[0], o);
    }
  }
}

// out[j] = sum over p of partials[p, j], p in order: the fixed-order
// second pass that makes two runs bit-equal.
__global__ void reduce_partials(const float* __restrict__ partials,
                                int n_part, long long width,
                                float* __restrict__ out) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= width) return;
  float s = 0.f;
  for (int p = 0; p < n_part; ++p) s += partials[(long long)p * width + j];
  out[j] = s;
}

// out[j] += sum over p of partials[p, j], p in order: the streamed
// kernels' second pass, which adds one block's sums into the pass's
// accumulators in block order.
__global__ void reduce_partials_add(const float* __restrict__ partials,
                                    int n_part, long long width,
                                    float* __restrict__ out) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= width) return;
  float s = 0.f;
  for (int p = 0; p < n_part; ++p) s += partials[(long long)p * width + j];
  out[j] += s;
}

}  // namespace
}  // namespace glm
