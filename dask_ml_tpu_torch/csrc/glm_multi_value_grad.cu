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
// flops a byte, below the card's f32 ratio of about 20 (the crossover is
// near C = 20 in f32, C = 10 in bf16).
//
// A CTA of 256 threads walks tiles of 32 rows. The tile is staged in
// shared memory as f32 in chunks of up to 512 features (one chunk at the
// main width, so X is read from device memory once); f32 rows of one
// chunk are copied in by cp.async into a second buffer while the current
// tile is computed, other tiles are loaded by the threads after asking L2
// for them one tile ahead. B's rows for up to 16 classes sit beside the
// tile (loaded once per kernel when C <= 16 and the row is one chunk). Per
// group of 16 classes:
//   - eta: thread (row = lane, class quad = warp % 4, feature half =
//     warp / 4) adds x[row, 4g:4g+4] . B[c, 4g:4g+4] for its 4 classes
//     over every other group g of four features: 16 FMAs per five 16-byte
//     shared loads. The two halves are added in a fixed order; a thread
//     per (row, class) applies the family and writes the residual into
//     the tile's (32, 16) block;
//   - the gradient is the transposed product: a thread owns 4 classes x 4
//     columns of the chunk (at the main shape 3 x 65 such blocks, one per
//     thread, so the 257th column costs no second round) and adds
//     resid[r, 4 classes] (x) x[r, 4 columns] over the tile's rows: 16
//     FMAs per two 16-byte shared loads; then it adds its block into its
//     own entries of the CTA's (C, d) gradient, which lives in shared
//     memory when it fits (the main shapes) and otherwise in the CTA's own
//     row of the partials in device memory.
// Rows wider than a chunk are staged again for the gradient (from L2), and
// beyond 16 classes the tile is read again per group of 16: every (C, d)
// is taken. No two threads ever add into one word, so there are no float
// atomics; each CTA writes a (1 + C d) partial and a second kernel reduces
// the partials in a fixed order: two runs give bit-equal results. Rows at
// or past n_valid are never read.
//
// bf16 X follows the JAX contract: B is rounded to bf16 for eta (by the
// wrapper), the residual is rounded to bf16 before the gradient
// contraction, and every sum is kept in f32 (X's bf16 values are exact in
// the f32 tile).
//
// The streamed flavour (glm_multi_stream, kStream) also replaces
// dask_ml_tpu/ops/pallas_fused.py::fused_glm_multi_stream (the Pallas body
// _glm_multi_stream_kernel), kinds "val" and "vg": the same design with
// the class codes as the stream's f32 targets (compared exactly with each
// class index, as the Pallas iota compare), the (C,) intercept row b0
// added to eta, the per-class sums of the (unrounded) residuals as column
// d of a gradient of row stride d + 1 (the intercepts' gradient), the
// gradient skipped for "val", and the bf16 operands of the JAX "mxu"
// policy taken from f32 X: rows rounded to bf16 as they are staged (so
// they are staged by the threads, not by cp.async). Its second pass adds
// the block's sums into the pass's accumulators. The rounding is a
// compile-time choice (kRound), as in glm_value_grad.cu.
//
// The SGD flavour (sgd_many_block_grad) replaces
// dask_ml_tpu/ops/pallas_fused.py::fused_sgd_many_block_grad (the Pallas
// body _sgd_many_grad_kernel): the streamed flavour with the SGD losses
// (glm_family.cuh, hinge included), N weight rows in place of the C
// classes, b0 (N,) = W[:, d] * iflags made by the wrapper, and a target
// mode: class codes compared with the row index exactly as f32
// (codes=True, the C one-vs-rest rows of a multiclass model), or one
// target y per data row shared by all N rows (codes=False, a cohort of N
// models). Per-row loss sums are an output too: the per-(row, class)
// losses are kept in a (32, 16) tile beside the residuals, and column
// d + 1 of each gradient row (stride d + 2) gets the tile's sums in row
// order, as column d gets the residuals'. Its second pass writes the
// block's sums. Bound at N = 16 (and C = 10): device memory, X read once;
// at N = 128 (the widest cohort) the 4 S d N flops are past the card's f32
// ratio of flops to bytes: operations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "glm_family.cuh"

namespace {

using glm::Elem;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTR = 32;                    // rows per tile (one per lane)
constexpr int kCK = 16;                    // classes per group
constexpr int kHalves = kWarps / (kCK / 4);  // feature halves of eta

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Stage rows [row0, row0 + rows) x columns [f0, f0 + fw) of a (., ld)
// row-major array into dst (n_rows rows of stride fs floats) as f32, zero
// past rows and fw up to fch: a warp per row, lanes along it.
// round: each value rounded to bf16 (the streamed bf16 operands).
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, long long row0,
                                      int rows, int n_rows, int f0, int fw,
                                      int fch, int fs, long long ld,
                                      bool round = false) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < n_rows; r += kWarps) {
    const T* sr = src + (row0 + r) * ld + f0;
    float* dr = dst + r * fs;
    const int w = r < rows ? fw : 0;
#pragma unroll 4
    for (int f = lane; f < fch; f += 32) {
      const float v = f < w ? Elem<T>::load(sr + f) : 0.f;
      dr[f] = round ? glm::round_bf16(v) : v;
    }
  }
}

// Runtime options: b0 (C,) intercepts or null; grad ("vg", else "val");
// ldg, the row stride of the CTA's gradient (d + 1 when column d holds the
// residual sums of the intercepts, which the streamed flavour adds when b0
// is given; d + 2 with loss_col; else d); shared_y: codes holds one target
// per row for every class (the SGD cohort), else class codes; loss_col:
// column d + 1 gets the per-class loss sums (the SGD flavour).
struct MultiOpts {
  const float* b0;
  int grad;
  int ldg;
  int shared_y;
  int loss_col;
};

// The same for a whole f32 tile (fw = d), by 4-byte cp.async copies that
// zero-fill past rows and d: nothing waits for them until
// cp.async.wait_group.
__device__ __forceinline__ void stage_async(float* dst, const float* x,
                                            long long row0, int rows, int d,
                                            int fch, int fs) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < kTR; r += kWarps) {
    const float* sr = r < rows ? x + (row0 + r) * d : x;
    const int w = r < rows ? d : 0;
    for (int f = lane; f < fch; f += 32) {
      const bool ok = f < w;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                       smem_addr(dst + r * fs + f)),
                   "l"(ok ? sr + f : x), "r"(ok ? 4 : 0)
                   : "memory");
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Shared memory (floats): xs (bufs, kTR, fs) | bs (kCK, fs) | red (kHalves,
// kTR, kCK) | resid_s (kTR, kCK) | loss_s (kWarps) | [resid_f (kTR, kCK),
// streamed: the unrounded residuals] | [per_f (kTR, kCK), with loss_col:
// the per-(row, class) losses] | [grad_s (C, ldg)], with
// fs = fch + 4 and fch (features per chunk, a multiple of 8, so that the
// rows' 16-byte loads spread over all banks) from
// ops/fused.py::glm_multi_geometry. bufs is 2 for f32 rows of one chunk
// (the next tile is copied in while this one is computed), else 1.
template <typename T, bool kStream, bool kRound>
__global__ void __launch_bounds__(kThreads, 2)
glm_multi_partials(const T* __restrict__ x,
                   const std::conditional_t<kStream, float, int>* __restrict__
                       codes,
                   const float* __restrict__ B, long long n_valid, int d,
                   int C, int family, int fch, int grad_smem,
                   float* __restrict__ partials, MultiOpts o) {
  using Code = std::conditional_t<kStream, float, int>;
  extern __shared__ __align__(16) float smem[];
  const int fs = fch + 4;
  const int n_fc = (d + fch - 1) / fch;
  const bool single = n_fc == 1;
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr bool round_x = kStream && kRound;
  const bool pipelined = kF32 && single && !round_x;
  const bool want_grad = !kStream || o.grad;
  const bool want_gb = kStream && o.grad && o.b0 != nullptr;
  const int ldg = o.ldg;
  float* xs0 = smem;
  float* bs = xs0 + (pipelined ? 2 : 1) * kTR * fs;
  float* red = bs + kCK * fs;
  float* resid_s = red + kHalves * kTR * kCK;
  float* loss_s = resid_s + kCK * kTR;
  float* resid_f = loss_s + kWarps;
  float* per_f = resid_f + (kStream ? kTR * kCK : 0);
  const long long width = want_grad ? 1 + (long long)C * ldg : 1;
  float* part = partials + (long long)blockIdx.x * width;
  float* g = grad_smem ? per_f + (o.loss_col ? kTR * kCK : 0) : part + 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int quad = warp % (kCK / 4), half = warp / (kCK / 4);
  if (want_grad)
    for (long long e = tid; e < (long long)C * ldg; e += kThreads) g[e] = 0.f;

  const bool b_resident = C <= kCK && single;
  if (b_resident) stage(bs, B, 0, C, kCK, 0, d, fch, fs, d);
  float loss = 0.f;  // this thread's
  const long long n_tiles = (n_valid + kTR - 1) / kTR;
  auto tile_rows = [&](long long t) {
    return (int)min((long long)kTR, n_valid - t * kTR);
  };
  int buf = 0;
  if constexpr (kF32) {
    if (pipelined && blockIdx.x < n_tiles)
      stage_async(xs0, reinterpret_cast<const float*>(x),
                  (long long)blockIdx.x * kTR, tile_rows(blockIdx.x), d, fch,
                  fs);
  }
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long row0 = t * kTR, tn = t + gridDim.x;
    const int rows = tile_rows(t);
    __syncthreads();  // every read of the previous tile is done
    float* xs = xs0 + buf * kTR * fs;
    if constexpr (kF32) {
      if (pipelined) {
        if (tn < n_tiles) {
          stage_async(xs0 + (buf ^ 1) * kTR * fs,
                      reinterpret_cast<const float*>(x), tn * kTR,
                      tile_rows(tn), d, fch, fs);
          asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        } else {
          asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        }
      }
    }
    if (!pipelined && tn < n_tiles) {
      // ask L2 for the CTA's next tile while this one is computed
      const long long nbytes = tile_rows(tn) * d * (long long)sizeof(T);
      const char* nb = reinterpret_cast<const char*>(x + tn * kTR * d);
      for (long long b = (long long)tid * 128; b < nbytes;
           b += (long long)kThreads * 128)
        asm volatile("prefetch.global.L2 [%0];" ::"l"(nb + b));
    }
    for (int c0 = 0; c0 < C; c0 += kCK) {
      const int nc = min(kCK, C - c0);
      // eta: a thread's 4 classes over its half of the feature groups
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int fc = 0; fc < n_fc; ++fc) {
        const int f0 = fc * fch, fw = min(fch, d - f0);
        if (!single || c0 > 0) __syncthreads();  // readers of xs, bs done
        if (!pipelined && !(single && c0 > 0))
          stage(xs, x, row0, rows, kTR, f0, fw, fch, fs, d, round_x);
        if (!b_resident)
          stage(bs, B + (long long)c0 * d, 0, nc, kCK, f0, fw, fch, fs, d);
        __syncthreads();  // the staged rows (and the async copies) are in
        if (quad * 4 < nc) {
          const float* xr = xs + lane * fs;
          const float* b0 = bs + (quad * 4) * fs;
          for (int gi = half * 4; gi < fw; gi += 4 * kHalves) {
            const float4 xv = *reinterpret_cast<const float4*>(xr + gi);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float4 bv =
                  *reinterpret_cast<const float4*>(b0 + j * fs + gi);
              acc[j] = fmaf(xv.x, bv.x, acc[j]);
              acc[j] = fmaf(xv.y, bv.y, acc[j]);
              acc[j] = fmaf(xv.z, bv.z, acc[j]);
              acc[j] = fmaf(xv.w, bv.w, acc[j]);
            }
          }
        }
      }
      float* rd = red + (half * kTR + lane) * kCK + quad * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) rd[j] = acc[j];
      __syncthreads();
      // the family at each (row, class): the halves added in order
      for (int e = tid; e < kTR * kCK; e += kThreads) {
        const int r = e / kCK, k = e % kCK;
        float resid = 0.f, per = 0.f;
        if (r < rows && k < nc) {
          float eta = 0.f;
          for (int h = 0; h < kHalves; ++h)
            eta += red[(h * kTR + r) * kCK + k];
          if (kStream && o.b0 != nullptr) eta += o.b0[c0 + k];
          const Code code = codes[row0 + r];
          const float yv = o.shared_y ? (float)code
                                      : (code == (Code)(c0 + k) ? 1.f : 0.f);
          glm::family_terms(family, eta, yv, &per, &resid);
          loss += per;
        }
        if constexpr (kStream) {
          resid_s[r * kCK + k] = kRound ? glm::round_bf16(resid) : resid;
          resid_f[r * kCK + k] = resid;
          if (o.loss_col) per_f[r * kCK + k] = per;
        } else {
          resid_s[r * kCK + k] = Elem<T>::round(resid);
        }
      }
      if (!want_grad) continue;
      // the gradient of these classes, chunk by chunk
      for (int fc = 0; fc < n_fc; ++fc) {
        const int f0 = fc * fch, fw = min(fch, d - f0);
        if (!single) {
          __syncthreads();
          stage(xs, x, row0, rows, kTR, f0, fw, fch, fs, d, round_x);
        }
        __syncthreads();  // resid_s (and a restaged chunk) are complete
        if (want_gb && fc == 0 && tid < nc) {
          // the intercepts' gradient: column d, which no unit writes; the
          // per-class losses: column d + 1 (loss_col)
          float a = 0.f;
          for (int r = 0; r < kTR; ++r) a += resid_f[r * kCK + tid];
          g[(long long)(c0 + tid) * ldg + d] += a;
          if (o.loss_col) {
            float l = 0.f;
            for (int r = 0; r < kTR; ++r) l += per_f[r * kCK + tid];
            g[(long long)(c0 + tid) * ldg + d + 1] += l;
          }
        }
        // unit u: classes 4 gq .. 4 gq + 3 and columns 4 cq .. 4 cq + 3
        const int n_kq = (nc + 3) / 4, n_cq = (fw + 3) / 4;
        for (int u = tid; u < n_kq * n_cq; u += kThreads) {
          const int gq = u % n_kq, cq = u / n_kq;
          float ga[4][4] = {};
#pragma unroll 8
          for (int r = 0; r < kTR; ++r) {
            const float4 rv =
                *reinterpret_cast<const float4*>(resid_s + r * kCK + 4 * gq);
            const float4 xv =
                *reinterpret_cast<const float4*>(xs + r * fs + 4 * cq);
            const float ra[4] = {rv.x, rv.y, rv.z, rv.w};
            const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                ga[i][j] = fmaf(ra[i], xa[j], ga[i][j]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int k = 4 * gq + i;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int f = 4 * cq + j;
              if (k < nc && f < fw)
                g[(long long)(c0 + k) * ldg + f0 + f] += ga[i][j];
            }
          }
        }
      }
    }
    buf ^= pipelined ? 1 : 0;
  }
  __syncthreads();
  loss = glm::warp_sum(loss);
  if (lane == 0) loss_s[warp] = loss;
  __syncthreads();
  if (grad_smem && want_grad)
    for (long long e = tid; e < (long long)C * ldg; e += kThreads)
      part[1 + e] = g[e];
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += loss_s[w];
    part[0] = s;
  }
}

template <typename T, bool kStream, bool kRound>
cudaError_t launch_partials(
    const T* x, const std::conditional_t<kStream, float, int>* codes,
    const float* B, long long n_valid, int d, int C, int family, int fch,
    int grad_smem, int smem, float* partials, int n_part, MultiOpts o,
    cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      glm_multi_partials<T, kStream, kRound>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  glm_multi_partials<T, kStream, kRound><<<n_part, kThreads, smem, s>>>(
      x, codes, B, n_valid, d, C, family, fch, grad_smem, partials, o);
  return cudaGetLastError();
}

}  // namespace

// x: (n, d) row-major, f32 (x_bf16 == 0) or bf16 (x_bf16 == 1); codes: (n,)
// int32 class codes; B: (C, d) f32, already rounded to bf16 values when x
// is bf16; partials: (n_part, 1 + C d) f32 scratch; out: (1 + C d) f32 =
// [loss, grad (C, d) row-major]. fch (features per staged chunk),
// grad_smem and smem (bytes) come from ops/fused.py::glm_multi_geometry.
// Returns cudaGetLastError() of the launches.
extern "C" int glm_multi_value_grad(const void* x, int x_bf16,
                                    const int* codes, const float* B,
                                    long long n_valid, int d, int C,
                                    int family, int fch, int grad_smem,
                                    int smem, float* partials, int n_part,
                                    float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const MultiOpts o{nullptr, 1, d, 0, 0};
  const cudaError_t err =
      x_bf16 ? launch_partials<__nv_bfloat16, false, false>(
                   static_cast<const __nv_bfloat16*>(x), codes, B, n_valid, d,
                   C, family, fch, grad_smem, smem, partials, n_part, o, s)
             : launch_partials<float, false, false>(
                   static_cast<const float*>(x), codes, B, n_valid, d, C,
                   family, fch, grad_smem, smem, partials, n_part, o, s);
  if (err != cudaSuccess) return (int)err;
  const long long width = 1 + (long long)C * d;
  glm::reduce_partials<<<(unsigned)((width + 255) / 256), 256, 0, s>>>(
      partials, n_part, width, out);
  return (int)cudaGetLastError();
}

// The streamed flavour: x (n, d) f32 row-major; codes (n,) f32 class codes
// (the stream's targets); B (C, d) f32, already rounded to bf16 values when
// round; b0 (C,) f32 intercepts or null; grad: "vg" (else "val");
// partials: (n_part, 1 + C ldg) ("vg", ldg = d + 1 with b0, else d) or
// (n_part,) ("val") f32 scratch; acc: [loss, grad (C, ldg) row-major]
// ("vg") or [loss] ("val"), which this call ADDS the block's sums into.
// fch, grad_smem and smem: ops/fused.py::glm_multi_geometry(stream=True).
// Returns cudaGetLastError() of the launches.
extern "C" int glm_multi_stream(const float* x, int round, const float* codes,
                                const float* B, const float* b0,
                                long long n_valid, int d, int C, int family,
                                int grad, int fch, int grad_smem, int smem,
                                float* partials, int n_part, float* acc,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ldg = b0 != nullptr ? d + 1 : d;
  const MultiOpts o{b0, grad, ldg, 0, 0};
  const cudaError_t err =
      round ? launch_partials<float, true, true>(x, codes, B, n_valid, d, C,
                                                 family, fch, grad_smem, smem,
                                                 partials, n_part, o, s)
            : launch_partials<float, true, false>(x, codes, B, n_valid, d, C,
                                                  family, fch, grad_smem,
                                                  smem, partials, n_part, o,
                                                  s);
  if (err != cudaSuccess) return (int)err;
  const long long width = grad ? 1 + (long long)C * ldg : 1;
  glm::reduce_partials_add<<<(unsigned)((width + 255) / 256), 256, 0, s>>>(
      partials, n_part, width, acc);
  return (int)cudaGetLastError();
}

// The SGD step of N weight rows on one block: x (n, d) f32 row-major, rows
// < n_valid valid; round: bf16 operands (rows rounded as staged, B already
// rounded to bf16 values, the residual rounded before the gradient
// product, the residual and loss sums unrounded); y (n,) f32: class codes
// (codes == 1, row c's target is y == c) or targets shared by every row
// (codes == 0); B (N, d) f32; b0 (N,) f32 = W[:, d] * iflags; loss: a
// glm_family.cuh Family; partials: (n_part, 1 + N (d + 2)) f32 scratch;
// out: (1 + N (d + 2)) f32 = [loss sum, (N, d + 2) row-major: grad (d),
// sum of residuals, loss sum of the row], written. fch, grad_smem and
// smem: ops/fused.py::glm_multi_geometry(sgd=True). Returns
// cudaGetLastError() of the launches.
extern "C" int sgd_many_block_grad(const float* x, int round, const float* y,
                                   int codes, const float* B, const float* b0,
                                   long long n_valid, int d, int N, int loss,
                                   int fch, int grad_smem, int smem,
                                   float* partials, int n_part, float* out,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const MultiOpts o{b0, 1, d + 2, codes ? 0 : 1, 1};
  const cudaError_t err =
      round ? launch_partials<float, true, true>(x, y, B, n_valid, d, N, loss,
                                                 fch, grad_smem, smem,
                                                 partials, n_part, o, s)
            : launch_partials<float, true, false>(x, y, B, n_valid, d, N,
                                                  loss, fch, grad_smem, smem,
                                                  partials, n_part, o, s);
  if (err != cudaSuccess) return (int)err;
  const long long width = 1 + (long long)N * (d + 2);
  glm::reduce_partials<<<(unsigned)((width + 255) / 256), 256, 0, s>>>(
      partials, n_part, width, out);
  return (int)cudaGetLastError();
}
