// Fused GLM value, gradient and Newton Hessian.
//
// Replaces dask_ml_tpu/ops/pallas_fused.py::fused_glm_value_grad_hess (the
// Pallas body _glm_vgh_kernel). For rows r < n_valid it computes
//   loss = sum_r pointwise(eta_r, y_r),   grad = sum_r resid_r x_r,
//   hess = sum_r w_r x_r x_r^T,
// with eta_r = x_r . beta, resid_r = mean(eta_r) - y_r and the Newton weight
// w_r = hess_weight(eta_r) of the family (glm_family.cuh). X is f32 only:
// the Newton and ADMM fits of the JAX package keep an f32 design.
//
// Bound on an H100: operations. The Hessian is a weighted SYRK, n d (d + 1)
// / 2 fused multiply-adds counting its upper half, against n d 4 bytes of
// X: at d = 257 that is 32 FMAs a byte, far above the card's f32 ratio.
// Tensor cores are left out on purpose: TF32 would move the Newton steps
// off the f32 reference. Every product is an f32 FMA on the SIMT units.
//
// Three launches:
//   1. vgh_rows: a warp per row forms eta (lanes stride the row, a
//      butterfly sums it), and lane 0 writes w_r and resid_r to two (n,)
//      vectors and adds the row's NLL into the CTA's loss partial;
//   2. vgh_syrk: the upper triangle of the (d, d) output is cut into 64 x 64
//      tiles (bi <= bj). A CTA of 128 threads owns one tile and one range
//      of rows (a "split"); it walks its rows 32 at a time through two
//      shared-memory stages (A = w_r x_r[i-tile], B = x_r[j-tile]; the
//      next step's rows are loaded while the current one is computed) and
//      every thread holds 8 x 4 of the tile's sums in registers: per row,
//      3 conflict-free 16-byte shared loads for 32 FMAs. The diagonal tile
//      of a column block also adds resid_r x_r[j-tile] into the gradient
//      from the same shared copy, so each gradient entry is summed by
//      exactly one CTA per split. A warp whose 16 columns all lie past d
//      skips the products (the last block of d = 257 holds one column).
//      The CTAs of one split are launched next to each other, so the
//      tiles share the split's rows through L2;
//   3. vgh_reduce: adds each tile's partials over the splits in a fixed
//      order and writes the upper triangle and its mirror, so the result
//      is exactly symmetric. With a single split (few rows, or a d so wide
//      that the partials would not fit) the tiles write the output
//      directly and this pass is skipped.
// No float atomics anywhere: two runs give bit-equal results. Rows at or
// past n_valid are never read, so the ragged edge needs no padded copy.
//
// The streamed flavour (glm_stream_vgh) also replaces
// dask_ml_tpu/ops/pallas_fused.py::fused_glm_stream for its kind "vgh" (the
// Pallas body _glm_stream_kernel): the same three launches, plus the
// intercept b0 = beta[d] added to eta, the row pass's per-CTA sums of the
// residuals and weights, the diagonal tiles' column sums of w_r x_r (the
// X^T w border of the intercept's Hessian), and every output ADDED into
// the pass's accumulators: [loss, grad (d), sum of residuals, hess] with
// hess (d + 1, d + 1) bordered by X^T w and the sum of w when there is an
// intercept, else (d, d). No column of ones is built.
//
// X is read twice: once for eta (launch 1), once for the products (launch
// 2), since w_r needs the whole row's eta before a tile can use it; the
// row pass takes about a tenth of the call at the main shape, the tile
// products the rest. A later kernel would read X once by giving each CTA
// all the tiles of its rows (eta from the CTA's own rows, the (d, d)
// partial spread over a cluster's shared memory), and would run the tile
// products on wgmma with each f32 input split into a pair of bf16 values.

#include <cuda_runtime.h>

#include "glm_family.cuh"

namespace {

constexpr int kRowWarps = 8;
constexpr int kBT = 64;             // tile edge
constexpr int kKC = 32;             // rows per step of a tile
constexpr int kSyrkThreads = 128;
constexpr int kTI = 8;              // tile rows per thread
constexpr int kTJ = 4;              // tile columns per thread
constexpr int kTIGroups = kBT / kTI;  // 8 row groups x 16 column groups

__device__ __forceinline__ void tile_of(long long t, int* bi, int* bj) {
  // t = bj (bj + 1) / 2 + bi with 0 <= bi <= bj
  long long j = (long long)((sqrt(8.0 * (double)t + 1.0) - 1.0) * 0.5);
  while (j * (j + 1) / 2 > t) --j;
  while ((j + 1) * (j + 2) / 2 <= t) ++j;
  *bj = (int)j;
  *bi = (int)(t - j * (j + 1) / 2);
}

__global__ void __launch_bounds__(kRowWarps * 32)
vgh_rows(const float* __restrict__ x, const float* __restrict__ y,
         const float* __restrict__ beta, long long n_valid, int d, int family,
         float* __restrict__ w, float* __restrict__ resid,
         float* __restrict__ loss_part, const float* __restrict__ b0,
         float* __restrict__ sums_part) {
  // b0 (streamed, with an intercept): added to eta. sums_part (streamed):
  // this CTA's [sum of residuals, sum of weights]
  __shared__ float loss_s[kRowWarps];
  __shared__ float rsum_s[kRowWarps];
  __shared__ float wsum_s[kRowWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long stride = (long long)gridDim.x * kRowWarps;
  const float bias = b0 != nullptr ? *b0 : 0.f;
  float loss = 0.f;  // lane 0's
  float rsum = 0.f, wsum = 0.f;
  for (long long r = (long long)blockIdx.x * kRowWarps + warp; r < n_valid;
       r += stride) {
    const float* xr = x + r * d;
    float eta = 0.f;
#pragma unroll 4
    for (int f = lane; f < d; f += 32)
      eta = fmaf(__ldg(xr + f), __ldg(beta + f), eta);
    eta = glm::warp_sum(eta);
    if (b0 != nullptr) eta += bias;
    if (lane == 0) {
      float per, res;
      glm::family_terms(family, eta, y[r], &per, &res);
      const float wr = glm::hess_weight(family, eta);
      loss += per;
      rsum += res;
      wsum += wr;
      w[r] = wr;
      resid[r] = res;
    }
  }
  if (lane == 0) {
    loss_s[warp] = loss;
    rsum_s[warp] = rsum;
    wsum_s[warp] = wsum;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int i = 0; i < kRowWarps; ++i) s += loss_s[i];
    loss_part[blockIdx.x] = s;
    if (sums_part != nullptr) {
      float rs = 0.f, ws = 0.f;
      for (int i = 0; i < kRowWarps; ++i) {
        rs += rsum_s[i];
        ws += wsum_s[i];
      }
      sums_part[2 * blockIdx.x] = rs;
      sums_part[2 * blockIdx.x + 1] = ws;
    }
  }
}

// A thread's tile rows: two float4s of As, 32 apart, so that the eight
// row groups of a warp read 32 distinct banks.
__device__ __forceinline__ int tile_row(int ti, int a) {
  return (a < 4 ? 0 : kBT / 2) + ti * 4 + (a & 3);
}

// grid (n_tiles, n_split). direct: write hess (d, d) with row stride ld and
// grad (d,) here (added into them when accumulate); else part_h (n_split,
// n_tiles, 64, 64) and part_g (n_split, nb * 64). border (streamed, with
// an intercept): the diagonal tiles also sum w_r x_r into column d of hess
// and its mirror row (direct), else into part_c (n_split, nb * 64).
// Two shared-memory stages: the next step's rows are loaded into
// registers while the current step is computed, then stored into the
// other stage; one barrier a step.
__global__ void __launch_bounds__(kSyrkThreads)
vgh_syrk(const float* __restrict__ x, const float* __restrict__ w,
         const float* __restrict__ resid, long long n_valid, int d, int nb,
         long long rows_per_split, int direct, float* __restrict__ part_h,
         float* __restrict__ part_g, float* __restrict__ hess,
         float* __restrict__ grad, int ld, int accumulate, int border,
         float* __restrict__ part_c) {
  constexpr int kLoads = kKC * kBT / kSyrkThreads;  // per thread and step
  __shared__ __align__(16) float As[2][kKC][kBT];
  __shared__ __align__(16) float Bs[2][kKC][kBT];
  __shared__ float rs[2][kKC];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int ti = tid % kTIGroups, tj = tid / kTIGroups;
  int bi, bj;
  tile_of(blockIdx.x, &bi, &bj);
  const int i0 = bi * kBT, j0 = bj * kBT;
  const bool diag = bi == bj;
  // warp w holds the tile columns 16 w .. 16 w + 15
  const bool active = j0 + warp * (kBT / 4) < d;
  const long long r_begin = (long long)blockIdx.y * rows_per_split;
  const long long r_end = min(r_begin + rows_per_split, n_valid);

  float acc[kTI][kTJ];
#pragma unroll
  for (int a = 0; a < kTI; ++a)
#pragma unroll
    for (int b = 0; b < kTJ; ++b) acc[a][b] = 0.f;
  float gacc = 0.f;  // diagonal tiles, threads < 64: column j0 + tid
  float cacc = 0.f;  // the same, w_r x_r (border)

  // element q of a thread's load: row r_first + 2 q, column c
  const int c = tid & (kBT - 1);
  const int r_first = tid / kBT;
  const bool ca = i0 + c < d, cb = j0 + c < d;
  float xa[kLoads], xb[kLoads], wr[kLoads], rr = 0.f;
  auto load = [&](long long row0) {
    const int rows = (int)min((long long)kKC, r_end - row0);
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int r = r_first + q * (kSyrkThreads / kBT);
      xa[q] = xb[q] = wr[q] = 0.f;
      if (r < rows) {
        const float* xr = x + (row0 + r) * d;
        wr[q] = __ldg(w + row0 + r);
        if (ca) xa[q] = __ldg(xr + i0 + c);
        if (!diag && cb) xb[q] = __ldg(xr + j0 + c);
      }
    }
    rr = tid < rows ? __ldg(resid + row0 + tid) : 0.f;
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int r = r_first + q * (kSyrkThreads / kBT);
      As[buf][r][c] = xa[q] * wr[q];  // the Pallas kernel's x * w
      Bs[buf][r][c] = diag ? xa[q] : xb[q];
    }
    if (tid < kKC) rs[buf][tid] = rr;
  };

  if (r_begin < r_end) {
    load(r_begin);
    store(0);
  }
  __syncthreads();
  int buf = 0;
  for (long long row0 = r_begin; row0 < r_end; row0 += kKC) {
    const bool more = row0 + kKC < r_end;
    if (more) load(row0 + kKC);
    if (active) {
#pragma unroll 8
      for (int k = 0; k < kKC; ++k) {
        const float4 a0 =
            *reinterpret_cast<const float4*>(&As[buf][k][tile_row(ti, 0)]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&As[buf][k][tile_row(ti, 4)]);
        const float4 b =
            *reinterpret_cast<const float4*>(&Bs[buf][k][tj * kTJ]);
        const float av[kTI] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[kTJ] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int a = 0; a < kTI; ++a)
#pragma unroll
          for (int q = 0; q < kTJ; ++q)
            acc[a][q] = fmaf(av[a], bv[q], acc[a][q]);
      }
    }
    if (diag && tid < kBT) {
#pragma unroll 8
      for (int k = 0; k < kKC; ++k)
        gacc = fmaf(rs[buf][k], Bs[buf][k][tid], gacc);
      if (border) {
        // a diagonal tile's As holds w_r x_r of its own columns
#pragma unroll 8
        for (int k = 0; k < kKC; ++k) cacc += As[buf][k][tid];
      }
    }
    // the other stage was last read before the previous barrier
    if (more) store(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

  if (direct) {
#pragma unroll
    for (int a = 0; a < kTI; ++a)
#pragma unroll
      for (int q = 0; q < kTJ; ++q) {
        const int i = i0 + tile_row(ti, a), j = j0 + tj * kTJ + q;
        if (i < d && j < d && i <= j) {
          float v = acc[a][q];
          if (accumulate) v += hess[(long long)i * ld + j];
          hess[(long long)i * ld + j] = v;
          hess[(long long)j * ld + i] = v;
        }
      }
    if (diag && tid < kBT && j0 + tid < d) {
      const int j = j0 + tid;
      grad[j] = accumulate ? grad[j] + gacc : gacc;
      if (border) {
        float v = cacc;
        if (accumulate) v += hess[(long long)j * ld + d];
        hess[(long long)j * ld + d] = v;
        hess[(long long)d * ld + j] = v;
      }
    }
  } else {
    const long long n_tiles = (long long)nb * (nb + 1) / 2;
    float* P = part_h + ((long long)blockIdx.y * n_tiles + blockIdx.x) *
                            (kBT * kBT);
#pragma unroll
    for (int a = 0; a < kTI; ++a) {
      const float4 v = make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
      *reinterpret_cast<float4*>(P + tile_row(ti, a) * kBT + tj * kTJ) = v;
    }
    if (diag && tid < kBT) {
      part_g[(long long)blockIdx.y * nb * kBT + j0 + tid] = gacc;
      if (border) part_c[(long long)blockIdx.y * nb * kBT + j0 + tid] = cacc;
    }
  }
}

// grid (n_tiles, kBT * kBT / 256): block (t, e) sums 256 entries of tile t
// over the splits in order and writes those of the upper triangle with
// their mirror (row stride ld; added into hess when accumulate); blocks
// (0, e) also sum the gradient and, with border, the X^T w column.
__global__ void __launch_bounds__(256)
vgh_reduce(const float* __restrict__ part_h, const float* __restrict__ part_g,
           int n_split, int d, int nb, float* __restrict__ hess,
           float* __restrict__ grad, int ld, int accumulate, int border,
           const float* __restrict__ part_c) {
  int bi, bj;
  tile_of(blockIdx.x, &bi, &bj);
  const long long n_tiles = (long long)nb * (nb + 1) / 2;
  const int e = blockIdx.y * blockDim.x + threadIdx.x;
  const int ii = e / kBT, jj = e % kBT;
  const int i = bi * kBT + ii, j = bj * kBT + jj;
  if (i < d && j < d && i <= j) {
    float s = 0.f;
    for (int p = 0; p < n_split; ++p)
      s += part_h[((long long)p * n_tiles + blockIdx.x) * (kBT * kBT) + e];
    if (accumulate) s += hess[(long long)i * ld + j];
    hess[(long long)i * ld + j] = s;
    hess[(long long)j * ld + i] = s;
  }
  if (blockIdx.x == 0) {
    for (int c = e; c < d; c += gridDim.y * blockDim.x) {
      float s = 0.f;
      for (int p = 0; p < n_split; ++p)
        s += part_g[(long long)p * nb * kBT + c];
      grad[c] = accumulate ? grad[c] + s : s;
      if (border) {
        float sc = 0.f;
        for (int p = 0; p < n_split; ++p)
          sc += part_c[(long long)p * nb * kBT + c];
        if (accumulate) sc += hess[(long long)c * ld + d];
        hess[(long long)c * ld + d] = sc;
        hess[(long long)d * ld + c] = sc;
      }
    }
  }
}

// The streamed flavour's scalars: the row pass's per-CTA loss, residual
// and weight sums in CTA order, added into the accumulators (wsum, the
// Hessian's corner, only with an intercept).
__global__ void vgh_stream_scalars(const float* __restrict__ loss_part,
                                   const float* __restrict__ sums_part,
                                   int n_part, float* __restrict__ loss,
                                   float* __restrict__ rsum,
                                   float* __restrict__ wsum) {
  if (threadIdx.x != 0) return;
  float l = 0.f, rs = 0.f, ws = 0.f;
  for (int p = 0; p < n_part; ++p) {
    l += loss_part[p];
    rs += sums_part[2 * p];
    ws += sums_part[2 * p + 1];
  }
  *loss += l;
  *rsum += rs;
  if (wsum != nullptr) *wsum += ws;
}

}  // namespace

// x: (n, d) row-major f32; y: (n,) f32; beta: (d,) f32. Scratch: w, resid
// (n_valid,); loss_part (n_rows_ctas,); part_h (n_split, n_tiles, 64, 64)
// and part_g (n_split, nb * 64) when n_split > 1. out: (1 + d + d * d) f32
// = [loss, grad, hess row-major]. Returns cudaGetLastError() of the
// launches.
extern "C" int glm_value_grad_hess(const float* x, const float* y,
                                   const float* beta, long long n_valid,
                                   int d, int family, float* w, float* resid,
                                   float* loss_part, int n_rows_ctas,
                                   float* part_h, float* part_g, int n_split,
                                   long long rows_per_split, float* out,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  vgh_rows<<<n_rows_ctas, kRowWarps * 32, 0, s>>>(
      x, y, beta, n_valid, d, family, w, resid, loss_part, nullptr, nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nb = (d + kBT - 1) / kBT;
  const long long n_tiles = (long long)nb * (nb + 1) / 2;
  const int direct = n_split == 1;
  float* grad = out + 1;
  float* hess = out + 1 + d;
  vgh_syrk<<<dim3((unsigned)n_tiles, n_split), kSyrkThreads, 0, s>>>(
      x, w, resid, n_valid, d, nb, rows_per_split, direct, part_h, part_g,
      hess, grad, d, 0, 0, nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (!direct) {
    vgh_reduce<<<dim3((unsigned)n_tiles, kBT * kBT / 256), 256, 0, s>>>(
        part_h, part_g, n_split, d, nb, hess, grad, d, 0, 0, nullptr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  glm::reduce_partials<<<1, 32, 0, s>>>(loss_part, n_rows_ctas, 1, out);
  return (int)cudaGetLastError();
}

// The streamed flavour: x (n, d) f32 row-major; y (n,) f32; beta (d + 1,)
// with intercept (b0 = beta[d]) or (d,) without. Scratch as
// glm_value_grad_hess, plus sums_part (2 n_rows_ctas,) and, when n_split >
// 1 and intercept, part_c (n_split, nb * 64). acc: [loss, grad (d), sum of
// residuals, hess (D, D) row-major], D = d + 1 with intercept (bordered by
// X^T w and the sum of w) else d; this call ADDS the block's sums into it.
// Returns cudaGetLastError() of the launches.
extern "C" int glm_stream_vgh(const float* x, const float* y,
                              const float* beta, int intercept,
                              long long n_valid, int d, int family, float* w,
                              float* resid, float* loss_part,
                              float* sums_part, int n_rows_ctas,
                              float* part_h, float* part_g, float* part_c,
                              int n_split, long long rows_per_split,
                              float* acc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  vgh_rows<<<n_rows_ctas, kRowWarps * 32, 0, s>>>(
      x, y, beta, n_valid, d, family, w, resid, loss_part,
      intercept ? beta + d : nullptr, sums_part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nb = (d + kBT - 1) / kBT;
  const long long n_tiles = (long long)nb * (nb + 1) / 2;
  const int direct = n_split == 1;
  const int ld = intercept ? d + 1 : d;
  float* grad = acc + 1;
  float* hess = acc + 2 + d;
  vgh_syrk<<<dim3((unsigned)n_tiles, n_split), kSyrkThreads, 0, s>>>(
      x, w, resid, n_valid, d, nb, rows_per_split, direct, part_h, part_g,
      hess, grad, ld, 1, intercept, part_c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (!direct) {
    vgh_reduce<<<dim3((unsigned)n_tiles, kBT * kBT / 256), 256, 0, s>>>(
        part_h, part_g, n_split, d, nb, hess, grad, ld, 1, intercept,
        part_c);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  vgh_stream_scalars<<<1, 32, 0, s>>>(
      loss_part, sums_part, n_rows_ctas, acc, acc + 1 + d,
      intercept ? hess + (long long)d * ld + d : nullptr);
  return (int)cudaGetLastError();
}
