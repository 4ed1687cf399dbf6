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
// / 2 multiply-adds counting its upper half, against n d 4 bytes of X: at
// d = 257 that is 32 multiply-adds a byte. On the CUDA cores (67 TFLOP/s
// of f32 FMA) it could not beat cuBLAS's f32 (X*w)^T X; so the products run
// on the tensor cores, to f32 accuracy by the 3xTF32 split of tf32x3.cuh:
// each f32 operand a = big + small in TF32, each product small_a big_b +
// big_a small_b + big_a big_b accumulated in f32, about 2^-21 relative
// error a product, inside HESS_RTOL = 1e-4 of the largest entry against the
// float64 sums that chip_smoke.py holds the Hessian to. Its bound is three
// TF32 products at 495 TFLOP/s. Plain TF32 (one product) would carry 2^-11
// and move the Newton steps off the f32 reference.
//
// Three launches:
//   1. vgh_rows: a warp takes 4 rows at once (its lanes stride them, many
//      loads in flight, halving shuffles sum the 4 dot products), one lane
//      per row applies the family and writes w_r and resid_r to two (n,)
//      vectors; the CTA's loss (and streamed: residual and weight) sums go
//      to per-CTA partials, which vgh_scalars adds in order;
//   2. vgh_syrk: the upper triangle of the (d, d) output is cut into
//      128 x 128 tiles (bi <= bj); a rest of d past the last full block
//      that is at most 16 wide (d = 257 has one column) is a tail folded
//      into the diagonal tiles, a wider rest a block of its own. A CTA of
//      8 warps owns one tile and one range of rows (a "split"); two CTAs
//      share an SM. Its rows arrive 32 at a time by 16-byte cp.async
//      copies (each row from the aligned address at or below its first
//      column, so any d takes whole 16-byte copies; zero-filled past
//      n_valid and past d) into a ring of 3 shared-memory stages, with
//      their w_r and resid_r: one barrier a stage, two stages in flight
//      while one is computed. Warp (wi, wj) holds 64 x 32 sums (4 x 4
//      m16n8 fragments): per 8 rows it gathers its B fragments x[k][j]
//      and A fragments w_k x[k][i] (x^T as the A operand) from the staged
//      row-major copy and splits each value once into registers; per
//      16-row band the three products of its fragments go into zeroed
//      accumulators round by round, then into the band's f32 sums by
//      rounded adds (the tensor cores truncate). Bands that hold no entry
//      of the upper triangle within d are skipped. On the diagonal the two
//      warps whose sums would all lie below it take the tail's strip
//      (the block's rows by the tail's columns, staged beside the block),
//      and the last diagonal tile sums the tail's corner on the CUDA
//      cores: a one-column tail costs no CTAs of its own. The staged row
//      stride is 8 mod 32 floats, so both gathers are free of bank
//      conflicts when d % 4 == 0 (other widths shift rows by up to 3
//      floats: at most two-way conflicts, which measured no slower). The
//      diagonal tile of a column block also adds resid_r x_r (and, in the
//      streamed flavour with an intercept, w_r x_r) of its columns, and
//      the last one of the tail's, on the CUDA cores from the same staged
//      copy, so each gradient entry is summed by exactly one CTA per
//      split. The CTAs of one split are launched next to each other, so
//      the tiles share its rows in L2;
//   3. vgh_reduce: adds each tile's partials over the splits (four
//      quarters of the splits in order, then the quarters in order) and
//      writes the upper triangle and its mirror, so the result is exactly
//      symmetric. With a single split (few rows, or a d so wide that the
//      partials would not fit) the tiles write the output directly and
//      mirror it, and this pass is skipped.
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
// What holds it back (PERF.md): mma.sync TF32 peaks below wgmma's 495
// TFLOP/s (scripts/mma_sync_peak.cu measures it); the gathers and splits
// are redone by every warp that reads a value
// (4x for A, 2x for B); a barrier a stage aligns the warps' phases; and a
// diagonal tile's busiest warp does a full warp's products while two
// idle. X is read twice: once for eta (launch 1), once for the products
// (launch 2), since w_r needs the whole row's eta before a tile can use
// it; at 4M x 257 the row pass alone moves 4.1 GB (1.23 ms at 3.35 TB/s).
// A later kernel would feed wgmma from K-major split copies made once per
// stage by a producer warp, and read X once by giving each CTA all the
// tiles of its rows.

#include <cuda_runtime.h>

#include <cstdint>

#include "glm_family.cuh"
#include "tf32x3.cuh"

namespace {

using tf32x3::cp_async16;
using tf32x3::cp_async4;
using tf32x3::cp_async_commit;
using tf32x3::cp_async_wait;
using tf32x3::mma_tf32;
using tf32x3::mma_tf32_zero;
using tf32x3::split;

constexpr int kRowWarps = 8;
constexpr int kRowsPerWarp = 4;     // rows a warp of vgh_rows takes at once
constexpr int kBT = 128;            // tile edge
constexpr int kKC = 32;             // rows per stage
constexpr int kStages = 3;          // the ring of staged rows
constexpr int kSyrkThreads = 256;   // 8 warps
constexpr int kRegion = kBT + 4;    // a block's columns and a row's shift
constexpr int kLd = 2 * kRegion;    // staged row stride, 8 mod 32 floats

// A stage holds kKC rows: the tile's A columns from 0 and, off the
// diagonal, its B columns from kRegion; row r's columns start sh(r) =
// (its address / 4) mod 4 floats in (copied 16 bytes at a time from the
// aligned address at or below them).
struct SyrkSmem {
  float x[kStages][kKC][kLd];
  float w[kStages][kKC];
  float r[kStages][kKC];
  float gsum[2][kBT];  // the diagonal tile's column sums, per row half
  float csum[2][kBT];
  float tsum[2][16];   // the same for the tail's columns
  float tcsum[2][16];
};

__device__ __forceinline__ void tile_of(long long t, int* bi, int* bj) {
  // t = bj (bj + 1) / 2 + bi with 0 <= bi <= bj
  long long j = (long long)((sqrt(8.0 * (double)t + 1.0) - 1.0) * 0.5);
  while (j * (j + 1) / 2 > t) --j;
  while ((j + 1) * (j + 2) / 2 <= t) ++j;
  *bj = (int)j;
  *bi = (int)(t - j * (j + 1) / 2);
}

// A warp takes kRowsPerWarp consecutive rows at once: every lane loads its
// strided features of all of them (many loads in flight), the partial dot
// products are summed across the warp by halving shuffles, and one lane
// per row applies the family.
__global__ void __launch_bounds__(kRowWarps * 32)
vgh_rows(const float* __restrict__ x, const float* __restrict__ y,
         const float* __restrict__ beta, long long n_valid, int d, int family,
         float* __restrict__ w, float* __restrict__ resid,
         float* __restrict__ loss_part, const float* __restrict__ b0,
         float* __restrict__ sums_part) {
  // b0 (streamed, with an intercept): added to eta. sums_part (streamed):
  // this CTA's [sum of residuals, sum of weights]
  constexpr int R = kRowsPerWarp;
  __shared__ float loss_s[kRowWarps];
  __shared__ float rsum_s[kRowWarps];
  __shared__ float wsum_s[kRowWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long stride = (long long)gridDim.x * kRowWarps * R;
  const float bias = b0 != nullptr ? *b0 : 0.f;
  float loss = 0.f, rsum = 0.f, wsum = 0.f;  // the lanes of the family
  for (long long r0 = ((long long)blockIdx.x * kRowWarps + warp) * R;
       r0 < n_valid; r0 += stride) {
    const int rows = (int)min((long long)R, n_valid - r0);
    const float* xr = x + r0 * d;
    float p[R];
#pragma unroll
    for (int j = 0; j < R; ++j) p[j] = 0.f;
#pragma unroll 4
    for (int f = lane; f < d; f += 32) {
      const float bf = __ldg(beta + f);
#pragma unroll
      for (int j = 0; j < R; ++j)
        if (j < rows) p[j] = fmaf(__ldg(xr + (long long)j * d + f), bf, p[j]);
    }
    glm::warp_sum_halving<R>(p, lane);
    const int j = lane / (32 / R);
    if (lane % (32 / R) == 0 && j < rows) {
      const long long r = r0 + j;
      const float eta = b0 != nullptr ? p[0] + bias : p[0];
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
  loss = glm::warp_sum(loss);
  rsum = glm::warp_sum(rsum);
  wsum = glm::warp_sum(wsum);
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

// The column blocks: nb full 128-wide blocks and, when the rest of d is 1
// to kTail columns wide, a tail folded into the diagonal tiles (tail > 0);
// else the rest is a block of its own (nb counts it) and tail = 0.
constexpr int kTail = 16;

struct Blocks {
  int nb, tail;
};

__host__ __device__ inline Blocks blocks_of(int d) {
  const int full = d / kBT, rest = d - full * kBT;
  if (full >= 1 && rest > 0 && rest <= kTail) return {full, rest};
  return {(d + kBT - 1) / kBT, 0};
}

// Issue the copies of rows [row0, row0 + rows) of the tile's columns into
// stage buf: a warp per row, 16-byte copies from the aligned address at or
// below each region's first column (X is 16-byte aligned, so the bytes
// before it belong to the same row or the row before), up to 16 columns
// past the region's width rounded to 16 (the widest fragment), zero past
// the width and past rows; w_r (and resid_r on the diagonal) beside them.
// Region A: columns [i0, i0 + wa); region B (wb > 0): [j0, j0 + wb).
__device__ __forceinline__ void issue_stage(
    SyrkSmem& sm, int buf, const float* __restrict__ x,
    const float* __restrict__ w, const float* __restrict__ resid,
    long long row0, int rows, int d, int i0, int wa, int j0, int wb,
    bool diag) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* base = x + row0 * (long long)d;
  const int sh0 = (int)((reinterpret_cast<uintptr_t>(base) >> 2) & 3);
  const int qa = ((wa + 15) & ~15) / 4 + 1;
  const int per_row = qa + (wb > 0 ? ((wb + 15) & ~15) / 4 + 1 : 0);
  for (int r = warp; r < kKC; r += kSyrkThreads / 32) {
    const int sh = (sh0 + r * d) & 3;
    const float* row = base + (long long)r * d - sh;
    for (int q = lane; q < per_row; q += 32) {
      const bool in_a = q < qa;
      const int qq = in_a ? q : q - qa;
      const int width = in_a ? wa : wb;
      const int valid =
          r < rows ? min(max(width + sh - 4 * qq, 0), 4) : 0;
      const float* src = valid > 0 ? row + (in_a ? i0 : j0) + 4 * qq : x;
      cp_async16(&sm.x[buf][r][(in_a ? 0 : kRegion) + 4 * qq], src,
                 4 * valid);
    }
  }
  const int tid = threadIdx.x;
  if (tid < kKC) {
    cp_async4(&sm.w[buf][tid], tid < rows ? w + row0 + tid : w, tid < rows);
  } else if (diag && tid < 2 * kKC) {
    const int k = tid - kKC;
    cp_async4(&sm.r[buf][k], k < rows ? resid + row0 + k : resid, k < rows);
  }
}

// One k-step (8 staged rows) of a warp's N n8 fragments per live band:
// gather and split B once, then per band its A, the three products into
// zeroed accumulators round by round over the N fragments, and rounded
// adds into the band's f32 sums (the tensor cores truncate).
template <int N>
__device__ __forceinline__ void k_step(float (&acc)[4][4][4], unsigned mlive,
                                       const float (*xs)[kLd], int kk, int a0,
                                       int b0, float w0, float w1, int g,
                                       int t) {
  uint32_t bb[N][2], bs[N][2];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int jc = b0 + 8 * n + g;
    split(xs[kk + t][jc], bb[n][0], bs[n][0]);
    split(xs[kk + t + 4][jc], bb[n][1], bs[n][1]);
  }
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    if (!((mlive >> m) & 1u)) continue;
    const int ic = a0 + 16 * m + g;
    // A = (x * w)^T, the Pallas kernel's x * w in f32
    const float av[4] = {xs[kk + t][ic] * w0, xs[kk + t][ic + 8] * w0,
                         xs[kk + t + 4][ic] * w1, xs[kk + t + 4][ic + 8] * w1};
    uint32_t ab[4], as[4];
    split(av, ab, as);
    float tmp[N][4];
#pragma unroll
    for (int n = 0; n < N; ++n) mma_tf32_zero(tmp[n], as, bb[n]);
#pragma unroll
    for (int n = 0; n < N; ++n) mma_tf32(tmp[n], ab, bs[n]);
#pragma unroll
    for (int n = 0; n < N; ++n) mma_tf32(tmp[n], ab, bb[n]);
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] += tmp[n][e];
  }
}

// grid (n_tiles, n_split). direct: write hess (d, d) with row stride ld and
// grad (d,) here (added into them when accumulate); else part_h (n_split,
// n_tiles, 128, 128) and part_g (n_split, nb * 128 + kTail). border
// (streamed, with an intercept): the diagonal tiles also sum w_r x_r into
// column d of hess and its mirror row (direct), else into part_c (as
// part_g).
//
// Warp (wi, wj) of a tile holds 64 x 32 sums (4 x 4 m16n8 fragments): rows
// 64 wi + 16 m, columns 32 wj + 8 n; bands (m) that hold no entry of the
// upper triangle within d are skipped. On the diagonal, warps (1, 0) and
// (1, 1) would hold only entries below it; with a tail they take the
// strip (block rows 64 wj.., the tail's columns) instead, from the tail
// columns staged beside the block, and the last diagonal tile also sums
// the tail's corner, gradient and border columns on the CUDA cores. In
// the partial tile the strip sits in rows 64.. and columns 0..31 (strip
// row ii at row 64 + ii % 64, column 16 (ii / 64) + jt) and the corner in
// rows 64.. and columns 32..47: both below the diagonal, where the tile
// has no entries of its own. kTailed: the kernel is built with and
// without the tail's code (a d that has none spends no registers on it).
template <bool kTailed>
__global__ void __launch_bounds__(kSyrkThreads, 2)
vgh_syrk(const float* __restrict__ x, const float* __restrict__ w,
         const float* __restrict__ resid, long long n_valid, int d, int nb,
         int tail, long long rows_per_split, int direct,
         float* __restrict__ part_h, float* __restrict__ part_g,
         float* __restrict__ hess, float* __restrict__ grad, int ld,
         int accumulate, int border, float* __restrict__ part_c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SyrkSmem& sm = *reinterpret_cast<SyrkSmem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wi = warp >> 2, wj = warp & 3;
  int bi, bj;
  tile_of(blockIdx.x, &bi, &bj);
  const int i0 = bi * kBT, j0 = bj * kBT;
  const int wa = min(kBT, d - i0), wb = min(kBT, d - j0);
  const bool diag = bi == bj;
  const int jt0 = nb * kBT;  // the tail's first column
  const bool with_tail = kTailed && diag;
  const bool corner = with_tail && bi == nb - 1;
  const bool strip = with_tail && wi == 1 && wj < 2;
  // the warp's rows (A region) and columns (staged at b0 + 8 n)
  const int row0w = strip ? 64 * wj : 64 * wi;
  const int col0w = strip ? 0 : 32 * wj;
  const int boff = diag && !strip ? 0 : kRegion;
  const int wcols = strip ? tail : wb;  // the width its columns lie in
  const long long r_begin = (long long)blockIdx.y * rows_per_split;
  const long long r_end = min(r_begin + rows_per_split, n_valid);
  const int n_steps =
      r_end > r_begin ? (int)((r_end - r_begin + kKC - 1) / kKC) : 0;
  // rows_per_split is a multiple of kKC: every stage starts at a row
  // whose shift is sh0 + k d (k the stage), and a lane's rows kk + t and
  // kk + t + 4 share the shift sh0 + t d, for every kk
  const int sh_split =
      (int)((reinterpret_cast<uintptr_t>(x + r_begin * d) >> 2) & 3);
  const int kd = kKC * d;

  unsigned mlive = 0;
  if (col0w < wcols) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int im = row0w + 16 * m;
      if (im < wa && (strip || !diag || im <= col0w + 31)) mlive |= 1u << m;
    }
  }

  float acc[4][4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
  // diagonal tiles: column gc's sums over row half gh of each stage; the
  // last one's tail: column tc's (threads < 2 kTail) and the corner entry
  // (ca, cc) (threads < tail * tail with ca <= cc)
  const int gc = tid & (kBT - 1), gh = tid / kBT;
  const int tc = tid % kTail, th = tid / kTail;
  const int ca = tail > 0 ? tid / tail : 0, cc = tail > 0 ? tid % tail : 0;
  const bool corner_thread = corner && tid < tail * tail && ca <= cc;
  float gacc = 0.f, cacc = 0.f, tgacc = 0.f, tcacc = 0.f, kacc = 0.f;

  auto issue = [&](int step) {
    const long long row0 = r_begin + (long long)step * kKC;
    issue_stage(sm, step % kStages, x, w, resid, row0,
                (int)min((long long)kKC, r_end - row0), d, i0, wa,
                diag ? jt0 : j0, diag ? tail : wb, diag);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_steps) issue(s);
    cp_async_commit();
  }
  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<kStages - 2>();
    // this stage has landed for every thread, and every read of the stage
    // about to be refilled (two steps ago) is done
    __syncthreads();
    if (step + kStages - 1 < n_steps) issue(step + kStages - 1);
    cp_async_commit();
    const int buf = step % kStages;
    const float(*xs)[kLd] = sm.x[buf];
    const float* ws = sm.w[buf];
    const int sh_stage = (sh_split + step * kd) & 3;
    if (mlive) {
      const int sh = (sh_stage + t * d) & 3;
#pragma unroll
      for (int kk = 0; kk < kKC; kk += 8) {
        const float w0 = ws[kk + t], w1 = ws[kk + t + 4];
        if (strip)
          k_step<2>(acc, mlive, xs, kk, sh + row0w, boff + sh, w0, w1, g, t);
        else
          k_step<4>(acc, mlive, xs, kk, sh + row0w, boff + sh + col0w, w0,
                    w1, g, t);
      }
    }
    if (diag) {
      const float* rs = sm.r[buf];
      if (gc < wa) {
#pragma unroll
        for (int k = 0; k < kKC / 2; ++k) {
          const int kr = gh * (kKC / 2) + k;
          const float xv = xs[kr][((sh_stage + kr * d) & 3) + gc];
          gacc = fmaf(rs[kr], xv, gacc);
          if (border) cacc = fmaf(ws[kr], xv, cacc);
        }
      }
      if (corner && th < 2 && tc < tail) {
#pragma unroll
        for (int k = 0; k < kKC / 2; ++k) {
          const int kr = th * (kKC / 2) + k;
          const float xv = xs[kr][kRegion + ((sh_stage + kr * d) & 3) + tc];
          tgacc = fmaf(rs[kr], xv, tgacc);
          if (border) tcacc = fmaf(ws[kr], xv, tcacc);
        }
      }
      if (corner_thread) {
        for (int kr = 0; kr < kKC; ++kr) {
          const float* xr = &xs[kr][kRegion + ((sh_stage + kr * d) & 3)];
          kacc = fmaf(xr[ca] * ws[kr], xr[cc], kacc);  // the Pallas x * w
        }
      }
    }
  }
  cp_async_wait<0>();

  if (diag) {
    sm.gsum[gh][gc] = gacc;
    sm.csum[gh][gc] = cacc;
    if (corner && th < 2) {
      sm.tsum[th][tc] = tgacc;
      sm.tcsum[th][tc] = tcacc;
    }
  }
  __syncthreads();
  float gs = 0.f, cs = 0.f;
  if (diag && tid < kBT) {
    gs = sm.gsum[0][tid] + sm.gsum[1][tid];
    cs = sm.csum[0][tid] + sm.csum[1][tid];
  } else if (corner && tid >= kBT && tid < kBT + tail) {
    gs = sm.tsum[0][tid - kBT] + sm.tsum[1][tid - kBT];
    cs = sm.tcsum[0][tid - kBT] + sm.tcsum[1][tid - kBT];
  }
  // the column this thread's gs, cs belong to (threads past kBT: the tail)
  const int gcol = tid < kBT ? j0 + tid : jt0 + tid - kBT;
  const bool gown = diag && (tid < wa || (corner && tid >= kBT &&
                                          tid < kBT + tail));

  const long long n_tiles = (long long)nb * (nb + 1) / 2;
  float* P = direct ? nullptr
                    : part_h + ((long long)blockIdx.y * n_tiles + blockIdx.x) *
                                   (kBT * kBT);
  // the sums into the output (direct: entries i <= j < d, which no other
  // CTA writes; added into it when accumulate) or the partial tile
  auto put = [&](int i, int j, int pi, int pj, float v) {
    if (direct) {
      if (i < d && j < d && i <= j) {
        if (accumulate) v += hess[(long long)i * ld + j];
        hess[(long long)i * ld + j] = v;
        hess[(long long)j * ld + i] = v;
      }
    } else {
      P[pi * kBT + pj] = v;
    }
  };
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    if (!((mlive >> m) & 1u)) continue;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      if (strip && n >= 2) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ii = row0w + 16 * m + g + (e >> 1) * 8;
        const int jj = col0w + 8 * n + 2 * t + (e & 1);
        if (strip) {
          if (jj < tail)
            put(i0 + ii, jt0 + jj, 64 + (ii & 63), 16 * (ii >> 6) + jj,
                acc[m][n][e]);
        } else {
          put(i0 + ii, j0 + jj, ii, jj, acc[m][n][e]);
        }
      }
    }
  }
  if (corner_thread) put(jt0 + ca, jt0 + cc, 64 + ca, 32 + cc, kacc);
  if (gown) {
    if (direct) {
      grad[gcol] = accumulate ? grad[gcol] + gs : gs;
      if (border) {
        float v = cs;
        if (accumulate) v += hess[(long long)gcol * ld + d];
        hess[(long long)gcol * ld + d] = v;
        hess[(long long)d * ld + gcol] = v;
      }
    } else {
      const long long gw = (long long)nb * kBT + kTail;
      part_g[blockIdx.y * gw + gcol] = gs;
      if (border) part_c[blockIdx.y * gw + gcol] = cs;
    }
  }
}

// grid (n_tiles, kBT * kBT / (4 * kRedEntries)), kRedThreads threads:
// block (t, y) sums kRedEntries float4s of tile t's partials over the
// splits, each of kRedParts thread groups over its own quarter of the
// splits in order, then the quarters in order; it writes the entries of
// the upper triangle (and of a diagonal tile's strip and corner, see
// vgh_syrk) with their mirror (row stride ld; added into hess when
// accumulate). Blocks (0, y) also sum the gradient and, with border, the
// X^T w column.
constexpr int kRedEntries = 64;
constexpr int kRedParts = 4;
constexpr int kRedThreads = kRedEntries * kRedParts;

__global__ void __launch_bounds__(kRedThreads)
vgh_reduce(const float* __restrict__ part_h, const float* __restrict__ part_g,
           int n_split, int d, int nb, int tail, float* __restrict__ hess,
           float* __restrict__ grad, int ld, int accumulate, int border,
           const float* __restrict__ part_c) {
  __shared__ float4 quarter[kRedParts][kRedEntries];
  int bi, bj;
  tile_of(blockIdx.x, &bi, &bj);
  const long long n_tiles = (long long)nb * (nb + 1) / 2;
  const int q = threadIdx.x / kRedEntries, el = threadIdx.x % kRedEntries;
  const int e4 = 4 * (blockIdx.y * kRedEntries + el);
  const int ii = e4 / kBT, jj = e4 % kBT;
  const int i0 = bi * kBT, jt0 = nb * kBT;
  // where entries ii, jj .. jj + 3 of the partial tile go: the output's
  // (i, j + c), and whether the four are needed at all
  int i = i0 + ii, j = bj * kBT + jj;
  bool used = i < d && j < d && i <= j + 3;
  if (bi == bj && tail > 0 && ii >= 64) {
    if (jj < 32) {  // the strip
      i = i0 + (ii - 64) + 64 * (jj / 16);
      j = jt0 + jj % 16;
      used = i < d && j < d;
    } else if (jj < 48 && bi == nb - 1 && ii < 64 + kTail) {  // the corner
      i = jt0 + ii - 64;
      j = jt0 + jj - 32;
      used = i < d && j < d && i <= j + 3;
    }
  }
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (used) {
    const float4* P = reinterpret_cast<const float4*>(part_h) +
                      ((long long)blockIdx.x * (kBT * kBT) + e4) / 4;
    const long long step = n_tiles * (kBT * kBT) / 4;
    const int p0 = q * n_split / kRedParts;
    const int p1 = (q + 1) * n_split / kRedParts;
#pragma unroll 8
    for (int p = p0; p < p1; ++p) {
      const float4 v = P[p * step];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
  }
  quarter[q][el] = s;
  __syncthreads();
  if (q == 0 && used) {
    for (int k = 1; k < kRedParts; ++k) {
      const float4 v = quarter[k][el];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const float v4[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int jq = j + c;
      if (jq < d && i <= jq) {
        float v = v4[c];
        if (accumulate) v += hess[(long long)i * ld + jq];
        hess[(long long)i * ld + jq] = v;
        hess[(long long)jq * ld + i] = v;
      }
    }
  }
  if (blockIdx.x == 0) {
    const long long gw = (long long)nb * kBT + kTail;
    const int e = blockIdx.y * blockDim.x + threadIdx.x;
    for (int c = e; c < d; c += gridDim.y * blockDim.x) {
      float sg = 0.f;
      for (int p = 0; p < n_split; ++p) sg += part_g[p * gw + c];
      grad[c] = accumulate ? grad[c] + sg : sg;
      if (border) {
        float sc = 0.f;
        for (int p = 0; p < n_split; ++p) sc += part_c[p * gw + c];
        if (accumulate) sc += hess[(long long)c * ld + d];
        hess[(long long)c * ld + d] = sc;
        hess[(long long)d * ld + c] = sc;
      }
    }
  }
}

// The row pass's per-CTA sums, one warp: lane l adds the CTAs l, l + 32,
// ... in order, then a fixed butterfly; loss is written (resident) or
// added into (streamed), and the streamed flavour also adds the residual
// and weight sums (wsum, the Hessian's corner, only with an intercept).
__global__ void vgh_scalars(const float* __restrict__ loss_part,
                            const float* __restrict__ sums_part, int n_part,
                            int add, float* __restrict__ loss,
                            float* __restrict__ rsum,
                            float* __restrict__ wsum) {
  const int lane = threadIdx.x;
  float l = 0.f, rs = 0.f, ws = 0.f;
  for (int p = lane; p < n_part; p += 32) {
    l += loss_part[p];
    if (sums_part != nullptr) {
      rs += sums_part[2 * p];
      ws += sums_part[2 * p + 1];
    }
  }
  l = glm::warp_sum(l);
  rs = glm::warp_sum(rs);
  ws = glm::warp_sum(ws);
  if (lane != 0) return;
  *loss = add ? *loss + l : l;
  if (rsum != nullptr) *rsum += rs;
  if (wsum != nullptr) *wsum += ws;
}

// The tile products and, with several splits, their reduction.
cudaError_t launch_products(const float* x, const float* w, const float* resid,
                            long long n_valid, int d, int n_split,
                            long long rows_per_split, float* part_h,
                            float* part_g, float* part_c, float* hess,
                            float* grad, int ld, int accumulate, int border,
                            cudaStream_t s) {
  const Blocks b = blocks_of(d);
  const long long n_tiles = (long long)b.nb * (b.nb + 1) / 2;
  const int direct = n_split == 1;
  const int smem = (int)sizeof(SyrkSmem);
  auto kernel = b.tail > 0 ? vgh_syrk<true> : vgh_syrk<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)n_tiles, n_split), kSyrkThreads, smem, s>>>(
      x, w, resid, n_valid, d, b.nb, b.tail, rows_per_split, direct, part_h,
      part_g, hess, grad, ld, accumulate, border, part_c);
  err = cudaGetLastError();
  if (err != cudaSuccess || direct) return err;
  vgh_reduce<<<dim3((unsigned)n_tiles, kBT * kBT / (4 * kRedEntries)),
               kRedThreads, 0, s>>>(part_h, part_g, n_split, d, b.nb,
                                    b.tail, hess, grad, ld, accumulate,
                                    border, part_c);
  return cudaGetLastError();
}

}  // namespace

// Tile CTAs an SM holds at once (the occupancy of the tile kernel at its
// launch bounds and shared memory), for ops/fused.py::vgh_geometry; 0 or
// less on an error.
extern "C" int glm_vgh_tile_ctas_per_sm() {
  const int smem = (int)sizeof(SyrkSmem);
  using Kernel = decltype(&vgh_syrk<true>);
  const Kernel kernels[2] = {vgh_syrk<true>, vgh_syrk<false>};
  int least = 1 << 30;
  for (Kernel kernel : kernels) {
    int n = 0;
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel,
                                                      kSyrkThreads,
                                                      smem) != cudaSuccess)
      return -1;
    least = n < least ? n : least;
  }
  return least;
}

// x: (n, d) row-major f32; y: (n,) f32; beta: (d,) f32. Scratch: w, resid
// (n_valid,); loss_part (n_rows_ctas,); part_h (n_split, n_tiles, 128, 128)
// and part_g (n_split, nb * 128) when n_split > 1. out: (1 + d + d * d) f32
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
  err = launch_products(x, w, resid, n_valid, d, n_split, rows_per_split,
                        part_h, part_g, nullptr, out + 1 + d, out + 1, d, 0,
                        0, s);
  if (err != cudaSuccess) return (int)err;
  vgh_scalars<<<1, 32, 0, s>>>(loss_part, nullptr, n_rows_ctas, 0, out,
                               nullptr, nullptr);
  return (int)cudaGetLastError();
}

// The streamed flavour: x (n, d) f32 row-major; y (n,) f32; beta (d + 1,)
// with intercept (b0 = beta[d]) or (d,) without. Scratch as
// glm_value_grad_hess, plus sums_part (2 n_rows_ctas,) and, when n_split >
// 1 and intercept, part_c (n_split, nb * 128). acc: [loss, grad (d), sum of
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
  const int ld = intercept ? d + 1 : d;
  float* hess = acc + 2 + d;
  err = launch_products(x, w, resid, n_valid, d, n_split, rows_per_split,
                        part_h, part_g, part_c, hess, acc + 1, ld, 1,
                        intercept, s);
  if (err != cudaSuccess) return (int)err;
  vgh_scalars<<<1, 32, 0, s>>>(
      loss_part, sums_part, n_rows_ctas, 1, acc, acc + 1 + d,
      intercept ? hess + (long long)d * ld + d : nullptr);
  return (int)cudaGetLastError();
}
