// Lloyd pass: nearest-center assignment and per-cluster statistics.
//
// Replaces three TPU kernels of dask_ml_tpu/ops/pallas_fused.py:
//   fused_lloyd_stats   (body _lloyd_stats_kernel): sums (k, d), counts (k,)
//                       and inertia of the rows r < n_rows, no per-row output;
//   fused_assign_update (body _assign_update_kernel): the same statistics
//                       over the rows with mask > 0, plus labels (n,) and the
//                       masked min-d2 (n,) of every row;
//   fused_kmeans_block_stats (body _kmeans_stream_kernel): the statistics of
//                       one streamed block's rows r < n_valid, ADDED into the
//                       pass's accumulators (kmeans_block_stats), with the
//                       cross term x.c optionally on bf16-rounded operands
//                       (the JAX "mxu" policy; norms and sums stay f32).
// Any (k, d) is taken. Per row, d2_j = ||x||^2 - 2 x.c_j + ||c_j||^2
// clamped at 0, and the label is the FIRST index reaching the minimum, as
// in the Pallas kernels.
//
// Two kernels, one per entry:
//   - lloyd_pass (fused_lloyd_stats; fused_assign_update, the same pass
//     with the per-row label and min-d2 pointers set) takes the
//     tensor-core step, lloyd_mma_partials;
//   - kmeans_block_stats takes the CUDA-core step, lloyd_partials, in f32
//     and with its bf16 cross term.
//
// Bound on an H100. The cross term is 2 n k d flops against n d 4 bytes
// of X: on the main path (8M x 128, k = 64) 131 GFLOP, 2 ms at the CUDA
// cores' f32 FMA rate, 0.8 ms at the f32-accurate 3xTF32 rate of the
// tensor cores (tf32x3.cuh), where the 4.1 GB of X (1.22 ms at 3.35
// TB/s) bound the pass. The CUDA-core step ran the cross term at about 19
// TFLOP/s; with one phase cut at a time (scripts/lloyd_phase_split.py)
// its 6.8 ms split into about 2.7 ms of cross term, 1.7 ms of per-cluster
// sums walk, 0.3 ms of argmin shuffles and 1.6 ms of copies.
//
// The tensor-core step (lloyd_mma_partials): a CTA of 16 warps walks
// tiles of 128 rows, copied by 16-byte cp.async into a ring of two buffers
// (the next tile lands while this one is computed), each row from its
// aligned start (any d and offset), with the row stride 8 mod 32 floats
// and the 16-byte groups of rows whose bit 2 is set swapped pairwise, so
// both fragment gathers below are free of bank conflicts. Per tile:
//   - the cross term X_tile C^T on mma.sync m16n8k8 with the 3xTF32
//     split: warp (h, g) takes rows 16 g .. 16 g + 15 and the 32 centers
//     of half h of a chunk of 64 (four n8 tiles); each X fragment is split
//     in registers as it is gathered, the centers are split once per CTA
//     into (big, small) fragments in shared memory (once per step when
//     they are not resident: more than 64 centers or rows cut into feature
//     chunks). Runs of four k-steps go into zeroed accumulators, which are
//     added into the f32 dot products by rounded adds (the tensor cores
//     add by truncation). ||x||^2 is summed from the same fragments;
//   - the fold: d2 and the first-minimum argmin straight from the
//     accumulator fragments (a lane's candidates rise in index, `<` keeps
//     the first), across the four lanes of a row by shuffles that keep the
//     lower index on a tie, then across the two halves in shared memory;
//   - the per-cluster sums on the CUDA cores, from the tile's rows
//     sorted by label: a stable counting sort per chunk of 64 clusters
//     (ranks within a warp of rows by __match_any_sync, one warp scans
//     the counts), then thread (q, f) walks the rows of clusters 16 q ..
//     16 q + 15 of the chunk in row order and adds feature f of each
//     into its register sums, a plain f32 add per row and feature. On the
//     main path (k <= 64, d <= 128) the CTA's whole (k, d) sums stay in
//     those registers across its tiles and are written once at the end;
//     larger (k, d) take slices of 64 clusters x 128 features, each added
//     into the CTA's slice of the partials in device memory per tile.
//     Rows of several feature chunks copy each 128-feature slice of the
//     tile again (from L2, which the steps' copies just filled) into the
//     step's buffer for the walk. The onehot^T X products on the tensor
//     cores took as long on the main path and 1.3-1.5x as long off it
//     (PERF.md).
// Counts are int32 (not the Pallas f32), added with integer atomics into
// the CTA's own counts, whose result does not depend on their order; the
// inertia is one partial per thread over its own rows. No float atomics:
// a second kernel reduces the CTAs' partials in a fixed order, so two
// runs are bit-equal. Rows past n_rows are never read (their copies
// zero-fill), so the ragged edge needs no padded copy of X. What holds it
// back (scripts/lloyd_phase_split.py, PERF.md): the cross term, the sums
// and the copies with the fold take turns behind barriers in the one CTA
// an SM holds, each near a third of the pass; mma.sync issues about 0.3
// products a clock per SM in the cross term, against 0.6 at its peak.
// Off the main path every step re-splits its chunk of centers, wide rows
// copy the tile again for the sums, and the sums' slices are added into
// the CTA's partials in device memory per tile (a cluster with no rows in
// the tile skipped): k = 256 and d = 768 are slower than on the CUDA-core
// step.
//
// The CUDA-core step (lloyd_partials, kmeans_block_stats only) keeps the
// FMA units fed:
//   - a CTA walks tiles of 128 rows. Each tile is computed in steps:
//     one step per (chunk of 64 centers, chunk of FC features). A step
//     holds a (128, FC) sub-tile of X row-major (row stride FC + 4, which
//     puts neighbouring rows in other banks) and the (FC, 64) block of the
//     transposed centers in shared memory;
//   - a step is register-blocked like a matrix product: 256 threads form
//     16 row-groups x 16 center-groups; a thread holds 8 rows x 4 centers
//     of dot products in registers and, per 4 features, issues 12
//     16-byte shared loads for 128 fused multiply-adds;
//   - the next step's sub-tiles are copied from device memory with
//     cp.async into a second buffer while the current step is computed;
//   - on the main shapes (k <= 64 and a whole row in one chunk) a tile is
//     one step, the centers stay resident and X is read exactly once. More
//     centers re-read the tile from L2 once per chunk of 64; wider rows
//     than fit are cut into feature chunks (ops/fused.py::lloyd_geometry
//     picks FC and where the sums live, as a rule on (d, k));
//   - the 16 threads of a row reduce their candidates with shuffles,
//     keeping the lowest index on a tie, so the first-minimum rule holds
//     for any k.
// Its statistics: after a tile is assigned, thread f owns feature columns
// f, f + 256, ... and walks the tile's rows in order, eight at a time
// (their sums loaded together, a row whose label came earlier in the
// eight continuing from that row's value), adding into the CTA's (k, d)
// sums, which sit in shared memory when they fit and otherwise in the
// CTA's own slice of the partials in device memory; counts by integer
// atomics, a thread's own inertia partial, the same fixed-order reduce.
//
// The bf16 cross term (mxu, CUDA-core step): a step's sub-tile is rounded
// to bf16 in shared memory after its ||x||^2 is taken, the centers arrive
// rounded from the wrapper (their f32 norms beside them), and the sums
// walk then reads the f32 rows from device memory (L2, where the step's
// copy just brought them) instead of the rounded sub-tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "tf32x3.cuh"

namespace {

// ---------------------------------------------------------------------------
// The CUDA-core step (kmeans_block_stats)
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kTC = 16;                  // center-groups per row
constexpr int kTR = kThreads / kTC;      // row-groups
constexpr int kTN = 4;                   // centers per thread and chunk
constexpr int kChunk = kTC * kTN;        // centers per chunk
constexpr int kTM = 8;                   // rows per thread
constexpr int kBM = kTR * kTM;           // rows per tile
constexpr int kWalk = 8;                 // rows per step of the sums walk

// The step geometry (ops/fused.py::lloyd_geometry).
struct Geom {
  long long n_rows;
  int d, k;
  int fc;         // features per step, a multiple of 4
  int n_fc;       // feature chunks: n_fc * fc >= d
  int n_cc;       // center chunks: KP = 64 n_cc
  int vec4;       // d % 4 == 0 and X 16-byte aligned: rows are float4s
  int sums_smem;  // the CTA's (k, d) sums and (k,) counts in shared memory
  int mxu;        // the cross term on bf16-rounded x (and centers)
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// copy `bytes` (<= 16) of src and zero-fill the rest of the 16 bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `n` of this thread's newest copy groups are in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// Start copying X[row0 : row0 + rows, f0 : f0 + fc] into xs (kBM rows,
// stride fc + 4). Rows at or past `rows` and columns at or past d are
// zero-filled.
__device__ __forceinline__ void load_x(float* xs, const float* x,
                                       long long row0, int rows, int f0,
                                       const Geom& g) {
  const int xstride = g.fc + 4;
  if (g.vec4) {
    const int q = g.fc >> 2;
    for (int e = threadIdx.x; e < kBM * q; e += kThreads) {
      const int r = e / q, c = e - r * q, f = f0 + 4 * c;
      const bool ok = r < rows && f < g.d;
      cp_async16(xs + r * xstride + 4 * c,
                 ok ? x + (row0 + r) * g.d + f : x, ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < kBM * g.fc; e += kThreads) {
      const int r = e / g.fc, c = e - r * g.fc, f = f0 + c;
      const bool ok = r < rows && f < g.d;
      cp_async4(xs + r * xstride + c, ok ? x + (row0 + r) * g.d + f : x,
                ok ? 4 : 0);
    }
  }
}

// Start copying the (fc, 64) block (feature chunk fi, center chunk ci) of
// cT, the transposed centers (n_fc fc, KP) zero-padded, into cs.
__device__ __forceinline__ void load_c(float* cs, const float* cT, int ci,
                                       int fi, const Geom& g) {
  const int KP = g.n_cc * kChunk;
  const float* src = cT + (size_t)fi * g.fc * KP + ci * kChunk;
  for (int e = threadIdx.x; e < g.fc * (kChunk / 4); e += kThreads) {
    const int f = e / (kChunk / 4), c = e - f * (kChunk / 4);
    cp_async16(cs + f * kChunk + 4 * c, src + (size_t)f * KP + 4 * c, 16);
  }
}

// Shared memory (floats unless noted):
//   xbuf (2, kBM, fc + 4) | cbuf (1 or 2, fc, 64) | x2s (kBM)
//   | red (kThreads) | lab_s (kBM, int) | [csum (k, d) | cnt (k, int)]
//   when sums_smem
__global__ void __launch_bounds__(kThreads)
lloyd_partials(const float* __restrict__ x, const float* __restrict__ cT,
               const float* __restrict__ c2, Geom g,
               float* __restrict__ psums, int* __restrict__ pcounts,
               float* __restrict__ pinertia) {
  constexpr int BM = kBM, TM = kTM;
  extern __shared__ __align__(16) float smem[];
  const int d = g.d, k = g.k, fc = g.fc, xstride = fc + 4;
  const bool c_resident = g.n_cc == 1 && g.n_fc == 1;
  const int xbuf_size = BM * xstride, cbuf_size = fc * kChunk;
  float* xbuf = smem;
  float* cbuf = xbuf + 2 * xbuf_size;
  float* x2s = cbuf + (c_resident ? 1 : 2) * cbuf_size;
  float* red = x2s + BM;
  int* lab_s = reinterpret_cast<int*>(red + kThreads);
  float* csum_s = reinterpret_cast<float*>(lab_s + BM);
  float* csum = g.sums_smem ? csum_s : psums + (size_t)blockIdx.x * k * d;
  int* cnt = g.sums_smem ? reinterpret_cast<int*>(csum_s + (size_t)k * d)
                         : pcounts + (size_t)blockIdx.x * k;

  const int tid = threadIdx.x;
  const int tc = tid % kTC;  // center-group: lanes 0-15 and 16-31 of a warp
  const int tr = tid / kTC;  // row-group: rows tr, tr + 16, ..., of a tile
  // thread f zeroes the sums of its own feature columns, which only it adds
  for (int f = tid; f < d; f += kThreads)
    for (int j = 0; j < k; ++j) csum[(size_t)j * d + f] = 0.f;
  for (int j = tid; j < k; j += kThreads) cnt[j] = 0;
  if (c_resident) load_c(cbuf, cT, 0, 0, g);

  const long long n_tiles = (g.n_rows + BM - 1) / BM;
  const long long my_tiles =
      blockIdx.x < n_tiles ? (n_tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int per_tile = g.n_cc * g.n_fc;
  const long long n_steps = my_tiles * per_tile;

  // A step is (tile t, center chunk ci, feature chunk fi); this CTA's
  // tiles are blockIdx.x, blockIdx.x + gridDim.x, ...
  auto advance = [&](long long& t, int& ci, int& fi) {
    if (++fi == g.n_fc) {
      fi = 0;
      if (++ci == g.n_cc) {
        ci = 0;
        t += gridDim.x;
      }
    }
  };
  auto issue = [&](long long t, int ci, int fi, int b) {
    const long long row0 = t * BM;
    const int rows = (int)min((long long)BM, g.n_rows - row0);
    load_x(xbuf + b * xbuf_size, x, row0, rows, fi * fc, g);
    if (!c_resident) load_c(cbuf + b * cbuf_size, cT, ci, fi, g);
  };

  long long t = blockIdx.x;
  int ci = 0, fi = 0;
  if (n_steps > 0) issue(t, ci, fi, 0);
  cp_async_commit();

  float inertia = 0.f;  // over this thread's rows (tc == 0 only)
  float acc[TM][kTN];
  float best[TM];
  int bidx[TM];
  long long tn = t;
  int cn = ci, fn = fi;
  for (long long s = 0; s < n_steps; ++s, t = tn, ci = cn, fi = fn) {
    const int b = (int)(s & 1);
    const long long row0 = t * BM;
    const int rows = (int)min((long long)BM, g.n_rows - row0);
    advance(tn, cn, fn);  // the next step
    // every thread is done with the other buffers and the per-row scratch
    __syncthreads();
    if (s + 1 < n_steps) issue(tn, cn, fn, b ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this step's group has landed (the next may not)
    __syncthreads();
    const float* xs = xbuf + b * xbuf_size;
    const float* cs = c_resident ? cbuf : cbuf + b * cbuf_size;

    if (ci == 0 && tid < rows) {
      const float* xr = xs + tid * xstride;
      const int nf = min(fc, d - fi * fc);
      float sq = fi == 0 ? 0.f : x2s[tid];
      for (int f = 0; f < nf; ++f) sq = fmaf(xr[f], xr[f], sq);
      x2s[tid] = sq;
    }
    if (g.mxu) {
      // round the sub-tile for the cross term once ||x||^2 has read it
      __syncthreads();
      float* xw = xbuf + b * xbuf_size;
      for (int e = tid; e < BM * fc; e += kThreads) {
        const int r = e / fc, c = e - r * fc;
        xw[r * xstride + c] = round_bf16(xw[r * xstride + c]);
      }
      __syncthreads();
    }
    if (fi == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int q = 0; q < kTN; ++q) acc[i][q] = 0.f;
    }
    const float* cbase = cs + tc * kTN;
#pragma unroll 2
    for (int f = 0; f < fc; f += 4) {
      float4 cv[4];
#pragma unroll
      for (int p = 0; p < 4; ++p)
        cv[p] = *reinterpret_cast<const float4*>(cbase + (f + p) * kChunk);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 xv = *reinterpret_cast<const float4*>(
            xs + (tr + kTR * i) * xstride + f);
        acc[i][0] = fmaf(xv.x, cv[0].x, acc[i][0]);
        acc[i][1] = fmaf(xv.x, cv[0].y, acc[i][1]);
        acc[i][2] = fmaf(xv.x, cv[0].z, acc[i][2]);
        acc[i][3] = fmaf(xv.x, cv[0].w, acc[i][3]);
        acc[i][0] = fmaf(xv.y, cv[1].x, acc[i][0]);
        acc[i][1] = fmaf(xv.y, cv[1].y, acc[i][1]);
        acc[i][2] = fmaf(xv.y, cv[1].z, acc[i][2]);
        acc[i][3] = fmaf(xv.y, cv[1].w, acc[i][3]);
        acc[i][0] = fmaf(xv.z, cv[2].x, acc[i][0]);
        acc[i][1] = fmaf(xv.z, cv[2].y, acc[i][1]);
        acc[i][2] = fmaf(xv.z, cv[2].z, acc[i][2]);
        acc[i][3] = fmaf(xv.z, cv[2].w, acc[i][3]);
        acc[i][0] = fmaf(xv.w, cv[3].x, acc[i][0]);
        acc[i][1] = fmaf(xv.w, cv[3].y, acc[i][1]);
        acc[i][2] = fmaf(xv.w, cv[3].z, acc[i][2]);
        acc[i][3] = fmaf(xv.w, cv[3].w, acc[i][3]);
      }
    }
    if (fi < g.n_fc - 1) continue;

    // the center chunk's dot products are whole: fold them into best
    __syncthreads();  // x2s is whole
    if (ci == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        best[i] = CUDART_INF_F;
        bidx[i] = 0;
      }
    }
    // this thread's candidates rise in index, so `<` keeps the first
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float x2 = x2s[tr + kTR * i];
#pragma unroll
      for (int q = 0; q < kTN; ++q) {
        const int j = ci * kChunk + tc * kTN + q;
        const float v = fmaxf(x2 - 2.f * acc[i][q] + __ldg(c2 + j), 0.f);
        if (v < best[i]) {
          best[i] = v;
          bidx[i] = j;
        }
      }
    }
    if (ci < g.n_cc - 1) continue;

    // the tile's rows are assigned
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float v = best[i];
      int j = bidx[i];
      // the 16 threads of a row are the lanes of one half-warp
#pragma unroll
      for (int o = kTC / 2; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, o);
        const int oj = __shfl_xor_sync(0xffffffffu, j, o);
        if (ov < v || (ov == v && oj < j)) {
          v = ov;
          j = oj;
        }
      }
      const int r = tr + kTR * i;
      if (tc == 0 && r < rows) {
        lab_s[r] = j;
        inertia += v;
      }
    }
    __syncthreads();

    // a whole row sits in this step's sub-tile; else it is read again
    const bool whole = g.n_fc == 1 && !g.mxu;
    const float* src = whole ? xs : x + row0 * d;
    const int stride = whole ? xstride : d;
    for (int f = tid; f < d; f += kThreads) {
      float* cf = csum + f;
      const float* xf = src + f;
      int r = 0;
      // kWalk rows at a time: their sums are loaded together, each row
      // continues from the latest earlier row of its label, and the
      // stores go in row order, so every sum adds its rows in row order,
      // as a row-by-row walk would, without one load waiting per row
      for (; r + kWalk <= rows; r += kWalk) {
        int l[kWalk];
        float v[kWalk], s[kWalk];
#pragma unroll
        for (int q = 0; q < kWalk; ++q) {
          l[q] = lab_s[r + q];
          v[q] = xf[(size_t)(r + q) * stride];
        }
#pragma unroll
        for (int q = 0; q < kWalk; ++q) s[q] = cf[(size_t)l[q] * d];
#pragma unroll
        for (int q = 0; q < kWalk; ++q) {
#pragma unroll
          for (int p = 0; p < q; ++p)
            if (l[p] == l[q]) s[q] = s[p];
          s[q] += v[q];
        }
#pragma unroll
        for (int q = 0; q < kWalk; ++q) cf[(size_t)l[q] * d] = s[q];
      }
      for (; r < rows; ++r) cf[(size_t)lab_s[r] * d] += xf[(size_t)r * stride];
    }
    if (tid < rows) atomicAdd(&cnt[lab_s[tid]], 1);
  }
  cp_async_wait<0>();
  red[tid] = inertia;
  __syncthreads();

  if (g.sums_smem) {
    float* ps = psums + (size_t)blockIdx.x * k * d;
    for (int i = tid; i < k * d; i += kThreads) ps[i] = csum[i];
    for (int j = tid; j < k; j += kThreads)
      pcounts[(size_t)blockIdx.x * k + j] = cnt[j];
  }
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < kThreads; ++w) s += red[w];
    pinertia[blockIdx.x] = s;
  }
}

// ---------------------------------------------------------------------------
// The tensor-core step (lloyd_pass)
// ---------------------------------------------------------------------------

constexpr int kMRows = 128;               // rows per tile
constexpr int kMGroups = kMRows / 16;     // m16 row groups
constexpr int kMWarps = 2 * kMGroups;     // a row group's two center halves
constexpr int kMThreads = kMWarps * 32;
constexpr int kMCenters = 64;             // centers per chunk: 8 n8 tiles
constexpr int kCTiles = kMCenters / 16;   // n8 tiles of a center half
constexpr int kRunKs = 4;                 // k-steps of a cross-term run
constexpr int kSumF = kMThreads / 4;      // features of a sums slice
constexpr int kSumC = kMCenters / 4;      // clusters a thread sums

// The step geometry (ops/fused.py::lloyd_mma_geometry).
struct MmaGeom {
  long long n_rows;
  int d, k;
  int fc;    // features per step, a multiple of 8
  int n_fc;  // feature chunks: n_fc fc >= d
  int n_cc;  // center chunks: 64 n_cc >= k
  int sx;    // floats per staged row, 8 mod 32, at least fc + 8
};

// Copy X[row0 : row0 + rows, f0 : f0 + fw] into xs (kMRows rows of stride
// sx), a warp per row: 16-byte cp.async from each row's aligned start (X
// is 16-byte aligned, so the bytes before a row's start belong to the row
// before it), zero-filled past fw and past rows, up to fc features. Row
// r's feature f lands at r sx + ((sh(r) + f) ^ swz(r)), with sh(r) its
// start's offset in 16 bytes and swz(r) = 4 where bit 2 of r is set.
__device__ __forceinline__ void stage_rows(float* xs, const float* x,
                                           long long row0, int rows,
                                           int f0, int fw, const MmaGeom& g) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nq = g.fc / 4 + 1;
  const float* base = x + row0 * g.d + f0;
  const int sh0 = (int)((reinterpret_cast<uintptr_t>(base) / 4) & 3);
  for (int r = warp; r < kMRows; r += kMWarps) {
    const int sh = (sh0 + r * g.d) & 3;
    const float* row = base + (long long)r * g.d - sh;
    const int swz = ((r >> 2) & 1) << 2;
    for (int q = lane; q < nq; q += 32) {
      const int valid = r < rows ? min(max(fw + sh - 4 * q, 0), 4) : 0;
      tf32x3::cp_async16(xs + r * g.sx + ((4 * q) ^ swz),
                         valid > 0 ? row + 4 * q : x, 4 * valid);
    }
  }
}

// Shared memory (floats unless noted): xbuf (2, kMRows, sx) | cf (fc / 8,
// 8, 32) float4, the chunk's centers split into the B fragments of each
// k-step, n8 tile and lane: (big, small) of b0 and of b1 | lab_s (kMRows,
// int) | hv (kMRows), hj (kMRows, int): the second center half's best |
// red (kMThreads) | the rows sorted by label: wcnt (kMRows / 32,
// kMCenters, int), the rows of each label in each warp of rows, then
// their first slots; start (kMCenters + 1, int); perm (kMRows, int).
// ops/fused.py::lloyd_mma_geometry sizes it the same way.
__global__ void __launch_bounds__(kMThreads, 1)
lloyd_mma_partials(const float* __restrict__ x,
                   const float* __restrict__ mask,
                   const float* __restrict__ cen,
                   const float* __restrict__ c2, MmaGeom g,
                   int* __restrict__ labels, float* __restrict__ mind_out,
                   float* __restrict__ psums, int* __restrict__ pcounts,
                   float* __restrict__ pinertia) {
  extern __shared__ __align__(16) float msmem[];
  const int d = g.d, k = g.k, fc = g.fc, sx = g.sx;
  const int xbuf_size = kMRows * sx;
  float* xbuf = msmem;
  float4* cf = reinterpret_cast<float4*>(xbuf + 2 * xbuf_size);
  int* lab_s = reinterpret_cast<int*>(cf + fc * 32);
  float* hv = reinterpret_cast<float*>(lab_s + kMRows);
  int* hj = reinterpret_cast<int*>(hv + kMRows);
  float* red = reinterpret_cast<float*>(hj + kMRows);
  int* wcnt = reinterpret_cast<int*>(red + kMThreads);
  int* start = wcnt + (kMRows / 32) * kMCenters;
  int* perm = start + kMCenters + 1;
  float* ps = psums + (size_t)blockIdx.x * k * d;
  int* cnt = pcounts + (size_t)blockIdx.x * k;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  // the cross term: warp (ch, rg) takes rows 16 rg .. 16 rg + 15 and the
  // centers 32 ch .. 32 ch + 31 of a chunk
  const int rg = warp % kMGroups, ch = warp / kMGroups;
  // the sums' slices: chunks of 64 clusters x kSumF features; thread
  // (q, f) of a slice sums clusters kSumC q .. kSumC q + kSumC - 1 of the
  // chunk at feature f
  const int n_cs = (k + kMCenters - 1) / kMCenters;
  const int n_fs = (d + kSumF - 1) / kSumF;
  const int n_slices = n_cs * n_fs;
  const int sq4 = tid / kSumF, sf = tid % kSumF;
  for (int e = tid; e < (kMRows / 32) * kMCenters; e += kMThreads)
    wcnt[e] = 0;
  const bool whole = g.n_fc == 1;
  if (n_slices > 1)
    for (long long e = tid; e < (long long)k * d; e += kMThreads) ps[e] = 0.f;
  for (int j = tid; j < k; j += kMThreads) cnt[j] = 0;

  // the centers [64 ci, 64 ci + 64) x features [fc fi, fc fi + fc) split
  // into cf, zero past k and d; the caller's barrier publishes them
  auto fill_c = [&](int ci, int fi) {
    // unrolled, so a thread's loads are in flight together
#pragma unroll 8
    for (int q = tid; q < fc * 32; q += kMThreads) {
      const int ks = q >> 8, j = (q >> 5) & 7, l = q & 31;
      const int c = ci * kMCenters + 8 * j + (l >> 2);
      const int f = fi * fc + 8 * ks + (l & 3);
      const float* cr = cen + (size_t)c * d;
      const float v0 = c < k && f < d ? __ldg(cr + f) : 0.f;
      const float v1 = c < k && f + 4 < d ? __ldg(cr + f + 4) : 0.f;
      uint32_t b0, s0, b1, s1;
      tf32x3::split(v0, b0, s0);
      tf32x3::split(v1, b1, s1);
      cf[q] = make_float4(__uint_as_float(b0), __uint_as_float(s0),
                          __uint_as_float(b1), __uint_as_float(s1));
    }
  };

  const long long n_tiles = (g.n_rows + kMRows - 1) / kMRows;
  const long long my_tiles =
      blockIdx.x < n_tiles ? (n_tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int per_tile = g.n_cc * g.n_fc;
  const bool c_resident = per_tile == 1;
  const long long n_steps = my_tiles * per_tile;
  if (c_resident) fill_c(0, 0);

  // A step is (tile t, center chunk ci, feature chunk fi); this CTA's
  // tiles are blockIdx.x, blockIdx.x + gridDim.x, ...
  auto advance = [&](long long& t, int& ci, int& fi) {
    if (++fi == g.n_fc) {
      fi = 0;
      if (++ci == g.n_cc) {
        ci = 0;
        t += gridDim.x;
      }
    }
  };
  auto tile_rows = [&](long long t) {
    return (int)min((long long)kMRows, g.n_rows - t * kMRows);
  };
  auto issue = [&](long long t, int fi, int b) {
    stage_rows(xbuf + b * xbuf_size, x, t * kMRows, tile_rows(t), fi * fc,
               min(fc, d - fi * fc), g);
  };

  // a lane's gather offsets in a staged tile: the cross term's A (rows
  // 16 rg + gq + 8 h, k-offsets tq and tq + 4), the sums' B (rows tq and
  // tq + 4 of each 8, feature gq of each n8 tile)
  // (rows start off 16 bytes when d % 4 != 0: each step's own shifts)
  const int sh0 = (int)((reinterpret_cast<uintptr_t>(x) / 4) & 3);
  int oa[2][2], ob[2];
  auto offsets = [&](int s0) {
    const int swz = ((gq >> 2) & 1) << 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * rg + gq + 8 * h;
      const int sh = (s0 + r * d) & 3;
      oa[h][0] = r * sx + ((sh + tq) ^ swz);
      oa[h][1] = r * sx + ((sh + tq + 4) ^ swz);
    }
    const int sh = (s0 + tq * d) & 3;
    ob[0] = tq * sx + sh + gq;
    ob[1] = (tq + 4) * sx + ((sh + gq) ^ 4);
  };

  long long t = blockIdx.x;
  int ci = 0, fi = 0;
  if (n_steps > 0) issue(t, fi, 0);
  tf32x3::cp_async_commit();

  float inertia = 0.f;  // over this lane's rows (tq == 0 only)
  float acc[kCTiles][4];
  float sq[2];
  float best[2];
  int bidx[2];
  // this thread's sums of a slice, kept across the CTA's tiles when there
  // is one slice
  float sacc[kSumC];
#pragma unroll
  for (int c = 0; c < kSumC; ++c) sacc[c] = 0.f;
  long long tn = t;
  int cn = ci, fn = fi;
  for (long long s = 0; s < n_steps; ++s, t = tn, ci = cn, fi = fn) {
    const int b = (int)(s & 1);
    const long long row0 = t * kMRows;
    const int rows = tile_rows(t);
    advance(tn, cn, fn);  // the next step
    // every thread is done with the other buffer, cf and lab_s
    __syncthreads();
    if (s + 1 < n_steps) issue(tn, fn, b ^ 1);
    tf32x3::cp_async_commit();
    tf32x3::cp_async_wait<1>();  // this step's group has landed
    if (!c_resident) fill_c(ci, fi);
    __syncthreads();
    const float* xs = xbuf + b * xbuf_size;
    // the shift of the step's first row in the staged tile
    const int s0 = (sh0 + (int)((row0 * d + fi * fc) & 3)) & 3;
    offsets(s0);

    if (fi == 0) {
#pragma unroll
      for (int j = 0; j < kCTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      sq[0] = sq[1] = 0.f;
    }
    // the cross term in runs of kRunKs k-steps, each into zeroed
    // accumulators added into acc by rounded adds
    const int nks = fc / 8;
    for (int ks0 = 0; ks0 < nks; ks0 += kRunKs) {
      float run[kCTiles][4];
#pragma unroll
      for (int j = 0; j < kCTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) run[j][e] = 0.f;
#pragma unroll
      for (int q = 0; q < kRunKs; ++q) {
        const int ks = ks0 + q;
        if (ks >= nks) break;
        const int k0 = 8 * ks;
        // a0 (row gq, k tq), a1 (gq + 8, tq), a2 (gq, tq + 4), a3 (gq + 8,
        // tq + 4)
        const float av[4] = {xs[oa[0][0] + k0], xs[oa[1][0] + k0],
                             xs[oa[0][1] + k0], xs[oa[1][1] + k0]};
        sq[0] = fmaf(av[0], av[0], sq[0]);
        sq[0] = fmaf(av[2], av[2], sq[0]);
        sq[1] = fmaf(av[1], av[1], sq[1]);
        sq[1] = fmaf(av[3], av[3], sq[1]);
        uint32_t ab[4], as[4];
        tf32x3::split(av, ab, as);
        uint32_t bb[kCTiles][2], bs[kCTiles][2];
#pragma unroll
        for (int j = 0; j < kCTiles; ++j) {
          const float4 v = cf[(ks * 8 + kCTiles * ch + j) * 32 + lane];
          bb[j][0] = __float_as_uint(v.x);
          bs[j][0] = __float_as_uint(v.y);
          bb[j][1] = __float_as_uint(v.z);
          bs[j][1] = __float_as_uint(v.w);
        }
        // the three products round by round over the accumulators
#pragma unroll
        for (int j = 0; j < kCTiles; ++j) tf32x3::mma_tf32(run[j], as, bb[j]);
#pragma unroll
        for (int j = 0; j < kCTiles; ++j) tf32x3::mma_tf32(run[j], ab, bs[j]);
#pragma unroll
        for (int j = 0; j < kCTiles; ++j) tf32x3::mma_tf32(run[j], ab, bb[j]);
      }
#pragma unroll
      for (int j = 0; j < kCTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += run[j][e];
    }
    if (fi < g.n_fc - 1) continue;

    // the chunk's dot products are whole: ||x||^2 of rows gq and gq + 8
    // over the row's four lanes, then d2 folded into this lane's best
    float x2[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      x2[h] = sq[h] + __shfl_xor_sync(0xffffffffu, sq[h], 1);
      x2[h] += __shfl_xor_sync(0xffffffffu, x2[h], 2);
    }
    if (ci == 0) {
      best[0] = best[1] = CUDART_INF_F;
      bidx[0] = bidx[1] = 0;
    }
    // c0 (row gq, center 2 tq), c1 (gq, 2 tq + 1), c2 (gq + 8, 2 tq),
    // c3 (gq + 8, 2 tq + 1): a lane's candidates rise in index, so `<`
    // keeps the first
#pragma unroll
    for (int j = 0; j < kCTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int c = ci * kMCenters + 32 * ch + 8 * j + 2 * tq + (e & 1);
        const float v = fmaxf(x2[h] - 2.f * acc[j][e] + __ldg(c2 + c), 0.f);
        if (v < best[h]) {
          best[h] = v;
          bidx[h] = c;
        }
      }
    if (ci < g.n_cc - 1) continue;

    // the tile's rows are assigned: the four lanes of a row agree on the
    // first minimum of their center half, keeping the lower index on a
    // tie; the second half hands its best to the first through hv, hj
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      for (int o = 1; o < 4; o <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best[h], o);
        const int oj = __shfl_xor_sync(0xffffffffu, bidx[h], o);
        if (ov < best[h] || (ov == best[h] && oj < bidx[h])) {
          best[h] = ov;
          bidx[h] = oj;
        }
      }
      if (ch == 1 && tq == 0) {
        hv[16 * rg + gq + 8 * h] = best[h];
        hj[16 * rg + gq + 8 * h] = bidx[h];
      }
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * rg + gq + 8 * h;
      if (ch == 0 && tq == 0) {
        float v = best[h];
        int j = bidx[h];
        if (hv[r] < v || (hv[r] == v && hj[r] < j)) {
          v = hv[r];
          j = hj[r];
        }
        int lab = -1;
        if (r < rows) {
          const long long row = row0 + r;
          const float m = mask != nullptr ? mask[row] : 1.f;
          if (m > 0.f) {
            lab = j;
            inertia += v;
            atomicAdd(&cnt[j], 1);
          }
          if (labels != nullptr) {
            labels[row] = j;
            mind_out[row] = v * m;
          }
        }
        lab_s[r] = lab;
      }
    }
    __syncthreads();  // lab_s is whole

    // the sums, a chunk of 64 clusters at a time: the tile's rows of the
    // chunk sorted by label (a stable counting sort: a row's slot is its
    // label's first slot, plus the rows of its label in earlier warps of
    // rows, plus its rank among its warp's), then thread (q, f) walks the
    // rows of its clusters in row order and adds feature f into its sums.
    // A masked row or one past rows (label -1) is in no chunk.
    for (int cs = 0; cs < n_cs; ++cs) {
      int key = kMCenters, rank = 0;
      if (tid < kMRows) {
        const int l = lab_s[tid] - kMCenters * cs;
        key = l >= 0 && l < kMCenters ? l : kMCenters;
        const unsigned peers = __match_any_sync(0xffffffffu, key);
        rank = __popc(peers & ((1u << lane) - 1u));
        if (rank == 0 && key < kMCenters)
          wcnt[warp * kMCenters + key] = __popc(peers);
      }
      __syncthreads();
      if (warp == 0) {
        // lane l takes labels l and l + 32: their totals over the warps
        // of rows, scanned across the lanes, give each label's first slot
        int tot[2], first[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          tot[h] = 0;
#pragma unroll
          for (int w = 0; w < kMRows / 32; ++w)
            tot[h] += wcnt[w * kMCenters + lane + 32 * h];
          int inc = tot[h];
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const int v = __shfl_up_sync(0xffffffffu, inc, o);
            if (lane >= o) inc += v;
          }
          first[h] = inc - tot[h];
        }
        // the second half starts after every label of the first
        first[1] += __shfl_sync(0xffffffffu, first[0] + tot[0], 31);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = lane + 32 * h;
          start[c] = first[h];
          int run = first[h];
#pragma unroll
          for (int w = 0; w < kMRows / 32; ++w) {
            const int n = wcnt[w * kMCenters + c];
            wcnt[w * kMCenters + c] = run;
            run += n;
          }
          if (c == kMCenters - 1) start[kMCenters] = run;
        }
      }
      __syncthreads();
      if (tid < kMRows && key < kMCenters)
        perm[wcnt[warp * kMCenters + key] + rank] = tid;
      __syncthreads();
      for (int e = tid; e < (kMRows / 32) * kMCenters; e += kMThreads)
        wcnt[e] = 0;
      for (int fs = 0; fs < n_fs; ++fs) {
        // rows cut into feature chunks (then fc == kSumF): the slice's
        // chunk of the tile is copied again (from L2) into this step's
        // buffer, whose cross term is done
        int ss = s0;
        if (!whole) {
          if (fs > 0 || cs > 0) __syncthreads();  // the last walk is done
          stage_rows(xbuf + b * xbuf_size, x, row0, rows, kSumF * fs,
                     min(kSumF, d - kSumF * fs), g);
          tf32x3::cp_async_commit();
          tf32x3::cp_async_wait<0>();
          __syncthreads();
          ss = (sh0 + (int)((row0 * d + kSumF * fs) & 3)) & 3;
        }
        const int f = kSumF * fs + sf;
        if (n_slices > 1) {
#pragma unroll
          for (int c = 0; c < kSumC; ++c) sacc[c] = 0.f;
        }
        if (f < d) {
          const int fl = whole ? f : sf;  // the feature in the staged rows
#pragma unroll
          for (int c = 0; c < kSumC; ++c) {
            const int j1 = start[kSumC * sq4 + c + 1];
            for (int j = start[kSumC * sq4 + c]; j < j1; ++j) {
              const int r = perm[j];
              const int sh = (ss + r * d) & 3, swz = ((r >> 2) & 1) << 2;
              sacc[c] += xs[r * sx + ((sh + fl) ^ swz)];
            }
          }
          if (n_slices > 1) {
            // into the CTA's partials; a cluster with no rows in this
            // tile adds nothing, and its read and write are skipped
#pragma unroll
            for (int c = 0; c < kSumC; ++c) {
              const int lb = kSumC * sq4 + c, cl = kMCenters * cs + lb;
              if (cl < k && start[lb + 1] > start[lb])
                ps[(size_t)cl * d + f] += sacc[c];
            }
          }
        }
      }
      __syncthreads();  // start and perm are read
    }
  }
  tf32x3::cp_async_wait<0>();
  if (n_slices == 1 && sf < d) {
#pragma unroll
    for (int c = 0; c < kSumC; ++c) {
      const int cl = kSumC * sq4 + c;
      if (cl < k) ps[(size_t)cl * d + sf] = sacc[c];
    }
  }
  red[tid] = inertia;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < kMThreads; ++w) s += red[w];
    pinertia[blockIdx.x] = s;
  }
}

// accumulate: out[j] += the sum (the streamed blocks' accumulators)
template <typename T>
__global__ void reduce_partials(const T* __restrict__ partials, int n_part,
                                long long width, T* __restrict__ out,
                                int accumulate) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= width) return;
  T s = 0;
  for (int p = 0; p < n_part; ++p) s += partials[(long long)p * width + j];
  out[j] = accumulate ? out[j] + s : s;
}

cudaError_t launch_reduce(int d, int k, const float* psums,
                          const int* pcounts, const float* pinertia,
                          int n_part, float* sums, int* counts,
                          float* inertia, int accumulate, cudaStream_t s) {
  const long long w = (long long)k * d;
  reduce_partials<float><<<(unsigned)((w + 255) / 256), 256, 0, s>>>(
      psums, n_part, w, sums, accumulate);
  reduce_partials<int><<<(k + 255) / 256, 256, 0, s>>>(
      pcounts, n_part, k, counts, accumulate);
  reduce_partials<float><<<1, 32, 0, s>>>(pinertia, n_part, 1, inertia,
                                           accumulate);
  return cudaGetLastError();
}

}  // namespace

// The tensor-core pass (fused_lloyd_stats, fused_assign_update). x:
// (n_rows, d) f32 row-major, 16-byte aligned; mask: (n_rows,) f32 or
// null (all rows valid); cen: (k, d) f32 row-major, the centers; c2: (64
// n_cc,) f32 = ||c||^2, +inf past k. fc, n_fc, n_cc, sx and smem (bytes of
// the layout above): ops/fused.py::lloyd_mma_geometry. labels (n_rows,)
// int32 and mind (n_rows,) f32 are written when not null. Scratch psums
// (n_part, k, d), pcounts (n_part, k), pinertia (n_part,); results sums
// (k, d), counts (k,) int32, inertia (1,). Returns cudaGetLastError() of
// the launches.
extern "C" int lloyd_pass(const float* x, const float* mask, const float* cen,
                          const float* c2, long long n_rows, int d, int k,
                          int fc, int n_fc, int n_cc, int sx, int smem,
                          int* labels, float* mind, float* psums,
                          int* pcounts, float* pinertia, int n_part,
                          float* sums, int* counts, float* inertia,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const MmaGeom g{n_rows, d, k, fc, n_fc, n_cc, sx};
  cudaError_t err = cudaFuncSetAttribute(
      lloyd_mma_partials, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  lloyd_mma_partials<<<n_part, kMThreads, smem, s>>>(
      x, mask, cen, c2, g, labels, mind, psums, pcounts, pinertia);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_reduce(d, k, psums, pcounts, pinertia, n_part, sums,
                            counts, inertia, 0, s);
}

// The streamed flavour (fused_kmeans_block_stats), on the CUDA-core step:
// x (n, d) f32 row-major, rows < n_valid; cT: (n_fc fc, 64 n_cc) f32, the
// transposed centers zero-padded (bf16-rounded with mxu); c2: (64 n_cc,)
// f32 = ||c||^2 of the f32 centers, +inf past k; mxu: the cross term takes
// bf16-rounded x. fc, n_fc, n_cc, sums_smem and smem (bytes of the layout
// above): ops/fused.py::lloyd_geometry; vec4: 1 when d % 4 == 0 and x is
// 16-byte aligned. Scratch psums (n_part, k, d), pcounts (n_part, k),
// pinertia (n_part,). sums (k, d) f32, counts (k,) int32 and inertia (1,)
// are accumulators that this call ADDS the block's statistics into.
// Returns cudaGetLastError() of the launches.
extern "C" int kmeans_block_stats(const float* x, const float* cT,
                                  const float* c2, long long n_valid, int d,
                                  int k, int fc, int n_fc, int n_cc, int vec4,
                                  int sums_smem, int smem, int mxu,
                                  float* psums, int* pcounts,
                                  float* pinertia, int n_part, float* sums,
                                  int* counts, float* inertia, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geom g{n_valid, d, k, fc, n_fc, n_cc, vec4, sums_smem, mxu};
  cudaError_t err = cudaFuncSetAttribute(
      lloyd_partials, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  lloyd_partials<<<n_part, kThreads, smem, s>>>(x, cT, c2, g, psums, pcounts,
                                                pinertia);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_reduce(d, k, psums, pcounts, pinertia, n_part, sums,
                            counts, inertia, 1, s);
}
