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
// One kernel, lloyd_mma_partials, serves the three entries: lloyd_pass
// (fused_lloyd_stats; fused_assign_update, the same pass with the
// per-row label and min-d2 pointers set) and kmeans_block_stats (the
// rows < n_valid, no mask and no per-row output, in f32 or with its bf16
// cross term; its reduce adds into the accumulators).
//
// Bound on an H100. The cross term is 2 n k d flops against n d 4 bytes
// of X: on the main path (8M x 128, k = 64) 131 GFLOP, 2 ms at the CUDA
// cores' f32 FMA rate, 0.8 ms at the f32-accurate 3xTF32 rate of the
// tensor cores (tf32x3.cuh), where the 4.1 GB of X (1.22 ms at 3.35
// TB/s) bound the pass. The CUDA-core step this kernel replaced ran the
// cross term at about 19 TFLOP/s; with one phase cut at a time (scripts/lloyd_phase_split.py)
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
//     into (big, small) fragments in shared memory. When they are not
//     resident (more than 64 centers or rows cut into feature chunks),
//     split_centers splits every chunk once per launch into device memory
//     and each step copies its chunk's fragments by cp.async with its
//     tile. Runs of four k-steps go into zeroed accumulators, which are
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
// Off the main path wide rows copy the tile again for the sums, and the
// sums' slices are added into the CTA's partials in device memory per
// tile (a cluster with no rows in the tile skipped). The streamed block
// (524,288 rows) at k = 256 takes about as long as on the CUDA-core step;
// at d = 768 it is slower (PERF.md). Sorting a tile once for all its
// chunks of centers saved 3 % at k = 256, and marking X's copies
// evict-first in L2 nothing; neither is taken.
//
// The bf16 cross term (kmeans_block_stats with mxu, the JAX "mxu"
// policy): each X fragment is rounded to bf16 as it is gathered, after
// its unrounded value has gone into ||x||^2; the centers arrive rounded
// to bf16 values from the wrapper, their norms taken from the f32
// centers; the sums walk reads the staged f32 rows. A bf16 value is exact
// in TF32 (its low 13 mantissa bits are zero), so a split of it has no
// small part and the cross term is ONE TF32 product per k-step on the
// f32 path's fragment layout, against three. m16n8k16 bf16 products
// would halve the issue count again, with fragment layouts of their own
// for X and the centers; they are not taken, since the bf16 pass takes
// about as long as the f32 one on an H100: the products are not what sets
// its pace (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "tf32x3.cuh"

namespace {

// ---------------------------------------------------------------------------
// The tensor-core step
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

// The centers [64 ci, 64 ci + 64) x features [fc fi, fc fi + fc) split
// into cf, the B fragments of each k-step, n8 tile and lane ((fc / 8, 8,
// 32) float4: (big, small) of b0 and of b1), zero past k and d; thread
// `first` of `stride` takes float4s first, first + stride, ...
__device__ __forceinline__ void split_chunk(float4* cf, const float* cen,
                                            const MmaGeom& g, int ci, int fi,
                                            int first, int stride) {
  // unrolled, so a thread's loads are in flight together
#pragma unroll 8
  for (int q = first; q < g.fc * 32; q += stride) {
    const int ks = q >> 8, j = (q >> 5) & 7, l = q & 31;
    const int c = ci * kMCenters + 8 * j + (l >> 2);
    const int f = fi * g.fc + 8 * ks + (l & 3);
    const float* cr = cen + (size_t)c * g.d;
    const float v0 = c < g.k && f < g.d ? __ldg(cr + f) : 0.f;
    const float v1 = c < g.k && f + 4 < g.d ? __ldg(cr + f + 4) : 0.f;
    uint32_t b0, s0, b1, s1;
    tf32x3::split(v0, b0, s0);
    tf32x3::split(v1, b1, s1);
    cf[q] = make_float4(__uint_as_float(b0), __uint_as_float(s0),
                        __uint_as_float(b1), __uint_as_float(s1));
  }
}

// Every (center chunk ci, feature chunk fi) split once per launch into
// csplit[ci n_fc + fi], a block each, for the steps of a pass whose
// centers are not resident (more than 64 centers, or rows of several
// feature chunks): each step then copies its chunk's fragments by
// cp.async with its tile, in place of splitting them again.
__global__ void __launch_bounds__(kMThreads)
split_centers(const float* __restrict__ cen, MmaGeom g,
              float4* __restrict__ csplit) {
  split_chunk(csplit + (size_t)blockIdx.x * g.fc * 32, cen, g,
              blockIdx.x / g.n_fc, blockIdx.x % g.n_fc, threadIdx.x,
              kMThreads);
}

// Shared memory (floats unless noted): xbuf (2, kMRows, sx) | cf (fc / 8,
// 8, 32) float4, the chunk's centers split into the B fragments of each
// k-step, n8 tile and lane: (big, small) of b0 and of b1 | lab_s (kMRows,
// int) | hv (kMRows), hj (kMRows, int): the second center half's best |
// red (kMThreads) | the rows sorted by label: wcnt (kMRows / 32,
// kMCenters, int), the rows of each label in each warp of rows, then
// their first slots; start (kMCenters + 1, int); perm (kMRows, int).
// ops/fused.py::lloyd_mma_geometry sizes it the same way. kMxu: the
// cross term on bf16-rounded X fragments (the centers come rounded).
// csplit: split_centers' fragments when the centers are not resident.
template <bool kMxu>
__global__ void __launch_bounds__(kMThreads, 1)
lloyd_mma_partials(const float* __restrict__ x,
                   const float* __restrict__ mask,
                   const float* __restrict__ cen,
                   const float* __restrict__ c2,
                   const float4* __restrict__ csplit, MmaGeom g,
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

  // a step's split centers when they are not resident: a copy of
  // split_centers' chunk, committed as a group of its own
  auto copy_c = [&](int ci, int fi) {
    const float4* src = csplit + (size_t)(ci * g.n_fc + fi) * fc * 32;
    for (int q = tid; q < fc * 32; q += kMThreads)
      tf32x3::cp_async16(cf + q, src + q, 16);
    tf32x3::cp_async_commit();
  };

  const long long n_tiles = (g.n_rows + kMRows - 1) / kMRows;
  const long long my_tiles =
      blockIdx.x < n_tiles ? (n_tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int per_tile = g.n_cc * g.n_fc;
  const bool c_resident = per_tile == 1;
  const long long n_steps = my_tiles * per_tile;
  // resident centers: split once, published by the first step's barrier
  if (c_resident) split_chunk(cf, cen, g, 0, 0, tid, kMThreads);

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
    if (!c_resident) copy_c(ci, fi);
    if (s + 1 < n_steps) issue(tn, fn, b ^ 1);
    tf32x3::cp_async_commit();
    // every group but the next tile's has landed: this step's tile and
    // centers
    tf32x3::cp_async_wait<1>();
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
        if constexpr (kMxu) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            ab[i] = __float_as_uint(__bfloat162float(__float2bfloat16(av[i])));
        } else {
          tf32x3::split(av, ab, as);
        }
        uint32_t bb[kCTiles][2], bs[kCTiles][2];
#pragma unroll
        for (int j = 0; j < kCTiles; ++j) {
          const float4 v = cf[(ks * 8 + kCTiles * ch + j) * 32 + lane];
          bb[j][0] = __float_as_uint(v.x);
          bs[j][0] = __float_as_uint(v.y);
          bb[j][1] = __float_as_uint(v.z);
          bs[j][1] = __float_as_uint(v.w);
        }
        // the three products round by round over the accumulators; bf16
        // operands have no small parts
        if constexpr (!kMxu) {
#pragma unroll
          for (int j = 0; j < kCTiles; ++j)
            tf32x3::mma_tf32(run[j], as, bb[j]);
#pragma unroll
          for (int j = 0; j < kCTiles; ++j)
            tf32x3::mma_tf32(run[j], ab, bs[j]);
        }
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

template <bool kMxu>
cudaError_t launch_step(const float* x, const float* mask, const float* cen,
                        const float* c2, float4* csplit, const MmaGeom& g,
                        int smem, int* labels, float* mind, float* psums,
                        int* pcounts, float* pinertia, int n_part,
                        cudaStream_t s) {
  if (g.n_cc * g.n_fc > 1)
    split_centers<<<g.n_cc * g.n_fc, kMThreads, 0, s>>>(cen, g, csplit);
  cudaError_t err = cudaFuncSetAttribute(
      lloyd_mma_partials<kMxu>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  lloyd_mma_partials<kMxu><<<n_part, kMThreads, smem, s>>>(
      x, mask, cen, c2, csplit, g, labels, mind, psums, pcounts, pinertia);
  return cudaGetLastError();
}

// lloyd_mma_partials<mxu> and the fixed-order reduce; accumulate: the
// reduce adds into sums, counts and inertia
cudaError_t launch_pass(bool mxu, const float* x, const float* mask,
                        const float* cen, const float* c2, void* csplit,
                        const MmaGeom& g, int smem, int* labels, float* mind,
                        float* psums, int* pcounts, float* pinertia,
                        int n_part, float* sums, int* counts, float* inertia,
                        int accumulate, cudaStream_t s) {
  float4* cs = static_cast<float4*>(csplit);
  const cudaError_t err =
      mxu ? launch_step<true>(x, mask, cen, c2, cs, g, smem, labels, mind,
                              psums, pcounts, pinertia, n_part, s)
          : launch_step<false>(x, mask, cen, c2, cs, g, smem, labels, mind,
                               psums, pcounts, pinertia, n_part, s);
  if (err != cudaSuccess) return err;
  return launch_reduce(g.d, g.k, psums, pcounts, pinertia, n_part, sums,
                       counts, inertia, accumulate, s);
}

}  // namespace

// The tensor-core pass (fused_lloyd_stats, fused_assign_update). x:
// (n_rows, d) f32 row-major, 16-byte aligned; mask: (n_rows,) f32 or
// null (all rows valid); cen: (k, d) f32 row-major, the centers; c2: (64
// n_cc,) f32 = ||c||^2, +inf past k. fc, n_fc, n_cc, sx and smem (bytes of
// the layout above): ops/fused.py::lloyd_mma_geometry. labels (n_rows,)
// int32 and mind (n_rows,) f32 are written when not null. Scratch csplit
// (n_cc n_fc fc 32 float4, 16-byte aligned; used when n_cc n_fc > 1),
// psums (n_part, k, d), pcounts (n_part, k), pinertia (n_part,); results
// sums (k, d), counts (k,) int32, inertia (1,). Returns
// cudaGetLastError() of the launches.
extern "C" int lloyd_pass(const float* x, const float* mask, const float* cen,
                          const float* c2, long long n_rows, int d, int k,
                          int fc, int n_fc, int n_cc, int sx, int smem,
                          int* labels, float* mind, void* csplit,
                          float* psums, int* pcounts, float* pinertia,
                          int n_part, float* sums, int* counts,
                          float* inertia, void* stream) {
  const MmaGeom g{n_rows, d, k, fc, n_fc, n_cc, sx};
  return (int)launch_pass(false, x, mask, cen, c2, csplit, g, smem, labels,
                          mind, psums, pcounts, pinertia, n_part, sums,
                          counts, inertia, 0,
                          static_cast<cudaStream_t>(stream));
}

// The streamed flavour (fused_kmeans_block_stats) on the same step, over
// the rows < n_valid of one block: x (n, d) f32 row-major, 16-byte
// aligned; mxu: the cross term on bf16-rounded x (cen then holds the
// centers rounded to bf16 values); cen (k, d) f32; c2: (64 n_cc,) f32 =
// ||c||^2 of the f32 centers, +inf past k. fc, n_fc, n_cc, sx and smem:
// ops/fused.py::lloyd_mma_geometry. Scratch csplit, psums, pcounts and
// pinertia as lloyd_pass's. sums (k, d) f32, counts (k,) int32 and
// inertia (1,) are accumulators that this call ADDS the block's
// statistics into. Returns cudaGetLastError() of the launches.
extern "C" int kmeans_block_stats(const float* x, int mxu, const float* cen,
                                  const float* c2, long long n_valid, int d,
                                  int k, int fc, int n_fc, int n_cc, int sx,
                                  int smem, void* csplit, float* psums,
                                  int* pcounts, float* pinertia, int n_part,
                                  float* sums, int* counts, float* inertia,
                                  void* stream) {
  const MmaGeom g{n_valid, d, k, fc, n_fc, n_cc, sx};
  return (int)launch_pass(mxu != 0, x, nullptr, cen, c2, csplit, g, smem,
                          nullptr, nullptr, psums, pcounts, pinertia, n_part,
                          sums, counts, inertia, 1,
                          static_cast<cudaStream_t>(stream));
}
