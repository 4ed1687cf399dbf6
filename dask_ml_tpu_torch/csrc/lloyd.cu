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
// One kernel serves all three; the per-row outputs are written when their
// pointers are not null. Any (k, d) is taken.
//
// Per row, d2_j = ||x||^2 - 2 x.c_j + ||c_j||^2 clamped at 0, and the label
// is the FIRST index reaching the minimum, as in the Pallas kernels.
//
// Bound on an H100: the f32 FMA rate. The cross term is 2 n k d flops
// against n d 4 bytes of X, far above the card's f32 ratio of flops to
// bytes. Tensor cores are left out on purpose: TF32 would move argmins away
// from the f32 reference. The design keeps the FMA units fed:
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
// The statistics are race-free without float atomics: after a tile is
// assigned, thread f owns feature columns f, f + 256, ... and walks the
// tile's rows in order, eight at a time (their sums loaded together, a
// row whose label came earlier in the eight continuing from that row's
// value), adding into the CTA's (k, d) sums, which sit in
// shared memory when they fit and otherwise in the CTA's own slice of the
// partials in device memory. Counts are int32 (not the Pallas f32) and
// added with integer atomics, whose result does not depend on their order;
// each thread keeps its own inertia partial over its own rows. A second
// kernel reduces the CTAs' partials in a fixed order, so two runs are
// bit-equal. Rows past n_rows are never read (their copies zero-fill), so
// the ragged edge needs no padded copy of X.
//
// The bf16 cross term (mxu): a step's sub-tile is rounded to bf16 in
// shared memory after its ||x||^2 is taken, the centers arrive rounded
// from the wrapper (their f32 norms beside them), and the sums walk then
// reads the f32 rows from device memory (L2, where the step's copy just
// brought them) instead of the rounded sub-tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

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
lloyd_partials(const float* __restrict__ x, const float* __restrict__ mask,
               const float* __restrict__ cT, const float* __restrict__ c2,
               Geom g, int* __restrict__ labels, float* __restrict__ mind_out,
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
        const long long row = row0 + r;
        const float m = mask != nullptr ? mask[row] : 1.f;
        lab_s[r] = m > 0.f ? j : -1;
        if (m > 0.f) inertia += v;
        if (labels != nullptr) {
          labels[row] = j;
          mind_out[row] = v * m;
        }
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
          if (l[q] < 0) {  // a masked row adds 0 to cluster 0
            l[q] = 0;
            v[q] = 0.f;
          }
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
      for (; r < rows; ++r) {
        const int l = lab_s[r];
        if (l >= 0) cf[(size_t)l * d] += xf[(size_t)r * stride];
      }
    }
    if (tid < rows && lab_s[tid] >= 0) atomicAdd(&cnt[lab_s[tid]], 1);
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

cudaError_t launch_pass(const float* x, const float* mask, const float* cT,
                        const float* c2, const Geom& g, int smem, int* labels,
                        float* mind, float* psums, int* pcounts,
                        float* pinertia, int n_part, float* sums, int* counts,
                        float* inertia, int accumulate, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      lloyd_partials, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  lloyd_partials<<<n_part, kThreads, smem, s>>>(x, mask, cT, c2, g, labels,
                                                mind, psums, pcounts,
                                                pinertia);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long w = (long long)g.k * g.d;
  reduce_partials<float><<<(unsigned)((w + 255) / 256), 256, 0, s>>>(
      psums, n_part, w, sums, accumulate);
  reduce_partials<int><<<(g.k + 255) / 256, 256, 0, s>>>(
      pcounts, n_part, g.k, counts, accumulate);
  reduce_partials<float><<<1, 32, 0, s>>>(pinertia, n_part, 1, inertia,
                                           accumulate);
  return cudaGetLastError();
}

}  // namespace

// x: (n_rows, d) f32 row-major; mask: (n_rows,) f32 or null (all rows
// valid); cT: (n_fc fc, 64 n_cc) f32, the transposed centers zero-padded;
// c2: (64 n_cc,) f32 = ||c||^2, +inf past k. fc, n_fc, n_cc, sums_smem and
// smem (bytes of the layout above): ops/fused.py::lloyd_geometry; vec4: 1
// when d % 4 == 0 and x is 16-byte aligned. labels (n_rows,) int32 and
// mind (n_rows,) f32 are written when not null. Scratch psums (n_part, k,
// d), pcounts (n_part, k), pinertia (n_part,); results sums (k, d), counts
// (k,) int32, inertia (1,). Returns cudaGetLastError() of the launches.
extern "C" int lloyd_pass(const float* x, const float* mask, const float* cT,
                          const float* c2, long long n_rows, int d, int k,
                          int fc, int n_fc, int n_cc, int vec4, int sums_smem,
                          int smem, int* labels, float* mind, float* psums,
                          int* pcounts, float* pinertia, int n_part,
                          float* sums, int* counts, float* inertia,
                          void* stream) {
  const Geom g{n_rows, d, k, fc, n_fc, n_cc, vec4, sums_smem, 0};
  return (int)launch_pass(x, mask, cT, c2, g, smem, labels, mind, psums,
                          pcounts, pinertia, n_part, sums, counts, inertia, 0,
                          static_cast<cudaStream_t>(stream));
}

// The streamed flavour (fused_kmeans_block_stats): no mask and no per-row
// outputs; mxu: cT holds the bf16-rounded centers (c2 the norms of the f32
// centers) and the cross term takes bf16-rounded x. sums (k, d) f32,
// counts (k,) int32 and inertia (1,) are accumulators that this call ADDS
// the block's statistics into. Returns cudaGetLastError() of the launches.
extern "C" int kmeans_block_stats(const float* x, const float* cT,
                                  const float* c2, long long n_valid, int d,
                                  int k, int fc, int n_fc, int n_cc, int vec4,
                                  int sums_smem, int smem, int mxu,
                                  float* psums, int* pcounts,
                                  float* pinertia, int n_part, float* sums,
                                  int* counts, float* inertia, void* stream) {
  const Geom g{n_valid, d, k, fc, n_fc, n_cc, vec4, sums_smem, mxu};
  return (int)launch_pass(x, nullptr, cT, c2, g, smem, nullptr, nullptr,
                          psums, pcounts, pinertia, n_part, sums, counts,
                          inertia, 1, static_cast<cudaStream_t>(stream));
}
