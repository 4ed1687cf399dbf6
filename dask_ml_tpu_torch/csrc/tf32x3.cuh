// Float32-accurate products on Hopper's tensor cores: the 3xTF32 split.
//
// A TF32 value keeps 10 explicit mantissa bits (11 significant), so one
// TF32 product carries about 2^-11 of relative error: too coarse for the
// port's float32 contract (a Newton step taken on a TF32 Hessian moves).
// Each f32 operand is split as a = big + small with big = tf32(a) and
// small = tf32(a - big) (a - big is exact in f32), and every product is
// taken as small_a big_b + big_a small_b + big_a big_b with f32
// accumulation; the small_a small_b term (about 2^-22 of the product) is
// dropped. The products of TF32 values are exact in f32, so the error of
// one product is about 2^-21 relative, far inside the kernels' tolerances
// (chip_smoke.py: HESS_RTOL = 1e-4 against float64 sums, GLM_GRAD_RTOL =
// 1e-4). CUTLASS calls this OpMultiplyAddFastF32. At the TF32 rate (495
// TFLOP/s dense on an H100 SXM) three products give 165 TFLOP/s of
// f32-accurate work, against 67 TFLOP/s of f32 FMA on the CUDA cores.
//
// The products are mma.sync m16n8k8 (row-major A, column-major B) with the
// fragment layout of the PTX ISA: with g = lane / 4 and t = lane % 4,
//   A (16 x 8): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8):  b0 (t, g), b1 (t + 4, g)                   [k, n]
//   C (16 x 8): c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// Fragments are gathered by the kernels from shared memory in either
// orientation (a staged row-major tile of X serves as A = X or A = X^T),
// so they are plain loads here, split once into registers and reused for
// every product of the warp's tile that reads them. wgmma would take TF32
// only K-major for both operands, which row-major X tiles are not.
// bf16 operands need no split: mma_bf16 (m16n8k16) takes them as they are.
//
// The three products of a fragment pair are mma_tf32 calls in the order
// small_a big_b, big_a small_b, big_a big_b. The kernels issue them round
// by round across a warp's independent accumulators: one accumulator's
// chain of three dependent products, issued back to back, stalls the
// warp's in-order issue.
//
// The tensor cores add into the accumulator with truncation, not rounding
// to nearest: each addition may drop up to about 2^-24 of the sum, all in
// one direction, so tens of thousands of rows summed in one accumulator
// drift past HESS_RTOL. The kernels therefore sum only a short run of
// rows inside the tensor
// cores (the Hessian: 8 rows, from a zeroed accumulator, mma_tf32_zero;
// the one-vs-rest gradient: one 64-row tile) and add the run into their
// running f32 sums with ordinary, rounded adds.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace tf32x3 {
namespace {

// f32 -> TF32, round to nearest with ties away from zero (the low 13
// mantissa bits of the result are zero): the bit pattern cvt.rna.tf32.f32
// gives for every finite value and for +-inf, by adding half a TF32 ulp to
// the magnitude bits and truncating. Two integer operations; on sm_90a
// the cvt instruction compiles to four (it also guards NaN, which the
// kernels never split: rows past n_valid are zero-filled, never read).
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

// v = big + small, both TF32
__device__ __forceinline__ void split(float v, uint32_t& big,
                                      uint32_t& small) {
  big = to_tf32(v);
  small = to_tf32(v - __uint_as_float(big));
}

template <int N>
__device__ __forceinline__ void split(const float (&v)[N], uint32_t (&big)[N],
                                      uint32_t (&small)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split(v[i], big[i], small[i]);
}

// d += a b, one m16n8k8 TF32 product with f32 accumulation
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a b, one m16n8k8 TF32 product into a zeroed accumulator
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// d += a b, one m16n8k16 bf16 product with f32 accumulation. A register
// holds two bf16 values, the lower k index in its low half:
//   A (16 x 16): a0 (g, 2t..2t+1), a1 (g + 8, 2t..), a2 (g, 2t+8..),
//                a3 (g + 8, 2t+8..)
//   B (16 x 8):  b0 (2t..2t+1, g), b1 (2t+8..2t+9, g)        [k, n]
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two bf16 bit patterns (lo at the lower k index) in one register
__device__ __forceinline__ uint32_t pack_bf16(unsigned short lo,
                                              unsigned short hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy into shared memory; the bytes past src_bytes
// (0..16) are zero-filled, and with src_bytes == 0 nothing is read
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4-byte asynchronous copy; zero-filled when !ok (nothing read)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace
}  // namespace tf32x3
