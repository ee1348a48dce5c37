// f32-accurate matrix products on Hopper's tensor cores (3xTF32), and the
// cp.async helpers of the multi-stage rings that feed them. Shared by the
// top-k kernel (topk.cu), the eps-count kernel (count.cu) and the Gram kernel
// (xtx.cu); the histogram kernel (hist.cu) takes the cp.async helpers.
//
// 3xTF32. The tensor cores multiply TF32 operands (f32 with 10 explicit
// mantissa bits) at 495 TFLOP/s on an H100 SXM, against 67 TFLOP/s for f32 FMA
// on the CUDA cores, but one TF32 product keeps only about three decimal
// digits. Each f32 operand x is split into x_hi, x rounded to TF32 (to
// nearest, by an integer add and a mask), and x_lo = x - x_hi, which is exact
// in f32 and at most 2^-11 |x|; the tensor cores read x_lo's TF32 part, so
// x_hi + x_lo keeps x to about 2^-21 relative, with an error of either sign.
// a.b is taken as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi (a_lo.b_lo, about 2^-22 of
// the product, is dropped); every product of two TF32 values is exact in f32.
// The tensor cores' own accumulation truncates (rounds toward zero), so a long
// chain of mma on one accumulator drifts: on an H100, a first Gram kernel that
// chained 384 mma per sum gave S2 of 10,007 rows 9.3e-6 off f64, where cuBLAS
// f32 is 1.4e-7 off (chip_smoke.py's phase 2a check). So
// callers chain the mma of one ring stage (4 k-steps, 12 mma) on a fresh
// fragment and add that to their f32 accumulator by ordinary f32 adds (round
// to nearest). The result has f32-level accuracy at a third of the tensor
// cores' rate.
//
// The mma is mma.sync.aligned.m16n8k8 with TF32 operands and f32 accumulators.
// Per warp, with g = lane / 4 and t = lane % 4:
//   A (16 x 8, row major)  a0 = A[g][t]  a1 = A[g+8][t]  a2 = A[g][t+4]  a3 = A[g+8][t+4]
//   B (8 x 8, column major) b0 = B[t][g]  b1 = B[t+4][g]
//   C (16 x 8)  c0 = C[g][2t]  c1 = C[g][2t+1]  c2 = C[g+8][2t]  c3 = C[g+8][2t+1]

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16split.cuh"

// (hi, lo) of one operand value: hi = x rounded to TF32 (ties away from zero,
// as cvt.rna.tf32.f32 rounds; the low 13 bits zero), lo = x - hi.
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// (hi, lo) of one operand value as its two bf16 parts (bf16split.cuh), held in
// TF32 registers: a bf16 value is exact in TF32 (its low 16 bits are zero), so
// the tensor cores form each product of two parts exactly, as a bf16 m16n8k16
// mma would, and mma_3xtf32 computes the two-part bf16 split of a.b (the
// Gram kernel's n_split 2 form, at the TF32 rate).
__device__ __forceinline__ void bf16x2_split(float x, uint32_t& hi, uint32_t& lo) {
  float h, l;
  bf16_parts<2>(x, h, l);
  hi = __float_as_uint(h);
  lo = __float_as_uint(l);
}

// c += a.b for one m16n8k8 TF32 fragment (layout above).
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One A fragment and one B fragment, split into their TF32 parts.
struct FragA3 {
  uint32_t hi[4], lo[4];
};
struct FragB3 {
  uint32_t hi[2], lo[2];
};

// The fragments' parts: TF32 (3xTF32, f32 accuracy) or, with BF16, bf16.
template <bool BF16 = false>
__device__ __forceinline__ void split_value(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (BF16) {
    bf16x2_split(x, hi, lo);
  } else {
    tf32_split(x, hi, lo);
  }
}

template <bool BF16 = false>
__device__ __forceinline__ void split_a(const float v[4], FragA3& f) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_value<BF16>(v[i], f.hi[i], f.lo[i]);
}

template <bool BF16 = false>
__device__ __forceinline__ void split_b(float v0, float v1, FragB3& f) {
  split_value<BF16>(v0, f.hi[0], f.lo[0]);
  split_value<BF16>(v1, f.hi[1], f.lo[1]);
}

// c += a.b in 3xTF32 on the tensor cores: the two small products first, the
// large one last. c is a stage's fragment (see above), not a long sum.
__device__ __forceinline__ void mma_3xtf32(float c[4], const FragA3& a, const FragB3& b) {
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
}

// acc += p and p = 0, for n floats: a stage's fragments into the f32 sums.
template <int N>
__device__ __forceinline__ void add_stage(float* acc, float* p) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    acc[i] += p[i];
    p[i] = 0.f;
  }
}

// cp.async: copy 16 (or 4) bytes from global to shared memory without
// passing through registers, asynchronously. With pred false nothing is read
// and the destination is zero-filled (src-size 0): a select, so whatever lies
// past an edge never reaches the arithmetic. `src` must be a valid address
// either way (callers pass the array's base when pred is false). Each thread
// commits its copies as one group per ring stage and waits until at most N of
// its groups are still in flight; a __syncthreads() after the wait makes every
// thread's copies visible to the block.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
