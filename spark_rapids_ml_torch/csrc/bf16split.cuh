// The bf16 split of an f32 operand, the counterpart of the TPU kernels'
// _split_bf16 / _dot_multipass (spark_rapids_ml_tpu/ops/pallas_kmeans.py),
// shared by the nearest-center tile (nearest.cuh: the Lloyd and assignment
// kernels) and the Gram kernel (xtx.cu, through tf32x3.cuh).
//
// An f32 value x is taken as n_split parts: hi = x rounded to bf16 (to nearest
// even), lo = (x - hi) rounded to bf16, each held as an f32 with its low 16 bits
// zero. n_split 1 keeps hi (one bf16 pass, the MXU's DEFAULT precision);
// n_split 2 keeps both and a product a.b is taken as lo_a hi_b + hi_a lo_b +
// hi_a hi_b, smallest first (parity_precision "high"); n_split 3 is the f32
// value itself (the kernels' full-f32 forms). Two bf16 values multiply exactly
// in f32 (8 + 8 significant bits), so FMA on the CUDA cores and the tensor
// cores form the same products, and only the order of the f32 sums differs.
// A NaN stays NaN in every part; x - hi of an infinity is NaN.

#pragma once

#include <cuda_bf16.h>

__device__ __forceinline__ float bf16_rn(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The parts of v at NSPLIT: hi (the f32 value itself at NSPLIT 3) and, at
// NSPLIT 2, lo.
template <int NSPLIT>
__device__ __forceinline__ void bf16_parts(float v, float& hi, float& lo) {
  if constexpr (NSPLIT >= 3) {
    hi = v;
    lo = 0.f;
  } else {
    hi = bf16_rn(v);
    lo = NSPLIT == 2 ? bf16_rn(v - hi) : 0.f;
  }
}
