// Eps-neighbor counts, DBSCAN's core-point test: for each query row i,
// counts[i] = #{ j < n : item j valid and max(q2_i - 2 q_i.x_j + x2_j, 0) <= eps2 },
// with eps2 a runtime argument.
//
// Replaces: spark_rapids_ml_tpu/ops/pallas_select.py::_count_kernel (the
// count-below-eps reduction of the fused distance+select family, reached through
// _fused_count and fused_count_below).
//
// What bounds it on the H100: the cross terms take 2 nq n d f32 operations and
// the criterion about 4 more per pair; at the main path's 262,144 x 32 with
// Q = X that is 4.7e12 operations, 70 ms at the 67 TFLOP/s f32 peak of the CUDA
// cores, against 68 MB of inputs and counts (0.02 ms at 3.35 TB/s): it is bound
// by operations.
//
// Design:
//   * Each block takes whole query tiles (NR_ROWS = 32 queries, a grid-stride
//     loop) and scans every item for them, so each count is accumulated in
//     registers and written once, without atomics across blocks.
//   * The distance tile is nearest.cuh's: items pass through shared memory in
//     chunks of 32 items by 32 columns; each thread owns one query and four
//     items of a chunk and accumulates q.x in f32 FMA (no TF32). For d <= 32 the
//     query tile is staged once and stays resident for the whole scan.
//   * The criterion is the TPU kernel's: max(q2 - 2 q.x + x2, 0) <= eps2, with
//     q2 and x2 the wrapper's row norms, and x2m_j = -1 for an invalid item (the
//     TPU kernel's folding of the mask into the norm operand): an invalid item,
//     or one past n, never counts. The clamp keeps a NaN (a kernel never turns
//     NaN into a number), so a query or item with a NaN feature counts
//     nothing, as in the plain count and the JAX package.
//   * The eight threads of a query add their counts by shuffles at the end.

#include "nearest.cuh"

__global__ void __launch_bounds__(NR_THREADS)
count_kernel(const float* __restrict__ Q, const float* __restrict__ q2, int64_t nq,
             int d, const float* __restrict__ X, const float* __restrict__ x2m, int n,
             float eps2, int* __restrict__ counts) {
  __shared__ NearestSmem sm;
  const int r = threadIdx.x >> 3;  // this thread's query in the tile
  const int g = threadIdx.x & 7;   // its items in a chunk: g, g + 8, g + 16, g + 24
  const bool resident = d <= NR_D;
  for (int64_t row0 = (int64_t)blockIdx.x * NR_ROWS; row0 < nq;
       row0 += (int64_t)gridDim.x * NR_ROWS) {
    const int64_t qrow = row0 + r;
    const float qn = qrow < nq ? q2[qrow] : 0.f;
    if (resident) {
      __syncthreads();  // the previous tile's readers of sm.xs are done
      stage_rows(Q, row0, nq, d, 0, sm);
    }
    int cnt = 0;
    for (int k0 = 0; k0 < n; k0 += NR_K) {
      float acc[4];
      if (resident) {
        cross_chunk<true>(Q, row0, nq, d, X, k0, n, sm, acc);
      } else {
        cross_chunk<false>(Q, row0, nq, d, X, k0, n, sm, acc);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = k0 + g + 8 * q;
        if (j < n) {
          const float xn = x2m[j];
          float d2 = qn - 2.f * acc[q] + xn;
          d2 = d2 < 0.f ? 0.f : d2;  // keeps a NaN, which counts nothing (fmaxf gives 0)
          cnt += (xn >= 0.f && d2 <= eps2) ? 1 : 0;
        }
      }
    }
    for (int o = 4; o > 0; o >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
    if (g == 0 && qrow < nq) counts[qrow] = cnt;
  }
}

// Launches on `stream`; allocates nothing, does not synchronise. Returns
// cudaGetLastError() (0 on success).
extern "C" int srml_count(const void* Q, const void* q2, long long nq, int d,
                          const void* X, const void* x2m, int n, float eps2,
                          void* counts, int n_blocks, void* stream) {
  if (nq > 0) {
    count_kernel<<<n_blocks, NR_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)Q, (const float*)q2, (int64_t)nq, d, (const float*)X,
        (const float*)x2m, n, eps2, (int*)counts);
  }
  return (int)cudaGetLastError();
}
