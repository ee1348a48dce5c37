// Fused Lloyd step: for the rows below n_valid, the nearest center by
// argmin_c (|c|^2 - 2 x.c) (first index wins a tie), then per center the
// weighted sums of its rows, their weight (the count) and the inertia
// sum w max(|x|^2 + min, 0).
//
// Replaces: spark_rapids_ml_tpu/ops/pallas_kmeans.py::_lloyd_kernel_masked (unit
// weights: `w` is null and every row below n_valid weighs 1) and
// ::_lloyd_kernel (a weightCol: `w` points at the weights and n_valid = n).
//
// Forms: NSPLIT 3 (f32, the parity default), 2 (the two-part bf16 split,
// parity_precision "high") and 1 (one bf16 pass, fast_math), as the TPU
// kernel's n_split (bf16split.cuh). Both products take the split: the cross
// terms in nearest_tile, and the update, which adds split(w).split(x) per row,
// lo_w hi_x + hi_w lo_x + hi_w hi_x at NSPLIT 2 (the one-hot entry carries the
// weight: unit weights add hi_x + lo_x, or hi_x at NSPLIT 1). The counts, |x|^2
// and |c|^2 stay f32; the inertia takes the split criterion, as on the TPU.
//
// What bounds it on the H100: one step reads X once, 4 n d bytes (8.6 GB at the
// main path's 8.4M x 256), and does 2 n k d f32 operations for the distances
// plus 2 n d for the sums; at k = 20 that is 2.6 ms of memory against 1.3 ms of
// f32 FMA at the published peaks, so it is bound by bytes. The NSPLIT 2 form
// does three exact part products per product on the CUDA cores: 3.9 ms of FMA,
// still near the bytes (on the tensor cores its products would take 0.1 ms).
//
// Design:
//   * X is read from device memory once per step, as on the TPU: each row tile
//     goes through nearest_tile (nearest.cuh), then its rows are added into the
//     block's accumulators while the tile is still in L1/L2.
//   * Blocks run in parallel and in no order, where the TPU carried its
//     accumulators across a sequential grid. Each block owns a contiguous range
//     of rows and a partial (sums, counts, inertia) of its own; a second kernel
//     adds the partials in block order. No float atomics: a fit gives the same
//     centers and n_iter on every run.
//   * Inside a block, thread j owns feature columns j, j + 256, ... of every
//     center's sum, and rows are added in order, so no two threads ever touch
//     one accumulator. Thread 0 owns the counts and the inertia. The partial
//     sits in shared memory when k d fits (k d <= 24K floats), else in the
//     block's own slice of the scratch in device memory, so any (k, d) runs.
//   * Rows at or past n_valid are excluded by a select (nearest.cuh), never by
//     a multiply; rows of weight 0 add nothing.

#include "nearest.cuh"

#define SMEM_ACC_MAX_FLOATS 24576  // 96 KiB of dynamic shared memory

template <int NSPLIT>
__global__ void __launch_bounds__(NR_THREADS)
lloyd_partial_kernel(const float* __restrict__ X, const float* __restrict__ w,
                     int64_t n_valid, int d, const float* __restrict__ C,
                     const float* __restrict__ c2, int k, int64_t rows_per_block,
                     int smem_acc, float* __restrict__ part) {
  extern __shared__ float acc_smem[];
  __shared__ NearestSmemT<NSPLIT> sm;
  const int tid = threadIdx.x;
  const int64_t kd = (int64_t)k * d;
  const int64_t stride = kd + k + 1;  // sums (k, d), counts (k), inertia
  float* my_part = part + (int64_t)blockIdx.x * stride;
  float* acc = smem_acc ? acc_smem : my_part;
  for (int64_t e = tid; e < kd + k; e += NR_THREADS) acc[e] = 0.f;

  const int64_t r_begin = (int64_t)blockIdx.x * rows_per_block;
  const int64_t r_end = min(r_begin + rows_per_block, n_valid);
  float inertia = 0.f;  // thread 0's
  for (int64_t row0 = r_begin; row0 < r_end; row0 += NR_ROWS) {
    nearest_tile<false, NSPLIT>(X, row0, r_end, d, C, c2, k, sm);
    const int rows = (int)min((int64_t)NR_ROWS, r_end - row0);
    for (int rr = 0; rr < rows; ++rr) {
      const int64_t row = row0 + rr;
      const float wr = w ? w[row] : 1.f;
      if (wr == 0.f) continue;
      float* dst = acc + (int64_t)sm.best_i[rr] * d;
      const float* src = X + row * d;
      float wh, wl;
      bf16_parts<NSPLIT>(wr, wh, wl);
      for (int j = tid; j < d; j += NR_THREADS) {
        float xh, xl;
        bf16_parts<NSPLIT>(src[j], xh, xl);
        float a = dst[j];
        if constexpr (NSPLIT == 2) {
          a = fmaf(wl, xh, a);
          a = fmaf(wh, xl, a);
        }
        dst[j] = fmaf(wh, xh, a);
      }
    }
    if (tid == 0) {
      float tile = 0.f;  // two-level sum: per tile, then per block
      for (int rr = 0; rr < rows; ++rr) {
        const float wr = w ? w[row0 + rr] : 1.f;
        if (wr == 0.f) continue;
        acc[kd + sm.best_i[rr]] += wr;
        tile = fmaf(wr, fmaxf(sm.x2[rr] + sm.best_v[rr], 0.f), tile);
      }
      inertia += tile;
    }
  }
  __syncthreads();
  if (smem_acc) {
    for (int64_t e = tid; e < kd + k; e += NR_THREADS) my_part[e] = acc[e];
  }
  if (tid == 0) my_part[kd + k] = inertia;
}

// out[e] = sum over blocks b, in order, of part[b][e]
__global__ void lloyd_reduce_kernel(const float* __restrict__ part, int n_blocks,
                                    int64_t stride, float* __restrict__ out) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= stride) return;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += part[(int64_t)b * stride + e];
  out[e] = s;
}

template <int NSPLIT>
static cudaError_t launch_partial(const void* X, const void* w, long long n_valid, int d,
                                  const void* C, const void* c2, int k,
                                  long long rows_per_block, int n_blocks, int smem_acc,
                                  size_t smem, void* part, cudaStream_t s) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(lloyd_partial_kernel<NSPLIT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
  }
  lloyd_partial_kernel<NSPLIT><<<n_blocks, NR_THREADS, smem, s>>>(
      (const float*)X, (const float*)w, (int64_t)n_valid, d, (const float*)C,
      (const float*)c2, k, (int64_t)rows_per_block, smem_acc, (float*)part);
  return cudaGetLastError();
}

// out holds k d + k + 1 floats: sums (k, d), counts (k), inertia. part holds
// n_blocks times as many. n_split is 1, 2 or 3 (see above). Launches on
// `stream`; allocates nothing, does not synchronise. Returns
// cudaGetLastError() (0 on success).
extern "C" int srml_lloyd_step(const void* X, const void* w, long long n_valid,
                               int d, const void* C, const void* c2, int k,
                               long long rows_per_block, int n_blocks, void* part,
                               void* out, int n_split, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t stride = (int64_t)k * d + k + 1;
  const int smem_acc = (stride - 1) <= SMEM_ACC_MAX_FLOATS;
  const size_t smem = smem_acc ? (size_t)(stride - 1) * sizeof(float) : 0;
  cudaError_t err;
  if (n_split == 3) {
    err = launch_partial<3>(X, w, n_valid, d, C, c2, k, rows_per_block, n_blocks, smem_acc,
                            smem, part, s);
  } else if (n_split == 2) {
    err = launch_partial<2>(X, w, n_valid, d, C, c2, k, rows_per_block, n_blocks, smem_acc,
                            smem, part, s);
  } else if (n_split == 1) {
    err = launch_partial<1>(X, w, n_valid, d, C, c2, k, rows_per_block, n_blocks, smem_acc,
                            smem, part, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const int blocks = (int)((stride + threads - 1) / threads);
  lloyd_reduce_kernel<<<blocks, threads, 0, s>>>((const float*)part, n_blocks, stride,
                                                  (float*)out);
  return (int)cudaGetLastError();
}
