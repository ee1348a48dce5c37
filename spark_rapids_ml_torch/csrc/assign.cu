// Fused KMeans assignment: labels[i] = argmin_c max(|x_i|^2 - 2 x_i.c + |c|^2, 0),
// the first index winning a tie.
//
// Replaces: spark_rapids_ml_tpu/ops/pallas_select.py::_assign_kernel (the argmin
// reduction of the fused distance+select family, reached through fused_assign).
//
// What bounds it on the H100: at the main path's shapes (n = 8.4M, d = 256,
// k = 20 or the ~81 k-means|| candidates) it reads X once, 4 n d bytes, and does
// 2 n k d f32 operations; at k = 20 that is 2.6 ms of memory against 1.3 ms of
// f32 FMA at the published peaks, so it is bound by bytes, and by operations
// from k of about 40 up.
//
// Design: no (n, k) distance matrix is ever written. Rows stream through the
// shared nearest_tile (nearest.cuh): a row tile is staged once per center chunk
// and the running argmin closes in registers and shuffles. Centers stage through
// shared memory in (32 x 32) tiles, so any (k, d) runs. The products are f32 FMA
// on the CUDA cores, the counterpart of the TPU kernel's full-f32 (HIGHEST)
// bf16-split passes; no TF32. Under parity_precision "high" (n_split 2, as the
// TPU kernel's _assign_n_split gives it) each product is the two-part bf16
// split, three FMA of exact part products (nearest.cuh, bf16split.cuh): 3.9 ms
// of FMA at the main shape, near the bytes.

#include "nearest.cuh"

template <int NSPLIT>
__global__ void __launch_bounds__(NR_THREADS)
assign_kernel(const float* __restrict__ X, int64_t n, int d,
              const float* __restrict__ C, const float* __restrict__ c2, int k,
              int* __restrict__ labels) {
  __shared__ NearestSmemT<NSPLIT> sm;
  for (int64_t row0 = (int64_t)blockIdx.x * NR_ROWS; row0 < n;
       row0 += (int64_t)gridDim.x * NR_ROWS) {
    nearest_tile<true, NSPLIT>(X, row0, n, d, C, c2, k, sm);
    const int64_t row = row0 + threadIdx.x;
    if (threadIdx.x < NR_ROWS && row < n) labels[row] = sm.best_i[threadIdx.x];
  }
}

// n_split is 3 (f32) or 2 (the bf16 split). Launches on `stream`; allocates
// nothing, does not synchronise. Returns cudaGetLastError() (0 on success).
extern "C" int srml_assign(const void* X, long long n, int d, const void* C,
                           const void* c2, int k, void* labels, int n_blocks,
                           int n_split, void* stream) {
  if (n_split != 3 && n_split != 2) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (n_split == 3) {
      assign_kernel<3><<<n_blocks, NR_THREADS, 0, s>>>(
          (const float*)X, (int64_t)n, d, (const float*)C, (const float*)c2, k, (int*)labels);
    } else {
      assign_kernel<2><<<n_blocks, NR_THREADS, 0, s>>>(
          (const float*)X, (int64_t)n, d, (const float*)C, (const float*)c2, k, (int*)labels);
    }
  }
  return (int)cudaGetLastError();
}
