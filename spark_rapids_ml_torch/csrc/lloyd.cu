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
// terms on the tensor cores (3xTF32 at NSPLIT 3; bf16 mma.sync of the exact
// parts at 1 and 2), and the update, which adds split(w).split(x) per row,
// lo_w hi_x + hi_w lo_x + hi_w hi_x at NSPLIT 2 (the one-hot entry carries the
// weight: unit weights add hi_x + lo_x, or hi_x at NSPLIT 1). The counts, |x|^2
// and |c|^2 stay f32; the inertia takes the split criterion, as on the TPU.
//
// What bounds it on the H100: one step reads X once, 4 n d bytes (8.6 GB at
// the main path's 8.4M x 256, 2.56 ms), and does 2 n k d operations for the
// distances plus 2 n d for the sums; at k = 20 the distances take 0.52 ms in
// 3xTF32 (0.09 / 0.27 ms in the split forms' bf16 passes), so it is bound by
// bytes. At k = 81 (not a Lloyd shape of the main path) 2.11 ms in 3xTF32.
//
// Design: the nearest-center tile of nearest.cuh (one read of X through a
// cp.async ring, the centers resident and split once a block, the cross terms
// on the tensor cores, the argmin on the fragments), then the tile's rows are
// added from its stage into the block's partial, each center's rows in row
// order: on the main path (k <= 24, d <= 256, whole 64-row tiles) warp w keeps
// 8 columns a lane of centers w and w + 16 in registers and finds their rows
// by ballots; elsewhere the tile's rows are sorted by center and thread j
// adds to columns j, j + THREADS, ... of a partial in shared memory where
// k d fits, else in its slice of `part`. One warp adds the inertia in a
// shuffle tree. Each block owns a contiguous range of rows and a partial of
// its own; a second kernel adds the partials in block order. No float
// atomics: a fit gives the same centers and n_iter on every run. Rows at or
// past n_valid come in as zeros and are left out by their zero weight, never
// by a multiply; rows of weight 0 add nothing.

#include "nearest.cuh"

// out[e] = sum over blocks b, in order, of part[b][e]
__global__ void lloyd_reduce_kernel(const float* __restrict__ part, int n_blocks,
                                    int64_t stride, float* __restrict__ out) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= stride) return;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += part[(int64_t)b * stride + e];
  out[e] = s;
}

// out holds k d + k + 1 floats: sums (k, d), counts (k), inertia; part holds
// n_blocks times as many. The plan (R, S, DC, resident, CK, sums_smem,
// rows_per_block, n_blocks, smem) is ops/lloyd.py::_plan's, checked against
// nearest.cuh's layout. n_split is 1, 2 or 3 (see above). Launches on
// `stream`; allocates nothing, does not synchronise. Returns
// cudaGetLastError() (0 on success), cudaErrorInvalidValue for a plan the
// kernel does not take.
extern "C" int srml_lloyd_step(const void* X, const void* w, long long n_valid, int d,
                               const void* C, const void* c2, int k, int R, int S, int DC,
                               int resident, int CK, int sums_smem, long long rows_per_block,
                               int n_blocks, long long smem, void* part, void* out,
                               int n_split, void* stream) {
  const NtPlan plan{R, S, DC, resident, CK, sums_smem, rows_per_block};
  if (n_split < 1 || n_split > 3 || n_blocks < 1 || n_valid < 0 ||
      !nt_plan_check(n_split, plan, k, d, true, smem) ||
      (long long)n_blocks * rows_per_block < n_valid)
    return (int)cudaErrorInvalidValue;
  NtArgs args{};
  args.X = (const float*)X;
  args.w = (const float*)w;
  args.n_rows = n_valid;
  args.d = d;
  args.C = (const float*)C;
  args.c2 = (const float*)c2;
  args.k = k;
  args.part = (float*)part;
  args.plan = plan;
  args.vec16 = d % 4 == 0 && (uintptr_t)X % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (n_split == 3) {
    err = nt_launch<3, true>(args, n_blocks, (size_t)smem, s);
  } else if (n_split == 2) {
    err = nt_launch<2, true>(args, n_blocks, (size_t)smem, s);
  } else {
    err = nt_launch<1, true>(args, n_blocks, (size_t)smem, s);
  }
  if (err != cudaSuccess) return (int)err;
  const int64_t stride = (int64_t)k * d + k + 1;
  const int threads = 256;
  const int blocks = (int)((stride + threads - 1) / threads);
  lloyd_reduce_kernel<<<blocks, threads, 0, s>>>((const float*)part, n_blocks, stride,
                                                  (float*)out);
  return (int)cudaGetLastError();
}
