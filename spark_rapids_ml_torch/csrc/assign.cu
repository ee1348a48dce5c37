// Fused KMeans assignment: labels[i] = argmin_c max(|x_i|^2 - 2 x_i.c + |c|^2, 0),
// the first index winning a tie.
//
// Replaces: spark_rapids_ml_tpu/ops/pallas_select.py::_assign_kernel (the argmin
// reduction of the fused distance+select family, reached through fused_assign).
//
// What bounds it on the H100: at the main path's shapes (n = 8.4M, d = 256) it
// reads X once, 4 n d bytes (2.57 ms with the labels), and does 2 n k d
// operations for the cross terms: at k = 20 (the summaries, the transform)
// 1.3 ms of f32 FMA or 0.52 ms in 3xTF32; at k = 81 (k-means||'s candidates,
// 1 + 2 k initSteps, in the init weighting) 5.19 ms of f32 FMA, twice the
// bytes, and 2.11 ms in 3xTF32, under them. On the tensor cores it is bound by
// bytes at both.
//
// Design: no (n, k) distance matrix is ever written. Rows stream once through
// the nearest-center tile of nearest.cuh (a cp.async ring, the centers
// resident in shared memory and split once a block, 3xTF32 mma.sync for the
// f32 form, the counterpart of the TPU kernel's full-f32 (HIGHEST) passes, or
// under parity_precision "high" (n_split 2, as the TPU kernel's
// _assign_n_split gives it) three bf16 mma.sync passes of exact part products;
// the argmin on the fragments and the labels written once). With one center
// chunk the plan takes 128-row tiles, which spread each tile's fixed cost
// (the ring's barrier, the warps' tree, the argmin) over twice the rows of a
// 64-row tile of whole rows, in stages of 128 columns at k = 20 and, where the
// centers' parts crowd the ring (176 KB of TF32 parts at k = 81 in f32), of 64
// or 32 columns; X is still read once.

#include "nearest.cuh"

// The plan (R, S, DC, resident, CK, rows_per_block, n_blocks, smem) is
// ops/select.py::_plan's, checked against nearest.cuh's layout. n_split is 3
// (f32) or 2 (the bf16 split). Launches on `stream`; allocates nothing, does
// not synchronise. Returns cudaGetLastError() (0 on success),
// cudaErrorInvalidValue for a plan the kernel does not take.
extern "C" int srml_assign(const void* X, long long n, int d, const void* C, const void* c2,
                           int k, void* labels, int R, int S, int DC, int resident, int CK,
                           long long rows_per_block, int n_blocks, long long smem, int n_split,
                           void* stream) {
  const NtPlan plan{R, S, DC, resident, CK, 0, rows_per_block};
  if ((n_split != 3 && n_split != 2) || n_blocks < 1 || n < 0 ||
      !nt_plan_check(n_split, plan, k, d, false, smem) ||
      (long long)n_blocks * rows_per_block < n)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  NtArgs args{};
  args.X = (const float*)X;
  args.n_rows = n;
  args.d = d;
  args.C = (const float*)C;
  args.c2 = (const float*)c2;
  args.k = k;
  args.labels = (int*)labels;
  args.plan = plan;
  args.vec16 = d % 4 == 0 && (uintptr_t)X % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = n_split == 3 ? nt_launch<3, false>(args, n_blocks, (size_t)smem, s)
                                 : nt_launch<2, false>(args, n_blocks, (size_t)smem, s);
  return (int)err;
}
