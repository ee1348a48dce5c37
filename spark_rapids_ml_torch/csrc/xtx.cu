// Fused Gram accumulation: S2 = X^T X and s1 = colsum X over the rows below
// n_valid, for the PCA covariance (srml_xtx); and, with a label column y, also
// X^T y, sum y and sum y^2 in the same read of X, the normal-equation statistics
// of LinearRegression (srml_xtxy).
//
// Replaces: spark_rapids_ml_tpu/ops/pallas_xtwx.py::_xtx_kernel (reached through
// xtx_pallas and covariance_prefix_mask) and ::_xtxy_kernel (reached through
// xtxy_pallas and normal_eq_prefix_mask).
//
// What bounds it on the H100: S2 is symmetric, so the function needs one FMA
// per row for each of its d(d+1)/2 distinct entries, n d (d+1) f32 operations
// (plus n d for s1), against 4 n d bytes read. At the main path's 8.4M x 256
// that is 0.55 TFLOP: 8.3 ms at the 67 TFLOP/s f32 peak of the CUDA cores,
// 3.4 ms in 3xTF32 on the tensor cores (three TF32 products per f32 product at
// 495 TFLOP/s), against 2.6 ms for the 8.6 GB of X at 3.35 TB/s. The label
// adds 2 n d operations for X^T y and 3 n for its sums, and 4 n bytes.
//
// Under parity_precision "high" (n_split 2, BF16 below) the operands are split
// into their two bf16 parts in place of the TF32 parts, and the same three mma
// per product form lo.hi + hi.lo + hi.hi exactly (tf32x3.cuh, bf16split.cuh),
// the TPU kernel's _dot_multipass at n_split 2. Its least time is the same
// 2.6 ms of bytes (the split products at the bf16 peak, 3 n d (d+1) at 989
// TFLOP/s, take 1.7 ms); this form runs them at the TF32 rate. The column
// sums, sum y and sum y^2, entries of the same Gram, come out as split
// products too, sum (x_hi + x_lo), where the TPU kernel adds x in f32.
//
// Design (tf32x3.cuh has the products and the copies):
//   * The statistics are the Gram of Z = [X | y | 1] (xtx: [X | 1]): X^T y,
//     colsum X, sum y and sum y^2 are entries of Z^T Z, so they come out of
//     the same products and no thread has a role of its own. The label and
//     ones columns ride as 8 extra columns (EXT) beside the last 128-column
//     stripe of X, where the S2 tile would otherwise read past d.
//   * Only the upper 128 x 128 tiles of S2 are computed (3 at d = 256); a
//     diagonal tile computes both its halves and the reduction mirrors the
//     rest. Each tile reads the one or two column stripes of X it needs: 4
//     stripe reads, two reads of X, at d = 256.
//   * Products in 3xTF32 on the tensor cores (mma.sync m16n8k8): 8 warps as
//     2 x 4, each warp a 64 x 32 block of the tile (4 x 4 fragments), and in
//     the tiles of the last column one more 16 x 8 fragment against the
//     extra columns; warp 0 of the last diagonal tile adds the 16 x 8
//     fragment of the extra columns against themselves (y^T y, y^T 1).
//   * Rows come through a 4-stage cp.async ring of 32-row steps, so three
//     steps' copies are in flight while one is multiplied. Rows at or past
//     n_valid, and columns past d, are zero-filled by the copy (a select,
//     never a multiply).
//   * Sums are three-level: a stage's 32 rows on the tensor cores' own
//     accumulators (which truncate, so their chains are kept short), added
//     into f32 sums in registers, which every 1024 rows are added into
//     per-thread outer sums in shared memory; this keeps the f32 rounding of
//     a long row chunk near that of a blocked product.
//   * The work is split over tiles AND row chunks: the tiles of one chunk are
//     adjacent in the grid, so they run together and share their stripes
//     through L2; tiles x chunks is a whole number of waves (one block per
//     SM; ops/xtwx.py::_chunks). Each block writes its chunk's partial tile
//     to scratch and a second kernel adds the chunks in order. No float
//     atomics: the same input gives the same bits on every run.
//   * Any d runs (the TPU kernel's 512-column VMEM cap does not exist here);
//     when d is not a multiple of 4 the copies are 4 bytes each.

#include <stdint.h>

#include "tf32x3.cuh"

#define TILE 128
#define EXT 8                    // extra columns of the last stripe: [y,] 1, zeros
#define LDS (TILE + EXT)         // row stride in shared memory, 8 mod 32: no bank conflicts
#define RSTEP 32                 // rows per ring stage
#define STAGES 4
#define FLUSH_STEPS 32           // stages per inner-accumulator flush (1024 rows)
#define WARPS_M 2                // warps along a tile's rows
#define WARPS_N 4                // and along its columns
#define THREADS (32 * WARPS_M * WARPS_N)
#define MF (TILE / WARPS_M / 16)  // a warp's m16 fragments
#define NF (TILE / WARPS_N / 8)   // and n8 fragments
#define STAGE_FLOATS (RSTEP * LDS)  // one stripe of one stage
#define OUTER (MF * NF * 4 + 4 + 4)  // outer sums per thread: the tile, the extra fragments
#define SMEM_BYTES (4 * (STAGES * 2 * STAGE_FLOATS + OUTER * THREADS))

static_assert(RSTEP * EXT <= THREADS, "a stage's extra entries take one thread each");
static_assert(WARPS_N >= MF, "the extra column's m-fragments need a warp each");

// Copy rows [r0, r0 + RSTEP) of the stripe of X starting at column c0 into
// dst (RSTEP x LDS), zeros past r_end and past d; with ext, also the extra
// columns: y (HAS_Y), then ones, then zeros, zeros past r_end.
template <bool HAS_Y>
__device__ __forceinline__ void load_stripe(float* dst, const float* __restrict__ X,
                                            const float* __restrict__ y, int d, int c0,
                                            bool ext, int64_t r0, int64_t r_end, bool vec16) {
  const int tid = threadIdx.x;
  if (vec16) {
    for (int e = tid; e < RSTEP * (TILE / 4); e += THREADS) {
      const int rr = e / (TILE / 4), seg = e % (TILE / 4);
      const int64_t row = r0 + rr;
      const int col = c0 + 4 * seg;
      const bool p = row < r_end && col < d;
      cp_async16(dst + rr * LDS + 4 * seg, p ? X + row * d + col : X, p);
    }
  } else {
    for (int e = tid; e < RSTEP * TILE; e += THREADS) {
      const int rr = e / TILE, cc = e % TILE;
      const int64_t row = r0 + rr;
      const int col = c0 + cc;
      const bool p = row < r_end && col < d;
      cp_async4(dst + rr * LDS + cc, p ? X + row * d + col : X, p);
    }
  }
  if (ext && tid < RSTEP * EXT) {  // one extra entry per thread
    const int rr = tid / EXT, e = tid % EXT;
    const int64_t row = r0 + rr;
    const bool rv = row < r_end;
    float* p = dst + rr * LDS + TILE + e;
    if (HAS_Y && e == 0) {
      cp_async4(p, rv ? y + row : y, rv);
    } else {
      *p = (rv && e == (HAS_Y ? 1 : 0)) ? 1.f : 0.f;
    }
  }
}

template <bool HAS_Y, bool BF16>
__global__ void __launch_bounds__(THREADS, 1)
gram_partial_kernel(const float* __restrict__ X, const float* __restrict__ y,
                    int64_t n_valid, int d, int n_tiles, int n_pairs,
                    int64_t rows_per_chunk, bool vec16, float* __restrict__ s2_part,
                    float* __restrict__ s1_part, float* __restrict__ xty_part,
                    float* __restrict__ ys_part) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* outer = smem + STAGES * 2 * STAGE_FLOATS;

  // this block's upper tile (ti <= tj) and row chunk; the tiles of a chunk
  // are adjacent in the grid
  int pair = blockIdx.x % n_pairs, ti = 0, row_len = n_tiles;
  const int64_t chunk = blockIdx.x / n_pairs;
  while (pair >= row_len) {
    pair -= row_len;
    ++ti;
    --row_len;
  }
  const int tj = ti + pair;
  const int last = n_tiles - 1;
  const bool diag = ti == tj;
  const bool ext_b = tj == last;           // B stripe carries the extra columns
  const bool ext_ab = diag && ti == last;  // and A too: y^T y, y^T 1
  const int i0 = ti * TILE, j0 = tj * TILE;
  const int64_t r_begin = chunk * rows_per_chunk;
  const int64_t r_end = min(r_begin + rows_per_chunk, n_valid);
  const int n_steps = r_begin < r_end ? (int)((r_end - r_begin + RSTEP - 1) / RSTEP) : 0;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // this warp's rows wm*MF*16 .. and columns wn*NF*8 .. of the tile; warps
  // with wn < MF also take the extra columns against their m-fragment wn
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;

  // acc: f32 sums of this thread's fragments (the tile, the extra columns,
  // the extra columns against themselves); p: the same, for one ring stage
  // on the tensor cores
  float acc[MF][NF][4], acc_e[4], acc_ee[4], p[MF][NF][4], p_e[4], p_ee[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    acc_e[e] = acc_ee[e] = p_e[e] = p_ee[e] = 0.f;
#pragma unroll
    for (int mf = 0; mf < MF; ++mf)
#pragma unroll
      for (int nf = 0; nf < NF; ++nf) acc[mf][nf][e] = p[mf][nf][e] = 0.f;
  }
  for (int i = 0; i < OUTER; ++i) outer[i * THREADS + tid] = 0.f;

  auto load = [&](int step) {
    float* st = ring + (step % STAGES) * 2 * STAGE_FLOATS;
    const int64_t r0 = r_begin + (int64_t)step * RSTEP;
    load_stripe<HAS_Y>(st, X, y, d, i0, ext_ab, r0, r_end, vec16);
    if (!diag) load_stripe<HAS_Y>(st + STAGE_FLOATS, X, y, d, j0, ext_b, r0, r_end, vec16);
  };
  auto flush = [&]() {
    int i = 0;
#pragma unroll
    for (int mf = 0; mf < MF; ++mf)
#pragma unroll
      for (int nf = 0; nf < NF; ++nf)
#pragma unroll
        for (int e = 0; e < 4; ++e, ++i) {
          outer[i * THREADS + tid] += acc[mf][nf][e];
          acc[mf][nf][e] = 0.f;
        }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      outer[(MF * NF * 4 + e) * THREADS + tid] += acc_e[e];
      outer[(MF * NF * 4 + 4 + e) * THREADS + tid] += acc_ee[e];
      acc_e[e] = acc_ee[e] = 0.f;
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_steps) load(s);
    cp_async_commit();
  }
  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // this stage landed; every thread is done with the last one
    if (step + STAGES - 1 < n_steps) load(step + STAGES - 1);
    cp_async_commit();
    const float* As = ring + (step % STAGES) * 2 * STAGE_FLOATS;
    const float* Bs = diag ? As : As + STAGE_FLOATS;
#pragma unroll
    for (int kk = 0; kk < RSTEP; kk += 8) {
      const float* a0 = As + (kk + t) * LDS;
      const float* a4 = a0 + 4 * LDS;
      const float* b0 = Bs + (kk + t) * LDS;
      const float* b4 = b0 + 4 * LDS;
      FragB3 fb[NF], fe;
#pragma unroll
      for (int nf = 0; nf < NF; ++nf) {
        const int n = (wn * NF + nf) * 8 + g;
        split_b<BF16>(b0[n], b4[n], fb[nf]);
      }
      if (ext_b) split_b<BF16>(b0[TILE + g], b4[TILE + g], fe);
#pragma unroll
      for (int mf = 0; mf < MF; ++mf) {
        const int m = (wm * MF + mf) * 16 + g;
        const float v[4] = {a0[m], a0[m + 8], a4[m], a4[m + 8]};
        FragA3 fa;
        split_a<BF16>(v, fa);
#pragma unroll
        for (int nf = 0; nf < NF; ++nf) mma_3xtf32(p[mf][nf], fa, fb[nf]);
        if (ext_b && mf == wn) mma_3xtf32(p_e, fa, fe);  // wn < MF
      }
      if (ext_ab && warp == 0) {  // rows of A = the extra columns (8 of the 16)
        const float v[4] = {a0[TILE + g], 0.f, a4[TILE + g], 0.f};
        FragA3 fa;
        split_a<BF16>(v, fa);
        mma_3xtf32(p_ee, fa, fe);
      }
    }
    add_stage<MF * NF * 4>(&acc[0][0][0], &p[0][0][0]);
    add_stage<4>(acc_e, p_e);
    add_stage<4>(acc_ee, p_ee);
    if ((step + 1) % FLUSH_STEPS == 0) flush();
  }
  cp_async_wait<0>();
  flush();  // outer now holds this thread's sums

  float* out = s2_part + chunk * (int64_t)d * d;
  int i = 0;
#pragma unroll
  for (int mf = 0; mf < MF; ++mf)
#pragma unroll
    for (int nf = 0; nf < NF; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e, ++i) {
        const int r = i0 + (wm * MF + mf) * 16 + g + 8 * (e >> 1);
        const int c = j0 + (wn * NF + nf) * 8 + 2 * t + (e & 1);
        if (r < d && c < d) out[(int64_t)r * d + c] = outer[i * THREADS + tid];
      }
  if (ext_b && wn < MF && t == 0) {  // columns 0 and 1 of the extra fragment
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = i0 + (wm * MF + wn) * 16 + g + 8 * h;
      if (r >= d) continue;
      const float col0 = outer[(MF * NF * 4 + 2 * h) * THREADS + tid];
      const float col1 = outer[(MF * NF * 4 + 1 + 2 * h) * THREADS + tid];
      if (HAS_Y) {
        xty_part[chunk * d + r] = col0;
        s1_part[chunk * d + r] = col1;
      } else {
        s1_part[chunk * d + r] = col0;
      }
    }
  }
  if (HAS_Y && ext_ab && tid == 0) {  // (y, y) and (y, 1) of the extra fragment
    ys_part[chunk * 2] = outer[(MF * NF * 4 + 5) * THREADS];
    ys_part[chunk * 2 + 1] = outer[(MF * NF * 4 + 4) * THREADS];
  }
}

// S2 (d, d), s1 (d,) and, with y, X^T y (d,) and [sum y, sum y^2]: the chunks'
// partials added in chunk order; the lower tiles of S2 are read from their
// mirror in the upper ones.
template <bool HAS_Y>
__global__ void xtx_reduce_kernel(const float* __restrict__ s2_part,
                                  const float* __restrict__ s1_part,
                                  const float* __restrict__ xty_part,
                                  const float* __restrict__ ys_part, int n_chunks,
                                  int d, float* __restrict__ s2, float* __restrict__ s1,
                                  float* __restrict__ xty, float* __restrict__ ys) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t dd = (int64_t)d * d;
  if (e < dd) {
    int r = (int)(e / d), c = (int)(e % d);
    if (r / TILE > c / TILE) {
      const int tmp = r;
      r = c;
      c = tmp;
    }
    const int64_t src = (int64_t)r * d + c;
    float s = 0.f;
    for (int ch = 0; ch < n_chunks; ++ch) s += s2_part[ch * dd + src];
    s2[e] = s;
  } else if (e < dd + d) {
    const int c = (int)(e - dd);
    float s = 0.f;
    for (int ch = 0; ch < n_chunks; ++ch) s += s1_part[(int64_t)ch * d + c];
    s1[c] = s;
  } else if (HAS_Y && e < dd + 2 * d) {
    const int c = (int)(e - dd - d);
    float s = 0.f;
    for (int ch = 0; ch < n_chunks; ++ch) s += xty_part[(int64_t)ch * d + c];
    xty[c] = s;
  } else if (HAS_Y && e < dd + 2 * d + 2) {
    const int c = (int)(e - dd - 2 * d);
    float s = 0.f;
    for (int ch = 0; ch < n_chunks; ++ch) s += ys_part[(int64_t)ch * 2 + c];
    ys[c] = s;
  }
}

template <bool HAS_Y, bool BF16>
static int launch(const void* X, const void* y, long long n_valid, int d,
                  long long rows_per_chunk, int n_chunks, void* s2_part, void* s1_part,
                  void* xty_part, void* ys_part, void* s2, void* s1, void* xty, void* ys,
                  void* stream) {
  if (d < 1 || n_chunks < 1 || rows_per_chunk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n_tiles = (d + TILE - 1) / TILE;
  const int n_pairs = n_tiles * (n_tiles + 1) / 2;
  if ((long long)n_pairs * n_chunks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(gram_partial_kernel<HAS_Y, BF16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const bool vec16 = d % 4 == 0 && (uintptr_t)X % 16 == 0;
  gram_partial_kernel<HAS_Y, BF16><<<n_pairs * n_chunks, THREADS, SMEM_BYTES, s>>>(
      (const float*)X, (const float*)y, (int64_t)n_valid, d, n_tiles, n_pairs,
      (int64_t)rows_per_chunk, vec16, (float*)s2_part, (float*)s1_part, (float*)xty_part,
      (float*)ys_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t total = (int64_t)d * d + d + (HAS_Y ? d + 2 : 0);
  const int threads = 256;
  xtx_reduce_kernel<HAS_Y><<<(unsigned)((total + threads - 1) / threads), threads, 0, s>>>(
      (const float*)s2_part, (const float*)s1_part, (const float*)xty_part,
      (const float*)ys_part, n_chunks, d, (float*)s2, (float*)s1, (float*)xty,
      (float*)ys);
  return (int)cudaGetLastError();
}

// n_split 3 (3xTF32, f32 accuracy) or 2 (the two-part bf16 split)
template <bool HAS_Y>
static int launch_split(int n_split, const void* X, const void* y, long long n_valid, int d,
                        long long rows_per_chunk, int n_chunks, void* s2_part,
                        void* s1_part, void* xty_part, void* ys_part, void* s2, void* s1,
                        void* xty, void* ys, void* stream) {
  if (n_split == 3) {
    return launch<HAS_Y, false>(X, y, n_valid, d, rows_per_chunk, n_chunks, s2_part,
                                s1_part, xty_part, ys_part, s2, s1, xty, ys, stream);
  }
  if (n_split == 2) {
    return launch<HAS_Y, true>(X, y, n_valid, d, rows_per_chunk, n_chunks, s2_part,
                               s1_part, xty_part, ys_part, s2, s1, xty, ys, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// s2_part holds n_chunks * d * d floats, s1_part n_chunks * d; n_split 3 or 2.
// Launches on `stream`; allocates nothing, does not synchronise. Returns
// cudaGetLastError() (0 on success).
extern "C" int srml_xtx(const void* X, long long n_valid, int d,
                        long long rows_per_chunk, int n_chunks, void* s2_part,
                        void* s1_part, void* s2, void* s1, int n_split, void* stream) {
  return launch_split<false>(n_split, X, nullptr, n_valid, d, rows_per_chunk, n_chunks,
                             s2_part, s1_part, nullptr, nullptr, s2, s1, nullptr, nullptr,
                             stream);
}

// As srml_xtx, with the label y (n_valid or more floats): xty_part holds
// n_chunks * d floats and ys_part n_chunks * 2; xty gets X^T y and ys
// [sum y, sum y^2].
extern "C" int srml_xtxy(const void* X, const void* y, long long n_valid, int d,
                         long long rows_per_chunk, int n_chunks, void* s2_part,
                         void* s1_part, void* xty_part, void* ys_part, void* s2,
                         void* s1, void* xty, void* ys, int n_split, void* stream) {
  return launch_split<true>(n_split, X, y, n_valid, d, rows_per_chunk, n_chunks, s2_part,
                            s1_part, xty_part, ys_part, s2, s1, xty, ys, stream);
}
