// The distance tile shared by lloyd.cu and assign.cu, and the
// nearest-center search over one tile of rows built on it (lloyd, assign).
//
// A block of NR_THREADS threads takes NR_ROWS rows at a time. Centers pass
// through shared memory in chunks of NR_K centers by NR_D feature columns, so
// every (k, d) runs: nothing of size k or d has to fit the block at once. Each
// thread owns one row and four centers of a chunk (row tid/8, centers
// tid%8 + 8q) and accumulates their cross terms x.c in f32 FMA. The argmin
// across the eight threads of a row is a shuffle reduction in which the lower
// center index wins a tie; chunks are visited in ascending order and replace
// the running best only when strictly smaller, so the first index wins overall.
//
// Rows at or past `n_rows` read as zeros (a select, never a multiply, so what
// lies past the edge never reaches the arithmetic).
//
// The cross terms take NSPLIT (bf16split.cuh): 3 f32 FMA; 1 both operands
// rounded to bf16 as they are staged; 2 each staged as its hi and lo parts, and
// each product taken as three FMA of exact part products (lo.hi, hi.lo, hi.hi).
// The row norms |x|^2 stay f32, from X itself.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16split.cuh"

#define NR_ROWS 32
#define NR_K 32
#define NR_D 32
#define NR_THREADS 256

template <int NSPLIT>
struct NearestSmemT {
  float xs[NR_ROWS][NR_D + 1];  // +1: no bank conflicts on column reads
  float cs[NR_K][NR_D + 1];     // (the hi parts at NSPLIT 1 and 2)
  float xs_lo[NSPLIT == 2 ? NR_ROWS : 1][NR_D + 1];  // the lo parts (NSPLIT 2)
  float cs_lo[NSPLIT == 2 ? NR_K : 1][NR_D + 1];
  float x2[NR_ROWS];      // squared row norms
  float best_v[NR_ROWS];  // criterion of the nearest center
  int best_i[NR_ROWS];    // index of the nearest center
};

// Stage v, or its parts, at (rr, cc) of a tile: xs / xs_lo or cs / cs_lo.
template <int NSPLIT>
__device__ __forceinline__ void stage_value(float v, float (*hi)[NR_D + 1],
                                            float (*lo)[NR_D + 1], int rr, int cc) {
  float h, l;
  bf16_parts<NSPLIT>(v, h, l);
  hi[rr][cc] = h;
  if constexpr (NSPLIT == 2) lo[rr][cc] = l;
}

// The distance tile's cross terms: acc[q] = x_r . c_(k0 + g + 8q), q = 0..3, for
// this thread's row r = tid / 8 and centers g = tid % 8 of the chunk at k0, over
// all d columns, at NSPLIT (see the header). Both tiles pass through sm 32
// columns at a time; centers at or past k read as zeros.
template <int NSPLIT>
__device__ __forceinline__ void cross_chunk(const float* __restrict__ X, int64_t row0,
                                            int64_t n_rows, int d,
                                            const float* __restrict__ C, int k0, int k,
                                            NearestSmemT<NSPLIT>& sm, float acc[4]) {
  const int tid = threadIdx.x;
  const int r = tid >> 3;
  const int g = tid & 7;
#pragma unroll
  for (int q = 0; q < 4; ++q) acc[q] = 0.f;
  for (int d0 = 0; d0 < d; d0 += NR_D) {
    __syncthreads();
    for (int e = tid; e < NR_K * NR_D; e += NR_THREADS) {
      const int rr = e / NR_D;
      const int cc = e % NR_D;
      const int col = d0 + cc;
      const int64_t row = row0 + rr;  // NR_K == NR_ROWS: one loop stages both
      stage_value<NSPLIT>((row < n_rows && col < d) ? X[row * d + col] : 0.f, sm.xs,
                          sm.xs_lo, rr, cc);
      const int kk = k0 + rr;
      stage_value<NSPLIT>((kk < k && col < d) ? C[(int64_t)kk * d + col] : 0.f, sm.cs,
                          sm.cs_lo, rr, cc);
    }
    __syncthreads();
#pragma unroll 8
    for (int cc = 0; cc < NR_D; ++cc) {
      const float xv = sm.xs[r][cc];
      if constexpr (NSPLIT == 2) {
        const float xl = sm.xs_lo[r][cc];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float ch = sm.cs[g + 8 * q][cc];
          acc[q] = fmaf(xl, ch, acc[q]);
          acc[q] = fmaf(xv, sm.cs_lo[g + 8 * q][cc], acc[q]);
          acc[q] = fmaf(xv, ch, acc[q]);
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[q] = fmaf(xv, sm.cs[g + 8 * q][cc], acc[q]);
      }
    }
  }
}

// FULL = true:  criterion max(x2 - 2 x.c + c2, 0)   (the assignment kernel)
// FULL = false: criterion c2 - 2 x.c                (the Lloyd kernel; x2 cancels)
// x.c at NSPLIT; x2 and c2 in f32.
template <bool FULL, int NSPLIT>
__device__ __forceinline__ void nearest_tile(const float* __restrict__ X,
                                             int64_t row0, int64_t n_rows, int d,
                                             const float* __restrict__ C,
                                             const float* __restrict__ c2, int k,
                                             NearestSmemT<NSPLIT>& sm) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  __syncthreads();  // the previous tile's readers of sm are done

  // squared norms, one warp per row
  for (int r = warp; r < NR_ROWS; r += NR_THREADS / 32) {
    const int64_t row = row0 + r;
    float s = 0.f;
    if (row < n_rows) {
      for (int j = lane; j < d; j += 32) {
        const float v = X[row * d + j];
        s = fmaf(v, v, s);
      }
    }
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) sm.x2[r] = s;
  }

  const int r = tid >> 3;  // this thread's row in the tile
  const int g = tid & 7;   // its centers in a chunk: g, g + 8, g + 16, g + 24
  float bv = INFINITY;
  int bi = 0;
  for (int k0 = 0; k0 < k; k0 += NR_K) {
    float acc[4];
    cross_chunk<NSPLIT>(X, row0, n_rows, d, C, k0, k, sm, acc);
    float lv = INFINITY;
    int li = 0x7fffffff;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = k0 + g + 8 * q;
      if (c < k) {
        const float v = FULL ? fmaxf(sm.x2[r] - 2.f * acc[q] + c2[c], 0.f)
                             : c2[c] - 2.f * acc[q];
        if (v < lv) {
          lv = v;
          li = c;
        }
      }
    }
    for (int o = 4; o > 0; o >>= 1) {  // within the 8 lanes of this row
      const float ov = __shfl_xor_sync(0xffffffffu, lv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, li, o);
      if (ov < lv || (ov == lv && oi < li)) {
        lv = ov;
        li = oi;
      }
    }
    if (lv < bv) {
      bv = lv;
      bi = li;
    }
  }
  if (g == 0) {
    sm.best_v[r] = bv;
    sm.best_i[r] = bi;
  }
  __syncthreads();
}
