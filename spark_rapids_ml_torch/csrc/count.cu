// Eps-neighbor counts, DBSCAN's core-point test: for each query row i,
// counts[i] = #{ j < n : item j valid and max(q2_i - 2 q_i.x_j + x2_j, 0) <= eps2 },
// with eps2 a runtime argument.
//
// Replaces: spark_rapids_ml_tpu/ops/pallas_select.py::_count_kernel (the
// count-below-eps reduction of the fused distance+select family, reached through
// _fused_count and fused_count_below).
//
// What bounds it on the H100: the cross terms take 2 nq n d operations and
// the criterion about 4 more per pair; at the main path's 262,144 x 32 with
// Q = X that is 4.4e12 operations of products and 2.7e11 of the criterion,
// against 68 MB of inputs and counts (0.02 ms at 3.35 TB/s): it is bound by
// operations. In f32 on the CUDA cores (67 TFLOP/s) that is 69.8 ms; with the
// products in 3xTF32 on the tensor cores (three TF32 products each at
// 495 TFLOP/s) 26.6 ms, and the criterion's 4.1 ms at the f32 rate beside it.
//
// Design (the earlier design ran f32 FMA on the CUDA cores, a 32 x 32 tile
// re-staged element by element between two barriers a chunk, at 14% of its
// f32 bound; this one takes top-k's tensor-core tile, csrc/topk.cu and
// tf32x3.cuh):
//   * A block owns a 128-query tile and scans every item for it in 128-item
//     tiles, so each count is accumulated in registers and written once,
//     without atomics.
//   * The distance tile is 3xTF32 on the tensor cores (mma.sync m16n8k8,
//     tf32x3.cuh): 8 warps as 4 x 2, each a 32 x 64 block of the 128 x 128
//     tile (two m16 fragments by eight n8 ones, so each item fragment's split
//     serves two query fragments). Items come 32 columns at a time through a
//     3-stage cp.async ring (16-byte copies when rows are whole 16 bytes), so
//     the next tiles' copies overlap this tile's products; columns past d and
//     rows past the edges are zero-filled by the copy. One block an SM
//     (about 210 registers a thread): each warp's eight n8 fragments reuse
//     its resident query fragments, and each item fragment's split serves two
//     query fragments, fewer splits and loads an mma than top-k's 16 x 32.
//   * At d <= 32 (the main path's 32) a tile's whole depth is one ring
//     stage, and the query tile's fragments are split into their TF32 parts
//     once, when the block starts, and stay in registers for the whole scan:
//     only the items pass through the ring and are split. Wider rows pass the
//     query tile through the ring beside the items, a chunk at a time, as
//     top-k does.
//   * The tensor cores' accumulation truncates, so each stage's 12 mma chain
//     on a fresh fragment that is added to the f32 sums (tf32x3.cuh).
//   * The criterion is taken in registers on the fragment, as the TPU kernel
//     takes it: max(q2 - 2 q.x + x2, 0) <= eps2, with q2 and x2 the wrapper's
//     row norms, and x2m_j = -1 for an invalid item (the TPU kernel's folding
//     of the mask into the norm operand): an invalid item, or one past n,
//     never counts. For eps2 >= 0 the clamp changes no comparison, so the
//     kernel compares d2 itself, with an invalid item's norm taken as NaN (a
//     NaN d2 fails every comparison); for eps2 < 0 nothing counts. A kernel
//     never turns NaN into a number: a query or item with a NaN feature counts
//     nothing, as in the plain count and the JAX package.
//   * Each thread counts in int32 registers; at the end the four lanes of a
//     fragment row add by shuffles and the warps that share a query add
//     through shared memory (integer sums: no atomics).

#include <stdint.h>

#include <type_traits>

#include "tf32x3.cuh"

#define CQT 128        // queries per block
#define CIT 128        // items per tile
#define CDK 32         // feature columns per ring stage
#define CLDK (CDK + 4) // row stride in shared memory, 4 mod 32: no bank conflicts
#define CSTAGES 3
#define CWARPS_M 4     // warps along a tile's queries
#define CWARPS_N 2     // and along its items
#define CTHREADS (32 * CWARPS_M * CWARPS_N)
#define CMF (CQT / CWARPS_M / 16)  // a warp's m16 fragments (its CQT / CWARPS_M queries)
#define CNF (CIT / CWARPS_N / 8)   // and n8 fragments (its CIT / CWARPS_N items)
#define CKSTEPS (CDK / 8)          // mma k-steps of a stage

// Dynamic shared memory (ops/count.py::_plan): the ring (items, and the query
// chunks when they are not resident) and the warps' counts.
static size_t count_smem_bytes(bool resident) {
  return sizeof(float) * CSTAGES * ((resident ? 0 : CQT) + CIT) * CLDK +
         sizeof(int) * CWARPS_N * CQT;
}

// RES: d <= CDK, the query tile's split fragments held in registers.
template <bool RES>
__global__ void __launch_bounds__(CTHREADS, 1)
count_kernel(const float* __restrict__ Q, const float* __restrict__ q2, int64_t nq, int d,
             const float* __restrict__ X, const float* __restrict__ x2m, int n, float eps2,
             bool vec16, int* __restrict__ counts) {
  constexpr int ROWS = (RES ? 0 : CQT) + CIT;  // rows of a stage
  extern __shared__ __align__(16) float ring[];
  int* const wcount = reinterpret_cast<int*>(ring + CSTAGES * ROWS * CLDK);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // this warp's queries wm*CMF*16 .. and items wn*CNF*8 .. of the tile
  const int wm = warp / CWARPS_N, wn = warp % CWARPS_N;
  const int64_t q0 = (int64_t)blockIdx.x * CQT;
  const int n_dc = (d + CDK - 1) / CDK;
  const int n_units = (n + CIT - 1) / CIT * n_dc;  // (item tile, column chunk)

  float qn[CMF][2];  // q2 of this thread's rows (wm*CMF + mf)*16 + g + 8h
#pragma unroll
  for (int mf = 0; mf < CMF; ++mf)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t row = q0 + (wm * CMF + mf) * 16 + g + 8 * h;
      qn[mf][h] = row < nq ? q2[row] : 0.f;
    }
  FragA3 fa[RES ? CMF : 1][RES ? CKSTEPS : 1];  // the resident query fragments, split once
  if constexpr (RES) {
#pragma unroll
    for (int mf = 0; mf < CMF; ++mf) {
      const int64_t ra = q0 + (wm * CMF + mf) * 16 + g, rb = ra + 8;
#pragma unroll
      for (int ks = 0; ks < CKSTEPS; ++ks) {
        const int c = ks * 8 + t;
        auto at = [&](int64_t r, int col) {
          return r < nq && col < d ? Q[r * d + col] : 0.f;
        };
        const float v[4] = {at(ra, c), at(rb, c), at(ra, c + 4), at(rb, c + 4)};
        split_a(v, fa[mf][ks]);
      }
    }
  }

  // a stage: CDK columns of each of its rows (the query tile's first when not
  // resident), as 16-byte copies when rows are whole 16 bytes, else 4-byte ones
  auto load = [&](int u) {
    float* S = ring + (u % CSTAGES) * ROWS * CLDK;
    const int j0 = u / n_dc * CIT;
    const int c0 = (u % n_dc) * CDK;
    auto copies = [&](auto width) {
      constexpr int W = decltype(width)::value, PER = CDK / W;  // W: floats a copy
      for (int e = tid; e < ROWS * PER; e += CTHREADS) {
        const int rr = e / PER, cc = W * (e % PER);
        const int col = c0 + cc;
        const float* src;
        bool p;
        if (!RES && rr < CQT) {
          const int64_t q = q0 + rr;
          p = q < nq && col < d;
          src = p ? Q + q * d + col : Q;
        } else {
          const int j = j0 + rr - (RES ? 0 : CQT);
          p = j < n && col < d;
          src = p ? X + (int64_t)j * d + col : X;
        }
        if constexpr (W == 4) {
          cp_async16(S + rr * CLDK + cc, src, p);
        } else {
          cp_async4(S + rr * CLDK + cc, src, p);
        }
      }
    };
    if (vec16) {
      copies(std::integral_constant<int, 4>{});
    } else {
      copies(std::integral_constant<int, 1>{});
    }
  };

#pragma unroll
  for (int s = 0; s < CSTAGES - 1; ++s) {
    if (s < n_units) load(s);
    cp_async_commit();
  }

  int cnt[CMF][2] = {};
  int u = 0;
  for (int j0 = 0; j0 < n; j0 += CIT) {
    // x2 of this thread's items j0 + (wn*CNF + nf)*8 + 2t + e; NaN for an
    // invalid item (x2m -1) or one past n, so that its d2 is NaN and counts
    // nothing whatever eps2 is (a NaN item's norm is NaN already)
    float xe[CNF][2];
#pragma unroll
    for (int nf = 0; nf < CNF; ++nf)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = j0 + (wn * CNF + nf) * 8 + 2 * t + e;
        const float x = j < n ? __ldg(x2m + j) : -1.f;
        xe[nf][e] = x >= 0.f ? x : __int_as_float(0x7fc00000);  // NaN stays NaN
      }
    // acc: the tile's cross terms in f32; p: one column chunk's, on the
    // tensor cores (tf32x3.cuh: their accumulation truncates). With RES the
    // tile is one chunk, and p is the sum.
    float acc[RES ? 1 : CMF][RES ? 1 : CNF][4], p[CMF][CNF][4];
#pragma unroll
    for (int mf = 0; mf < CMF; ++mf)
#pragma unroll
      for (int nf = 0; nf < CNF; ++nf)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[mf][nf][e] = 0.f;
          if constexpr (!RES) acc[mf][nf][e] = 0.f;
        }

    for (int dc = 0; dc < n_dc; ++dc, ++u) {
      cp_async_wait<CSTAGES - 2>();
      __syncthreads();  // this chunk landed; every thread is done with the last one
      if (u + CSTAGES - 1 < n_units) load(u + CSTAGES - 1);
      cp_async_commit();
      const float* S = ring + (u % CSTAGES) * ROWS * CLDK;
      const float* Xs = S + (RES ? 0 : CQT) * CLDK;
#pragma unroll
      for (int ks = 0; ks < CKSTEPS; ++ks) {
        const int kk = ks * 8;
        FragB3 fb[CNF];
#pragma unroll
        for (int nf = 0; nf < CNF; ++nf) {
          const float* b = Xs + ((wn * CNF + nf) * 8 + g) * CLDK + kk + t;
          split_b(b[0], b[4], fb[nf]);
        }
#pragma unroll
        for (int mf = 0; mf < CMF; ++mf) {
          if constexpr (RES) {
#pragma unroll
            for (int nf = 0; nf < CNF; ++nf) mma_3xtf32(p[mf][nf], fa[mf][ks], fb[nf]);
          } else {
            const float* a = S + ((wm * CMF + mf) * 16 + g) * CLDK + kk + t;
            const float v[4] = {a[0], a[8 * CLDK], a[4], a[8 * CLDK + 4]};
            FragA3 fq;
            split_a(v, fq);
#pragma unroll
            for (int nf = 0; nf < CNF; ++nf) mma_3xtf32(p[mf][nf], fq, fb[nf]);
          }
        }
      }
      if constexpr (!RES) add_stage<CMF * CNF * 4>(&acc[0][0][0], &p[0][0][0]);
    }

    // the criterion on the fragment (c0, c1 row g; c2, c3 row g + 8):
    // max(d2, 0) <= eps2 is d2 <= eps2 for eps2 >= 0 (a NaN fails both), and
    // nothing counts for eps2 < 0 (checked once, at the end)
#pragma unroll
    for (int mf = 0; mf < CMF; ++mf)
#pragma unroll
      for (int nf = 0; nf < CNF; ++nf)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float c = RES ? p[mf][nf][e] : acc[RES ? 0 : mf][RES ? 0 : nf][e];
          const float d2 = fmaf(-2.f, c, qn[mf][e >> 1]) + xe[nf][e & 1];
          cnt[mf][e >> 1] += d2 <= eps2 ? 1 : 0;
        }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mf = 0; mf < CMF; ++mf)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int c = cnt[mf][h];
      c += __shfl_xor_sync(0xffffffffu, c, 1);
      c += __shfl_xor_sync(0xffffffffu, c, 2);
      if (t == 0) wcount[wn * CQT + (wm * CMF + mf) * 16 + g + 8 * h] = c;
    }
  __syncthreads();
  for (int r = tid; r < CQT; r += CTHREADS) {
    if (q0 + r < nq) {
      int c = 0;
#pragma unroll
      for (int w = 0; w < CWARPS_N; ++w) c += wcount[w * CQT + r];
      counts[q0 + r] = eps2 >= 0.f ? c : 0;
    }
  }
}

template <bool RES>
static cudaError_t launch_count(unsigned blocks, cudaStream_t stream, const float* Q,
                                const float* q2, int64_t nq, int d, const float* X,
                                const float* x2m, int n, float eps2, bool vec16, int* counts) {
  const size_t smem = count_smem_bytes(RES);
  cudaError_t err = cudaFuncSetAttribute(
      count_kernel<RES>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  count_kernel<RES><<<blocks, CTHREADS, smem, stream>>>(Q, q2, nq, d, X, x2m, n, eps2, vec16,
                                                       counts);
  return cudaGetLastError();
}

// Launches on `stream`; allocates nothing, does not synchronise. One block a
// 64-query tile. Returns cudaGetLastError() (0 on success).
extern "C" int srml_count(const void* Q, const void* q2, long long nq, int d,
                          const void* X, const void* x2m, int n, float eps2,
                          void* counts, void* stream) {
  if (nq <= 0) return (int)cudaGetLastError();
  if (d < 1 || n < 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (nq + CQT - 1) / CQT;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const bool vec16 = d % 4 == 0 && (uintptr_t)Q % 16 == 0 && (uintptr_t)X % 16 == 0;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (d <= CDK) {
    err = launch_count<true>((unsigned)blocks, st, (const float*)Q, (const float*)q2, nq, d,
                             (const float*)X, (const float*)x2m, n, eps2, vec16, (int*)counts);
  } else {
    err = launch_count<false>((unsigned)blocks, st, (const float*)Q, (const float*)q2, nq, d,
                              (const float*)X, (const float*)x2m, n, eps2, vec16, (int*)counts);
  }
  return (int)err;
}
