// Exact k nearest items by squared euclidean distance, the fused distance +
// running smallest-k scan: for each query row i, the k smallest of
//   d2_ij = min(max(q2_i - 2 q_i.x_j + x2_j, 0), INVALID_D2)   (item j valid)
//   d2_ij = INVALID_D2                                          (item j invalid)
// over the items j < n, ascending, with their int32 ids; ties go to the lower
// id. x2m_j holds the item's squared norm, or -1 for an invalid item.
//
// Replaces: spark_rapids_ml_tpu/ops/pallas_select.py::_topk_scan_kernel (the
// running top-k of the fused distance+select family, reached through
// _fused_topk_scan, fused_topk_pinned and fused_topk) in its float32 form,
// q.x_j exact f32, in 3xTF32 on the tensor cores (below). Its bfloat16 and
// int8 forms are topk_narrow.cu.
//
// What bounds it on the H100: the cross terms take 2 nq n d operations and the
// criterion and the compare about 4 more per pair. At the repo benchmark's
// traffic (100 queries against 8,388,608 x 256 items, k = 200) that is
// 4.3e14: 6.5 ms at the 67 TFLOP/s f32 peak of the CUDA cores, 2.6 ms in
// 3xTF32 on the tensor cores (three TF32 products per f32 product at
// 495 TFLOP/s), against 8.6 GB of items read once (2.6 ms at 3.35 TB/s). At
// 4,096 queries it is bound by operations, 107 ms in 3xTF32.
//
// Design (tf32x3.cuh has the products and the copies):
//   * A block owns a 64-query tile and one contiguous range of items, walked
//     in 128-item tiles. Query tiles run fastest in the grid, so the blocks
//     reading one item range run together and share it through L2; the
//     wrapper (ops/topk.py::_splits) sizes the ranges so that tiles x ranges
//     fills whole waves of the card's resident blocks.
//   * The distance tile is 3xTF32 on the tensor cores (mma.sync m16n8k8):
//     16 warps as 4 x 4, each a 16 x 32 block of the 64 x 128 tile. Query and
//     item columns come 32 at a time through a 3-stage cp.async ring, so the
//     next chunk's copies overlap this chunk's products; any d runs, columns
//     past d and rows past the edges zero-filled by the copy.
//   * Selection by 64-bit keys (topk_keys.cuh): the f32 bits of d2 high and
//     the item id low, unique and ordered as (d2, id). Each query keeps a
//     sorted pool of k keys in shared memory (sized by k at launch) and a
//     candidate buffer of 64 keys (32 when 64 do not fit beside the pools). The epilogue of a tile forms d2 in registers; a
//     thread first compares the least d2 of its 8 items of a query with the
//     query's current k-th d2, and only when that passes forms the keys and
//     appends each one below the query's k-th key to the query's buffer. When
//     a buffer is full, a warp sorts it (bitonic) and merges it into the pool
//     (merge path: every output found by a binary search, the pool rewritten
//     in place 32 outputs at a time from the top), which updates the k-th
//     key; the candidates that did not fit are appended after that, and the
//     rest wait for the range's end.
//   * One block of 16 warps per SM (__launch_bounds__(512, 1), at most 128
//     registers a thread; 219 KB of shared memory at k = 200 with 64-key
//     buffers, 231 KB at K_MAX with 32-key ones). The scan waits on the
//     latency of its fragment loads, splits and mma chains more than on the
//     tensor cores, so 16 warps beat 8: on an H100, builds with 8 warps, or
//     with one mma per fragment in place of three, showed it.
//   * Non-finite values: a kernel never turns NaN into a number. A NaN d2
//     (a NaN query) keys above INVALID_D2, as the plain version's selection
//     orders it; a NaN item has a NaN norm and is invalid.
//   * Pools start as all-ones keys (empty): every real key is below them, so
//     when k exceeds the valid items the tail holds the earliest invalid ids
//     at exactly INVALID_D2, as in the TPU kernel.
//   * With n_splits > 1, each range's pool goes to a scratch buffer and a
//     second kernel, one block per query, merges the n_splits sorted pools in
//     a tree of pairwise merge-path merges (global scratch, ping-pong), exact
//     and in key order.

#include <stdint.h>

#include <type_traits>

#include "tf32x3.cuh"
#include "topk_keys.cuh"

#define QT 64        // queries per block
#define IT 128       // items per tile
#define DK 32        // feature columns per ring stage
#define LDK (DK + 4) // row stride in shared memory, 4 mod 32: no bank conflicts
#define STAGES 3
#define BUF_MAX 64   // candidate buffer per query, when it fits (else 32)
#define WARPS_M 4    // warps along a tile's queries
#define WARPS_N 4    // and along its items
#define THREADS (32 * WARPS_M * WARPS_N)
#define MF (QT / WARPS_M / 16)  // a warp's m16 fragments (its QT / WARPS_M queries)
#define NF (IT / WARPS_N / 8)   // and n8 fragments (its IT / WARPS_N items)

static_assert(MF * NF * 4 <= 32, "a thread's candidates of a tile index one 32-bit mask");
static_assert(QT == 64, "merge_buffers takes a tile's queries as two 32-lane halves");

// Dynamic shared memory of the scan for k and a buffer of bcap keys a query
// (ops/topk.py::_smem_bytes): pools, buffers, k-th keys and their d2, the
// ring, the buffers' counts.
static size_t scan_smem_bytes(int k, int bcap) {
  return sizeof(u64) * ((size_t)QT * k + QT * bcap + QT) + sizeof(float) * QT +
         sizeof(float) * STAGES * (QT + IT) * LDK + sizeof(int) * QT;
}

// Merge query r's candidate buffer B (c keys, c <= 64, bcap 32 or 64) into its
// sorted pool P of k keys, by one warp: the buffer sorted (bitonic), then the
// pool rewritten in place, 32 outputs a round from the last round down (output
// o reads pool entries at or below o only, so a round never reads what a
// later-indexed round wrote). Returns the new k-th key (in every lane).
__device__ __forceinline__ u64 warp_merge(u64* P, u64* B, int c, int k, int bcap, int lane) {
  u64 a = lane < c ? B[lane] : KEY_EMPTY;
  u64 b = lane + 32 < c ? B[lane + 32] : KEY_EMPTY;
  warp_sort(a, b, lane, bcap == 32);
  B[lane] = a;
  if (bcap > 32) B[lane + 32] = b;
  __syncwarp();
  for (int s = (k - 1) / 32; s >= 0; --s) {
    const int o = lane + 32 * s;
    const u64 v = o < k ? merge_at(P, k, B, c, o) : 0ull;
    __syncwarp();
    if (o < k) P[o] = v;
    __syncwarp();
  }
  return P[k - 1];
}

// Merge into their pools the buffers that hold at least min_cnt keys, and
// update those queries' k-th key. The queries to merge are dealt out to the
// warps in turn (the i-th to warp i % 16), so a merge phase costs about one
// merge whether one query or sixteen need it. Called by the whole block.
__device__ void merge_buffers(u64* pool, u64* buf, u64* thr, float* thr_d2, int* cnt, int k,
                              int bcap, int min_cnt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  u64 todo = (u64)__ballot_sync(0xffffffffu, cnt[lane] >= min_cnt && cnt[lane] > 0) |
             (u64)__ballot_sync(0xffffffffu, cnt[lane + 32] >= min_cnt && cnt[lane + 32] > 0)
                 << 32;
  __syncthreads();  // every warp has its list before any count is reset
  for (int i = 0; todo != 0; ++i, todo &= todo - 1) {  // warp-uniform
    if (i % (THREADS / 32) != warp) continue;
    const int r = __ffsll((long long)todo) - 1;
    const u64 kth = warp_merge(pool + r * k, buf + r * bcap, min(cnt[r], bcap), k, bcap, lane);
    if (lane == 0) {
      thr[r] = kth;
      thr_d2[r] = kth_d2(kth);
      cnt[r] = 0;
    }
    __syncwarp();
  }
}

// Q (nq, d) and X (n, d) f32.
__global__ void __launch_bounds__(THREADS, 1)
topk_scan_kernel(const float* __restrict__ Q, const float* __restrict__ q2, int64_t nq,
                 int d, const float* __restrict__ X, const float* __restrict__ x2m,
                 int n, int k, int bcap, int split_items, int n_qtiles, bool vec16,
                 u64* __restrict__ part, float* __restrict__ out_d2,
                 int* __restrict__ out_id) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  u64* pool = reinterpret_cast<u64*>(smem_raw);
  u64* buf = pool + QT * k;
  u64* thr = buf + QT * bcap;                            // each query's k-th key
  float* thr_d2 = reinterpret_cast<float*>(thr + QT);    // and its d2 (+inf: pool not full)
  float* ring = thr_d2 + QT;
  int* cnt = reinterpret_cast<int*>(ring + STAGES * (QT + IT) * LDK);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // this warp's queries wm*MF*16 .. and items wn*NF*8 .. of the tile
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int64_t q0 = (int64_t)(blockIdx.x % n_qtiles) * QT;
  const int split = blockIdx.x / n_qtiles;
  const int lo = split * split_items;
  const int hi = min(lo + split_items, n);
  const int n_dc = (d + DK - 1) / DK;
  const int64_t row_bytes = (int64_t)d * 4;
  const char* const Qb = reinterpret_cast<const char*>(Q);
  const char* const Xb = reinterpret_cast<const char*>(X);
  const int n_units = (hi - lo + IT - 1) / IT * n_dc;  // (item tile, column chunk)

  for (int e = tid; e < QT * k; e += THREADS) pool[e] = KEY_EMPTY;
  if (tid < QT) {  // a query past nq takes nothing
    thr[tid] = q0 + tid < nq ? KEY_EMPTY : 0ull;
    thr_d2[tid] = q0 + tid < nq ? INFINITY : -INFINITY;
    cnt[tid] = 0;
  }
  float qn[MF][2];  // q2 of this thread's rows: (wm*MF + mf)*16 + g + 8h
#pragma unroll
  for (int mf = 0; mf < MF; ++mf)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t row = q0 + (wm * MF + mf) * 16 + g + 8 * h;
      qn[mf][h] = row < nq ? q2[row] : 0.f;
    }

  // a stage: 128 bytes of each of the tile's rows, as 16-byte copies where
  // the rows are whole 16 bytes, else as 4-byte ones
  auto load = [&](int u) {
    float* Qs = ring + (u % STAGES) * (QT + IT) * LDK;
    const int j0 = lo + u / n_dc * IT;
    const int64_t b0 = (int64_t)(u % n_dc) * (DK * 4);  // the stage's first byte of a row
    auto copies = [&](auto width) {  // width: bytes a copy, 16 or 4
      constexpr int W = decltype(width)::value, PER = DK * 4 / W;
      for (int e = tid; e < (QT + IT) * PER; e += THREADS) {
        const int rr = e / PER, off = W * (e % PER);
        float* dst = Qs + rr * LDK + off / 4;
        const bool in = b0 + off < row_bytes;
        const char* src;
        bool p;
        if (rr < QT) {
          p = q0 + rr < nq && in;
          src = p ? Qb + (q0 + rr) * row_bytes + b0 + off : Qb;
        } else {
          const int j = j0 + rr - QT;
          p = j < hi && in;
          src = p ? Xb + (int64_t)j * row_bytes + b0 + off : Xb;
        }
        if constexpr (W == 16) {
          cp_async16(dst, src, p);
        } else {
          cp_async4(dst, src, p);
        }
      }
    };
    if (vec16) {
      copies(std::integral_constant<int, 16>{});
    } else {
      copies(std::integral_constant<int, 4>{});
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_units) load(s);
    cp_async_commit();
  }
  __syncthreads();  // pools, thresholds and counts initialised

  int u = 0;
  for (int j0 = lo; j0 < hi; j0 += IT) {
    float xn[NF][2];  // x2 of this thread's items j0 + (wn*NF + nf)*8 + 2t + e, or +inf
#pragma unroll
    for (int nf = 0; nf < NF; ++nf)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = j0 + (wn * NF + nf) * 8 + 2 * t + e;
        const float x2 = j < hi ? x2m[j] : -1.f;
        // a NaN norm (a NaN item) fails the test too: invalid
        xn[nf][e] = x2 >= 0.f ? x2 : INFINITY;
      }
    // acc: the tile's cross terms in f32; p: one column chunk's, on the
    // tensor cores (tf32x3.cuh: their accumulation truncates)
    float acc[MF][NF][4], p[MF][NF][4];
#pragma unroll
    for (int mf = 0; mf < MF; ++mf)
#pragma unroll
      for (int nf = 0; nf < NF; ++nf)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mf][nf][e] = p[mf][nf][e] = 0.f;

    for (int dc = 0; dc < n_dc; ++dc, ++u) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // this chunk landed; every thread is done with the last one
      if (u + STAGES - 1 < n_units) load(u + STAGES - 1);
      cp_async_commit();
      const float* Qs = ring + (u % STAGES) * (QT + IT) * LDK;
      const float* Xs = Qs + QT * LDK;
      // columns kk .. kk + 7 of the stage, one m16n8k8 k-step; its fragments
      // are columns {kk + t, kk + t + 4} of rows g and g + 8 (A) and of row g (B)
      auto kstep = [&](int kk) {
        FragB3 fb[NF];
#pragma unroll
        for (int nf = 0; nf < NF; ++nf) {
          const float* b = Xs + ((wn * NF + nf) * 8 + g) * LDK + kk + t;
          split_b(b[0], b[4], fb[nf]);
        }
#pragma unroll
        for (int mf = 0; mf < MF; ++mf) {
          const float* a = Qs + ((wm * MF + mf) * 16 + g) * LDK + kk + t;
          const float v[4] = {a[0], a[8 * LDK], a[4], a[8 * LDK + 4]};
          FragA3 fa;
          split_a(v, fa);
#pragma unroll
          for (int nf = 0; nf < NF; ++nf) mma_3xtf32(p[mf][nf], fa, fb[nf]);
        }
      };
      // words of the rows left; zeros past them
      const int words = (int)((row_bytes - (int64_t)dc * (DK * 4)) / 4);
      if (words >= DK) {
#pragma unroll
        for (int kk = 0; kk < DK; kk += 8) kstep(kk);
      } else {
        for (int kk = 0; kk < words; kk += 8) kstep(kk);
      }
      add_stage<MF * NF * 4>(&acc[0][0][0], &p[0][0][0]);
    }

    // Epilogue: candidates below their query's k-th key go to its buffer;
    // `pend` marks the ones that did not fit yet (bit ((mf*NF + nf)*2 + h)*2 + e).
    // A key below the k-th key has d2 <= the k-th d2, and the least of the
    // clamped raw d2 (+inf items as INVALID_D2) is at most its d2, so the
    // thread forms a query's keys only when that least value passes.
    uint32_t pend = 0;
#pragma unroll
    for (int mf = 0; mf < MF; ++mf)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (wm * MF + mf) * 16 + g + 8 * h;
        float least = INFINITY;
#pragma unroll
        for (int nf = 0; nf < NF; ++nf)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = d2_raw(qn[mf][h], acc[mf][nf][2 * h + e], xn[nf][e]);
            least = fminf(least, fminf(v, TOPK_INVALID_D2));
          }
        if (!(least <= thr_d2[r])) continue;
        const u64 th = thr[r];
#pragma unroll
        for (int nf = 0; nf < NF; ++nf)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = j0 + (wn * NF + nf) * 8 + 2 * t + e;
            const u64 key = j < hi ? make_key(qn[mf][h], acc[mf][nf][2 * h + e], xn[nf][e], j)
                                   : KEY_EMPTY;
            if (key < th) pend |= 1u << (((mf * NF + nf) * 2 + h) * 2 + e);
          }
      }
    while (true) {
#pragma unroll
      for (int mf = 0; mf < MF; ++mf)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = (wm * MF + mf) * 16 + g + 8 * h;
#pragma unroll
          for (int nf = 0; nf < NF; ++nf)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const uint32_t bit = 1u << (((mf * NF + nf) * 2 + h) * 2 + e);
              if (!(pend & bit)) continue;
              const int j = j0 + (wn * NF + nf) * 8 + 2 * t + e;
              const int slot = atomicAdd(&cnt[r], 1);
              if (slot < bcap) {
                buf[r * bcap + slot] = make_key(qn[mf][h], acc[mf][nf][2 * h + e], xn[nf][e], j);
                pend &= ~bit;
              }
            }
        }
      if (!__syncthreads_or(pend != 0)) break;
      // the full buffers, and every one at least half full with them
      merge_buffers(pool, buf, thr, thr_d2, cnt, k, bcap, bcap / 2);
      __syncthreads();
#pragma unroll
      for (int mf = 0; mf < MF; ++mf)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const u64 th = thr[(wm * MF + mf) * 16 + g + 8 * h];
#pragma unroll
          for (int nf = 0; nf < NF; ++nf)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const uint32_t bit = 1u << (((mf * NF + nf) * 2 + h) * 2 + e);
              const int j = j0 + (wn * NF + nf) * 8 + 2 * t + e;
              if ((pend & bit) &&
                  !(make_key(qn[mf][h], acc[mf][nf][2 * h + e], xn[nf][e], j) < th)) {
                pend &= ~bit;
              }
            }
        }
    }
  }
  cp_async_wait<0>();
  merge_buffers(pool, buf, thr, thr_d2, cnt, k, bcap, 1);  // what the buffers still hold
  __syncthreads();

  for (int e = tid; e < QT * k; e += THREADS) {
    const int r = e / k, o = e % k;
    const int64_t row = q0 + r;
    if (row >= nq) continue;
    const u64 key = pool[e];
    if (part != nullptr) {
      part[((int64_t)split * nq + row) * k + o] = key;
    } else {
      out_d2[row * k + o] = key_d2(key);
      out_id[row * k + o] = key_id(key);
    }
  }
}

// Launches on `stream`; allocates nothing, does not synchronise. Q (nq, d)
// and X (n, d) f32. With n_splits == 1 the scan writes the result to (out_d2,
// out_id) and part / scratch are not read; otherwise the scan writes
// (n_splits, nq, k) keys to part, and the merge (topk_keys.cuh), with scratch
// of nq * (ceil(n_splits / 2) + ceil(n_splits / 4)) * k keys, writes the
// result. Returns cudaGetLastError() (0 on success).
extern "C" int srml_topk(const void* Q, const void* q2, long long nq, int d,
                         const void* X, const void* x2m, int n, int k, int n_splits,
                         int split_items, void* part, void* scratch, void* out_d2,
                         void* out_id, void* stream) {
  if (nq <= 0) return (int)cudaGetLastError();
  if (k < 1 || k > TOPK_K_MAX || n_splits < 1 || d < 1 || split_items < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const bool vec16 = d % 4 == 0 && (uintptr_t)Q % 16 == 0 && (uintptr_t)X % 16 == 0;
  const long long n_qtiles = (nq + QT - 1) / QT;
  if (n_qtiles * n_splits >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return (int)err;
  const int bcap = scan_smem_bytes(k, BUF_MAX) <= (size_t)max_smem ? BUF_MAX : 32;
  const size_t smem = scan_smem_bytes(k, bcap);
  const bool merge = n_splits > 1;
  const cudaStream_t st = (cudaStream_t)stream;
  err = cudaFuncSetAttribute(topk_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  topk_scan_kernel<<<(unsigned)(n_qtiles * n_splits), THREADS, smem, st>>>(
      (const float*)Q, (const float*)q2, nq, d, (const float*)X, (const float*)x2m, n, k, bcap,
      split_items, (int)n_qtiles, vec16, merge ? (u64*)part : nullptr, (float*)out_d2,
      (int*)out_id);
  err = cudaGetLastError();
  if (err != cudaSuccess || !merge) return (int)err;
  topk_merge_kernel<<<(unsigned)nq, MERGE_THREADS, 0, st>>>(
      (const u64*)part, (int64_t)nq, k, n_splits, (u64*)scratch, (float*)out_d2, (int*)out_id);
  return (int)cudaGetLastError();
}
