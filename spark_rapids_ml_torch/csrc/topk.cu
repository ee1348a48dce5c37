// Exact k nearest items by squared euclidean distance, the fused distance +
// running smallest-k scan: for each query row i, the k smallest of
//   d2_ij = min(max(q2_i - 2 q_i.x_j + x2_j, 0), INVALID_D2)   (item j valid)
//   d2_ij = INVALID_D2                                          (item j invalid)
// over the items j < n, ascending, with their int32 ids; ties go to the lower
// id. x2m_j holds the item's squared norm, or -1 for an invalid item.
//
// Replaces: spark_rapids_ml_tpu/ops/pallas_select.py::_topk_scan_kernel (the
// running top-k of the fused distance+select family, reached through
// _fused_topk_scan, fused_topk_pinned and fused_topk) in its three compiled
// forms, chosen at launch (`mode`), with q.x_j taken as _cross_term takes it:
//   * float32: exact f32, in 3xTF32 on the tensor cores (below);
//   * bfloat16: bf16 operands (the wrapper's round-to-nearest-even copies),
//     products exact in f32, summed by mma.sync m16n8k16 in one pass;
//   * int8: int8 operands (the wrapper's per-row symmetric quantization,
//     round(v / max(s, 1e-30)) with s = max |row| / 127), summed exactly in
//     int32 by mma.sync m16n8k32, then (float(sum) * s_q) * s_x in the
//     epilogue, the order the TPU kernel rescales in.
// The narrow forms return the candidate pool of an approximate ranking; the
// caller re-ranks it in exact f32 (ops/knn.py::parity_rerank_sq). Their
// operand rows are padded with zeros to a whole 16 bytes by the wrapper.
//
// What bounds it on the H100: the cross terms take 2 nq n d operations and the
// criterion and the compare about 4 more per pair. At the repo benchmark's
// traffic (100 queries against 8,388,608 x 256 items, k = 200) that is
// 4.3e14: 6.5 ms at the 67 TFLOP/s f32 peak of the CUDA cores, 2.6 ms in
// 3xTF32 on the tensor cores (three TF32 products per f32 product at
// 495 TFLOP/s), against 8.6 GB of items read once (2.6 ms at 3.35 TB/s). At
// 4,096 queries it is bound by operations, 107 ms in 3xTF32. The narrow forms
// do the same products at the dense bf16 (989 TFLOP/s) and int8 (1,979 TOPS)
// rates on 2 or 1 bytes an item column, so their bound at 4,096 queries is
// about 18 and 9 ms of products beside the f32 epilogue's 4 nq n operations.
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
//   * Selection by 64-bit keys: the f32 bits of d2 (non-negative, so
//     monotone as unsigned) high and the item id low, the key the plain
//     version selects by (ops/selection.py). Keys are unique and order as
//     (d2, id), so ties go to the lower id whatever order candidates arrive
//     in. Each query keeps a sorted pool of k keys in shared memory (sized by
//     k at launch) and a candidate buffer of 64 keys (32 when 64 do not fit
//     beside the pools). The epilogue of a tile forms d2 in registers; a
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
//   * The narrow forms keep all of this: their ring stages hold the same 128
//     bytes a row (64 bf16 or 128 int8 columns), and their fragments of a
//     k-step (16 bf16 or 32 int8 columns) sit at the same 32-bit words of a
//     row as a TF32 k-step's 8 columns, so one fragment load serves all three
//     forms; only the mma and the epilogue's rescale differ.
//   * Non-finite values: a kernel never turns NaN into a number. A NaN d2
//     (a NaN query) keys above INVALID_D2, as the plain version's selection
//     orders it; a NaN item has a NaN norm and is invalid, in every form.
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

#define TOPK_K_MAX 256
#define TOPK_INVALID_D2 1.7014117331926443e38f  // f32max / 2, exactly
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
#define MERGE_THREADS 256
#define KEY_EMPTY 0xffffffffffffffffull
#define MODE_F32 0   // the forms of the scan (ops/topk.py MODES)
#define MODE_BF16 1
#define MODE_INT8 2

typedef unsigned long long u64;

static_assert(MF * NF * 4 <= 32, "a thread's candidates of a tile index one 32-bit mask");
static_assert(QT == 64, "merge_buffers takes a tile's queries as two 32-lane halves");

// Dynamic shared memory of the scan for k and a buffer of bcap keys a query
// (ops/topk.py::_smem_bytes): pools, buffers, k-th keys and their d2, the
// ring, the buffers' counts.
static size_t scan_smem_bytes(int k, int bcap) {
  return sizeof(u64) * ((size_t)QT * k + QT * bcap + QT) + sizeof(float) * QT +
         sizeof(float) * STAGES * (QT + IT) * LDK + sizeof(int) * QT;
}

// q2 - 2 q.x + x2 before the clamps; xe is x2, or +inf for an invalid item
// (or one past the range), which makes the result +inf.
__device__ __forceinline__ float d2_raw(float qn, float acc, float xe) {
  return fmaf(-2.f, acc, qn) + xe;
}

// The clamps keep a NaN (fmaxf / fminf would turn it into 0 or the sentinel):
// its key, like its plain-version order key, ranks above every number's.
__device__ __forceinline__ u64 make_key(float qn, float acc, float xe, int id) {
  float v = TOPK_INVALID_D2;
  if (xe != INFINITY) {
    v = d2_raw(qn, acc, xe);
    v = v < 0.f ? 0.f : v;
    v = v > TOPK_INVALID_D2 ? TOPK_INVALID_D2 : v;
  }
  // & 0x7fffffff: a -0.0 (or a NaN with its sign set) keys as its positive twin
  return ((u64)(__float_as_uint(v) & 0x7fffffffu) << 32) | (uint32_t)id;
}

__device__ __forceinline__ float key_d2(u64 key) { return __uint_as_float((uint32_t)(key >> 32)); }
__device__ __forceinline__ int key_id(u64 key) { return (int)(uint32_t)key; }

// The o-th smallest of the union of sorted a (la) and sorted b (lb), a first
// on ties: the merge path's co-rank by binary search.
__device__ __forceinline__ u64 merge_at(const u64* a, int la, const u64* b, int lb, int o) {
  int lo = max(0, o - lb), hi = min(o, la);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= b[o - mid - 1]) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int j = o - lo;
  return (j >= lb || (lo < la && a[lo] <= b[j])) ? a[lo] : b[j];
}

// One compare-exchange step of a bitonic network across lanes: element e's
// partner is e ^ stride (stride < 32), and blocks of `size` with (e & size) == 0
// sort ascending.
__device__ __forceinline__ u64 bitonic_step(u64 v, int e, int size, int stride) {
  const u64 o = __shfl_xor_sync(0xffffffffu, v, stride);
  return (((e & stride) == 0) == ((e & size) == 0)) ? min(v, o) : max(v, o);
}

// Ascending bitonic sort of 64 keys in a warp, a = element lane, b = element
// lane + 32; with only32, of the 32 keys in a.
__device__ __forceinline__ void warp_sort(u64& a, u64& b, int lane, bool only32) {
  const int top = only32 ? 32 : 64;
  for (int size = 2; size <= top; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride == 32) {  // size 64: a pairs with b in the same lane
        const u64 lo = min(a, b);
        b = max(a, b);
        a = lo;
      } else {
        a = bitonic_step(a, lane, size, stride);
        if (!only32) b = bitonic_step(b, lane + 32, size, stride);
      }
    }
  }
}

// c += a.b for one m16n8k16 bf16 fragment, f32 accumulators. Per warp, g =
// lane / 4, t = lane % 4, each register two bf16 (lower column low):
//   A (16 x 16, row major)  a0 = A[g][2t..]  a1 = A[g+8][2t..]  a2 = A[g][2t+8..]  a3 = A[g+8][2t+8..]
//   B (16 x 8, column major) b0 = B[2t..][g]  b1 = B[2t+8..][g]
//   C as mma_tf32's (tf32x3.cuh).
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a.b for one m16n8k32 int8 fragment, exact int32 accumulators; each
// register four int8 (lowest column lowest byte):
//   A (16 x 32, row major)  a0 = A[g][4t..]  a1 = A[g+8][4t..]  a2 = A[g][4t+16..]  a3 = A[g+8][4t+16..]
//   B (32 x 8, column major) b0 = B[4t..][g]  b1 = B[4t+16..][g]
__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Merge into their pools the buffers that hold at least min_cnt keys, and
// update those queries' k-th key. The queries to merge are dealt out to the
// warps in turn (the i-th to warp i % 16), so a merge phase costs about one
// merge whether one query or sixteen need it. Called by the whole block. A
// pool is rewritten in place, 32
// outputs a round from the last round down: output o reads pool entries at or
// below o only, so a round never reads what a later-indexed round wrote.
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
    const int c = min(cnt[r], bcap);
    u64* P = pool + r * k;
    u64* B = buf + r * bcap;
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
    if (lane == 0) {
      const u64 kth = P[k - 1];
      thr[r] = kth;
      // a NaN k-th d2 (a NaN query's pool) filters nothing: keys decide
      thr_d2[r] = kth == KEY_EMPTY || isnan(key_d2(kth)) ? INFINITY : key_d2(kth);
      cnt[r] = 0;
    }
    __syncwarp();
  }
}

// MODE: the form of the products. Q (nq, d) and X (n, d) hold f32, bf16 or
// int8 by the form (d counts their columns, zero padding included); qs and xs
// are the int8 form's row scales (unread otherwise).
template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
topk_scan_kernel(const void* __restrict__ Q, const float* __restrict__ q2, int64_t nq,
                 int d, const void* __restrict__ X, const float* __restrict__ x2m,
                 const float* __restrict__ qs, const float* __restrict__ xs,
                 int n, int k, int bcap, int split_items, int n_qtiles, bool vec16,
                 u64* __restrict__ part, float* __restrict__ out_d2,
                 int* __restrict__ out_id) {
  constexpr int ESIZE = MODE == MODE_F32 ? 4 : MODE == MODE_BF16 ? 2 : 1;
  constexpr int DKE = DK * 4 / ESIZE;  // columns a ring stage holds (its 128 bytes a row)
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
  const int n_dc = (d + DKE - 1) / DKE;
  const int64_t row_bytes = (int64_t)d * ESIZE;
  const char* const Qb = static_cast<const char*>(Q);
  const char* const Xb = static_cast<const char*>(X);
  const int n_units = (hi - lo + IT - 1) / IT * n_dc;  // (item tile, column chunk)

  for (int e = tid; e < QT * k; e += THREADS) pool[e] = KEY_EMPTY;
  if (tid < QT) {  // a query past nq takes nothing
    thr[tid] = q0 + tid < nq ? KEY_EMPTY : 0ull;
    thr_d2[tid] = q0 + tid < nq ? INFINITY : -INFINITY;
    cnt[tid] = 0;
  }
  float qn[MF][2];  // q2 of this thread's rows: (wm*MF + mf)*16 + g + 8h
  float qsc[MF][2];  // and their int8 scales
#pragma unroll
  for (int mf = 0; mf < MF; ++mf)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t row = q0 + (wm * MF + mf) * 16 + g + 8 * h;
      qn[mf][h] = row < nq ? q2[row] : 0.f;
      qsc[mf][h] = MODE == MODE_INT8 && row < nq ? qs[row] : 0.f;
    }

  // a stage: 128 bytes of each of the tile's rows, as 16-byte copies (the
  // narrow forms' rows are whole 16 bytes), or as 4-byte ones for f32 rows
  // that are not
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
    float xsc[NF][2];  // and their int8 scales
#pragma unroll
    for (int nf = 0; nf < NF; ++nf)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = j0 + (wn * NF + nf) * 8 + 2 * t + e;
        const float x2 = j < hi ? x2m[j] : -1.f;
        // a NaN norm (a NaN item) fails the test too: invalid
        xn[nf][e] = x2 >= 0.f ? x2 : INFINITY;
        xsc[nf][e] = MODE == MODE_INT8 && j < hi ? xs[j] : 0.f;
      }
    // acc: the tile's cross terms in f32; p: one column chunk's, on the
    // tensor cores (tf32x3.cuh: their accumulation truncates); iacc: the int8
    // form's exact int32 sums
    float acc[MF][NF][4], p[MF][NF][4];
    int iacc[MF][NF][4];
#pragma unroll
    for (int mf = 0; mf < MF; ++mf)
#pragma unroll
      for (int nf = 0; nf < NF; ++nf)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[mf][nf][e] = p[mf][nf][e] = 0.f;
          iacc[mf][nf][e] = 0;
        }

    for (int dc = 0; dc < n_dc; ++dc, ++u) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // this chunk landed; every thread is done with the last one
      if (u + STAGES - 1 < n_units) load(u + STAGES - 1);
      cp_async_commit();
      const float* Qs = ring + (u % STAGES) * (QT + IT) * LDK;
      const float* Xs = Qs + QT * LDK;
      // words kk .. kk + 7 of the stage's rows: 8 f32, 16 bf16 or 32 int8
      // columns, one k-step of the form's mma; its fragments are words
      // {kk + t, kk + t + 4} of rows g and g + 8 (A) and of row g (B) in
      // every form
      auto kstep = [&](int kk) {
        if constexpr (MODE == MODE_F32) {
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
        } else {
          uint32_t fb[NF][2];
#pragma unroll
          for (int nf = 0; nf < NF; ++nf) {
            const float* b = Xs + ((wn * NF + nf) * 8 + g) * LDK + kk + t;
            fb[nf][0] = __float_as_uint(b[0]);
            fb[nf][1] = __float_as_uint(b[4]);
          }
#pragma unroll
          for (int mf = 0; mf < MF; ++mf) {
            const float* a = Qs + ((wm * MF + mf) * 16 + g) * LDK + kk + t;
            const uint32_t fa[4] = {__float_as_uint(a[0]), __float_as_uint(a[8 * LDK]),
                                    __float_as_uint(a[4]), __float_as_uint(a[8 * LDK + 4])};
#pragma unroll
            for (int nf = 0; nf < NF; ++nf) {
              if constexpr (MODE == MODE_BF16) {
                mma_bf16(p[mf][nf], fa, fb[nf]);
              } else {
                mma_s8(iacc[mf][nf], fa, fb[nf]);
              }
            }
          }
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
      if constexpr (MODE != MODE_INT8) add_stage<MF * NF * 4>(&acc[0][0][0], &p[0][0][0]);
    }
    if constexpr (MODE == MODE_INT8) {
      // the exact sums, rescaled as the TPU kernel does: (float(sum) * s_q) * s_x
#pragma unroll
      for (int mf = 0; mf < MF; ++mf)
#pragma unroll
        for (int nf = 0; nf < NF; ++nf)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float c = __int2float_rn(iacc[mf][nf][e]);
            acc[mf][nf][e] = __fmul_rn(__fmul_rn(c, qsc[mf][e >> 1]), xsc[nf][e & 1]);
          }
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

// One block per query: merge its n_splits sorted pools of (n_splits, nq, k)
// keys into the first k, by rounds of pairwise merge-path merges through the
// query's two scratch buffers (ceil(n/2) and ceil(n/4) pools), keys in order.
__global__ void __launch_bounds__(MERGE_THREADS)
topk_merge_kernel(const u64* __restrict__ part, int64_t nq, int k, int n_splits,
                  u64* __restrict__ scratch, float* __restrict__ out_d2,
                  int* __restrict__ out_id) {
  const int64_t i = blockIdx.x;
  const int h1 = (n_splits + 1) / 2, h2 = (h1 + 1) / 2;
  u64* const buf1 = scratch + i * (int64_t)(h1 + h2) * k;
  u64* const buf2 = buf1 + (int64_t)h1 * k;
  const u64* src = part + i * k;
  int64_t stride = nq * k;
  int lists = n_splits;
  bool second = false;
  while (lists > 1) {
    const int outs = (lists + 1) / 2;
    u64* dst = second ? buf2 : buf1;
    for (int64_t e = threadIdx.x; e < (int64_t)outs * k; e += MERGE_THREADS) {
      const int p = (int)(e / k), o = (int)(e % k);
      const u64* a = src + 2 * p * stride;
      const int lb = 2 * p + 1 < lists ? k : 0;
      const u64 v = merge_at(a, k, a + stride, lb, o);
      if (outs == 1) {
        out_d2[i * k + o] = key_d2(v);
        out_id[i * k + o] = key_id(v);
      } else {
        dst[(int64_t)p * k + o] = v;
      }
    }
    __syncthreads();  // this round's pools are written
    src = dst;
    stride = k;
    lists = outs;
    second = !second;
  }
}

// Launches on `stream`; allocates nothing, does not synchronise. `mode` is
// MODE_F32, MODE_BF16 or MODE_INT8; Q and X hold that form's operands (f32,
// bf16 or int8, d columns each, a whole 16 bytes a row in the narrow forms),
// and qs / xs the int8 form's row scales (ignored otherwise). With
// n_splits == 1 the scan writes the result to (out_d2, out_id) and part /
// scratch are not read; otherwise the scan writes (n_splits, nq, k) keys to
// part, and the merge, with scratch of nq * (ceil(n_splits / 2) +
// ceil(n_splits / 4)) * k keys, writes the result. Returns cudaGetLastError()
// (0 on success).
template <int MODE>
static cudaError_t launch_scan(unsigned blocks, size_t smem, cudaStream_t stream,
                               const void* Q, const float* q2, int64_t nq, int d,
                               const void* X, const float* x2m, const float* qs,
                               const float* xs, int n, int k, int bcap, int split_items,
                               int n_qtiles, bool vec16, u64* part, float* out_d2,
                               int* out_id) {
  cudaError_t err = cudaFuncSetAttribute(
      topk_scan_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  topk_scan_kernel<MODE><<<blocks, THREADS, smem, stream>>>(
      Q, q2, nq, d, X, x2m, qs, xs, n, k, bcap, split_items, n_qtiles, vec16, part, out_d2,
      out_id);
  return cudaGetLastError();
}

extern "C" int srml_topk(const void* Q, const void* q2, long long nq, int d,
                         const void* X, const void* x2m, int n, int k, int n_splits,
                         int split_items, void* part, void* scratch, void* out_d2,
                         void* out_id, int mode, const void* qs, const void* xs,
                         void* stream) {
  if (nq <= 0) return (int)cudaGetLastError();
  if (k < 1 || k > TOPK_K_MAX || n_splits < 1 || d < 1 || split_items < 1 || mode < MODE_F32 ||
      mode > MODE_INT8) {
    return (int)cudaErrorInvalidValue;
  }
  const int esize = mode == MODE_F32 ? 4 : mode == MODE_BF16 ? 2 : 1;
  const bool vec16 = (int64_t)d * esize % 16 == 0 && (uintptr_t)Q % 16 == 0 &&
                     (uintptr_t)X % 16 == 0;
  if (mode != MODE_F32 && !vec16) return (int)cudaErrorInvalidValue;  // rows of whole 16 bytes
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
  const unsigned blocks = (unsigned)(n_qtiles * n_splits);
  auto* const pp = merge ? (u64*)part : nullptr;
  const cudaStream_t st = (cudaStream_t)stream;
  if (mode == MODE_F32) {
    err = launch_scan<MODE_F32>(blocks, smem, st, Q, (const float*)q2, nq, d, X,
                                (const float*)x2m, nullptr, nullptr, n, k, bcap, split_items,
                                (int)n_qtiles, vec16, pp, (float*)out_d2, (int*)out_id);
  } else if (mode == MODE_BF16) {
    err = launch_scan<MODE_BF16>(blocks, smem, st, Q, (const float*)q2, nq, d, X,
                                 (const float*)x2m, nullptr, nullptr, n, k, bcap, split_items,
                                 (int)n_qtiles, vec16, pp, (float*)out_d2, (int*)out_id);
  } else {
    err = launch_scan<MODE_INT8>(blocks, smem, st, Q, (const float*)q2, nq, d, X,
                                 (const float*)x2m, (const float*)qs, (const float*)xs, n, k,
                                 bcap, split_items, (int)n_qtiles, vec16, pp, (float*)out_d2,
                                 (int*)out_id);
  }
  if (err != cudaSuccess || !merge) return (int)err;
  topk_merge_kernel<<<(unsigned)nq, MERGE_THREADS, 0, (cudaStream_t)stream>>>(
      (const u64*)part, (int64_t)nq, k, n_splits, (u64*)scratch, (float*)out_d2,
      (int*)out_id);
  return (int)cudaGetLastError();
}
