// The bfloat16 and int8 forms of the fused distance + running smallest-k scan
// (topk.cu is the float32 form): for each query row i, the k smallest keys of
//   d2_ij = min(max(q2_i - 2 c_ij + x2_j, 0), INVALID_D2)   (item j valid)
//   d2_ij = INVALID_D2                                       (item j invalid)
// over the items j < n, ascending, with their int32 ids, ties to the lower id,
// where the cross term c_ij is taken as the TPU kernel's _cross_term takes it:
//   * bfloat16: bf16 operands (the wrapper's round-to-nearest-even copies),
//     products exact in f32, summed in f32 on the tensor cores;
//   * int8: int8 operands (the wrapper's per-row symmetric quantization),
//     summed exactly in int32, then (float(sum) * s_q) * s_x, the order the
//     TPU kernel rescales in.
// x2m_j holds the item's squared norm, or -1 for an invalid item. The result
// is the candidate pool of an approximate ranking; the caller re-ranks it in
// exact f32 (ops/knn.py::parity_rerank_sq). Operand rows are zero-padded by
// the wrapper to a whole 16 bytes (ops/topk.py::narrow_rows).
//
// Replaces: spark_rapids_ml_tpu/ops/pallas_select.py::_topk_scan_kernel in its
// bfloat16 and int8 forms (_cross_term, pallas_select.py:236-249).
//
// What bounds it on the H100: 2 nq n d products at the dense bf16 (989
// TFLOP/s) or int8 (1,979 TOPS) rate, against the items read once (2 or 1
// bytes a column); the f32 epilogue's 4 operations a pair run on the CUDA
// cores beside the products. At 4,096 queries against 8,388,608 x 256 items that is 17.8 ms
// (bf16) and 8.9 ms (int8) of products; at 100 queries the 4.3 GB (bf16) or
// 2.1 GB (int8) of items, 1.29 and 0.66 ms at 3.35 TB/s.
//
// Design, for Hopper (a block a resident SM):
//   * A block owns one or two consumer warpgroups of 64 queries each (the
//     wrapper's plan, ops/topk.py::narrow_plan: two where their pools fit;
//     a template parameter, so that each build keeps its registers) and one
//     contiguous range of items, walked in 128-item tiles; query blocks run
//     fastest in the grid, so the blocks of one item range run together and
//     share it through L2.
//   * A producer warpgroup gives its registers to the consumers (setmaxnreg;
//     with two consumers ptxas still holds them to 168). Its first thread
//     feeds a ring of `stages` stages in shared memory with TMA
//     (cp.async.bulk.tensor, 128-byte swizzle): a stage is 128 bytes of each
//     of a tile's 128 item rows (64 bf16 or 128 int8 columns), one mbarrier
//     "full" (transaction bytes) and one "empty" (each consumer warp arrives
//     when its products have read the stage). The depth is what the pools
//     leave of the block's shared memory. The query tile is resident: loaded
//     once, by TMA in the same swizzled chunks; where it does not fit (wide
//     d) its chunks ride in each stage beside the items'. TMA zero-fills rows
//     past n or nq and columns past the padded width; the x2m sentinel
//     decides validity.
//   * Each consumer warpgroup takes the 64 x 128 distance tile of its queries
//     with wgmma from shared memory, both operands K-major (d contiguous), the
//     descriptors' 128-byte swizzle the TMA's: bf16 m64n128k16 into f32
//     accumulators, int8 m64n128k32 into exact s32 ones, a column chunk's
//     k-steps committed as one group. With a whole tile's chunks in the ring
//     the stages are released after the tile's products; else each one as
//     soon as the group after it is issued.
//   * Two consumer warpgroups run independently: one's epilogue on the CUDA
//     cores overlaps the other's products on the tensor cores. (Making their
//     product issues alternate, by two named barriers, was slower on an
//     H100, PERF.md.)
//   * Selection (topk_keys.cuh) as in topk.cu, per warpgroup: a sorted pool
//     of k keys and a candidate buffer of 32 keys a query, the query's k-th
//     key and d2 in shared memory. A thread holds two rows x 32 items of a
//     tile (the wgmma accumulator layout: rows 16 w + g and + 8, columns
//     8 i + 2 t + e). It first tests each row at once, by the least of x2 -
//     2 c over its items against the k-th d2 with a rounding slack (an FMA
//     and a min a pair), and keys only a row that passes; keys below the
//     k-th key go to the buffer. A full buffer is merged into the pool by one
//     warp (warp_merge32: each buffer key's rank by binary search, the pool
//     shifted by counts), under a barrier of the warpgroup's 128 threads.
//   * Shared bounds across the item ranges of a query: each range offers its
//     full pool's k-th key (a launch-wide atomicMin) and stores its key at
//     rank ceil(k / n_splits) - 1; the producer warpgroup's other warps read
//     them from L2 and keep each query's bound in shared memory, and a range
//     filters by the least of its own k-th key and that bound. Either bound
//     is at least the final k-th key and keys are unique, so the merge of the
//     ranges stays exact, and a range skips the keys other ranges have
//     already beaten (the warm-up of a pool that every range pays alone).
//   * Non-finite values as in topk.cu: a NaN d2 keys above INVALID_D2; a NaN
//     item has a NaN norm and is invalid. Pools start empty (all-ones keys),
//     so the sentinel tail holds the earliest invalid ids.
//   * With n_splits > 1 the ranges' pools are merged by topk_merge_kernel.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "topk_keys.cuh"

#define QW 64                 // queries of a consumer warpgroup
#define BCAP 32               // candidate keys buffered a query (warp_merge32's lanes)
#define NIT 128               // items of a tile (the wgmma's N)
#define CHUNK_BYTES 128       // bytes of a row a stage holds (the swizzle's span)
#define ITEM_STAGE (NIT * CHUNK_BYTES)
#define QUERY_CHUNK (QW * CHUNK_BYTES)
#define WG_THREADS 128
#define MAX_CONSUMERS 2
#define PRODUCER_REGS 40      // setmaxnreg: the producer warpgroup gives registers up
#define CONSUMER_REGS 232     // and the consumers take them (2 x 128 x 232 + 128 x 40 <= 64 K)
#define FORM_BF16 1           // ops/topk.py MODES
#define FORM_INT8 2
#define BAR_WG 1              // named barriers 1, 2: a consumer warpgroup's own
#define WAIT_LIMIT_NS 20000000000ull  // a barrier not reached in 20 s is lost: trap
#define SHARE_SLEEP_NS 10000  // between two reads of the shared bounds (L2 traffic)

// Dynamic shared memory (ops/topk.py::narrow_smem_bytes): 1 KB of alignment
// slack, the resident query chunks, the ring, then per consumer warpgroup the
// pools, buffers, k-th keys and shared bounds, the ring's mbarriers and a
// count of finished consumers, the k-th d2 and counts, and the tile's item
// norms and scales.
static size_t narrow_smem_bytes(int consumers, int k, int stages, int n_chunks, bool resident) {
  const size_t q = resident ? (size_t)consumers * n_chunks * QUERY_CHUNK : 0;
  const size_t stage = ITEM_STAGE + (resident ? 0 : (size_t)consumers * QUERY_CHUNK);
  return 1024 + q + stages * stage +
         8 * ((size_t)consumers * QW * (k + BCAP + 2) + 2 * stages + 2) + 8 * (size_t)consumers * QW +
         8 * (size_t)consumers * NIT;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait for the phase of `parity` to complete; a wait of WAIT_LIMIT_NS traps
// (a fault of the pipeline), so a lost arrival ends the launch with an error.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try(a, parity)) return;
  const uint64_t t0 = global_ns();
  for (uint32_t i = 1;; ++i) {
    if (mbar_try(a, parity)) return;
    if ((i & 0xffffu) == 0 && global_ns() - t0 > WAIT_LIMIT_NS) __trap();
  }
}

// One box (128 bytes x rows) of a 2-D tensor map at (column c0, row c1) into
// shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// A barrier of one warpgroup's 128 threads that returns whether any of them
// passed v.
__device__ __forceinline__ bool wg_sync_or(int id, bool v) {
  uint32_t r;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.u32 q, %1, 0;\nbar.red.or.pred p, %2, 128, q;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(r)
      : "r"((uint32_t)v), "r"(id)
      : "memory");
  return r != 0;
}

// The wgmma descriptor of a K-major tile of 8-row x 128-byte swizzled atoms
// (TMA's 128-byte swizzle) at p, 1,024-byte aligned: the start address >> 4,
// the leading offset unused (1), the stride between 8-row groups 1,024 bytes,
// the 128-byte swizzle. A k-step 32 bytes further is the start address + 2.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3ffffu) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Tells the compiler that the accumulators are read and written here (and
// shared memory too): after the wait, so that it keeps them live (and no
// other value in their registers) while the asynchronous products still write
// them; in the epilogue, so that it recomputes from them rather than keeps.
template <typename T>
__device__ __forceinline__ void fence_acc(T (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if constexpr (std::is_floating_point<T>::value) {
      asm volatile("" : "+f"(d[i])::"memory");
    } else {
      asm volatile("" : "+r"(d[i])::"memory");
    }
  }
}

// d (+)= A.B^T for a 64 x 128 tile, one k-step of 16 bf16 columns; scale_d 0
// overwrites d. Thread (warp w, lane 4 g + t) holds d[4 i + 2 h + e] = row
// 16 w + g + 8 h, column 8 i + 2 t + e.
__device__ __forceinline__ void wgmma_bf16(float d[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
      "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
      "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The same for 32 int8 columns, exact s32 sums.
__device__ __forceinline__ void wgmma_s8(int d[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
      "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
      "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
      "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
      "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
      "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
      "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
      "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
      "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]),
      "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Merge a candidate buffer B of c <= 32 keys into the sorted pool P of k keys
// by one warp, the same result as topk.cu's warp_merge in fewer steps
// when k is large: the buffer sorted across the lanes (bitonic), each buffer
// key's rank in the pool found by one binary search a lane, then the pool's
// keys from the lowest rank up shifted by the number of buffer keys below
// them, 32 at a time from the top (a key only moves up, so a round never
// overwrites one not yet read), and the buffer keys written at rank + lane.
// Keys are unique, so no buffer key ties a pool key. Returns the k-th key.
__device__ __forceinline__ u64 warp_merge32(u64* P, const u64* B, int c, int k, int lane) {
  u64 b = lane < c ? B[lane] : KEY_EMPTY;
  u64 unused = KEY_EMPTY;
  warp_sort(b, unused, lane, true);
  int lo = 0, hi = k;  // pos = the pool keys below b
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (P[mid] < b) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int pos = lo;
  const int first = __shfl_sync(0xffffffffu, pos, 0);  // keys below the least rank stay
  for (int s = (k - 1) / 32; s >= first / 32; --s) {
    const int j = 32 * s + lane;
    const u64 v = j < k ? P[j] : 0ull;
    int below = 0;  // buffer keys with rank <= j: the largest such count, by halving
#pragma unroll
    for (int step = 32; step > 0; step >>= 1) {
      const int at = __shfl_sync(0xffffffffu, pos, below + step - 1);
      if (below + step <= c && at <= j) below += step;
    }
    __syncwarp();
    if (j < k && j >= first && j + below < k) P[j + below] = v;
    __syncwarp();
  }
  if (lane < c && pos + lane < k) P[pos + lane] = b;
  __syncwarp();
  return P[k - 1];
}

// Merge into their pools the buffers (BCAP keys) of one warpgroup's 64
// queries that hold at least min_cnt keys, and lower those queries' bound
// (thr, thr_d2) to their pool's k-th key; the queries to merge dealt out to
// its 4 warps in turn. With shared bounds (gk and mine: the queries' entries of the
// launch's bounds, real rows below `rows`), a full pool's k-th key is
// offered to gk (atomicMin) and its key at rank m is stored in mine.
// Called by the whole warpgroup.
__device__ void wg_merge(u64* pool, u64* buf, u64* thr, float* thr_d2, int* cnt, int k, int min_cnt, int lane, int wp, int bar, u64* gk, u64* mine, int m,
                         int rows) {
  u64 todo = (u64)__ballot_sync(0xffffffffu, cnt[lane] >= min_cnt && cnt[lane] > 0) |
             (u64)__ballot_sync(0xffffffffu, cnt[lane + 32] >= min_cnt && cnt[lane + 32] > 0)
                 << 32;
  named_sync(bar, WG_THREADS);  // every warp has its list before any count is reset
  for (int i = 0; todo != 0; ++i, todo &= todo - 1) {  // warp-uniform
    if (i % 4 != wp) continue;
    const int r = __ffsll((long long)todo) - 1;
    const u64 kth =
        min(warp_merge32(pool + r * k, buf + r * BCAP, min(cnt[r], BCAP), k, lane), thr[r]);
    if (lane == 0) {
      thr[r] = kth;
      thr_d2[r] = kth_d2(kth);
      cnt[r] = 0;
      if (gk != nullptr && r < rows) {
        if (kth != KEY_EMPTY) atomicMin(gk + r, kth);
        mine[r] = pool[r * k + m];
      }
    }
    __syncwarp();
  }
}

// The shared bounds of the block's queries (see the kernel), kept current in
// sb by the producer warpgroup's warps 1-3 (hid 0-95) until every consumer
// warpgroup has counted itself in `done`: the least of row n_splits and the
// largest of rows 0 .. n_splits - 1 of `bounds`, read from L2 every
// SHARE_SLEEP_NS or so.
__device__ void share_bounds(const u64* bounds, int64_t nq, int64_t qbase, int queries,
                             int n_splits, int consumers, volatile u64* sb, volatile int* done,
                             int hid) {
  while (*done < consumers) {
    for (int q = hid; q < queries; q += 3 * 32) {
      const int64_t row = qbase + q;
      if (row >= nq) break;
      u64 most = 0;  // KEY_EMPTY while a range has stored none
      for (int r = 0; r < n_splits && most != KEY_EMPTY; ++r) {
        most = max(most, __ldcg(bounds + r * nq + row));
      }
      const u64 b = min(__ldcg(bounds + n_splits * nq + row), most);
      if (b < sb[q]) sb[q] = b;
    }
    __nanosleep(SHARE_SLEEP_NS);
  }
}

// FORM: FORM_BF16 or FORM_INT8; CONS: consumer warpgroups; SMALL: the int8
// form's sums are below 2^22 in magnitude (at most 256 columns). qmap / xmap: the (nq, dp) and (n, dp)
// operands' tensor maps, boxes of 128 bytes x 64 and x 128 rows; qs / xs the
// int8 form's row scales (unread in bf16).
template <int FORM, int CONS, bool SMALL>
__global__ void __launch_bounds__((CONS + 1) * WG_THREADS, 1)
topk_narrow_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap xmap,
                   const float* __restrict__ q2, int64_t nq, int n_chunks,
                   const float* __restrict__ x2m, const float* __restrict__ x2max,
                   const float* __restrict__ qs,
                   const float* __restrict__ xs, int n, int k, int split_items,
                   int n_qblocks, int stages, bool resident, bool products_only,
                   u64* __restrict__ bounds, u64* __restrict__ part, float* __restrict__ out_d2,
                   int* __restrict__ out_id) {
  constexpr int CE = FORM == FORM_BF16 ? 64 : 128;  // columns of a chunk
  constexpr int consumers = CONS, bcap = BCAP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // 1,024-byte aligned, by an offset (so the compiler keeps shared accesses)
  unsigned char* const base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const int stage_bytes = ITEM_STAGE + (resident ? 0 : consumers * QUERY_CHUNK);
  unsigned char* const qres = base;
  unsigned char* const ring = qres + (resident ? consumers * n_chunks * QUERY_CHUNK : 0);
  u64* const pools = reinterpret_cast<u64*>(ring + (size_t)stages * stage_bytes);
  u64* const bufs = pools + consumers * QW * k;
  u64* const thrs = bufs + consumers * QW * bcap;  // each query's k-th key
  uint64_t* const full = reinterpret_cast<uint64_t*>(thrs + consumers * QW);
  uint64_t* const empty = full + stages;
  uint64_t* const qbar = empty + stages;
  u64* const sbs = reinterpret_cast<u64*>(qbar + 1);  // each query's shared bound
  int* const done = reinterpret_cast<int*>(sbs + consumers * QW);  // consumers finished
  float* const thr_d2s = reinterpret_cast<float*>(done + 2);  // the k-th d2 (+inf: not full)
  int* const cnts = reinterpret_cast<int*>(thr_d2s + consumers * QW);
  float* const tile_x2s = reinterpret_cast<float*>(cnts + consumers * QW);  // x2 or +inf
  float* const tile_xss = tile_x2s + consumers * NIT;                       // int8 scales

  const int tid = threadIdx.x;
  const int cons_threads = consumers * WG_THREADS;
  const int64_t qbase = (int64_t)(blockIdx.x % n_qblocks) * consumers * QW;
  const int split = blockIdx.x / n_qblocks;
  const int lo = split * split_items;
  const int hi = min(lo + split_items, n);
  const int n_tiles = (hi - lo + NIT - 1) / NIT;
  const int n_units = n_tiles * n_chunks;  // (item tile, column chunk)

  for (int e = tid; e < consumers * QW * k; e += blockDim.x) pools[e] = KEY_EMPTY;
  if (tid < consumers * QW) {  // a query past nq takes nothing
    const bool real = qbase + tid < nq;
    thrs[tid] = real ? KEY_EMPTY : 0ull;
    thr_d2s[tid] = real ? INFINITY : -INFINITY;
    cnts[tid] = 0;
    sbs[tid] = KEY_EMPTY;
  }
  if (tid == 0) *done = 0;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], consumers * 4);  // lane 0 of each consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= cons_threads) {
    // the producer warpgroup: its first thread issues every copy, its warps
    // 1-3 keep the shared bounds current
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid >= cons_threads + 32) {
      if (bounds != nullptr)
        share_bounds(bounds, nq, qbase, consumers * QW, gridDim.x / n_qblocks, consumers, sbs,
                     done, tid - cons_threads - 32);
      return;
    }
    if (tid != cons_threads) return;
    if (resident) {
      mbar_expect_tx(qbar, (uint32_t)(consumers * n_chunks * QUERY_CHUNK));
      for (int w = 0; w < consumers; ++w)
        for (int c = 0; c < n_chunks; ++c)
          tma_load(qres + (w * n_chunks + c) * QUERY_CHUNK, &qmap, c * CE, (int)(qbase + w * QW),
                   qbar);
    }
    // unit u: stage s, in its round's parity ph; column chunk c of the tile at row
    int s = 0, c = 0, row = lo;
    uint32_t ph = 0;
    for (int u = 0; u < n_units; ++u) {
      if (u >= stages) mbar_wait(&empty[s], ph ^ 1);  // the last round's consumers are done
      unsigned char* const st = ring + (size_t)s * stage_bytes;
      mbar_expect_tx(&full[s], (uint32_t)stage_bytes);
      tma_load(st, &xmap, c * CE, row, &full[s]);
      if (!resident)
        for (int w = 0; w < consumers; ++w)
          tma_load(st + ITEM_STAGE + w * QUERY_CHUNK, &qmap, c * CE, (int)(qbase + w * QW),
                   &full[s]);
      if (++c == n_chunks) c = 0, row += NIT;
      if (++s == stages) s = 0, ph ^= 1;
    }
    return;
  }

  // a consumer warpgroup: its 64 queries qbase + 64 w ..
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int w = tid / WG_THREADS, wt = tid % WG_THREADS;
  const int wp = wt >> 5, lane = wt & 31, g = lane >> 2, t = lane & 3;
  const int wbar = BAR_WG + w;
  u64* const pool = pools + w * QW * k;
  u64* const buf = bufs + w * QW * bcap;
  u64* const thr = thrs + w * QW;
  float* const thr_d2 = thr_d2s + w * QW;
  int* const cnt = cnts + w * QW;
  float* const tx2 = tile_x2s + w * NIT;
  float* const txs = tile_xss + w * NIT;
  const int64_t q0 = qbase + w * QW;
  // The shared bounds of this warpgroup's real queries (none with one range):
  // bounds holds (n_splits + 1, nq) keys, sb the current bound of each. Row
  // n_splits is the least k-th key of a full pool of any range: no key at or
  // above it can be among the final k. Row s is range s's key at rank m = ceil(k / n_splits) - 1: the
  // ranges together hold at least k keys at or below the largest of these,
  // so once every range has stored one, no key above it can be among the
  // final k either. Keys are unique, so the merge of the pools stays exact.
  const int rows = (int)max((int64_t)0, min((int64_t)QW, nq - q0));
  const int n_splits = gridDim.x / n_qblocks;
  const int m = (k + n_splits - 1) / n_splits - 1;
  u64* const gk = bounds != nullptr ? bounds + n_splits * nq + q0 : nullptr;
  u64* const mine = bounds != nullptr ? bounds + split * nq + q0 : nullptr;
  const volatile u64* const sb = sbs + w * QW;

  float qn[2], qsc[2];  // q2 and the int8 scale of this thread's rows 16 wp + g + 8 h
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t row = q0 + 16 * wp + g + 8 * h;
    qn[h] = row < nq ? q2[row] : 0.f;
    qsc[h] = FORM == FORM_INT8 && row < nq ? qs[row] : 0.f;
  }
  if (resident) mbar_wait(qbar, 0);

  // the next tile's item norm and scale, one a thread, loaded a tile ahead
  // (in products_only, the timing variant, only the products and the ring run)
  float nx2 = lo + wt < hi ? x2m[lo + wt] : -1.f;
  float nxs = FORM == FORM_INT8 && lo + wt < hi ? xs[lo + wt] : 0.f;
  const bool whole = stages >= n_chunks;  // a tile's chunks all fit in the ring
  const float x2mx = *x2max;              // the largest valid item norm
  int ring_s = 0;  // the stage of the next unit to consume, and its round's parity
  uint32_t ring_ph = 0;
  for (int j0 = lo; j0 < hi; j0 += NIT) {
    // the tile's item norms (+inf for an invalid item or one past the range;
    // a NaN norm, a NaN item, fails the test too) and scales in shared memory:
    // every thread has passed the last tile's final barrier, so nothing reads
    // them any more
    tx2[wt] = nx2 >= 0.f ? nx2 : INFINITY;
    if (FORM == FORM_INT8) txs[wt] = nxs;
    if (wt < QW) {  // a shared bound lowers this query's k-th key
      const u64 b = sb[wt];
      if (b < thr[wt]) {
        thr[wt] = b;
        thr_d2[wt] = kth_d2(b);
      }
    }
    named_sync(wbar, WG_THREADS);
    if (j0 + NIT + wt < hi) {
      nx2 = x2m[j0 + NIT + wt];
      if (FORM == FORM_INT8) nxs = xs[j0 + NIT + wt];
    } else {
      nx2 = -1.f;
      nxs = 0.f;
    }
    using Acc = typename std::conditional<FORM == FORM_BF16, float, int>::type;
    Acc acc[64];
    const int s0 = ring_s;
    for (int c = 0, prev = 0; c < n_chunks; ++c) {
      const int s = ring_s;
      mbar_wait(&full[s], ring_ph);
      if (++ring_s == stages) ring_s = 0, ring_ph ^= 1;
      wgmma_fence();
      unsigned char* const st = ring + (size_t)s * stage_bytes;
      const uint64_t da = sw128_desc(resident ? qres + (w * n_chunks + c) * QUERY_CHUNK
                                              : st + ITEM_STAGE + w * QUERY_CHUNK);
      const uint64_t db = sw128_desc(st);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if constexpr (FORM == FORM_BF16) {
          wgmma_bf16(acc, da + 2 * kk, db + 2 * kk, (c | kk) != 0);
        } else {
          wgmma_s8(acc, da + 2 * kk, db + 2 * kk, (c | kk) != 0);
        }
      }
      wgmma_commit();
      if (!whole && c > 0) {  // the chunk before this one is read: release its stage
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(&empty[prev]);
      }
      prev = s;
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) {  // release the tile's stages (with !whole, its last one)
      int s = whole ? s0 : (ring_s == 0 ? stages : ring_s) - 1;
      for (int c = whole ? 0 : n_chunks - 1; c < n_chunks; ++c) {
        mbar_arrive(&empty[s]);
        if (++s == stages) s = 0;
      }
    }
    if (products_only) continue;  // the timing variant: no epilogue, the pools stay empty

    // the cross term of accumulator r (row h = (r >> 1) & 1, column 8 i + 2 t
    // + e with i = r >> 2, e = r & 1) in f32, given that item's scale sx: the
    // int8 form's exact sum rescaled as the TPU kernel does, (float(sum) *
    // s_q) * s_x
    auto cross = [&](int r, float sx) -> float {
      if constexpr (FORM == FORM_BF16) {
        return acc[r];
      } else {
        // float(sum): below 2^22 in magnitude (up to 256 columns: 256 x 127^2)
        // by an integer add into a float's mantissa, exact, at the full rate
        // (the conversion instruction runs at a quarter of it)
        const float c = SMALL ? __int_as_float(0x4b400000 + acc[r]) - 12582912.f
                              : __int2float_rn(acc[r]);
        return __fmul_rn(__fmul_rn(c, qsc[(r >> 1) & 1]), sx);
      }
    };
    // the norms, and the int8 scales, of this thread's items 8 i + 2 t (.x)
    // and 8 i + 2 t + 1 (.y)
    auto x2at = [&](int i) { return *reinterpret_cast<const float2*>(tx2 + 8 * i + 2 * t); };
    auto xsat = [&](int i) {
      return FORM == FORM_INT8 ? *reinterpret_cast<const float2*>(txs + 8 * i + 2 * t)
                               : make_float2(0.f, 0.f);
    };

    // Epilogue. First, per row h of the thread's two, the least of y = x2 -
    // 2 c over its 32 items (an FMA and a min a pair); the row can hold a key
    // below its query's k-th key only if q2 + least y <= the k-th d2 + slack,
    // where the slack covers the rounding by which q2 + y differs from the
    // key's d2_raw = (q2 - 2 c) + x2 (each within 2^-23 (q2 + x2 + |2 c|) of
    // the exact value; |2 c| is at most (q2 + x2) times the product of the
    // two rows' quantized-to-true norm ratios, well below 15): 2^-18 (q2 +
    // x2max + kth). A NaN passes (the keys decide); an unfilled
    // pool's kth (or one at the sentinel) passes every pair; a row past nq
    // (kth -inf) none. Then only a passing row's 32 items are keyed; a key
    // below the k-th key goes to the query's buffer, and one that finds the
    // buffer full is marked in `pend` (bit 4 i + 2 h + e, the accumulator's
    // index).
    float lim[2], least[2][2] = {{INFINITY, INFINITY}, {INFINITY, INFINITY}};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float kth = thr_d2[16 * wp + g + 8 * h];
      lim[h] = kth >= TOPK_INVALID_D2 ? INFINITY : kth + 0x1p-18f * (qn[h] + x2mx + kth);
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float2 x2 = x2at(i), sx = xsat(i);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float y = fmaf(-2.f, cross(4 * i + 2 * h + e, e ? sx.y : sx.x), e ? x2.y : x2.x);
          least[h][i & 1] = fminf(least[h][i & 1], y);
        }
    }
    bool pass[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) pass[h] = !(qn[h] + fminf(least[h][0], least[h][1]) > lim[h]);
    // The keying recomputes a passing row's d2 from the accumulators: kept
    // from the first pass, 64 values would spill at two consumers' 168
    // registers.
    fence_acc(acc);
    u64 pend = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!pass[h]) continue;
      const int r = 16 * wp + g + 8 * h;
      const u64 th = thr[r];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float2 x2 = x2at(i), sx = xsat(i);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int a = 4 * i + 2 * h + e, j = j0 + 8 * i + 2 * t + e;
          if (j >= hi) continue;
          const u64 key = make_key(qn[h], cross(a, e ? sx.y : sx.x), e ? x2.y : x2.x, j);
          if (!(key < th)) continue;
          const int slot = atomicAdd(&cnt[r], 1);
          if (slot < bcap) {
            buf[r * bcap + slot] = key;
          } else {
            pend |= 1ull << a;
          }
        }
      }
    }
    // Buffers that overflowed: merge them (and every one at least half full
    // with them), then append what still passes its query's new k-th key,
    // until nothing waits.
    while (wg_sync_or(wbar, pend != 0)) {
      wg_merge(pool, buf, thr, thr_d2, cnt, k, bcap / 2, lane, wp, wbar, gk, mine, m, rows);
      named_sync(wbar, WG_THREADS);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * wp + g + 8 * h;
        const u64 th = thr[r];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const float2 x2 = x2at(i), sx = xsat(i);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int a = 4 * i + 2 * h + e;
            if (!(pend >> a & 1)) continue;
            const u64 key =
                make_key(qn[h], cross(a, e ? sx.y : sx.x), e ? x2.y : x2.x, j0 + 8 * i + 2 * t + e);
            if (key < th) {
              const int slot = atomicAdd(&cnt[r], 1);
              if (slot >= bcap) continue;
              buf[r * bcap + slot] = key;
            }
            pend &= ~(1ull << a);
          }
        }
      }
    }
  }
  if (wt == 0) atomicAdd(done, 1);
  named_sync(wbar, WG_THREADS);  // every append of the last tile is in
  wg_merge(pool, buf, thr, thr_d2, cnt, k, 1, lane, wp, wbar, nullptr, nullptr, 0, 0);
  named_sync(wbar, WG_THREADS);

  for (int e = wt; e < QW * k; e += WG_THREADS) {
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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, found through the runtime's entry-point
// query (no -lcuda at the build).
static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// The tensor map of `rows` rows of dp elements of esize bytes: boxes of 128
// bytes x box_rows rows, 128-byte swizzle, zeros out of bounds.
static bool make_map(CUtensorMap* map, const void* ptr, int64_t rows, int dp, int esize,
                     int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)dp, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)dp * esize};
  const cuuint32_t box[2] = {(cuuint32_t)(CHUNK_BYTES / esize), (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, esize == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
            const_cast<void*>(ptr), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int FORM, int CONS, bool SMALL>
static cudaError_t launch_narrow(unsigned blocks, size_t smem, cudaStream_t st,
                                 const CUtensorMap& qmap, const CUtensorMap& xmap,
                                 const float* q2, int64_t nq, int n_chunks, const float* x2m,
                                 const float* x2max,
                                 const float* qs, const float* xs, int n, int k,
                                 int split_items, int n_qblocks, int stages,
                                 bool resident, bool products_only, u64* bounds, u64* part,
                                 float* out_d2, int* out_id) {
  cudaError_t err = cudaFuncSetAttribute(topk_narrow_kernel<FORM, CONS, SMALL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  topk_narrow_kernel<FORM, CONS, SMALL><<<blocks, (CONS + 1) * WG_THREADS, smem, st>>>(
      qmap, xmap, q2, nq, n_chunks, x2m, x2max, qs, xs, n, k, split_items, n_qblocks, stages,
      resident, products_only, bounds, part, out_d2, out_id);
  return cudaGetLastError();
}

// Launches on `stream`; allocates nothing, does not synchronise. form:
// FORM_BF16 or FORM_INT8; Q (nq, dp) and X (n, dp) that form's operands, rows
// of a whole 16 bytes at 16-byte aligned addresses; qs / xs the int8 form's
// row scales (unread in bf16); x2max one float on the card, the largest
// finite norm of a valid item (0 if none). consumers, stages and resident
// are the
// launch plan (ops/topk.py::narrow_plan), refused when its shared memory does
// not fit a block.
// products_only != 0 is a timing variant that skips the epilogue (the result
// is then meaningless). part / scratch and the merge as srml_topk (topk.cu);
// with n_splits > 1, bound holds (n_splits + 1) * nq keys, all ones
// (KEY_EMPTY) at the launch: the ranges' shared bounds. Returns cudaGetLastError() (0 on success).
extern "C" int srml_topk_narrow(const void* Q, const void* q2, long long nq, int dp,
                                const void* X, const void* x2m, int n, int k, int n_splits,
                                int split_items, int consumers, int stages, int resident,
                                void* part, void* scratch, void* out_d2, void* out_id, int form,
                                const void* qs, const void* xs, const void* x2max,
                                int products_only, void* bound, void* stream) {
  if (nq <= 0) return (int)cudaGetLastError();
  if (form != FORM_BF16 && form != FORM_INT8) return (int)cudaErrorInvalidValue;
  const int esize = form == FORM_BF16 ? 2 : 1;
  const int n_chunks = (dp * esize + CHUNK_BYTES - 1) / CHUNK_BYTES;
  if (k < 1 || k > TOPK_K_MAX || n_splits < 1 || dp < 1 || n < 1 || split_items < 1 ||
      consumers < 1 || consumers > MAX_CONSUMERS || stages < 2 ||
      dp * esize % 16 != 0 || (uintptr_t)Q % 16 != 0 ||
      (uintptr_t)X % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n_qblocks = (nq + consumers * QW - 1) / (consumers * QW);
  if (n_qblocks * n_splits >= (1LL << 31) || nq >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return (int)err;
  const size_t smem = narrow_smem_bytes(consumers, k, stages, n_chunks, resident != 0);
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  CUtensorMap qmap, xmap;
  if (!make_map(&qmap, Q, nq, dp, esize, QW) || !make_map(&xmap, X, n, dp, esize, NIT)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool merge = n_splits > 1;
  const unsigned blocks = (unsigned)(n_qblocks * n_splits);
  const cudaStream_t st = (cudaStream_t)stream;
  u64* const pp = merge ? (u64*)part : nullptr;
  u64* const gb = merge ? (u64*)bound : nullptr;
  const bool res = resident != 0, po = products_only != 0;
  const int nb = (int)n_qblocks;
  const float *fq2 = (const float*)q2, *fx2m = (const float*)x2m, *fmx = (const float*)x2max;
  const float *fqs = (const float*)qs, *fxs = (const float*)xs;
  float* const od = (float*)out_d2;
  int* const oi = (int*)out_id;
#define NARROW_LAUNCH(F, C, S)                                                                \
  launch_narrow<F, C, S>(blocks, smem, st, qmap, xmap, fq2, nq, n_chunks, fx2m, fmx, fqs, fxs, n, k, \
                         split_items, nb, stages, res, po, gb, pp, od, oi)
  const bool small = dp <= 256;  // int8 sums below 256 x 127^2 < 2^22
  if (form == FORM_BF16) {
    err = consumers == 2 ? NARROW_LAUNCH(FORM_BF16, 2, false) : NARROW_LAUNCH(FORM_BF16, 1, false);
  } else if (small) {
    err = consumers == 2 ? NARROW_LAUNCH(FORM_INT8, 2, true) : NARROW_LAUNCH(FORM_INT8, 1, true);
  } else {
    err = consumers == 2 ? NARROW_LAUNCH(FORM_INT8, 2, false) : NARROW_LAUNCH(FORM_INT8, 1, false);
  }
#undef NARROW_LAUNCH
  if (err != cudaSuccess || !merge) return (int)err;
  topk_merge_kernel<<<(unsigned)nq, MERGE_THREADS, 0, st>>>(
      (const u64*)part, (int64_t)nq, k, n_splits, (u64*)scratch, (float*)out_d2, (int*)out_id);
  return (int)cudaGetLastError();
}
