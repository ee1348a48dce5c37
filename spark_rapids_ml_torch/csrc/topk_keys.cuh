// The selection half of the top-k kernels, shared by the f32 scan (topk.cu)
// and the narrow forms' scan (topk_narrow.cu): the 64-bit keys a candidate is
// ranked by, the merge path's co-rank, a warp's bitonic sort of a candidate
// buffer, the k-th d2 a scan filters by, and the kernel that merges the
// per-range pools of one query.
//
// A key is the f32 bits of d2 (non-negative, so monotone as unsigned) high and
// the item id low, the key the plain version selects by (ops/selection.py).
// Keys are unique and order as (d2, id), so ties go to the lower id whatever
// order candidates arrive in.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define TOPK_K_MAX 256
#define TOPK_INVALID_D2 1.7014117331926443e38f  // f32max / 2, exactly
#define MERGE_THREADS 256
#define KEY_EMPTY 0xffffffffffffffffull

typedef unsigned long long u64;

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

// The k-th d2 a scan compares candidates with: a NaN k-th d2 (a NaN query's
// pool) or an unfilled pool filters nothing, and keys decide.
__device__ __forceinline__ float kth_d2(u64 kth) {
  return kth == KEY_EMPTY || isnan(key_d2(kth)) ? INFINITY : key_d2(kth);
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
