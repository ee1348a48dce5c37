// The nearest-center tile shared by lloyd.cu and assign.cu: for every row x
// of X, argmin over the centers c of a criterion built on the cross term x.c,
// the first index winning a tie, and (Lloyd) the update of the centers' sums
// from the rows so assigned.
//
// Replaces the tile under spark_rapids_ml_tpu/ops/pallas_kmeans.py::_lloyd_kernel
// / _lloyd_kernel_masked and pallas_select.py::_assign_kernel.
//
// What bounds it on the H100 (n = 8,388,608, d = 256): X is read once, 4 n d
// bytes, 2.56 ms at 3.35 TB/s. The cross terms take 2 n k d operations: at
// k = 20 (the Lloyd step and KMeans's assignments) 1.3 ms of f32 FMA on the
// CUDA cores and 0.52 ms in 3xTF32 on the tensor cores; at k = 81 (the
// k-means|| weighting's candidates) 5.19 ms of f32 FMA, so the CUDA cores
// cannot reach the bytes there, and 2.11 ms in 3xTF32, which can. The split
// forms' bf16 part products take 0.09 ms (n_split 1) and 0.27 ms (n_split 2)
// at k = 20. So every form is bound by bytes on the tensor cores, and the
// design keeps the card reading X while the products, the argmin and the
// update run:
//   * X is read from device memory once per launch. Persistent blocks (one an
//     SM) each own a contiguous range of rows and stream it in tiles of R rows
//     (16 a warp row; the warps that share a warp row split its depth)
//     through a ring of S >= 2 stages of 16-byte cp.async copies
//     (tf32x3.cuh), so the next stages are in flight while this one
//     computes. A stage holds the tile's whole rows (DC = d padded to 16:
//     d <= 512 at the plan's R, R = 64 at d = 256 for Lloyd) or DC = 128, 64
//     or 32 columns of them (an assignment's 128-row tiles, and past the
//     whole rows' reach). Rows at or past the range's end (n_valid / n) and
//     columns past d come in as zeros, by the copy's zero fill, never by a
//     multiply. |x|^2 is taken in f32 from the values the fragments are built
//     from.
//   * The centers stay resident: padded to the mma's n8 in chunks of CK = 24
//     or 88 centers (k = 20 takes 24, k = 81 88), split into the parts the
//     form needs (TF32 hi and lo for f32; bf16 hi, and lo at n_split 2) once
//     a block, and kept in shared memory in fragment order, one 16- or 8-byte
//     load a lane a fragment. Where they do not fit beside the smallest ring,
//     each (center chunk, column chunk) is read and split anew for every
//     tile; with whole rows the tile stays in its stage for every chunk.
//   * The cross terms run on the tensor cores: mma.sync m16n8k8 in 3xTF32 for
//     f32 (tf32x3.cuh); m16n8k16 bf16, one pass on the bf16-rounded parts at
//     n_split 1, three at n_split 2 (lo.hi, hi.lo, hi.hi, smallest first, as
//     bf16split.cuh defines them; each product of parts is exact in f32). The
//     tensor cores' accumulation truncates, so each warp chains at most
//     NT_CHAIN k-steps on a fresh fragment and adds it to f32 sums. A warp
//     holds the chunk's CK / 8 fragments (a template parameter: every loop
//     over them unrolls with no branch, and ptxas keeps the mma back to
//     back), issues their mma pass by pass, so that consecutive mma are
//     independent, and reads the next k-step's values while this one's
//     multiply. The warps sharing a warp row add their partial sums in a
//     fixed tree through shared memory. 24-center chunks run 16 warps, 88
//     8 (their fragments take twice the registers): the tile's loops wait on
//     shared-memory and mma latency, which more warps hide.
//   * The argmin is taken on the fragments: each thread holds two centers of
//     two rows a fragment; it visits its centers in ascending order, the
//     quad's four lanes reduce by shuffles (the lower index wins a tie) and
//     the chunks merge in ascending order (a later chunk wins only when
//     strictly smaller). FULL = true: max(|x|^2 - 2 x.c + |c|^2, 0) (assign);
//     false: |c|^2 - 2 x.c (Lloyd; |x|^2 cancels). A row whose criterion is NaN
//     everywhere goes to center 0.
//   * Lloyd: the update reads the tile from its stage (from device memory only
//     where the stage holds part of the rows), split(w).split(x) at the form's
//     split, and adds each center's rows in row order. On the main path (one
//     chunk of 24 centers, whole rows of at most 256 columns) warp w keeps 8
//     columns a lane of the sums of centers w and w + 16 in registers for the
//     whole launch and finds each center's rows by two ballots over the
//     tile's labels; its counts likewise. Elsewhere the tile's live rows are
//     sorted by center (a stable counting sort) and thread j adds each
//     center's run to columns j, j + THREADS, ... of a partial in shared
//     memory where k d fits, else in its slice of device memory. One warp
//     adds the inertia terms in a fixed shuffle tree. A second kernel adds
//     the blocks' partials in block order: no float atomics, the same bits on
//     every run.
// The launch plan (R, S, DC, resident, CK, where the sums are kept, the rows
// of a block, the shared memory) is chosen by the wrappers
// (ops/select.py::nearest_plan), and nt_plan_check holds it to nt_layout here.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

// A chunk holds CK = 8 NF centers, NF (the n8 fragments a warp holds, a
// template parameter, so that every loop over them unrolls without a branch)
// 3 or 11: k = 20 pads to 24, k = 81 to 88.
#define NT_CK_SMALL 24
#define NT_CK_LARGE 88

// Threads of a block: 16 warps with 24-center chunks, 8 with 88 (whose
// fragments take twice the registers). The tile's loops wait mostly on
// shared-memory latency, which more warps hide.
__host__ __device__ constexpr int nt_threads(int ck) { return ck == NT_CK_SMALL ? 512 : 256; }
#define NT_CHAIN 4                   // k-steps chained on a fresh fragment
#define NT_MAX_STAGES 4
#define NT_MAX_SMEM (227 * 1024)

// A form's operands: the mma's depth, a lane's 32-bit words of center parts
// for one fragment and k-step, and the staged rows' pad (floats; with it the
// fragment loads are free of bank conflicts).
__host__ __device__ constexpr int nt_kstep(int nsplit) { return nsplit == 3 ? 8 : 16; }
__host__ __device__ constexpr int nt_part_words(int nsplit) { return nsplit == 1 ? 2 : 4; }
__host__ __device__ constexpr int nt_xpad(int nsplit) { return nsplit == 3 ? 4 : 8; }

struct NtPlan {
  int R;              // rows of a tile: 16 to 256, 16 a warp
  int S;              // ring stages, 2..NT_MAX_STAGES
  int DC;             // columns a stage holds (d padded to 16 when rows are whole)
  int resident;       // the centers' parts stay in shared memory for the block
  int CK;             // centers a chunk: NT_CK_SMALL or NT_CK_LARGE
  int sums_smem;      // Lloyd: the block's sums and counts in shared memory
  long long rows_per_block;
};

// Byte offsets of the dynamic shared memory: the centers' parts, the ring, the
// warps' partial cross terms and norms, the per-row arrays (|x|^2, the
// chunk's and the running best, the weights and their parts, the tile's live
// rows in order of center), the sums.
struct NtLayout {
  size_t parts, ring, comb, combn, rows, sums, total;
};

__host__ __device__ inline NtLayout nt_layout(int nsplit, const NtPlan& p, int k, int d,
                                              bool lloyd) {
  const int n_dc = (d + p.DC - 1) / p.DC;
  const long long k_pad = (k + 7) / 8 * 8, n_cc = (k_pad + p.CK - 1) / p.CK;
  const long long frags = (p.resident ? n_cc : 1) * p.CK / 8;
  const long long ksteps = (long long)(p.resident ? n_dc * p.DC : p.DC) / nt_kstep(nsplit);
  NtLayout L;
  L.parts = 0;
  L.ring = (size_t)(frags * ksteps * 32 * nt_part_words(nsplit) * 4);
  L.comb = L.ring + (size_t)p.S * p.R * (p.DC + nt_xpad(nsplit)) * 4;
  const int WM = p.R / 16, WS = nt_threads(p.CK) / 32 / WM;  // warp rows; warps sharing one
  const size_t slots = WS > 1 ? (size_t)(WS / 2) * WM : 0;   // the tree's partial sums
  L.combn = L.comb + slots * (p.CK / 8) * 32 * 16;
  L.rows = L.combn + slots * 32 * 8;
  L.sums = L.rows + (size_t)12 * p.R * 4;
  const size_t sums = (lloyd && p.sums_smem) ? ((size_t)((long long)k * d + k) * 4 + 15) / 16 * 16 : 0;
  L.total = L.sums + sums;
  return L;
}

// The plan is one the kernel takes, and its shared memory the wrapper's figure.
inline bool nt_plan_check(int nsplit, const NtPlan& p, int k, int d, bool lloyd,
                          long long smem) {
  if (k < 1 || d < 1) return false;
  if (p.R != 16 && p.R != 32 && p.R != 64 && p.R != 128 && p.R != 256) return false;
  if (p.R > nt_threads(p.CK) / 2) return false;  // a warp row of 16 rows a warp
  if (p.S < 2 || p.S > NT_MAX_STAGES) return false;
  if (p.DC < 16 || p.DC % 16 != 0) return false;
  const int n_dc = (d + p.DC - 1) / p.DC;
  if (n_dc > 1 && p.DC % 32 != 0) return false;
  if (n_dc == 1 && p.DC != (d + 15) / 16 * 16) return false;
  if (p.CK != NT_CK_SMALL && p.CK != NT_CK_LARGE) return false;
  if (p.rows_per_block < p.R || p.rows_per_block % p.R != 0) return false;
  if ((long long)k * d >= (1LL << 31)) return false;
  const NtLayout L = nt_layout(nsplit, p, k, d, lloyd);
  return (long long)L.total == smem && L.total <= (size_t)NT_MAX_SMEM;
}

struct NtArgs {
  const float* X;   // (n_rows', d): rows at or past n_rows are never read
  const float* w;   // Lloyd weights (n_rows,), or null: unit weights
  int64_t n_rows;
  int d;
  const float* C;   // (k, d)
  const float* c2;  // (k,) |c|^2
  int k;
  int* labels;      // assign: (n_rows,)
  float* part;      // Lloyd: per block (k d + k + 1) floats
  NtPlan plan;
  int vec16;        // rows are whole 16 bytes: 16-byte copies
};

// Two bf16 values (f32 with their low 16 bits zero) in one register, the
// lower column in the low half.
__device__ __forceinline__ uint32_t nt_pack(float lo_col, float hi_col) {
  return (__float_as_uint(hi_col) & 0xffff0000u) | (__float_as_uint(lo_col) >> 16);
}

// c += a.b for one m16n8k16 bf16 fragment (fragment layout: topk.cu's mma_bf16).
__device__ __forceinline__ void nt_mma_bf16(float c[4], const uint32_t a[4], const uint32_t b0,
                                            const uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The centers' parts in fragment order: for fragments f < nfr (centers c0 +
// 8 f + g) and k-steps ks < nks (columns col0 + ks KSTEP ...), lane l's words
// at ((f nks + ks) 32 + l) * PW: f32 {b0 hi, b1 hi, b0 lo, b1 lo} (TF32
// parts); n_split 2 the same of bf16 pairs; n_split 1 {b0 hi, b1 hi}.
// Centers at or past k and columns past d are zeros.
template <int NSPLIT>
__device__ void nt_fill_parts(uint32_t* __restrict__ parts, const float* __restrict__ C, int k,
                              int d, int c0, int nfr, int col0, int nks) {
  constexpr int PW = nt_part_words(NSPLIT);
  const int total = nfr * nks * 32;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int ln = e & 31, fk = e >> 5, ks = fk % nks, f = fk / nks;
    const int c = c0 + f * 8 + (ln >> 2), tt = ln & 3;
    const float* crow = C + (int64_t)(c < k ? c : 0) * d;
    auto cv = [&](int col) { return c < k && col < d ? __ldg(crow + col) : 0.f; };
    uint32_t* dst = parts + (size_t)e * PW;
    if constexpr (NSPLIT == 3) {
      const int col = col0 + ks * 8 + tt;
      uint32_t h0, l0, h1, l1;
      tf32_split(cv(col), h0, l0);
      tf32_split(cv(col + 4), h1, l1);
      *reinterpret_cast<uint4*>(dst) = make_uint4(h0, h1, l0, l1);
    } else {
      const int col = col0 + ks * 16 + 2 * tt;
      float h[4], l[4];
      bf16_parts<NSPLIT>(cv(col), h[0], l[0]);
      bf16_parts<NSPLIT>(cv(col + 1), h[1], l[1]);
      bf16_parts<NSPLIT>(cv(col + 8), h[2], l[2]);
      bf16_parts<NSPLIT>(cv(col + 9), h[3], l[3]);
      if constexpr (NSPLIT == 2) {
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(nt_pack(h[0], h[1]), nt_pack(h[2], h[3]), nt_pack(l[0], l[1]),
                       nt_pack(l[2], l[3]));
      } else {
        *reinterpret_cast<uint2*>(dst) = make_uint2(nt_pack(h[0], h[1]), nt_pack(h[2], h[3]));
      }
    }
  }
}

// One warp's A fragment at column kk of the staged rows a (16 rows, stride
// xs): its raw values (f32: a0 = row g, column t; a1 = row g + 8; a2, a3 the
// same at column t + 4; bf16 forms: pairs at columns 2t, 2t + 1 and + 8), read
// a k-step ahead of their use.
template <int NSPLIT>
struct NtRawA {
  float v[NSPLIT == 3 ? 4 : 8];
};

template <int NSPLIT>
__device__ __forceinline__ void nt_read_a(const float* __restrict__ a, int xs, int kk, int g,
                                          int t, NtRawA<NSPLIT>& ra) {
  if constexpr (NSPLIT == 3) {
    const float* r = a + g * xs + kk + t;
    ra.v[0] = r[0];
    ra.v[1] = r[8 * xs];
    ra.v[2] = r[4];
    ra.v[3] = r[8 * xs + 4];
  } else {
    const float* r = a + g * xs + kk + 2 * t;
    const int off[4] = {0, 8 * xs, 8, 8 * xs + 8};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = *reinterpret_cast<const float2*>(r + off[i]);
      ra.v[2 * i] = v.x;
      ra.v[2 * i + 1] = v.y;
    }
  }
}

// The fragment's parts at the form (hi and lo TF32 or bf16 pairs), and its
// squared values added to xn (rows g and g + 8) when `norms`.
template <int NSPLIT>
struct NtFragA {
  uint32_t hi[4], lo[4];
};

template <int NSPLIT>
__device__ __forceinline__ void nt_split_a(const NtRawA<NSPLIT>& ra, bool norms, float xn[2],
                                           NtFragA<NSPLIT>& fa) {
  if constexpr (NSPLIT == 3) {
    if (norms) {
      xn[0] = fmaf(ra.v[2], ra.v[2], fmaf(ra.v[0], ra.v[0], xn[0]));
      xn[1] = fmaf(ra.v[3], ra.v[3], fmaf(ra.v[1], ra.v[1], xn[1]));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) tf32_split(ra.v[i], fa.hi[i], fa.lo[i]);
  } else {
    if (norms) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float& s = xn[i & 1];
        s = fmaf(ra.v[2 * i + 1], ra.v[2 * i + 1], fmaf(ra.v[2 * i], ra.v[2 * i], s));
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float h0, l0, h1, l1;
      bf16_parts<NSPLIT>(ra.v[2 * i], h0, l0);
      bf16_parts<NSPLIT>(ra.v[2 * i + 1], h1, l1);
      fa.hi[i] = nt_pack(h0, h1);
      fa.lo[i] = nt_pack(l0, l1);
    }
  }
}

// p[j] += a.b_j for the chunk's NF fragments j (their parts' words bw[j],
// nt_fill_parts' layout), pass by pass across the fragments, so that
// consecutive mma are independent; each accumulator takes lo.hi, hi.lo, then
// hi.hi (f32 and n_split 2), or hi.hi (n_split 1).
template <int NSPLIT, int NF>
__device__ __forceinline__ void nt_mma_chunk(float (*p)[4], const NtFragA<NSPLIT>& fa,
                                             const uint32_t (*bw)[nt_part_words(NSPLIT)]) {
  if constexpr (NSPLIT == 3) {
#pragma unroll
    for (int j = 0; j < NF; ++j) mma_tf32(p[j], fa.lo, bw[j]);
#pragma unroll
    for (int j = 0; j < NF; ++j) mma_tf32(p[j], fa.hi, bw[j] + 2);
#pragma unroll
    for (int j = 0; j < NF; ++j) mma_tf32(p[j], fa.hi, bw[j]);
  } else {
    if constexpr (NSPLIT == 2) {
#pragma unroll
      for (int j = 0; j < NF; ++j) nt_mma_bf16(p[j], fa.lo, bw[j][0], bw[j][1]);
#pragma unroll
      for (int j = 0; j < NF; ++j) nt_mma_bf16(p[j], fa.hi, bw[j][2], bw[j][3]);
    }
#pragma unroll
    for (int j = 0; j < NF; ++j) nt_mma_bf16(p[j], fa.hi, bw[j][0], bw[j][1]);
  }
}

__device__ __forceinline__ void nt_wait(int stages) {
  if (stages >= 4) {
    cp_async_wait<2>();
  } else if (stages == 3) {
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
}

// LLOYD = false: labels[i] = argmin_c max(|x_i|^2 - 2 x_i.c + |c|^2, 0).
// LLOYD = true: the block's partial (sums (k, d), counts (k,), inertia) of a
// Lloyd step over its rows, the rows below n_rows weighing w (1 without w).
template <int NSPLIT, bool LLOYD, int NF>
__global__ void __launch_bounds__(nt_threads(8 * NF), 1) nearest_kernel(const NtArgs a) {
  constexpr int THREADS = nt_threads(8 * NF), WARPS = THREADS / 32;
  extern __shared__ __align__(16) unsigned char nt_smem[];
  const NtPlan p = a.plan;
  const int d = a.d, k = a.k, R = p.R, S = p.S, DC = p.DC, CK = p.CK;
  constexpr int KSTEP = nt_kstep(NSPLIT), PW = nt_part_words(NSPLIT);
  const int XS = DC + nt_xpad(NSPLIT);
  const int n_dc = (d + DC - 1) / DC, d_pad = n_dc * DC;
  const int k_pad = (k + 7) / 8 * 8, n_cc = (k_pad + CK - 1) / CK;
  const NtLayout L = nt_layout(NSPLIT, p, k, d, LLOYD);
  uint32_t* parts = reinterpret_cast<uint32_t*>(nt_smem + L.parts);
  float* ring = reinterpret_cast<float*>(nt_smem + L.ring);
  float4* comb = reinterpret_cast<float4*>(nt_smem + L.comb);
  float2* combn = reinterpret_cast<float2*>(nt_smem + L.combn);
  float* x2s = reinterpret_cast<float*>(nt_smem + L.rows);
  float* cand_v = x2s + R;
  int* cand_i = reinterpret_cast<int*>(cand_v + R);
  float* best_v = reinterpret_cast<float*>(cand_i + R);
  int* best_i = reinterpret_cast<int*>(best_v + R);
  float* w_raw = reinterpret_cast<float*>(best_i + R);
  float* w_hi = w_raw + R;
  float* w_lo = w_hi + R;
  int4* srt4 = reinterpret_cast<int4*>(w_lo + R);  // R: the sorted live rows

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int WM = R / 16, WS = WARPS / WM;  // warp rows; warps sharing one
  const int wm = warp / WS, ws = warp % WS;
  const int64_t r_begin = (int64_t)blockIdx.x * p.rows_per_block;
  const int64_t r_end = min(r_begin + (int64_t)p.rows_per_block, a.n_rows);
  const int n_tiles = r_end > r_begin ? (int)((r_end - r_begin + R - 1) / R) : 0;
  const int units = n_tiles * n_cc * n_dc;  // (tile, center chunk, column chunk)

  const int64_t kd = (int64_t)k * d;
  float* my_part = LLOYD ? a.part + (int64_t)blockIdx.x * (kd + k + 1) : nullptr;
  float* sums = LLOYD ? (p.sums_smem ? reinterpret_cast<float*>(nt_smem + L.sums) : my_part)
                      : nullptr;
  if constexpr (LLOYD) {
    for (int64_t e = tid; e < kd + k; e += THREADS) sums[e] = 0.f;
  }
  float inertia = 0.f;  // the last warp's
  // Lloyd with one chunk of 24 centers and whole rows of at most 256 columns
  // (the main path): warp w keeps 8 columns a lane of the sums of centers w
  // and w + WARPS in registers, and their counts
  constexpr int NRQ = NF == 3 && LLOYD ? (8 * NF + WARPS - 1) / WARPS : 1;  // centers a warp
  const bool reg_path = LLOYD && NF == 3 && n_cc == 1 && n_dc == 1 && d <= 256 && R <= 64;
  float sreg[8 * NRQ], creg[NRQ];
#pragma unroll
  for (int c = 0; c < 8 * NRQ; ++c) sreg[c] = 0.f;
#pragma unroll
  for (int q = 0; q < NRQ; ++q) creg[q] = 0.f;

  if (p.resident) nt_fill_parts<NSPLIT>(parts, a.C, k, d, 0, n_cc * NF, 0, d_pad / KSTEP);

  // the stage a unit's rows sit in: with whole rows a tile's, loaded at its
  // first center chunk and kept for the others
  auto x_index = [&](int u) { return n_dc == 1 ? u / n_cc : u; };
  auto load = [&](int u) {
    const int dc = u % n_dc, q = u / n_dc, cc = q % n_cc, tile = q / n_cc;
    if (n_dc == 1 && cc != 0) return;
    float* st = ring + (size_t)(x_index(u) % S) * R * XS;
    const int64_t row0 = r_begin + (int64_t)tile * R;
    const int c0 = dc * DC;
    // copy e of the stage: row e / per, columns W (e % per) ..; stepped
    // without a division
    const int W = a.vec16 ? 4 : 1, per = DC / W;
    const int step_r = THREADS / per, step_c = THREADS % per;
    int rr = tid / per, cw = tid % per;
    for (int e = tid; e < R * per; e += THREADS) {
      const int col = c0 + W * cw;
      const int64_t row = row0 + rr;
      const bool ok = row < r_end && col < d;
      float* dst = st + rr * XS + W * cw;
      if (W == 4) {
        cp_async16(dst, ok ? a.X + row * d + col : a.X, ok);
      } else {
        cp_async4(dst, ok ? a.X + row * d + col : a.X, ok);
      }
      rr += step_r;
      cw += step_c;
      if (cw >= per) {
        cw -= per;
        ++rr;
      }
    }
  };

  for (int s = 0; s < S - 1; ++s) {
    if (s < units) load(s);
    cp_async_commit();
  }

  float acc[NF][4], pf[NF][4], xn[2] = {0.f, 0.f}, xq[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NF; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) pf[j][e] = 0.f;

  for (int u = 0; u < units; ++u) {
    const int dc = u % n_dc, q = u / n_dc, cc = q % n_cc, tile = q / n_cc;
    nt_wait(S);
    __syncthreads();  // this unit's rows landed; every thread is done with the last unit
    if (u + S - 1 < units) load(u + S - 1);
    cp_async_commit();
    if (!p.resident) {
      nt_fill_parts<NSPLIT>(parts, a.C, k, d, cc * CK, NF, dc * DC, DC / KSTEP);
      __syncthreads();
    }
    const bool norms = cc == 0;
    if (dc == 0) {
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      if (norms) xn[0] = xn[1] = 0.f;
    }

    // this warp's k-steps of the unit: ws, ws + WS, ...
    const float* st = ring + (size_t)(x_index(u) % S) * R * XS;
    const float* arow = st + wm * 16 * XS;
    const int ksu = DC / KSTEP;
    const int f0 = p.resident ? cc * NF : 0;
    const int nks = p.resident ? d_pad / KSTEP : ksu;
    const int ks0 = p.resident ? dc * ksu : 0;
    // the chunk's center parts at a k-step
    auto load_b = [&](int kq, uint32_t (*bw)[PW]) {
      const uint32_t* bp = parts + ((size_t)(f0 * nks + ks0 + kq) * 32 + lane) * PW;
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        const uint32_t* q = bp + (size_t)j * nks * 32 * PW;
        if constexpr (PW == 4) {
          const uint4 w4 = *reinterpret_cast<const uint4*>(q);
          bw[j][0] = w4.x;
          bw[j][1] = w4.y;
          bw[j][2] = w4.z;
          bw[j][3] = w4.w;
        } else {
          const uint2 w2 = *reinterpret_cast<const uint2*>(q);
          bw[j][0] = w2.x;
          bw[j][1] = w2.y;
        }
      }
    };
    int chain = 0;
    NtRawA<NSPLIT> ra;
    if (ws < ksu) nt_read_a<NSPLIT>(arow, XS, ws * KSTEP, g, t, ra);
    for (int ks = ws; ks < ksu; ks += WS) {
      // this k-step's center parts, then its fragment's split while they
      // arrive, then the next k-step's raw values
      uint32_t bw[NF][PW];
      load_b(ks, bw);
      NtFragA<NSPLIT> fa;
      nt_split_a<NSPLIT>(ra, norms, xn, fa);
      if (ks + WS < ksu) nt_read_a<NSPLIT>(arow, XS, (ks + WS) * KSTEP, g, t, ra);
      nt_mma_chunk<NSPLIT, NF>(pf, fa, bw);
      if (++chain == NT_CHAIN) {
        chain = 0;
#pragma unroll
        for (int j = 0; j < NF; ++j) add_stage<4>(acc[j], pf[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < NF; ++j) add_stage<4>(acc[j], pf[j]);
    if (dc != n_dc - 1) continue;

    const int64_t row0 = r_begin + (int64_t)tile * R;
    const bool last = cc == n_cc - 1;
    // a row's candidate (cv, ci) of this chunk against its running best across
    // the chunks, ascending (a later chunk wins only when strictly smaller);
    // after the last chunk its label, or (Lloyd) its weight and its parts
    auto finish_row = [&](int r, float cv, int ci) {
      float bv = cc == 0 ? INFINITY : best_v[r];
      int bi = cc == 0 ? 0 : best_i[r];
      if (cv < bv) {
        bv = cv;
        bi = ci;
      }
      best_v[r] = bv;
      best_i[r] = bi;
      const int64_t row = row0 + r;
      if constexpr (!LLOYD) {
        if (last && row < r_end) a.labels[row] = bi;
      } else if (last) {
        const float wr = row < r_end ? (a.w ? a.w[row] : 1.f) : 0.f;
        float wh, wl;
        bf16_parts<NSPLIT>(wr, wh, wl);
        w_raw[r] = wr;
        w_hi[r] = wh;
        w_lo[r] = wl;
      }
    };
    // the chunk's cross terms: the warps of a warp row add theirs in a tree
    // through shared memory, and the first takes the argmin on its fragments
    for (int half = WS / 2; half >= 1; half >>= 1) {
      if (ws >= half && ws < 2 * half) {
        const int slot = (ws - half) * WM + wm;
#pragma unroll
        for (int j = 0; j < NF; ++j)
          comb[(slot * NF + j) * 32 + lane] =
              make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
        if (norms) combn[slot * 32 + lane] = make_float2(xn[0], xn[1]);
      }
      __syncthreads();
      if (ws < half) {
        const int slot = ws * WM + wm;
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          const float4 v = comb[(slot * NF + j) * 32 + lane];
          acc[j][0] += v.x;
          acc[j][1] += v.y;
          acc[j][2] += v.z;
          acc[j][3] += v.w;
        }
        if (norms) {
          const float2 v = combn[slot * 32 + lane];
          xn[0] += v.x;
          xn[1] += v.y;
        }
      }
      if (half > 1) __syncthreads();
    }
    // c0, c1: row g, centers 2t, 2t + 1; c2, c3: row g + 8; then the quad
    if (ws == 0) {
      if (norms) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float sq = xn[h];
          sq += __shfl_xor_sync(0xffffffffu, sq, 1);
          sq += __shfl_xor_sync(0xffffffffu, sq, 2);
          xq[h] = sq;
          if (t == 0) x2s[wm * 16 + g + 8 * h] = sq;
        }
      }
      float c2v[NF][2];  // |c|^2 of this thread's centers, read before any is used
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          c2v[j][e] = __ldg(a.c2 + min(cc * CK + j * 8 + 2 * t + e, k - 1));
      float lv[2] = {INFINITY, INFINITY};
      int li[2] = {0x7fffffff, 0x7fffffff};
#pragma unroll
      for (int j = 0; j < NF; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = cc * CK + j * 8 + 2 * t + (e & 1), h = e >> 1;
          const float v = LLOYD ? c2v[j][e & 1] - 2.f * acc[j][e]
                                : fmaxf(xq[h] - 2.f * acc[j][e] + c2v[j][e & 1], 0.f);
          if (c < k && v < lv[h]) {
            lv[h] = v;
            li[h] = c;
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int o = 1; o <= 2; o <<= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, lv[h], o);
          const int oi = __shfl_xor_sync(0xffffffffu, li[h], o);
          if (ov < lv[h] || (ov == lv[h] && oi < li[h])) {
            lv[h] = ov;
            li[h] = oi;
          }
        }
        if (t == 0) {
          cand_v[wm * 16 + g + 8 * h] = lv[h];
          cand_i[wm * 16 + g + 8 * h] = li[h];
        }
      }
    }
    __syncthreads();
    if (tid < R) finish_row(tid, cand_v[tid], cand_i[tid]);
    if constexpr (LLOYD) {
      if (!last) continue;
      __syncthreads();
      const int rows = (int)min((int64_t)R, r_end - row0);
      if constexpr (NF == 3) {
        if (reg_path) {
          // warp w owns centers w and w + WARPS, lane l columns 8 l .. 8 l + 7
          // of their sums, in registers. The rows of a center come from two
          // ballots over the tile's labels and are added in row order, each
          // read from the stage 32 bytes a lane; so are its count's weights.
          const unsigned full = 0xffffffffu;
          const bool in0 = lane < R, in1 = lane + 32 < R;
          const int lab0 = in0 && w_raw[lane] != 0.f ? best_i[lane] : -1;
          const int lab1 = in1 && w_raw[lane + 32] != 0.f ? best_i[lane + 32] : -1;
          const bool cols = 8 * lane < d;
#pragma unroll
          for (int q = 0; q < NRQ; ++q) {
            const int c = warp + q * WARPS;
            unsigned mk[2] = {__ballot_sync(full, lab0 == c), __ballot_sync(full, lab1 == c)};
            float cs = 0.f;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              while (mk[h]) {
                const int r = __ffs(mk[h]) - 1 + 32 * h;
                mk[h] &= mk[h] - 1u;
                const float wh = w_hi[r], wl = w_lo[r];
                cs += w_raw[r];
                if (cols) {
                  const float4 xa = *reinterpret_cast<const float4*>(st + r * XS + 8 * lane);
                  const float4 xb = *reinterpret_cast<const float4*>(st + r * XS + 8 * lane + 4);
                  const float xv[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
                  for (int i = 0; i < 8; ++i) {
                    float xh, xl;
                    bf16_parts<NSPLIT>(xv[i], xh, xl);
                    float& v = sreg[8 * q + i];
                    if constexpr (NSPLIT == 2) {
                      v = fmaf(wl, xh, v);
                      v = fmaf(wh, xl, v);
                    }
                    v = fmaf(wh, xh, v);
                  }
                }
              }
            }
            creg[q] += cs;
          }
        }
      }
      if (!reg_path) {
        // the tile's live rows (weight not 0; rows past the range weigh 0) in
        // order of center, rows in order within a center (a stable counting
        // sort): each live row's place is the number of live rows of a lower
        // center and of earlier live rows of its own
        if (tid < R && w_raw[tid] != 0.f) {
          const int lab = best_i[tid];
          int pos = 0;
#pragma unroll 16
          for (int r = 0; r < R; ++r) {
            const int o = best_i[r];
            pos += w_raw[r] != 0.f && (o < lab || (o == lab && r < tid));
          }
          srt4[pos] = make_int4(tid, lab, __float_as_int(w_hi[tid]), __float_as_int(w_lo[tid]));
        }
        const int m = __syncthreads_count(tid < R && w_raw[tid] != 0.f);  // live rows
        // thread j's columns: each center's run of rows added in a register,
        // in row order, its sum read and written once a tile
        for (int col = tid; col < d; col += THREADS) {
          int cur = -1;
          float v = 0.f;
          for (int i = 0; i < m; ++i) {
            const int4 sr = srt4[i];
            const int r = sr.x, c = sr.y;
            if (c != cur) {
              if (cur >= 0) sums[(int64_t)cur * d + col] = v;
              cur = c;
              v = sums[(int64_t)c * d + col];
            }
            const float xv = n_dc == 1 ? st[r * XS + col] : a.X[(row0 + r) * d + col];
            float xh, xl;
            bf16_parts<NSPLIT>(xv, xh, xl);
            const float wh = __int_as_float(sr.z);
            if constexpr (NSPLIT == 2) {
              v = fmaf(__int_as_float(sr.w), xh, v);
              v = fmaf(wh, xl, v);
            }
            v = fmaf(wh, xh, v);
          }
          if (cur >= 0) sums[(int64_t)cur * d + col] = v;
        }
        for (int c = tid; c < k; c += THREADS) {
          float s = 0.f;
          for (int r = 0; r < rows; ++r) s += best_i[r] == c ? w_raw[r] : 0.f;
          sums[kd + c] += s;
        }
      }
      if (warp == WARPS - 1) {
        float s = 0.f;
        for (int r = lane; r < rows; r += 32) {
          if (w_raw[r] != 0.f) s = fmaf(w_raw[r], fmaxf(x2s[r] + best_v[r], 0.f), s);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        inertia += s;
      }
    }
  }
  cp_async_wait<0>();
  if constexpr (LLOYD) {
    __syncthreads();
    if (reg_path) {
#pragma unroll
      for (int q = 0; q < NRQ; ++q) {
        const int c = warp + q * WARPS;
        if (c < k) {
#pragma unroll
          for (int i = 0; i < 8; ++i)
            if (8 * lane + i < d) my_part[(int64_t)c * d + 8 * lane + i] = sreg[8 * q + i];
          if (lane == 0) my_part[kd + c] = creg[q];
        }
      }
    } else if (p.sums_smem) {
      for (int64_t e = tid; e < kd + k; e += THREADS) my_part[e] = sums[e];
    }
    if (warp == WARPS - 1 && lane == 0) my_part[kd + k] = inertia;
  }
}

template <int NSPLIT, bool LLOYD, int NF>
static cudaError_t nt_launch_nf(const NtArgs& args, int n_blocks, size_t smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(nearest_kernel<NSPLIT, LLOYD, NF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  nearest_kernel<NSPLIT, LLOYD, NF><<<n_blocks, nt_threads(8 * NF), smem, s>>>(args);
  return cudaGetLastError();
}

template <int NSPLIT, bool LLOYD>
static cudaError_t nt_launch(const NtArgs& args, int n_blocks, size_t smem, cudaStream_t s) {
  return args.plan.CK == NT_CK_SMALL
             ? nt_launch_nf<NSPLIT, LLOYD, NT_CK_SMALL / 8>(args, n_blocks, smem, s)
             : nt_launch_nf<NSPLIT, LLOYD, NT_CK_LARGE / 8>(args, n_blocks, smem, s);
}
