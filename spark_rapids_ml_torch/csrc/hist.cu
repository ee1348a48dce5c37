// Level histograms of the random-forest builder:
//   srml_node_bin_hist: out[w, j, b, k] = sum_r [node_r = w] [Xb[r, j] = b] val[r, k]
//     Xb (n, d) int32 bins, node (n,) int32, val (n, s) f32 -> (width, d, nbins, s) f32;
//   srml_segment_hist:  out[j, g, k] = sum_r [seg[r, j] = g] val[r, k]
//     seg (n, d) int32, val (n, s) f32 -> (d, n_segments, s) f32,
//     the same kernel with every node 0, width 1 and nbins = n_segments.
// A node or bin outside its range matches nothing (node -1 is how a caller
// drops a row); rows past n are never read (no padding copy); s is a runtime
// operand (2 for a binary classifier, 3 for variance, up to the class count).
//
// Replaces: spark_rapids_ml_tpu/ops/pallas_histogram.py::_nb_hist_kernel
// (reached through node_bin_histogram_pallas and node_bin_histogram) and
// ::_hist_kernel (reached through segment_histogram_pallas and
// segment_histogram(use_pallas=True)).
//
// What bounds it on the H100: memory. A level reads each bin id once
// (4 n d bytes), the node ids (4 n) and the stats (4 n s), and writes the
// histogram; at the main path's 50M x 64 with s = 2 that is 13.4 GB, 4.0 ms at
// 3.35 TB/s, against one add per (row, feature, stat), 6.4e9 operations.
//
// Design (the TPU's one-hot MXU products are not carried over: on this card
// the natural form is a scatter into shared memory):
//   * A block owns a tile of (dt features x wt nodes x bt bins) and a fixed
//     range of rows. Its histogram tile lives in dynamic shared memory, each
//     feature's (wt, bt, s) region padded by one float so neighbouring features
//     fall in other banks. The wrapper picks the tile so it fits the budget
//     (SMEM_BYTES in ops/histogram.py): the whole level at the main shape,
//     node and bin tiles at wide levels or many bins.
//   * One input gives one histogram, bit for bit, every run: every add has a
//     fixed place in a fixed order. Warp w owns features w, w + warps, ...:
//     no other warp writes their cells. For each 32 rows, lane l takes row l
//     of the feature; the lanes whose rows share a (node, bin) cell find each
//     other (__match_any_sync), the lowest of them sums their stats in lane
//     order, that is row order, and makes the one add to the cell. A warp
//     takes two groups of 32 rows at a time, their matches and sums side by
//     side (each waits on shared-memory latency), their adds one group after
//     the other. A row whose node or bin lies outside the tile adds nothing.
//   * Rows come through shared memory in stages of `stage_rows` (the
//     wrapper's choice, ops/histogram.py::_stage_rows): the tile's bin ids
//     (a row's features side by side, an odd row stride so a warp's 32 rows
//     of one feature fall in 32 banks), the node ids and the stats, copied by
//     cp.async into two buffers, so the next stage's copies are in flight
//     while this one is summed. A deep level's tile holds few features (7 at
//     32 nodes x 32 bins x 2 stats), so each warp has little work a stage:
//     without the overlap every stage waited for device memory.
//   * The block has one warp a feature of its tile, up to 16, so a deep
//     level's blocks stay small and three share an SM. Blocks of the same
//     rows and neighbouring feature tiles are launched together, so that the
//     32-byte sectors of a row that one block fetches can serve the next from
//     L2.
//   * Blocks run in no order, so each writes its tile of its row range's
//     partial histogram to scratch and a second kernel adds the partials in
//     row-range order (as csrc/xtx.cu does): no float atomics anywhere.
//   * With one row range the partial kernel writes the output itself.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"  // cp.async helpers

#define HIST_WARPS_MAX 16
#define REDUCE_THREADS 256

// Dynamic shared memory of a block (ops/histogram.py::_smem_bytes): the
// histogram tile, and two stages of stage_rows rows, each row its bin ids at
// an odd stride, its node id and its s stats.
static size_t hist_smem_bytes(int dt, int wt, int bt, int s, int stage_rows) {
  return sizeof(float) * ((size_t)dt * ((size_t)wt * bt * s + 1) +
                          2 * (size_t)stage_rows * ((dt | 1) + 1 + s));
}

__global__ void __launch_bounds__(32 * HIST_WARPS_MAX)
hist_partial_kernel(const int* __restrict__ Xb, const int* __restrict__ node,
                    const float* __restrict__ val, int64_t n, int d, int s, int width,
                    int nbins, int dt, int wt, int bt, int d_tiles, int w_tiles,
                    int b_tiles, int64_t rows_per_chunk, int stage_rows,
                    float* __restrict__ part) {
  extern __shared__ __align__(16) float sh[];
  const int tiles = d_tiles * w_tiles * b_tiles;
  const int64_t chunk = blockIdx.x / tiles;
  int tile = blockIdx.x % tiles;
  const int td = tile % d_tiles;  // feature tile fastest: neighbours share rows
  tile /= d_tiles;
  const int tb = tile % b_tiles;
  const int tw = tile / b_tiles;
  const int j0 = td * dt, w0 = tw * wt, b0 = tb * bt;
  const int dn = min(dt, d - j0), wn = min(wt, width - w0), bn = min(bt, nbins - b0);
  const int fs = wn * bn * s + 1;  // one feature's region, padded
  const int cells = dn * fs;
  const int sp = dt | 1;  // a staged row's bin ids
  const int stage_words = stage_rows * (sp + 1 + s);
  int* const stages = reinterpret_cast<int*>(sh + dt * (wt * bt * s + 1));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;

  for (int i = threadIdx.x; i < cells; i += blockDim.x) sh[i] = 0.f;

  const int64_t r0 = chunk * rows_per_chunk;
  const int64_t r1 = min(r0 + rows_per_chunk, n);
  // stage b: bin ids [rr * sp + jj], then node ids [rr], then stats [rr * s + k]
  auto fetch = [&](int64_t rs, int b) {
    int* const bins = stages + b * stage_words;
    int* const nodes = bins + stage_rows * sp;
    float* const vals = reinterpret_cast<float*>(nodes + stage_rows);
    const int rows = (int)min((int64_t)stage_rows, r1 - rs);
    for (int e = threadIdx.x; e < rows * dn; e += blockDim.x) {
      const int rr = e / dn, jj = e % dn;
      cp_async4(bins + rr * sp + jj, Xb + (rs + rr) * d + j0 + jj, true);
    }
    if (node != nullptr) {
      for (int e = threadIdx.x; e < rows; e += blockDim.x) cp_async4(nodes + e, node + rs + e, true);
    }
    for (int e = threadIdx.x; e < rows * s; e += blockDim.x) cp_async4(vals + e, val + rs * s + e, true);
    cp_async_commit();
  };

  if (r0 < r1) fetch(r0, 0);
  int b = 0;
  for (int64_t rs = r0; rs < r1; rs += stage_rows, b ^= 1) {
    if (rs + stage_rows < r1) {
      fetch(rs + stage_rows, b ^ 1);  // the next stage, in flight while this one is summed
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this stage landed for every thread (and the tile is zeroed)
    const int* const bins = stages + b * stage_words;
    const int* const nodes = bins + stage_rows * sp;
    const float* const vals = reinterpret_cast<const float*>(nodes + stage_rows);
    const int rows = (int)min((int64_t)stage_rows, r1 - rs);
    // two groups of 32 rows at a time (a, then b): their matches and sums are
    // independent, and their adds keep the order a group at a time would
    for (int rg = 0; rg < rows; rg += 64) {
      const int ra = rg + lane, rb = rg + 32 + lane;
      const int wa = ra < rows ? (node != nullptr ? nodes[ra] : 0) - w0 : -1;
      const int wb = rb < rows ? (node != nullptr ? nodes[rb] : 0) - w0 : -1;
      const bool ina = (unsigned)wa < (unsigned)wn, inb = (unsigned)wb < (unsigned)wn;
      const float* const va = vals + rg * s;  // the groups' stats
      const float* const vb = va + 32 * s;
      for (int jj = warp; jj < dn; jj += warps) {
        const int bina = ina ? bins[ra * sp + jj] - b0 : -1;
        const int binb = inb ? bins[rb * sp + jj] - b0 : -1;
        const int ca = ina && (unsigned)bina < (unsigned)bn ? wa * bn + bina : -1;
        const int cb = inb && (unsigned)binb < (unsigned)bn ? wb * bn + binb : -1;
        const unsigned pa = __match_any_sync(0xffffffffu, ca);
        const unsigned pb = __match_any_sync(0xffffffffu, cb);
        const unsigned below = (1u << lane) - 1u;
        const bool la = ca >= 0 && (pa & below) == 0u;  // the lowest lane of its cell
        const bool lb = cb >= 0 && (pb & below) == 0u;
        float* const h = sh + jj * fs;
        for (int k = 0; k < s; ++k) {
          float sa = 0.f, sb = 0.f;
          if (la) {
            for (unsigned m = pa; m != 0u; m &= m - 1u) sa += va[(__ffs(m) - 1) * s + k];
          }
          if (lb) {
            for (unsigned m = pb; m != 0u; m &= m - 1u) sb += vb[(__ffs(m) - 1) * s + k];
          }
          if (la) h[ca * s + k] += sa;
          __syncwarp();  // group a's add to a cell lands before group b's
          if (lb) h[cb * s + k] += sb;
        }
        __syncwarp();
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  __syncthreads();

  // this tile of the chunk's partial, laid out (width, d, nbins, s)
  float* out = part + chunk * (int64_t)width * d * nbins * s;
  const int per_w = bn * s;
  for (int i = threadIdx.x; i < dn * wn * per_w; i += blockDim.x) {
    const int jjw = i / per_w, rest = i % per_w;
    const int f = jjw / wn, w = jjw % wn;
    const int64_t o = (((int64_t)(w0 + w) * d + (j0 + f)) * nbins + b0) * s + rest;
    out[o] = sh[f * fs + w * per_w + rest];
  }
}

// out[i] = sum over chunks c, in order, of part[c][i]
__global__ void __launch_bounds__(REDUCE_THREADS)
hist_reduce_kernel(const float* __restrict__ part, int64_t size, int n_chunks,
                   float* __restrict__ out) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < size;
       i += (int64_t)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int c = 0; c < n_chunks; ++c) acc += part[(int64_t)c * size + i];
    out[i] = acc;
  }
}

static int launch(const int* Xb, const int* node, const float* val, long long n, int d,
                  int s, int width, int nbins, int dt, int wt, int bt,
                  long long rows_per_chunk, int n_chunks, int stage_rows, int reduce_blocks,
                  float* part, float* out, cudaStream_t stream) {
  const int d_tiles = (d + dt - 1) / dt;
  const int w_tiles = (width + wt - 1) / wt;
  const int b_tiles = (nbins + bt - 1) / bt;
  if (stage_rows < 32 || stage_rows % 32 != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = hist_smem_bytes(dt, wt, bt, s, stage_rows);
  cudaError_t err = cudaFuncSetAttribute(
      hist_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (int64_t)n_chunks * d_tiles * w_tiles * b_tiles;
  const int threads = 32 * (dt < HIST_WARPS_MAX ? dt : HIST_WARPS_MAX);
  hist_partial_kernel<<<(unsigned)blocks, threads, smem, stream>>>(
      Xb, node, val, (int64_t)n, d, s, width, nbins, dt, wt, bt, d_tiles, w_tiles,
      b_tiles, (int64_t)rows_per_chunk, stage_rows, n_chunks > 1 ? part : out);
  if (n_chunks > 1) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int64_t size = (int64_t)width * d * nbins * s;
    hist_reduce_kernel<<<reduce_blocks, REDUCE_THREADS, 0, stream>>>(part, size, n_chunks,
                                                                    out);
  }
  return (int)cudaGetLastError();
}

// Both launch on `stream`; allocate nothing, do not synchronise. `part` holds
// n_chunks partial histograms (unused when n_chunks is 1); stage_rows is a
// positive multiple of 32. Return
// cudaGetLastError() (0 on success).
extern "C" int srml_node_bin_hist(const void* Xb, const void* node, const void* val,
                                  long long n, int d, int s, int width, int nbins, int dt,
                                  int wt, int bt, long long rows_per_chunk, int n_chunks,
                                  int stage_rows, int reduce_blocks, void* part, void* out,
                                  void* stream) {
  return launch((const int*)Xb, (const int*)node, (const float*)val, n, d, s, width, nbins,
                dt, wt, bt, rows_per_chunk, n_chunks, stage_rows, reduce_blocks, (float*)part,
                (float*)out, (cudaStream_t)stream);
}

extern "C" int srml_segment_hist(const void* seg, const void* val, long long n, int d, int s,
                                 int n_segments, int dt, int bt, long long rows_per_chunk,
                                 int n_chunks, int stage_rows, int reduce_blocks, void* part,
                                 void* out, void* stream) {
  return launch((const int*)seg, nullptr, (const float*)val, n, d, s, 1, n_segments, dt, 1,
                bt, rows_per_chunk, n_chunks, stage_rows, reduce_blocks, (float*)part,
                (float*)out, (cudaStream_t)stream);
}
