// Level histograms of the random-forest builder:
//   srml_node_bin_hist: out[w, j, b, k] = sum_r [node_r = w] [Xb[r, j] = b] val[r, k]
//     Xb (n, d) uint8 or int32 bins, node (n,) int32, val (n, s) f32
//     -> (width, d, nbins, s) f32;
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
// (n d bytes as uint8, 4 n d as int32), the node ids (4 n) and the stats
// (4 n s), and writes the histogram: at the main path's 50M x 64 with s = 2
// that is 3.8 GB in uint8, 1.13 ms at 3.35 TB/s (13.4 GB, 4.0 ms, in int32).
// Its shared-memory work is one read-modify-write per (row, feature, stat):
// 6.4e9 at s = 2.
//
// Design (the TPU's one-hot MXU products are not carried over: on this card
// the natural form is a scatter into shared memory). The earlier design gave
// each lane a row and found the lanes whose rows share a cell
// (__match_any_sync), a serial chain of dependent shared-memory loads a group;
// it ran at 7% of its bound. This one gives each lane a feature, so no two
// lanes of a warp ever touch the same cell and nothing has to be matched:
//   * A block owns a tile of (up to 32 features x wt nodes x bt bins) and a
//     fixed range of rows. Lane f of every warp takes feature j0 + f of each
//     row the warp processes: all lanes share the row's node and stats (one
//     broadcast read each) and each reads its own bin id (the row's 32 bin
//     bytes are one shared-memory wavefront). The histogram tile lives in
//     dynamic shared memory as [cell][stat][32 lanes], so lane f always hits
//     bank f: the scatter is free of bank conflicts whatever the bins.
//   * One input gives one histogram, bit for bit, every run: every add has a
//     fixed place in a fixed order. The warps of a block split the tile's
//     nodes into P contiguous subsets and each stage's rows into R contiguous
//     shares, one a replica of the tile: warp (rho, p) adds the rows of share
//     rho whose node lies in subset p, in row order, into replica rho, which
//     no other warp writes. At the end of the block the replicas are added in
//     replica order. Deep levels have many nodes and take P subsets of one
//     replica; the root has one node and takes R replicas; the wrapper
//     (ops/histogram.py::_tiles) picks P and R so that 4 to 16 warps share
//     the tile and its replicas fit HIST_BYTES.
//   * The forest's level nodes are very uneven (at width 32 a few nodes hold
//     most rows), and the warp that owns a large node bounds its block. So
//     blocks are kept small (48 KB of replicas, 256-row stages), three an SM,
//     and three such warps run at once (chip_smoke.py's phase 4 times every
//     level of a tree under this plan and under one block an SM). A level
//     whose bins would be cut into tiles at 48 KB (many bins or stats, as the
//     segment entry's) takes 160 KB and fewer bin tiles.
//   * A warp finds its rows of HIST_SCAN 32-row groups by one ballot a group
//     over the staged local node ids and writes them, in row order, into a
//     list of its own (row and local node packed in one word, at their rank
//     among the ballot's bits); then it walks the list HIST_BATCH rows at a
//     time: their bin ids and stats are read first, their adds made after, in
//     row order (a lane's adds may hit the same cell, so they stay in order).
//     At deep levels a warp owns a node or two of 32 and finds a row or two
//     a group: listing four groups at a time keeps its batches full.
//   * Rows whose stats are all zero are skipped (a bootstrap weight of 0, 37%
//     of the rows at subsamplingRate 1): an accumulator that starts at +0
//     never holds -0, and x + (+-0) = x, so this changes no bit.
//   * Rows come through shared memory in stages of `stage_rows`, two in the
//     block, the next one's copies in flight while this one is summed: the
//     tile's bin ids of each row (16-byte cp.async copies when rows and tiles
//     sit on 16-byte boundaries, as uint8 rows of 64 features do; else the
//     4-byte words that cover them), the node ids and the stats.
//     After a stage lands, the block writes each row's local node id, or -1
//     for a row outside the tile's nodes or with zero stats, beside it.
//   * uint8 bins (the forest's, maxBins <= 256) cut the bytes of a level 3.5x
//     against int32; the kernel is a template of the bin type, and int32
//     stays for ids above 255 (the segment entry, maxBins > 256).
//   * Blocks run in no order, so each writes its tile of its row range's
//     partial histogram to scratch and a second kernel adds the partials in
//     row-range order (as csrc/xtx.cu does): no float atomics anywhere. With
//     one row range the block writes the output itself. Blocks of the same
//     rows and neighbouring tiles are launched together, so that the rows one
//     block fetches can serve the next from L2.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"  // cp.async helpers

#define HIST_WARPS_MAX 16
#define HIST_LANES 32  // features of a tile, one a lane
#define HIST_BATCH 4   // rows a warp reads before it adds them
#define HIST_SCAN 4    // 32-row groups a warp scans at a time
#define HIST_RING 2    // row stages a block holds: the next one in flight
#define REDUCE_THREADS 256

// Copy the first nbytes (0..4) of a 4-byte word, the rest zero-filled.
__device__ __forceinline__ void cp_async4_n(void* dst, const void* src, int nbytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(nbytes)
               : "memory");
}

// Bytes of one row stage: bin ids (a slot of `slot` bytes a row), node ids
// and stats. Dynamic shared memory of a block (ops/histogram.py::_smem_bytes):
// R replicas of the (wt, bt, s, 32) tile, HIST_RING row stages, a local node
// id a row, and each warp's row list of a scan window.
__host__ __device__ inline size_t stage_bytes(int stage_rows, int slot, int s) {
  return (size_t)stage_rows * (slot + 4 + 4 * s);
}
static size_t hist_smem_bytes(int P, int R, int wt, int bt, int s, int stage_rows, int slot) {
  return sizeof(float) * (size_t)R * wt * bt * s * HIST_LANES +
         HIST_RING * stage_bytes(stage_rows, slot, s) + sizeof(int16_t) * (size_t)stage_rows +
         sizeof(int) * (size_t)P * R * HIST_SCAN * 32;
}

// S: the stats a row (1-4), or 0 when s is read at run time.
template <typename BinT, int S>
__global__ void __launch_bounds__(32 * HIST_WARPS_MAX)
hist_partial_kernel(const BinT* __restrict__ Xb, const int* __restrict__ node,
                    const float* __restrict__ val, int64_t n, int d, int s_rt, int width,
                    int nbins, int dt, int wt, int bt, int P, int R, int d_tiles, int w_tiles,
                    int b_tiles, int64_t rows_per_chunk, int stage_rows, int slot, bool vec16,
                    float* __restrict__ part) {
  constexpr int E = (int)sizeof(BinT);
  const int s = S > 0 ? S : s_rt;
  extern __shared__ __align__(16) unsigned char smem[];
  float* const hist = reinterpret_cast<float*>(smem);
  const int64_t rep = (int64_t)wt * bt * s * HIST_LANES;  // floats of one replica
  unsigned char* const stages = smem + sizeof(float) * rep * R;
  const size_t sbytes = stage_bytes(stage_rows, slot, s);
  int16_t* const loc = reinterpret_cast<int16_t*>(stages + HIST_RING * sbytes);
  // each warp's list of its rows of a scan window
  int* const list =
      reinterpret_cast<int*>(loc + stage_rows) + (threadIdx.x >> 5) * HIST_SCAN * 32;

  const int tiles = d_tiles * w_tiles * b_tiles;
  const int64_t chunk = blockIdx.x / tiles;
  int tile = blockIdx.x % tiles;
  const int td = tile % d_tiles;  // feature tile fastest: neighbours share rows
  tile /= d_tiles;
  const int tw = tile % w_tiles;
  const int tb = tile / w_tiles;
  const int j0 = td * dt, w0 = tw * wt, b0 = tb * bt;
  const int dn = min(dt, d - j0), wn = min(wt, width - w0), bn = min(bt, nbins - b0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int threads = blockDim.x;

  for (int64_t i = threadIdx.x; i < rep * R; i += threads) hist[i] = 0.f;

  const int64_t r0 = chunk * rows_per_chunk;
  const int64_t r1 = min(r0 + rows_per_chunk, n);
  const unsigned char* const xbytes = reinterpret_cast<const unsigned char*>(Xb);
  const int64_t total = n * d * E;  // bytes of Xb
  const int tbytes = dn * E;        // a row's bytes of this tile

  // stage b: bin ids [rr * slot ...], node ids [rr], stats [rr * s + k]
  auto fetch = [&](int64_t rs, int b) {
    unsigned char* const bins = stages + b * sbytes;
    int* const nodes = reinterpret_cast<int*>(bins + (size_t)stage_rows * slot);
    float* const vals = reinterpret_cast<float*>(nodes + stage_rows);
    const int rows = (int)min((int64_t)stage_rows, r1 - rs);
    if (vec16) {  // rows and the tile on 16-byte boundaries: whole 16 bytes
      const int per = (tbytes + 15) >> 4;
      for (int e = threadIdx.x; e < rows * per; e += threads) {
        const int rr = e / per, c = e - rr * per;
        cp_async16(bins + rr * slot + 16 * c, xbytes + ((rs + rr) * d + j0) * E + 16 * c, true);
      }
    } else {  // the 4-byte words that cover the row's tile bytes
      const int per = slot >> 2;
      for (int e = threadIdx.x; e < rows * per; e += threads) {
        const int rr = e / per, c = e - rr * per;
        const int64_t a = ((rs + rr) * d + j0) * E;
        const int64_t wa = (a & ~(int64_t)3) + 4 * c;
        if (wa < a + tbytes) {
          const int nb = (int)max((int64_t)0, min((int64_t)4, total - wa));
          cp_async4_n(bins + rr * slot + 4 * c, nb > 0 ? xbytes + wa : xbytes, nb);
        }
      }
    }
    if (node != nullptr) {
      for (int e = threadIdx.x; e < rows; e += threads) cp_async4(nodes + e, node + rs + e, true);
    }
    for (int e = threadIdx.x; e < rows * s; e += threads) {
      cp_async4(vals + e, val + rs * s + e, true);
    }
    cp_async_commit();
  };

  // this warp: replica rho, local nodes [lo, hi)
  const int rho = warp / P, p = warp - rho * P;
  const int lo = p * wn / P, hi = (p + 1) * wn / P;
  float* const H = hist + rep * rho + lane;
  const bool lane_on = lane < dn;

  const int n_stages = (int)((r1 - r0 + stage_rows - 1) / stage_rows);
  for (int i = 0; i < HIST_RING - 1; ++i) {
    if (i < n_stages) fetch(r0 + (int64_t)i * stage_rows, i);
    else cp_async_commit();
  }
  for (int st = 0; st < n_stages; ++st) {
    cp_async_wait<HIST_RING - 2>();  // this stage landed
    __syncthreads();  // for every thread; and every warp is done with the last stage
    if (st + HIST_RING - 1 < n_stages) {
      fetch(r0 + (int64_t)(st + HIST_RING - 1) * stage_rows, (st + HIST_RING - 1) % HIST_RING);
    } else {
      cp_async_commit();
    }
    const int64_t rs = r0 + (int64_t)st * stage_rows;
    const unsigned char* const bins = stages + (st % HIST_RING) * sbytes;
    const int* const nodes = reinterpret_cast<const int*>(bins + (size_t)stage_rows * slot);
    const float* const vals = reinterpret_cast<const float*>(nodes + stage_rows);
    const int rows = (int)min((int64_t)stage_rows, r1 - rs);
    for (int rr = threadIdx.x; rr < stage_rows; rr += threads) {
      int wl = -1;
      if (rr < rows) {
        const int w = (node != nullptr ? nodes[rr] : 0) - w0;
        if ((unsigned)w < (unsigned)wn) {
          bool any = false;  // a NaN stat is not zero: its row is added
          for (int k = 0; k < s; ++k) any |= vals[rr * s + k] != 0.f;
          wl = any ? w : -1;
        }
      }
      loc[rr] = (int16_t)wl;
    }
    __syncthreads();  // local node ids written
    const int64_t a_stage = (rs * d + j0) * E;  // byte of row rs's tile (uncovered path)
    // replica rho's groups of this stage: [ga, gb), HIST_SCAN at a time
    const int groups = (rows + 31) >> 5, per = (groups + R - 1) / R;
    const int ga = rho * per, gb = min(groups, ga + per);
    for (int gs = ga; gs < gb; gs += HIST_SCAN) {
      // this warp's rows of the next HIST_SCAN groups, in row order, packed
      // (row | local node << 16) into its list by their rank among the set
      // ballot bits
      int total = 0;
#pragma unroll
      for (int i = 0; i < HIST_SCAN; ++i) {
        const int rr = (gs + i) * 32 + lane;
        const int wl = gs + i < gb ? loc[rr] : -1;
        const bool mine = wl >= lo && wl < hi;
        const unsigned b = __ballot_sync(0xffffffffu, mine);
        if (mine) list[total + __popc(b & ((1u << lane) - 1u))] = rr | (wl << 16);
        total += __popc(b);
      }
      __syncwarp();
      for (int e0 = 0; e0 < total; e0 += HIST_BATCH) {
        int row[HIST_BATCH], cell[HIST_BATCH];
#pragma unroll
        for (int i = 0; i < HIST_BATCH; ++i) {
          const bool on = e0 + i < total;  // warp-uniform
          const int ent = on ? list[e0 + i] : 0;
          const int rr = ent & 0xffff;
          row[i] = rr;
          int c = -1;
          if (on && lane_on) {
            const int mis = vec16 ? 0 : (int)((a_stage + (int64_t)rr * d * E) & 3);
            const int bin =
                (int)*reinterpret_cast<const BinT*>(bins + rr * slot + mis + lane * E) - b0;
            if ((unsigned)bin < (unsigned)bn) c = ((ent >> 16) * bt + bin) * s;
          }
          cell[i] = c;
        }
        if constexpr (S > 0) {
          float v[HIST_BATCH][S > 0 ? S : 1];
#pragma unroll
          for (int i = 0; i < HIST_BATCH; ++i)
#pragma unroll
            for (int k = 0; k < S; ++k) v[i][k] = vals[row[i] * S + k];
#pragma unroll
          for (int i = 0; i < HIST_BATCH; ++i) {
            if (cell[i] >= 0) {
#pragma unroll
              for (int k = 0; k < S; ++k) H[(cell[i] + k) * HIST_LANES] += v[i][k];
            }
          }
        } else {
#pragma unroll
          for (int i = 0; i < HIST_BATCH; ++i) {
            if (cell[i] >= 0) {
              for (int k = 0; k < s; ++k) H[(cell[i] + k) * HIST_LANES] += vals[row[i] * s + k];
            }
          }
        }
      }
      __syncwarp();  // the list is read before the next window rewrites it
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // this tile of the chunk's partial, laid out (width, d, nbins, s): the
  // replicas added in replica order, a warp an (node, bin, stat), a lane a
  // feature
  float* const out = part + chunk * (int64_t)width * d * nbins * s;
  const int bs = bn * s;
  for (int it = warp; it < wn * bs; it += warps) {
    const int w = it / bs, rem = it - w * bs;
    const int bb = rem / s, k = rem - bb * s;
    if (lane_on) {
      const float* h = hist + ((int64_t)(w * bt + bb) * s + k) * HIST_LANES + lane;
      float acc = 0.f;
      for (int q = 0; q < R; ++q) acc += h[q * rep];
      out[(((int64_t)(w0 + w) * d + j0 + lane) * nbins + b0 + bb) * s + k] = acc;
    }
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

template <typename BinT, int S>
static cudaError_t launch_partial(unsigned blocks, int threads, size_t smem, cudaStream_t st,
                                  const BinT* Xb, const int* node, const float* val, int64_t n,
                                  int d, int s, int width, int nbins, int dt, int wt, int bt,
                                  int P, int R, int d_tiles, int w_tiles, int b_tiles,
                                  int64_t rows_per_chunk, int stage_rows, int slot, bool vec16,
                                  float* part) {
  cudaError_t err = cudaFuncSetAttribute(
      hist_partial_kernel<BinT, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  hist_partial_kernel<BinT, S><<<blocks, threads, smem, st>>>(
      Xb, node, val, n, d, s, width, nbins, dt, wt, bt, P, R, d_tiles, w_tiles, b_tiles,
      rows_per_chunk, stage_rows, slot, vec16, part);
  return cudaGetLastError();
}

template <typename BinT>
static int launch(const BinT* Xb, const int* node, const float* val, long long n, int d, int s,
                  int width, int nbins, int dt, int wt, int bt, int P, int R,
                  long long rows_per_chunk, int n_chunks, int stage_rows, int slot, int vec16,
                  int reduce_blocks, float* part, float* out, cudaStream_t stream) {
  constexpr int E = (int)sizeof(BinT);
  if (dt < 1 || dt > HIST_LANES || P < 1 || R < 1 || P * R > HIST_WARPS_MAX || P > wt ||
      stage_rows < 32 || stage_rows % 32 != 0 || slot % 16 != 0 || s < 1 || n_chunks < 1 ||
      (uintptr_t)Xb % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int d_tiles = (d + dt - 1) / dt;
  const int w_tiles = (width + wt - 1) / wt;
  const int b_tiles = (nbins + bt - 1) / bt;
  if (vec16 && ((d * E) % 16 != 0 || (d_tiles > 1 && (dt * E) % 16 != 0) ||
                slot < (dt * E + 15) / 16 * 16)) {
    return (int)cudaErrorInvalidValue;
  }
  if (!vec16 && slot < (dt * E + 3 + 3) / 4 * 4) return (int)cudaErrorInvalidValue;
  const size_t smem = hist_smem_bytes(P, R, wt, bt, s, stage_rows, slot);
  const int64_t blocks = (int64_t)n_chunks * d_tiles * w_tiles * b_tiles;
  const int threads = 32 * P * R;
  float* const dst = n_chunks > 1 ? part : out;
  cudaError_t err;
#define HIST_CASE(SV)                                                                        \
  err = launch_partial<BinT, SV>((unsigned)blocks, threads, smem, stream, Xb, node, val, n, d, \
                                 s, width, nbins, dt, wt, bt, P, R, d_tiles, w_tiles, b_tiles, \
                                 rows_per_chunk, stage_rows, slot, vec16 != 0, dst)
  switch (s) {
    case 1: HIST_CASE(1); break;
    case 2: HIST_CASE(2); break;
    case 3: HIST_CASE(3); break;
    case 4: HIST_CASE(4); break;
    default: HIST_CASE(0); break;
  }
#undef HIST_CASE
  if (err != cudaSuccess || n_chunks == 1) return (int)err;
  const int64_t size = (int64_t)width * d * nbins * s;
  hist_reduce_kernel<<<reduce_blocks, REDUCE_THREADS, 0, stream>>>(part, size, n_chunks, out);
  return (int)cudaGetLastError();
}

// Both launch on `stream`; allocate nothing, do not synchronise. The tile
// (dt features, wt nodes, bt bins), its P node subsets and R replicas, the
// row ranges and stages, and the staging copies (vec16, a row's `slot` bytes)
// are the wrapper's choice (ops/histogram.py); Xb starts on a 16-byte
// boundary. `part` holds n_chunks partial histograms (unused when n_chunks is
// 1). bin_bytes is 1 (uint8 bins) or 4 (int32). Return cudaGetLastError()
// (0 on success), or cudaErrorInvalidValue for a plan the kernel cannot take.
extern "C" int srml_node_bin_hist(const void* Xb, int bin_bytes, const void* node,
                                  const void* val, long long n, int d, int s, int width,
                                  int nbins, int dt, int wt, int bt, int P, int R,
                                  long long rows_per_chunk, int n_chunks, int stage_rows,
                                  int slot, int vec16, int reduce_blocks, void* part, void* out,
                                  void* stream) {
  if (bin_bytes == 1) {
    return launch((const uint8_t*)Xb, (const int*)node, (const float*)val, n, d, s, width,
                  nbins, dt, wt, bt, P, R, rows_per_chunk, n_chunks, stage_rows, slot, vec16,
                  reduce_blocks, (float*)part, (float*)out, (cudaStream_t)stream);
  }
  if (bin_bytes == 4) {
    return launch((const int*)Xb, (const int*)node, (const float*)val, n, d, s, width, nbins,
                  dt, wt, bt, P, R, rows_per_chunk, n_chunks, stage_rows, slot, vec16,
                  reduce_blocks, (float*)part, (float*)out, (cudaStream_t)stream);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int srml_segment_hist(const void* seg, const void* val, long long n, int d, int s,
                                 int n_segments, int dt, int bt, int R, long long rows_per_chunk,
                                 int n_chunks, int stage_rows, int slot, int vec16,
                                 int reduce_blocks, void* part, void* out, void* stream) {
  return launch((const int*)seg, nullptr, (const float*)val, n, d, s, 1, n_segments, dt, 1, bt,
                1, R, rows_per_chunk, n_chunks, stage_rows, slot, vec16, reduce_blocks,
                (float*)part, (float*)out, (cudaStream_t)stream);
}
