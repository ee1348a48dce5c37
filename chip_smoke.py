#!/usr/bin/env python3
"""Smoke test of the PyTorch port (spark_rapids_ml_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each fatal on failure (an exception ends the run with a traceback and a
non-zero exit code; nothing is caught):

1. Setup: the card's name and power limit, the torch and CUDA versions, and the
   build of every CUDA kernel (csrc/*.cu) with nvcc, one compile per source,
   all started together.
2. Kernel against plain: each kernel (xtx, xtxy, lloyd unit-weight and
   weighted, assign, count, topk, node_bin_hist, segment_hist) on the card at
   small ragged shapes and at the main paths' shapes, held against its plain PyTorch version on the same inputs
   (and xtx/xtxy against f64 sums, count against f64 distances, with the pairs
   whose f32 distance may fall on either side of eps² counted and allowed, topk
   against f64 distances within TOPK_RTOL, exactly on duplicate rows and on the
   sentinel tail of masked items, the histograms bit for bit on integer stats
   and within HIST_RTOL of each bin's sum |val| on normal ones). The small
   shapes include the Gram kernel's edges (d 1, 7, 129, 257; n_valid 0, 1 and
   off every row step, chunk and tile edge; X with no rows at all, for which
   xtx, xtxy, the Lloyd forms and assign launch nothing) and the top-k selection's hard
   cases (TOPK_HARD: items in descending distance order, all-duplicate items,
   k 1 / 200 / K_MAX, nq around the 64-query tile, n off the 128-item tile and
   n < k, d off the mma depth of 8, masked tails). The top-k kernel's bfloat16
   and int8 forms (csrc/topk_narrow.cu) are held to their plain versions at
   the same shapes, at the narrow scan's edges (NARROW_EDGE_D x
   NARROW_EDGE_SHAPES: every launch plan, resident and streamed queries, one
   and two consumer warpgroups, whole tiles in the ring or not) and TOPK_HARD (TOPK_INT8_RTOL,
   topk_narrow_rtol), and at both kNN traffics of the main shape, with the
   re-rank invariant (the returned neighbours are parity_rerank_sq of their
   ids, bit for bit). Non-finite inputs: count and
   the three top-k forms with NaN query and item rows against their plain
   versions, assign and Lloyd with NaN rows (center 0). The IVF probe kernel
   (csrc/probe.cu, phase_small_probe) at PROBE_SMALL (nq and nlist around its
   128-row tiles, d off its 32-column stage; nprobe 1, 256, 257, nlist and
   the JAX default nlist // 8; the row of keys in shared and in device
   memory, the sort buffer in device memory), a crowded row (290 copies of
   one center), its query blocks under a small scratch budget (the same bits
   as one launch, one count a call), and NaN query rows (the plain version's
   ids, NaN d2) against its plain version and f64 (check_probe). The histogram kernels
   on real-valued stats: three launches bit-equal. The redesigned kernels at
   their tile edges: the node x bin kernel on the forest's uint8 bins (d 1,
   15, 17, 33, 64; widths 1-64; nbins 2-256, and 257 in int32; n off the
   1,024-row stage and the 32-row group; zero-stat and -0 rows, node -1;
   s 2, 3, 5), the tensor-core count (nq off the 128-query tile, n off the
   128-item tile, d 1, 7, 31, 33, 257, self pairs, eps2 = 0, every item
   invalid), and the Lloyd and assignment kernels' nearest-center tile
   (csrc/nearest.cuh) in all six Lloyd forms and both assign forms: k 1, 8,
   9, 20, 24, 25, 81, 257 (one n8 fragment and past it, the 24- and
   88-center chunks and past them, centers not resident), d 3, 7, 130, 256,
   513 (whole rows at R 128 to 16, column chunks), n_valid off the plan's R
   and stage, n 1, 63 and 65 with n_valid 0 and n - 1.
   The bf16-split forms (n_split 1: KMeans under fast_math; n_split 2:
   parity_precision="high"): the Lloyd kernel's unit-weight and weighted forms
   at 1 and 2, assign and the Gram kernels (xtx, xtxy) at 2, at the small
   shapes and at the main shape, each against its plain version (the Lloyd and
   assign labels within the near ties of the form's own criterion, the Gram
   kernels against the form's exact value as the f32 forms against f64), and
   on discriminating data: flip_data, on which the split forms put every row in
   another center than f32 does (kernel counts and labels equal to plain), and
   split_data, on which the two-part split falls short of every f32 product by
   3·2^-18 of it (kernel within SPLIT_RTOL_* of the form's exact value, more
   than 10 times that from f32).
   Phase 2b also holds assign to its plain version at the k-means||
   candidates' count, k = 81 (81 rows of X), in the f32 and n_split 2 forms.
2c. The streamed accumulators (ops/streaming.py) on the card at n = 5,003,
   d = 37, for stream_batch_rows 48 (less than a kernel's 64-row tile), 1,024
   (a ragged last batch) and 8,192 (one batch): the covariance and the normal
   equations (unit weights through xtx / xtxy, weighted through the library
   products) and one Lloyd pass (unit and weighted, n_split 3, 1 and, under
   parity_precision="high", 2) against the in-core calls, by phase 2a's
   gates (within twice the in-core plain version's error of f64, plus 1e-6;
   check_lloyd's counts, sums and inertia); the streamed KMeans fit (unit and
   weighted, f32, "high" and fast_math), covariance and normal equations the
   same bits over three runs, with a torch.cuda.synchronize() after every
   batch, with the device cache off and holding a prefix; and NaN rows past
   n_valid in a full-size buffer leave xtx, xtxy and the unit Lloyd step's
   bits as they were.
3. Main paths, through the estimators, each driven with every kernel's launch
   counter zeroed just before it and read just after; every kernel of a path
   must have run in it:
   * PCA(k=3) and KMeans(k=20) fit and transform on numpy input at
     8,388,608 x 256 f32 (d = 256 is the north star's width; the row count is
     cut from the north star's 1B to fit the run's time limit), and KMeans with
     a weight column (the weighted Lloyd form) on the same rows;
   * LinearRegression on the same X with y = X.beta + noise: OLS with
     standardization, then regParam=0.01, elasticNetParam=0.5; each fit on
     all rows and evaluate (which transforms the frame through the entry
     point) on the first 1,048,576 (cut for the run's time), the
     coefficients held to f64 solves on the card;
   * DBSCAN on a 20-blob mixture of 262,144 x 32 f32 with 1% uniform noise
     (cut from the north star's rows because each label-propagation round is an
     O(n^2) scan in plain PyTorch), its labels held to a run with the plain count;
   * NearestNeighbors fit on the main X (8,388,608 x 256), then kneighbors and
     exactNearestNeighborsJoin at the repo's exact-kNN benchmark's traffic
     (benchmark/benchmark/bench_nearest_neighbors.py: k = 200, the first 100
     rows of X as queries, a pandas frame), and again at k = 10 for 4,096
     queries (2,048 rows of X, 2,048 fresh rows of its mixture) with a user id
     column; each self-query's first neighbor must be itself, and each answer
     the top-k kernel's of phase 2b. Then the same four calls with
     knn_precision bfloat16 and int8 (the kernel's narrow forms and the
     exact f32 re-rank): recall@k against the f32 answer at least
     KNN_RECALL_GATE, every returned distance within TOPK_RTOL of f64 on a
     sample of queries, self-queries first.
   * RandomForestClassifier (BASELINE.json configs[3], 50,000,000 x 64 f32
     from the benchmark's ClassificationDataGen recipe, fed as a pandas frame
     of 64 scalar columns, maxDepth 6 as the benchmark's, numTrees 10, cut
     from its 20 for the run's time) fit
     and transform: 60 node x bin kernel launches in the fit, none in the
     transform, and a 2-tree fit with the histogram routed to its plain
     version equal to the kernel fit's first 2 trees bit for bit (its levels
     held to plain before that, on 2 and 3 integer stats, and on the
     regressor's real stats three launches bit-equal); then
     RandomForestRegressor on the same X with y = X.beta + noise: fit and
     evaluate (its transform), its first 2 trees' predictions held to a plain-route
     fit's (RF_REG_RTOL, RF_REG_MOVED). These run last, after the earlier paths' data is
     freed, with their own phases 2b (every level of a tree held to plain) and
     4 (times at widths 1 and 32).
   * the same paths in the split forms, against the f32 fits of the run:
     KMeans (unit and weighted) under fast_math and under "high", PCA under
     "high", and LinearRegression OLS under "high" with its f32 fit beside it on
     the first N_LR_HIGH rows; each form's launch counter must move, and no
     other form's (KM_FORM_RTOL, FIT_TIE_RTOL; explained variance within 1e-4;
     coefficients within 1e-3).
   * phase 3s, the streamed fits at the main shape: PCA k=3, KMeans k=20
     (unit and weighted) and LinearRegression OLS through the estimators with
     every streaming key pinned (pin_stream_keys: stream_threshold_bytes 1,
     stream_batch_rows 1,000,000, so nine batches, the last 388,608 rows;
     ingest.zero_copy on, ingest.staging_pool_rows 0), once with the device
     cache off and once with a 4 GiB budget, which holds four batches and
     streams the rest. Each fit launches its kernel once per batch and pass;
     its peak device memory above its start stays below the cache budget plus
     the batches in flight plus 1 GB (X is 8.6 GB); both cache settings give
     the same bits; PCA's explained variance within rtol 1e-4 of the in-core
     fit and its components within 1e-4, LinReg's coefficients within the f64
     gate, KMeans equal to an in-core lloyd_fit from the same initial centers
     (n_iter equal, centers within 1e-4 of the data's rms, cluster sizes equal
     up to near ties). The host-to-device rate of X by route (pageable copy_,
     the pinned ring at 4-256 MiB chunks and 2, 4 or 8 buffers, the upload
     wrapper as staging calls it, cudaHostRegister in place) is measured
     first. The labelled fits read an Arrow table when
     pyarrow imports, else a pandas frame.
   * phase 3a, when pyarrow imports (else one line says it did not run):
     LinearRegression OLS and weighted KMeans fitted in-core from a pyarrow
     Table with a FixedSizeList<float32>[256] view of X, equal bit for bit to
     the fits from pandas frames of the same rows, their extract spans (under
     0.1 s) beside the pandas fits'.
   * phase 3o, the streamed (out-of-core) planes of kNN, DBSCAN and the
     forests, every streaming key pinned (stream_threshold_bytes 1, under
     the data): NearestNeighbors fit on the main items (8,388,608 x 256, 8.6
     GB), which stay on the host (peak device memory under 1 GB above the
     fit's start; the norms a tile at a time), then kneighbors at both
     traffics with the device cache off and at 4 GiB, each bit-equal to
     phase 3's in-core f32 search, the top-k kernel launched once a (query
     block, item tile), the peak under the cache budget plus the tiles in
     flight plus 1 GB, each call's seconds split into stream.ingest, the
     kernel (select) and the merge (phase_streamed_pairwise); DBSCAN's
     transform of phase 3's 262,144 x 32 rows streamed: its core counts
     phase 3's one-launch counts bit for bit, its labels phase 3's up to the
     borderline rule (check_db_rule; dbscan_band reads the library d2's
     error at the stream's tile shapes too), its rounds phase 3's, the count
     kernel launched once a (query block, tile); RandomForestClassifier at
     MP_RF_TREES trees fit out-of-core on the forest rows (an Arrow view of
     the memory-mapped rows, 12.8 GB of f32; phase_streamed_forest): the
     peak under the uint8 bins plus the stats plus the batches in flight
     plus 1 GB, the edges the quantiles of the strided sample, the resident
     bins bin_features(X, edges) bit for bit, the trees the in-core growth
     (grow_forest) from those bins bit for bit, RF_DEPTH histogram launches
     a tree. Phase 3m's forest ranks fit the classifier out-of-core too,
     equal to this one bit for bit, and its empty-rank case fits it
     out-of-core with no rows on rank 1. Phase 3o alone, without the ranks:
     `python3 -c 'import sys, chip_smoke; sys.exit(chip_smoke.streamed_main())'`.
   * phase 3i, approximate kNN (phase_ann): ApproximateNearestNeighbors
     through the estimator on 8,388,608 x 256 items made from phase 3's X
     (ann_items: its 20 blobs, each a Gaussian of intrinsic dimension 16 in
     the 256 columns, plus X's noise at 0.1; cut from BASELINE configs[4]'s
     10M x 512 for the card beside the other phases and the run's time;
     phase 3's X itself, isotropic in 256 dimensions, makes k-means at
     nlist 4,096 put each blob in one cell, a padded layout of 1,754 GB,
     which the build refuses with a ValueError before allocating it),
     their exact answers from the top-k kernel: IVF-Flat (nlist 4,096,
     nprobe 32), IVF-PQ (the same, M 32, n_bits 8, refine_ratio 2, on the
     first ANN_PQ_ROWS rows for the phase's time), brute_force, and cosine
     IVF-Flat on the first 1,048,576 rows, each searched at the ANN
     benchmark's traffic (bench_approximate_nearest_neighbors.py:17-18:
     k = 10, the first 100 rows as queries) and at 4,096 queries, k = 10.
     The cosine index also searches the 100 queries at the JAX package's
     default nprobe, nlist // 8 = 512 (algoParams without nprobe). Gates:
     every IVF search launches the probe (fused_probe, its own kernel
     csrc/probe.cu, counted once a call) once and the top-k kernel no other
     time, and its lists equal the plain probe's by the top-k rule at every
     rank with no near tie (check_probe); each search equals the same index's search from the
     plain probe's lists bit for bit on the rows whose lists are equal, and
     so does its recall@10 (printed against the exact answer; gated to
     nothing else); the streamed search (stream_threshold_bytes 1, the 100
     queries) equals the in-core search bit for bit; the streamed IVF-Flat
     build (1,000,000-row batches) equals layout_cells of one assignment
     launch against its own centers; brute_force gives the exact ids; the
     cosine distances are d^2/2 of the euclidean search of the unit rows,
     bit for bit; the default-nprobe search's recall@10 is at least the
     nprobe-32 search's; every index is saved, loaded and searched to the
     original's bits (ann_persist). Printed: each build's stages (init,
     Lloyd, assignment, layout, PQ codebooks and encoding), the launch
     plans at k = 4,096 and at the k-means|| candidates, each search's
     seconds and queries/s, peak device memory, max_cell against the mean
     cell and the padded layout's bytes. Alone:
     `python3 -c 'import sys, chip_smoke; sys.exit(chip_smoke.ann_main())'`.
   * phase 3m, the multi-process main path: two rank processes of this
     script (`--rank`, rank_main) join one torch.distributed group through
     the SRML_TPU_* variables, both on one card over gloo (and, where there
     are two or more cards, again one card a rank over NCCL; with one card a
     line says that run did not take place). The parent writes the main X,
     its label and weight to .npy files once; each rank memory-maps them and
     takes its ragged share of the rows (MP_SHARE: 60% / 40%), fits PCA k=3,
     KMeans k=20 (unit and weighted) and LinearRegression (OLS, elastic net)
     through the estimators in-core and then streamed (1,000,000-row global
     batches, cache off), and logs each fit's seconds, collectives and bytes,
     its backend and card. Gates: every model the same bits on both ranks;
     PCA within rtol 1e-4 (components sign-aligned) of phase 3's in-core and
     phase 3s's streamed fit; LinearRegression within the f64 gate; KMeans's
     first 2-rank Lloyd step from its initial centers held to the plain step
     over all of X by check_lloyd, and the 2-rank fit to the single-process
     lloyd_fit from the same centers (n_iter equal, centers within 1e-4 of
     the data's rms, sizes up to near ties); each rank launched xtx, xtxy,
     the Lloyd forms and (in-core KMeans) assign. Then kNN on the same ranks
     (rank_knn, check_mp_knn): NearestNeighbors on each rank's share of the
     main X (default ids, the global row numbers) searched by the all-gather
     route at both kNN traffics (the bench's queries all on rank 0, the
     4,096 split 60/40) in f32, bf16 and int8, f32 bit-equal to phase 3's
     searches, the narrow forms' distances the exact re-rank of their ids
     bit for bit, none above phase 3's, recall@k at KNN_RECALL_GATE; and the
     ring through the estimator, X's first MP_RING_ITEMS rows against the
     next MP_RING_QUERIES, bit-equal to the single-process search and to
     exact_knn_distributed on the same ranks; each search's collectives and
     each rank's top-k launches. An empty-rank case at MP_SMALL (rank 1 with
     no rows) equal bit for bit to the single-process models, both forests
     and a kNN search among them. The forests' ranks run inside
     phase_forest (phase_multiprocess_forest): both estimators at
     MP_RF_TREES trees (cut from RF_TREES for the time limit) on each rank's
     share of the forest rows, written once in row order and read through an
     Arrow view; the same bits on both ranks, the classifier equal to phase
     3's first MP_RF_TREES trees bit for bit, the regressor split alike at
     every node whose best gain is separated from its second best
     (separated_structure) and its predictions under phase 3's regressor
     rule; RF_DEPTH histogram launches a tree on each rank. DBSCAN across
     the ranks (rank_dbscan, check_mp_dbscan; ranks of their own, job
     "dbscan"): each rank clusters its 60/40 share of phase 3's 262,144 x
     32 rows through DBSCAN(...).fit(...).transform(...), the ring of
     ops/dbscan.py, over gloo on one card and over NCCL one card a rank
     where two cards exist. The borderline rule (check_mp_dbscan): a pair
     is borderline when its f64 d2 lies within DB_BAND_ULPS units of
     2^-23 (|a|² + |b|²) of eps², a band held every run to cover twice the
     library f32 d2 error and the count kernel's (dbscan_band). The
     eps-counts summed over the ring's hops equal phase 3's one-launch
     counts but by a row's borderline pairs, a core flag flips only at a
     pair's end, the labels equal phase 3's single-process transform as
     numbers at every row but the ends and the clusters holding a flipped
     row, and at most DB_MOVED_SHARE of the rows differ (each count
     logged); the same global label vector compacted on both ranks, each
     rank's labels its slice of it, phase 3's propagation rounds on both
     ranks, the count kernel launched once a hop on each rank, the ring's
     collectives (dbscan_ring_ops). A rank that
     fails or outruns MP_TIMEOUT fails the run after the other rank is
     killed; every rank logs each call's seconds, collectives, bytes and
     spans.
   * phase 3p, persistence (phase_persist): PCA, KMeans, LinearRegression
     (OLS, elastic net) and DBSCAN after phase 3's fits, both forests after
     theirs: each model and an estimator with its params saved in the JAX
     package's directory format (core/persistence.py) and loaded back, each
     save and load timed with its bytes on disk; the loaded instance the
     same class, uid and params, a model's attributes bit for bit; its
     transform of a prefix of the rows (PERSIST_ROWS of the main X and of
     the forest rows, PERSIST_DB_ROWS of DBSCAN's) the original's bits, the
     reloaded KMeansModel launching assign and DBSCAN count; each forest's
     toJSON -> fromJSON model predicting the same bits.
   Every phase sets the six streaming keys (pin_in_core: streaming and the
   cache off, for the phases that do not stream), so none depends on a
   default.
   The stages inside each call (staging, init, Lloyd loop, normal equations,
   solve, core mask, propagation, output construction...) are timed by the
   port's spans (spark_rapids_ml_torch.utils.record_spans), which synchronize
   the card at each stage's ends.
4. Times: CUDA events, warm-up and the median of 10 runs (3 for topk at
   4,096 queries and for topk in one item range, whose calls take seconds,
   3 for every plain version and for count's library figure; 2 with no
   warm-up for the narrow forms' plain versions at 4,096 queries),
   of each kernel, its plain version and the PyTorch
   calls that compute the same function where there are some, at the main
   paths' shapes (topk at both kNN traffics with the items' cached norms, as
   kneighbors calls it, and with its item ranges pinned to one against the
   wrapper's rule; its narrow forms at their pool widths, with their
   products alone (the epilogue skipped), their launch plan, the exact
   re-rank beside them and a bf16 cuBLAS library figure, narrow_times); each
   kernel's
   bound from the card's
   published peaks (f32 on the CUDA cores, and for the 3xTF32 kernels, xtx,
   xtxy and topk, also three TF32 operations per f32 operation on the tensor
   cores; the narrow forms' products at the dense bf16 and int8 peaks); the top-k and Gram kernels' shared memory, launch plan and ptxas
   report; the cost of the Lloyd loop's per-iteration host sync. The
   bf16-split forms beside their f32 forms, with their plain versions and a
   bound of the bytes or of their part products at the bf16 peak (no PyTorch
   call computes any of them: library none). The count's bound also with its
   products in 3xTF32 and its criterion in f32 (the row's), the histogram's
   with uint8 and with int32 bins and a shared-memory figure, at s 2 and 3,
   each beside the earlier design's time (EARLIER_*), with the launch plans
   and the ptxas reports of both kernels; the histogram at every level of
   tree 0 under the wrapper's plan and under one block an SM
   (HIST_ONE_BLOCK). The six Lloyd forms and assign (k = 20 in both forms,
   k = 81 in f32 and n_split 2) with their bound at the engine their
   products take (3xTF32, bf16 passes; nearest_bound), plain version,
   assign's library figure (cdist and argmin), the earlier design's time
   (EARLIER_NEAREST_MS), the launch plan, and the ptxas reports of both
   sources. The IVF probe (fused_probe) at phase 3i's 4,096 queries against
   the IVF-Flat index's 4,096 centers, nprobe 32 (the row's) and 512 (the
   default), and at 1,024 queries against 65,536 centers from blobs, nprobe
   8,192 (the row of keys in device memory; held by check_probe first):
   kernel, plain, library (cuBLAS addmm + torch.topk), its 3xTF32 bound and
   each pass's device time from torch.profiler (probe_times). The
   weighted k-means++ seeding on the host and on the card at k = 20 x 256
   and k = 256 x 8 (kmeans_pp_times).

The last three lines of standard output are one JSON object with a row per
kernel, the card's name and power limit as nvidia-smi gives them, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import gc
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SEED = 0
N_MAIN = 8_388_608
D_MAIN = 256
K_MAIN = 20
K_PCA = 3
N_DB = 262_144  # DBSCAN rows
D_DB = 32
DB_EPS = 6.0
DB_MIN_SAMPLES = 10
DB_NOISE = 0.01  # share of uniform noise rows
LR_NOISE = 0.5  # std of the label noise
EN_REG, EN_L1 = 0.01, 0.5
# LinearRegression OLS under parity_precision="high" and its f32 fit beside it
# run on the first N_LR_HIGH rows: an 8.4M-row fit is 92% host extraction of the
# per-row arrays (PERF.md §5)
N_LR_HIGH = 1 << 20
# a KMeans fit in a split form against the f32 fit of the same run: each center
# within KM_FORM_RTOL[n_split] of max |center| (a coordinate is a mean of values
# rounded to bf16, 2^-9 relative each, or of hi + lo, 2^-17), plus max |x| / the
# least cluster size for each row that changed cluster; cluster sizes apart by at
# most twice the rows whose two best f32-fit centers are within FIT_TIE_RTOL
KM_FORM_RTOL = {1: 2.0**-8, 2: 2.0**-14}
FIT_TIE_RTOL = 1e-3
# kNN traffic of the repo's exact-kNN benchmark
# (benchmark/benchmark/bench_nearest_neighbors.py:16-21): k = 200, the first
# 100 rows of X as queries
NQ_KNN = 100
K_KNN = 200
# and next to it ann-benchmarks' search (its default count k = 10; its
# sift-128-euclidean set has 10,000 test queries, cut to 4,096 for the time
# limit): half rows of X, half fresh rows of its mixture
NQ_KNN10 = 4096
K_KNN10 = 10
KNN_F64_QUERIES = 256  # of the 4,096 queries held to f64
KNN_LIB_BLOCK = 256  # queries per cuBLAS product of the library figure (8.6 GB tile)
COUNT_LIB_BLOCK = 4096  # queries per cuBLAS product of the count's library figure (4.3 GB tile)
# RandomForest: BASELINE.json configs[3] (RandomForestClassifier, 50M x 64) with
# the repo benchmark's parameters (benchmark/benchmark/bench_random_forest.py:
# numTrees 20, maxDepth 6, maxBins 32 the default, featureSubsetStrategy auto,
# bootstrap), on benchmark/gen_data.py's ClassificationDataGen recipe (2
# classes, n_informative = d // 2 = 32), made in chunks of RF_CHUNK rows with
# chunk i seeded SEED + i as its write_parquet seeds its files
N_RF = 50_000_000
D_RF = 64
# trees a forest fit grows: cut from the benchmark's 20 (bench_random_forest.py)
# to make room in the run's time for phase 3i
RF_TREES, RF_DEPTH, RF_BINS = 10, 6, 32
RF_PLAIN_TREES = 2  # trees of the plain-route fits held to the kernel fits' first
RF_CHUNK = 1 << 20
RF_LIB_ROWS = 1 << 21  # rows per index_add_ of the histogram library figure
HIST_RTOL = 1e-5  # of sum |val| per bin: normal-valued histogram sums in another order
# the earlier designs' kernel times, for phase 4's comparison (PERF.md section 6,
# chip_smoke.py of PR 7, runs 4-5, on an NVIDIA H100 80GB HBM3 at 700.00 W):
# node_bin_hist by (s, width) (s = 3 was not timed), segment_hist, count
EARLIER_HIST_MS = {(2, 1): "28.69-28.94", (2, 32): "55.03-55.28"}
EARLIER_SEGMENT_MS = "53.54-54.07"
EARLIER_COUNT_MS = "503.29-507.76"
# the Lloyd and assignment kernels' earlier design (one 32 x 32 f32-FMA tile;
# PERF.md section 6; at k = 81 timed once by nearest_times_main on that tile)
EARLIER_NEAREST_MS = {
    "lloyd": "19.61-19.95", "lloyd_weighted": "20.63-21.14",
    "lloyd_bf16": "19.98-20.20", "lloyd_weighted_bf16": "21.13-21.31",
    "lloyd_high": "31.93-32.33", "lloyd_weighted_high": "33.81-33.99",
    "assign": "14.12-14.62", "assign_high": "25.53-25.65",
    "assign_k81": "39.75", "assign_high_k81": "73.54",
}
# the histogram plan phase 4 compares with the wrapper's: 160 KB of replicas
# and 1,024-row stages, one block an SM
HIST_ONE_BLOCK = {"HIST_BYTES": 160 << 10, "MAX_STAGE_ROWS": 1024}
# the regressor against its plain route: leaf means from reordered sums agree
# within RF_REG_RTOL of max |prediction|, except the rows under a split that
# moved between two near-tied bins (the plain version's index_add_ sums carry
# some 1e-5 relative error at this n, the kernel's 1e-6): at most RF_REG_MOVED
# of the rows, and the two forests' rmse within 1e-3 relative
RF_REG_RTOL = 1e-4
RF_REG_MOVED = 0.01
PEAK_F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores (NVIDIA data sheet)
PEAK_TF32_FLOPS = 495e12  # H100 SXM, TF32 on the tensor cores, dense
PEAK_NARROW_OPS = {"bfloat16": 989e12, "int8": 1979e12}  # dense bf16 FLOP/s, int8 OP/s
KNN_FORMS = ("bfloat16", "int8")  # the top-k scan's narrow forms (config knn_precision)
# a narrow form's kneighbors against the f32 answer of the same run, at these
# blob data: recall@k at least this. bfloat16: 0.99. int8: 0.8, the JAX
# package's own floor for its narrow forms (tests/test_pallas_select.py,
# test_rerank_invariant_distances_exact): its per-row quantization moves q.x
# by about 1% of d2 at d = 256, as much as the 200th to 250th neighbours'
# distances differ among 8.4M blob items, so the pool of k + k/4 misses some
# true neighbours (the int8 pools equal their plain version's bit for bit, and
# the plain version the JAX package's on the CPU tests).
KNN_RECALL_GATE = {"bfloat16": 0.99, "int8": 0.8}
# a narrow form's kernel pool against its plain version's, tol_i = rtol *
# (q2_i + max valid x2), each pool d2 within tol of plain's at its rank and ids
# equal wherever plain's d2 is more than 2 tol from its neighbors':
#   int8: both sides take the same exact int32 sums and the same f32 rescale
#   and epilogue: a few ulps at most (equal bits expected; counted);
#   bfloat16: both sum the same exact products in another order, the tensor
#   cores' accumulation truncating: d * 2^-23 * sum |q x| each, twice that in
#   d2, and the epilogue's rounding
TOPK_INT8_RTOL = 2.0**-22


def topk_narrow_rtol(precision: str, d: int) -> float:
    return TOPK_INT8_RTOL if precision == "int8" else (d + 1) * 2.0**-22
TF32X3 = ("xtx", "xtxy", "topk")  # kernels whose products are 3xTF32 on the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
REPLACES = {
    "xtx": "spark_rapids_ml_tpu/ops/pallas_xtwx.py:55",
    "lloyd": "spark_rapids_ml_tpu/ops/pallas_kmeans.py:187",
    "lloyd_weighted": "spark_rapids_ml_tpu/ops/pallas_kmeans.py:136",
    "assign": "spark_rapids_ml_tpu/ops/pallas_select.py:473",
    "xtxy": "spark_rapids_ml_tpu/ops/pallas_xtwx.py:130",
    "count": "spark_rapids_ml_tpu/ops/pallas_select.py:610",
    "topk": "spark_rapids_ml_tpu/ops/pallas_select.py:258",
    "topk_bf16": "spark_rapids_ml_tpu/ops/pallas_select.py:258",
    "topk_int8": "spark_rapids_ml_tpu/ops/pallas_select.py:258",
    "node_bin_hist": "spark_rapids_ml_tpu/ops/pallas_histogram.py:131",
    "segment_hist": "spark_rapids_ml_tpu/ops/pallas_histogram.py:49",
    # the bf16-split forms (_dot_multipass, pallas_kmeans.py:111, at n_split 1 and 2)
    "lloyd_bf16": "spark_rapids_ml_tpu/ops/pallas_kmeans.py:187",
    "lloyd_high": "spark_rapids_ml_tpu/ops/pallas_kmeans.py:187",
    "lloyd_weighted_bf16": "spark_rapids_ml_tpu/ops/pallas_kmeans.py:136",
    "lloyd_weighted_high": "spark_rapids_ml_tpu/ops/pallas_kmeans.py:136",
    "assign_high": "spark_rapids_ml_tpu/ops/pallas_select.py:473",
    "xtx_high": "spark_rapids_ml_tpu/ops/pallas_xtwx.py:55",
    "xtxy_high": "spark_rapids_ml_tpu/ops/pallas_xtwx.py:130",
    # the IVF coarse probe: fused_topk's pallas_call at the probe's shapes
    "fused_probe": "spark_rapids_ml_tpu/ops/pallas_select.py:450",
}
SOURCE = {
    "xtx": "spark_rapids_ml_torch/csrc/xtx.cu",
    "lloyd": "spark_rapids_ml_torch/csrc/lloyd.cu",
    "lloyd_weighted": "spark_rapids_ml_torch/csrc/lloyd.cu",
    "assign": "spark_rapids_ml_torch/csrc/assign.cu",
    "xtxy": "spark_rapids_ml_torch/csrc/xtx.cu",
    "count": "spark_rapids_ml_torch/csrc/count.cu",
    "topk": "spark_rapids_ml_torch/csrc/topk.cu",
    "topk_bf16": "spark_rapids_ml_torch/csrc/topk_narrow.cu",
    "topk_int8": "spark_rapids_ml_torch/csrc/topk_narrow.cu",
    "node_bin_hist": "spark_rapids_ml_torch/csrc/hist.cu",
    "segment_hist": "spark_rapids_ml_torch/csrc/hist.cu",
    "lloyd_bf16": "spark_rapids_ml_torch/csrc/lloyd.cu",
    "lloyd_high": "spark_rapids_ml_torch/csrc/lloyd.cu",
    "lloyd_weighted_bf16": "spark_rapids_ml_torch/csrc/lloyd.cu",
    "lloyd_weighted_high": "spark_rapids_ml_torch/csrc/lloyd.cu",
    "assign_high": "spark_rapids_ml_torch/csrc/assign.cu",
    "xtx_high": "spark_rapids_ml_torch/csrc/xtx.cu",
    "xtxy_high": "spark_rapids_ml_torch/csrc/xtx.cu",
    "fused_probe": "spark_rapids_ml_torch/csrc/probe.cu",
}
TIE_RTOL = 1e-5  # two best centers closer than this (relative) may swap in f32
# a pair whose f64 d2 lies within this share of (|q| + |x|)^2 of eps^2 may fall on
# either side of it in f32: the FMA dot product's rounding is at most about
# 2 d u |q||x| <= 0.5 d u (|q| + |x|)^2, 1e-6 at d = 32, u = 2^-24
COUNT_RTOL = 4e-6
# a returned neighbor's d2 lies within TOPK_RTOL * (q2 + max x2) of its f64
# value, and of the f64 value at its rank: some 80 f32 ulps of the terms d2 is
# made of, several times the FMA dot product's typical rounding at d = 256
TOPK_RTOL = 1e-5


def log(*args) -> None:
    print(*args, flush=True)


def ptxas_lines(report: str) -> list:
    """ptxas -v's lines naming each kernel, its registers and shared memory,
    its stack and spills, and its warnings (a serialized wgmma among them)."""
    keys = ("entry function", "registers", "spill", "warning", "wgmma")
    return [line.strip() for line in report.splitlines() if any(k in line for k in keys)]


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def sm_clock_hz() -> float:
    """The card's maximum SM clock, as nvidia-smi gives it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return 1e6 * float(out)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ data


def blobs(n: int, d: int, k: int, seed: int, spread: float = 4.0):
    """A k-blob Gaussian mixture, f32, made on the host from numpy's generator:
    (X, true centers)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0.0, spread, (k, d)).astype(np.float32)
    labels = rng.integers(0, k, n)
    X = rng.standard_normal((n, d), dtype=np.float32)
    step = 1 << 20
    for s in range(0, n, step):
        X[s : s + step] += centers[labels[s : s + step]]
    return X, centers


def regression_label(Xh: np.ndarray, seed: int):
    """y = X.beta + 2 + noise, f32, on the host from numpy's generator."""
    rng = np.random.default_rng(seed)
    beta = rng.normal(0.0, 1.0, Xh.shape[1]).astype(np.float32)
    y = Xh @ beta
    y += np.float32(2.0) + rng.normal(0.0, LR_NOISE, Xh.shape[0]).astype(np.float32)
    return y


def dbscan_blobs(n: int, d: int, k: int, seed: int):
    """A k-blob Gaussian mixture (unit spread, centers N(0, 6^2), so no two
    blobs come within eps of each other) with a DB_NOISE share of rows uniform
    in [-16, 16]^d, shuffled: (X f32, true blob or -1)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0.0, 6.0, (k, d)).astype(np.float32)
    n_noise = int(n * DB_NOISE)
    truth = np.full(n, -1, np.int64)
    truth[: n - n_noise] = rng.integers(0, k, n - n_noise)
    X = np.empty((n, d), np.float32)
    X[: n - n_noise] = rng.standard_normal((n - n_noise, d), dtype=np.float32)
    X[: n - n_noise] += centers[truth[: n - n_noise]]
    X[n - n_noise :] = rng.uniform(-16.0, 16.0, (n_noise, d))
    perm = rng.permutation(n)
    return X[perm], truth[perm]


# ----------------------------------------------------- phase 3p: persistence

PERSIST_ROWS = 1 << 20  # rows of the main X (and of the forest rows) the reloaded models transform
PERSIST_DB_ROWS = 1 << 16  # rows of the DBSCAN data the reloaded DBSCAN model clusters


def dir_bytes(path) -> int:
    """Bytes of the files in a saved directory, its subdirectories included."""
    import os

    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def output_columns(out) -> dict:
    """The columns of a transform's frame, a column of per-row arrays stacked."""
    return {c: (np.stack(out[c].to_numpy()) if out[c].dtype == object else out[c].to_numpy())
            for c in out.columns}


def phase_persist(torch, run_path, path_counts, items: dict, tag: str = "") -> None:
    """Phase 3p: each model of phase 3 and an estimator with its params saved
    (core/persistence.py, the JAX package's directory format) to a directory
    beside this script and loaded back, each save and load timed with its
    bytes on disk; the loaded instance the same class, uid and params, a
    model's attributes bit for bit; the loaded model's transform of `rows`
    (a prefix of phase 3's rows) bit-equal to the original's, each through
    run_path (the launch counters zeroed just before it), the loaded one
    launching `kernel` where one is named. A forest also goes through
    toJSON -> fromJSON, which must predict the same bits. `items`: label ->
    (model, estimator, rows, kernel or None, JSON import args or None)."""
    workdir = mp_workdir("phase3p" + tag)
    try:
        for label, (model, est, rows, kernel, json_args) in items.items():
            loaded = {}
            for kind, obj in (("model", model), ("estimator", est)):
                path = str(workdir / f"{label.replace(' ', '_').replace(',', '')}_{kind}")
                t0 = time.perf_counter()
                obj.save(path)
                t_save = time.perf_counter() - t0
                t0 = time.perf_counter()
                back = type(obj).load(path)
                t_load = time.perf_counter() - t0
                log(f"  {label} {kind}: save {t_save:.4f} s, load {t_load:.4f} s, "
                    f"{dir_bytes(path)} bytes on disk")
                require(type(back) is type(obj) and back.uid == obj.uid
                        and back.extractParamMap() == obj.extractParamMap()
                        and back._torch_params == obj._torch_params,
                        f"{label} {kind}: the loaded instance differs in class, uid or params")
                if kind == "model":
                    require(bits_equal(back.get_model_attributes(), obj.get_model_attributes()),
                            f"{label}: the loaded model's attributes differ")
                loaded[kind] = back
            n = len(rows)
            want = output_columns(run_path(f"{label} transform, {n} rows",
                                           lambda: model.transform(rows)))
            got = output_columns(run_path(f"{label} transform, {n} rows, loaded",
                                          lambda: loaded["model"].transform(rows)))
            require(bits_equal(got, want), f"{label}: the loaded model transforms other bits")
            if kernel is not None:
                require(path_counts[f"{label} transform, {n} rows, loaded"][kernel] >= 1,
                        f"{label}: the loaded model's transform launched no {kernel}")
            note = f", launching {kernel}" if kernel is not None else ""
            if json_args is not None:
                # the dump carries the trees; the params (input columns) come from the model
                rebuilt = model._copyValues(type(model).fromJSON(model.toJSON(), **json_args))
                via_json = output_columns(run_path(f"{label} transform, {n} rows, from JSON",
                                                   lambda: rebuilt.transform(rows)))
                require(bits_equal(via_json, want),
                        f"{label}: the toJSON -> fromJSON forest predicts other bits")
                note += "; toJSON -> fromJSON predicts the same bits"
            log(f"  {label}: the loaded model transforms {n} rows to the same bits{note}")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


# ------------------------------------------------------------ comparisons


def near_ties(X, C, full: bool, rows_mask=None, n_split: int = 3, rtol: float = TIE_RTOL):
    """Rows whose two best centers are within rtol of each other, relative to
    the size of the terms the f32 criterion is made of (|x|² + |c|²), in f64,
    with the cross term of the form at n_split: the exact products of its bf16
    parts (ops/_precision.py), so that only the order of the f32 sums is left."""
    import torch

    from spark_rapids_ml_torch.ops._precision import F32, multipass, split_bf16

    n = X.shape[0]
    out = torch.zeros(n, dtype=torch.bool, device=X.device)
    if C.shape[0] < 2:
        return out
    C64 = C.double()
    c2 = (C64 * C64).sum(1)
    Cp = split_bf16(C, n_split) if n_split < F32 else None
    for s in range(0, n, 1 << 20):
        xf = X[s : s + (1 << 20)]
        x = xf.double()
        x2 = (x * x).sum(1, keepdim=True)
        if Cp is None:
            cross = x @ C64.T
        else:
            cross = multipass(split_bf16(xf, n_split), Cp, lambda a, b: a.double() @ b.double().T)
        crit = c2[None, :] - 2.0 * cross
        if full:
            crit = crit + x2
        two = torch.topk(crit, 2, dim=1, largest=False).values
        scale = x2[:, 0] + c2.max()
        out[s : s + x.shape[0]] = (two[:, 1] - two[:, 0]) <= rtol * scale
    if rows_mask is not None:
        out &= rows_mask
    return out


def rel_err(a, ref) -> float:
    return float((a.double() - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def check_xtx(X, n_valid: int, label: str) -> dict:
    from spark_rapids_ml_torch.ops.xtwx import xtx, xtx_plain

    s2_k, s1_k = xtx(X, n_valid)
    s2_p, s1_p = xtx_plain(X, n_valid)
    X64 = X[:n_valid].double()
    s2_r, s1_r = X64.T @ X64, X64.sum(0)
    del X64
    e = {
        "s2_kernel": rel_err(s2_k, s2_r), "s2_plain": rel_err(s2_p, s2_r),
        "s1_kernel": rel_err(s1_k, s1_r), "s1_plain": rel_err(s1_p, s1_r),
    }
    log(f"  xtx {label}: max rel err vs f64  S2 kernel {e['s2_kernel']:.3e} plain "
        f"{e['s2_plain']:.3e}  s1 kernel {e['s1_kernel']:.3e} plain {e['s1_plain']:.3e}")
    require(e["s2_kernel"] <= 2 * e["s2_plain"] + 1e-6, f"xtx {label}: S2 error {e}")
    require(e["s1_kernel"] <= 2 * e["s1_plain"] + 1e-6, f"xtx {label}: s1 error {e}")
    return {"max_abs_err": float((s2_k - s2_p).abs().max())}


def linreg_f64(torch, X, y):
    """The f64 references of the LinearRegression fits of X (n, d) and y on the
    card: (stats, beta, elastic net), stats the f64 normal-equation statistics
    (A, b, x̄, ȳ, n), beta the OLS coefficients of a direct solve, elastic net
    the f64 FISTA attributes of solve_from_stats at EN_REG, EN_L1."""
    from spark_rapids_ml_torch.ops import linear as linear_mod

    n = X.shape[0]
    s2_64, s1_64, xty_64, ysum_64, _ = xtxy_f64(X, y, n)
    nf = float(n)
    xbar64, ybar64 = s1_64 / nf, ysum_64 / nf
    stats64 = (s2_64, xty_64, xbar64, ybar64, torch.tensor(nf, dtype=torch.float64, device=X.device))
    A = s2_64 - nf * torch.outer(xbar64, xbar64)
    beta64 = torch.linalg.solve(A, xty_64 - nf * xbar64 * ybar64)
    en64 = linear_mod.solve_from_stats(*stats64, reg=EN_REG, l1_ratio=EN_L1, fit_intercept=True,
                                       standardize=True, max_iter=100, tol=1e-6)[0]
    return stats64, beta64, en64


def xtxy_f64(X, y, n_valid: int, n_split: int = 3):
    """(XᵀX, colsum X, Xᵀy, Σy, Σy²) over rows < n_valid in f64 on the card, by
    chunks of rows, as entries of the Gram of Z = [X | y | 1]; with n_split < 3
    the two-part bf16 split's value: the exact products of Z's parts
    (ops/_precision.py), summed in f64."""
    import torch

    from spark_rapids_ml_torch.ops._precision import multipass, split_bf16

    d = X.shape[1]
    G = torch.zeros((d + 2, d + 2), dtype=torch.float64, device=X.device)
    for s in range(0, n_valid, 1 << 20):
        e = min(s + (1 << 20), n_valid)
        Z = torch.cat([X[s:e], y[s:e, None], torch.ones_like(y[s:e, None])], dim=1)
        if n_split < 3:
            pz = split_bf16(Z, n_split)
            G += multipass(pz, pz, lambda a, b: a.double().T @ b.double())
        else:
            Z = Z.double()
            G += Z.T @ Z
    return G[:d, :d], G[:d, d + 1], G[:d, d], G[d, d + 1], G[d, d]


def check_xtxy(X, y, n_valid: int, label: str) -> dict:
    from spark_rapids_ml_torch.ops.xtwx import xtxy, xtxy_plain

    got = xtxy(X, y, n_valid)
    plain = xtxy_plain(X, y, n_valid)
    ref = xtxy_f64(X, y, n_valid)
    parts = []
    for name, k, p, r in zip(("S2", "s1", "Xty", "sum y", "sum y^2"), got, plain, ref):
        ek, ep = rel_err(k, r), rel_err(p, r)
        parts.append(f"{name} kernel {ek:.3e} plain {ep:.3e}")
        require(ek <= 2 * ep + 1e-6, f"xtxy {label}: {name} rel err {ek} (plain {ep})")
    log(f"  xtxy {label}: max rel err vs f64  " + "  ".join(parts))
    return {"max_abs_err": max(float((k - p).abs().max()) for k, p in zip(got, plain))}


def count_refs(Q, X, valid, eps2: float):
    """f64 on the card: each query's exact count, and its valid items whose d2
    lies within COUNT_RTOL * (|q| + |x|)^2 of eps2 (the pairs f32 may put on
    either side)."""
    import torch

    Q64, X64 = Q.double(), X.double()
    q2, x2 = (Q64 * Q64).sum(1), (X64 * X64).sum(1)
    qn, xn = q2.sqrt(), x2.sqrt()
    exact = torch.empty(Q.shape[0], dtype=torch.int64, device=Q.device)
    near = torch.empty_like(exact)
    rows = max(1, (1 << 27) // X.shape[0])
    for s in range(0, Q.shape[0], rows):
        e = min(s + rows, Q.shape[0])
        d2 = (q2[s:e, None] - 2.0 * (Q64[s:e] @ X64.T) + x2[None, :]).clamp_min(0.0)
        exact[s:e] = ((d2 <= eps2) & valid[None, :]).sum(1)
        tol = COUNT_RTOL * (qn[s:e, None] + xn[None, :]) ** 2
        near[s:e] = (((d2 - eps2).abs() <= tol) & valid[None, :]).sum(1)
    return exact, near


def check_count(Q, X, valid, eps2: float, label: str):
    """The kernel's and the plain counts against f64, each within its near-eps
    pairs per query. Returns (errs, kernel counts, plain counts, near pairs)."""
    from spark_rapids_ml_torch.ops.count import count_below_plain, fused_count_below

    ck = fused_count_below(Q, X, valid, eps2).long()
    cp = count_below_plain(Q, X, valid, eps2).long()
    exact, near = count_refs(Q, X, valid, eps2)
    d_kp = (ck - cp).abs()
    log(f"  count {label}: kernel vs plain {int(d_kp.sum())} count mismatches on "
        f"{int((d_kp > 0).sum())} queries (near-eps pairs {int(near.sum())}); kernel "
        f"vs f64 {int((ck - exact).abs().sum())}, plain vs f64 {int((cp - exact).abs().sum())}; "
        f"mean count {float(exact.double().mean()):.2f}")
    require(bool(((ck - exact).abs() <= near).all()), f"count {label}: kernel vs f64")
    require(bool(((cp - exact).abs() <= near).all()), f"count {label}: plain vs f64")
    require(bool((d_kp <= near).all()), f"count {label}: kernel vs plain per query")
    require(int(d_kp.sum()) <= int(near.sum()), f"count {label}: kernel vs plain in all")
    return {"max_abs_err": float(d_kp.max())}, ck, cp, near


def check_lloyd(X, C, n_valid: int, w, label: str, n_split: int = 3, got=None,
                counts_atol: float = 0.0) -> dict:
    """The Lloyd kernel's step (or `got`, the same statistics from another
    route, such as a streamed pass) against the plain version's; counts_atol
    allows real-valued weights summed in another order (a multi-process step)."""
    import torch

    from spark_rapids_ml_torch.ops.lloyd import lloyd_step, lloyd_step_plain

    s_k, c_k, i_k = lloyd_step(X, C, n_valid, w, n_split) if got is None else got
    s_p, c_p, i_p = lloyd_step_plain(X, C, n_valid, w, n_split)
    label = f"{label} n_split={n_split}"
    n = X.shape[0]
    valid = torch.arange(n, device=X.device) < n_valid
    wv = valid.float() if w is None else torch.where(valid, w, torch.zeros_like(w))
    ties = near_ties(X, C, full=False, rows_mask=wv > 0, n_split=n_split)
    n_ties = int(ties.sum())
    wmax = float(wv.max()) if n else 0.0
    count_diff = float((c_k - c_p).abs().sum())
    tie_mass = float((X[ties].abs() * wv[ties, None]).sum(0).max()) if n_ties else 0.0
    sums_err = float((s_k - s_p).abs().max())
    # rows that swapped centers move whole rows between sums; none swapped, none moved
    sums_tol = 1e-5 * float(s_p.abs().max()) + (2.0 * tie_mass if count_diff else 0.0)
    in_rel = abs(float(i_k) - float(i_p)) / max(abs(float(i_p)), 1e-30)
    log(f"  lloyd {label}: count diff {count_diff:g} (near ties {n_ties}), sums max abs "
        f"err {sums_err:.3e} (tol {sums_tol:.3e}), inertia rel err {in_rel:.3e}")
    require(count_diff <= 2.0 * wmax * n_ties + counts_atol,
            f"lloyd {label}: counts differ by {count_diff}")
    require(sums_err <= sums_tol, f"lloyd {label}: sums err {sums_err} > {sums_tol}")
    require(in_rel <= 1e-5, f"lloyd {label}: inertia rel err {in_rel}")
    return {"max_abs_err": sums_err}


def check_assign(X, C, label: str, n_split: int = 3) -> dict:
    from spark_rapids_ml_torch.ops.select import assign, assign_plain

    a_k = assign(X, C, n_split)
    a_p = assign_plain(X, C, n_split)
    label = f"{label} n_split={n_split}"
    n_ties = int(near_ties(X, C, full=True, n_split=n_split).sum())
    mismatches = int((a_k != a_p).sum())
    log(f"  assign {label}: label mismatches {mismatches} (near ties {n_ties})")
    require(mismatches <= n_ties, f"assign {label}: {mismatches} mismatches > {n_ties} ties")
    require(int(a_k.min()) >= 0 and int(a_k.max()) < C.shape[0], f"assign {label}: range")
    return {"max_abs_err": float(mismatches)}


# ------------------------------------------------------ the bf16-split forms

SPLIT_FORMS = {1: "bf16", 2: "high"}  # n_split -> the suffix of a form's name
# A split form of the Gram kernels on split_data, per entry, against the form's
# exact value (the exact part products summed in f64), as a share of the sum of
# |products| (|X|ᵀ|X|, ...): at 401 rows every f32 sum is exact too, so to a
# rounding or two (SPLIT_RTOL_EXACT); at the main shape the kernel's f32 sums'
# error (3e-7 of f64 in the f32 form). The plain versions are held to the exact
# value as check_xtx holds them to f64: cuBLAS's f32 S2 of the 8,388,608 x 256
# main X is 3.1e-5 of max |S2| off f64, its sums of the parts' products 9e-5
# off the kernel's, on an H100. The two-part split falls short of f32 by
# 3·2^-18 ≈ 1.14e-5 of every product of split_data, the gap that must exceed
# 10 tol.
SPLIT_RTOL_EXACT = 2.0**-22
SPLIT_RTOL_MAIN = 1e-6
SPLIT_ATOL = 1e-5  # a Lloyd form's sums against its plain version: of max |plain|


def form_name(base: str, n_split: int) -> str:
    return base if n_split == 3 else f"{base}_{SPLIT_FORMS[n_split]}"


def flip_data(torch, n: int, d: int, k: int, weights: str):
    """The discriminating data of the Lloyd and assignment forms: rows and
    centers on which the bf16-split forms (n_split 1 and 2) and f32 choose
    different centers, with every product and sum of the split forms exact.
    Center 0 is the origin; for P = min(k, d + 1) - 1 patterns, center 1 + p has
    only column j_p = p d // P, at 2^e (2 + 2^-8) with e = -3, 0, 4 in turn;
    row i has only column j_p, p = i mod P, at x = 2^e (1 + 2^-9 + 2^-18), whose
    bf16 parts are hi 2^e and lo 2^(e-9), 2^(e-18) left over. In both split
    forms c2 - 2 x.c is +2^(2e - 16) (the part products and their sums are
    exact); in f32 x.c rounds once, to 2^(2e) (2 + 2^-7 + 2^-16), and it is
    -2^(2e - 16). So the split forms put every row in center 0 and f32 each in
    its center 1 + p, and the full criterion |x|^2 - 2 x.c + |c|^2 orders them
    alike. Weights ("lo": u (1 + 2^-9), lo part 2^-9 u; "int": u; u uniform in
    0..3, 0..2 for "int"): a center's sums of parts stay exact up to about 10,000
    rows with "lo", and its counts up to 2^24 with "int". Returns (X, C, w)."""
    P = min(k, d + 1) - 1
    gen = torch.Generator("cuda").manual_seed(SEED + n + d)
    p = torch.arange(n, device="cuda") % P
    cols = (torch.arange(P, device="cuda") * d) // P
    e = torch.tensor([-3.0, 0.0, 4.0], device="cuda")[torch.arange(P, device="cuda") % 3]
    X = torch.zeros((n, d), device="cuda")
    X[torch.arange(n, device="cuda"), cols[p]] = torch.exp2(e[p]) * (1.0 + 2.0**-9 + 2.0**-18)
    C = torch.zeros((P + 1, d), device="cuda")
    C[torch.arange(1, P + 1, device="cuda"), cols] = torch.exp2(e) * (2.0 + 2.0**-8)
    u = torch.randint(0, 4 if weights == "lo" else 3, (n,), device="cuda", generator=gen).float()
    return X, C, u * (1.0 + 2.0**-9) if weights == "lo" else u


def check_lloyd_flip(X, C, w, n_split: int, label: str) -> None:
    """The discriminating check of a Lloyd form on flip_data: kernel and plain
    version equal in counts (exact), the sums within SPLIT_ATOL of max |plain|
    and the inertia within 1e-5; the plain version puts every row of weight in
    center 0, the plain f32 form none, and its sums differ from the form's by
    more than 10 times the sums' tolerance."""
    from spark_rapids_ml_torch.ops.lloyd import lloyd_step, lloyd_step_plain

    n = X.shape[0]
    s_k, c_k, i_k = lloyd_step(X, C, n, w, n_split)
    s_p, c_p, i_p = lloyd_step_plain(X, C, n, w, n_split)
    s_f, c_f, _ = lloyd_step_plain(X, C, n, w)
    total = float(X.shape[0] if w is None else w.sum())
    tol = SPLIT_ATOL * float(s_p.abs().max())
    err, gap = float((s_k - s_p).abs().max()), float((s_p - s_f).abs().max())
    in_rel = abs(float(i_k) - float(i_p)) / max(abs(float(i_p)), 1e-30)
    log(f"  lloyd flip {label} n_split={n_split}: counts kernel == plain "
        f"{bool(torch_equal_bits(c_k, c_p))}, center 0 holds {float(c_p[0]):g} of {total:g} "
        f"(f32 form {float(c_f[0]):g}); sums err {err:.3e}, f32 gap {gap:.3e} (tol {tol:.3e}); "
        f"inertia rel err {in_rel:.3e}")
    require(torch_equal_bits(c_k, c_p), f"lloyd flip {label} n_split={n_split}: counts differ")
    require(err <= tol and in_rel <= 1e-5, f"lloyd flip {label} n_split={n_split}: sums or inertia")
    require(float(c_p[0]) == total and float(c_f[0]) == 0.0 and gap >= 10 * tol,
            f"lloyd flip {label} n_split={n_split}: the form is not told apart from f32")


def check_assign_flip(X, C, label: str) -> None:
    """The discriminating check of the assignment's n_split 2 form on
    flip_data: kernel labels equal to the plain version's, all 0; the plain
    f32 form's all other than 0."""
    from spark_rapids_ml_torch.ops.select import assign, assign_plain

    a_k, a_p, a_f = assign(X, C, 2), assign_plain(X, C, 2), assign_plain(X, C)
    log(f"  assign flip {label} n_split=2: kernel == plain {bool(torch_equal_bits(a_k, a_p))}, "
        f"rows in center 0: form {int((a_p == 0).sum())}, f32 form {int((a_f == 0).sum())} "
        f"of {X.shape[0]}")
    require(torch_equal_bits(a_k, a_p), f"assign flip {label}: kernel labels differ from plain")
    require(bool((a_p == 0).all()) and bool((a_f != 0).all()),
            f"assign flip {label}: the form is not told apart from f32")


def split_data(torch, n: int, d: int):
    """The discriminating data of the Gram forms: X (n, d) and y (n,) at
    a (1 + 2^-9 + 2^-18), a uniform in 4..7: bf16 parts hi a, lo 2^-9 a, and
    2^-18 a left over, all positive, so the two-part split falls short of
    every product x x' by the same 3 * 2^-18 of it. Up to about 400 rows
    every sum of part products is exact."""
    gen = torch.Generator("cuda").manual_seed(SEED + n + d)
    f = 1.0 + 2.0**-9 + 2.0**-18
    X = torch.randint(4, 8, (n, d), device="cuda", generator=gen, dtype=torch.uint8).float() * f
    y = torch.randint(4, 8, (n,), device="cuda", generator=gen, dtype=torch.uint8).float() * f
    return X, y


def check_gram_split(X, y, n_valid: int, label: str, rtol=None) -> dict:
    """xtx and xtxy at n_split 2 and their plain versions against the form's
    exact value (the exact part products summed in f64), as check_xtx holds
    the f32 forms to f64: each output's error at most twice the plain
    version's plus 1e-6, relative to its largest entry. On split_data (rtol
    given) also each kernel entry within rtol of the exact value, as a share
    of its sum of |products| (the f64 statistics of the positive data), and
    the form's exact S2 more than 10 rtol off f32's at every entry: the
    discriminating check."""
    from spark_rapids_ml_torch.ops.xtwx import xtx, xtx_plain, xtxy, xtxy_plain

    kx, px = xtx(X, n_valid, 2), xtx_plain(X, n_valid, 2)
    ky, py = xtxy(X, y, n_valid, 2), xtxy_plain(X, y, n_valid, 2)
    ref, exact = xtxy_f64(X, y, n_valid), xtxy_f64(X, y, n_valid, 2)
    names = ("S2", "s1", "Xty", "sum y", "sum y^2")
    rows = list(zip(("xtx " + n for n in names[:2]), kx, px, ref[:2], exact[:2])) + list(
        zip(("xtxy " + n for n in names), ky, py, ref, exact))
    parts = []
    for name, k, p, r, x in rows:
        ek, ep = rel_err(k, x), rel_err(p, x)
        parts.append(f"{name} kernel {ek:.3e} plain {ep:.3e}")
        require(ek <= 2 * ep + 1e-6, f"gram {label}: {name} rel err {ek} (plain {ep})")
        if rtol is not None:
            e = float(((k.double() - x).abs() / r).max())
            require(e <= rtol, f"gram split data {label}: {name} err {e} per sum |products|")
    log(f"  gram n_split=2 {label}: max rel err vs the form's exact value  " + "  ".join(parts))
    if rtol is not None:
        gap = float(((exact[0] - ref[0]).abs() / ref[0]).min())
        log(f"  gram split data {label}: every kernel entry within {rtol:.3e} of the form's "
            f"exact value per sum |products|; the form's exact S2 at least {gap:.3e} off f32's")
        require(gap >= 10 * rtol, f"gram split data {label}: the form is not told apart")
    return {"xtx_high": {"max_abs_err": max(float((k - p).abs().max()) for k, p in zip(kx, px))},
            "xtxy_high": {"max_abs_err": max(float((k - p).abs().max()) for k, p in zip(ky, py))}}


def phase_split_forms(torch, X, C, w, n_valid: int, label: str, main: bool) -> dict:
    """Every bf16-split form at one shape: random data (X, C, w) against the
    plain versions, then flip_data and split_data. Returns each form's
    max_abs_err on the random data."""
    n, d = X.shape
    errs = {}
    for n_split in (1, 2):
        errs[form_name("lloyd", n_split)] = check_lloyd(
            X, C, n_valid, None, f"unit {label}", n_split)
        errs[form_name("lloyd_weighted", n_split)] = check_lloyd(
            X, C, n, w, f"weighted {label}", n_split)
    errs["assign_high"] = check_assign(X, C, label, 2)
    Xf, Cf, wf = flip_data(torch, n, d, max(C.shape[0], 2), "int" if main else "lo")
    for n_split in (1, 2):
        check_lloyd_flip(Xf, Cf, None, n_split, f"unit {label}")
        check_lloyd_flip(Xf, Cf, wf, n_split, f"weighted {label}")
    check_assign_flip(Xf, Cf, label)
    del Xf, Cf, wf
    return errs


def check_kmeans_form(model, ref, X, n_split: int, label: str) -> None:
    """A KMeans fit in a split form against the f32 fit of the same run (see
    KM_FORM_RTOL): the same n_iter, centers matched one to one, cluster sizes
    and centers within their tolerances, inertia within 1e-4."""
    import torch

    C, Cr = model.cluster_centers_, ref.cluster_centers_
    perm = ((C[:, None, :] - Cr[None, :, :]) ** 2).sum(-1).argmin(1)
    require(sorted(perm) == list(range(len(Cr))), f"{label}: centers do not match one to one")
    sizes = np.array(model.summary.clusterSizes)
    moved = int(np.abs(sizes - np.array(ref.summary.clusterSizes)[perm]).sum())
    ties = int(near_ties(X, torch.from_numpy(Cr).cuda(), full=True, rtol=FIT_TIE_RTOL).sum())
    tol = KM_FORM_RTOL[n_split] * float(np.abs(Cr).max()) + moved * float(X.abs().max()) / max(
        int(sizes.min()), 1)
    dc = float(np.abs(C - Cr[perm]).max())
    in_rel = abs(model.inertia_ - ref.inertia_) / ref.inertia_
    log(f"  {label} against the f32 fit: n_iter {model.summary.numIter} ({ref.summary.numIter}), "
        f"cluster sizes apart by {moved} rows (near ties {ties}), centers at most {dc:.3e} "
        f"apart (tol {tol:.3e}), inertia rel diff {in_rel:.3e}")
    require(model.summary.numIter == ref.summary.numIter, f"{label}: n_iter differs")
    require(moved <= 2 * ties, f"{label}: {moved} rows changed cluster")
    require(dc <= tol and in_rel <= 1e-4, f"{label}: centers or inertia")


def topk_f64(Q, X, valid, k: int):
    """f64 on the card: per query the k + 1 smallest d2 over all items (invalid
    items at the sentinel), by chunks of items, and the largest valid x2."""
    import torch

    from spark_rapids_ml_torch.ops.selection import INVALID_D2

    Q64 = Q.double()
    q2 = (Q64 * Q64).sum(1)
    n = X.shape[0]
    kk = min(k + 1, n)
    best, x2max = None, 0.0
    rows = max(1, (1 << 27) // max(Q.shape[0], 1))
    for s in range(0, n, rows):
        x = X[s : s + rows].double()
        x2 = (x * x).sum(1)
        v = valid[s : s + rows]
        if bool(v.any()):
            x2max = max(x2max, float(x2[v].max()))
        d2 = (q2[:, None] - 2.0 * (Q64 @ x.T) + x2[None, :]).clamp_min(0.0)
        d2 = torch.where(v[None, :], d2, INVALID_D2)
        top = torch.topk(d2, min(kk, d2.shape[1]), dim=1, largest=False).values
        best = top if best is None else torch.topk(torch.cat([best, top], 1), kk, 1, largest=False).values
    return best, x2max


def check_topk_result(d2, ids, Q, X, valid, k: int, rows, ref, tol, label: str, dups=()):
    """Hold one (d2, ids) result to f64 on the query rows `rows` (ref from
    topk_f64 for those rows, tol per row): shapes, ascending, unique ids; each d2 within tol
    of its pair's f64 d2 and each rank within 2 tol of the f64 value at that
    rank; the sentinel tail exact: max(0, k - n_valid) earliest invalid ids in
    order at INVALID_D2; duplicate rows (a < b, X[a] == X[b], both valid): b
    only after a, at the same d2 bits."""
    import torch

    from spark_rapids_ml_torch.ops.selection import INVALID_D2

    nq, n = Q.shape[0], X.shape[0]
    k = min(k, n)
    require(tuple(d2.shape) == tuple(ids.shape) == (nq, k), f"topk {label}: shape {tuple(d2.shape)}")
    require(bool((d2[:, 1:] >= d2[:, :-1]).all()), f"topk {label}: not ascending")
    srt = ids.sort(1).values
    require(bool((srt[:, 1:] != srt[:, :-1]).all()) and int(ids.min()) >= 0 and int(ids.max()) < n,
            f"topk {label}: ids repeat or out of range")
    n_valid = int(valid.sum())
    n_tail = max(0, k - n_valid)
    inval = ~valid[ids.long()]
    require(bool((inval.sum(1) == n_tail).all()), f"topk {label}: sentinel tail length")
    if n_tail:
        first = (~valid).nonzero()[:n_tail, 0].to(ids.dtype)
        require(bool((ids[:, k - n_tail :] == first).all()), f"topk {label}: tail ids")
        require(bool((d2[:, k - n_tail :] == INVALID_D2).all()), f"topk {label}: tail values")
    for a, b in dups:
        rank_a = (ids == a).int().argmax(1)
        has_a, has_b = (ids == a).any(1), (ids == b).any(1)
        rank_b = (ids == b).int().argmax(1)
        require(bool((~has_b | (has_a & (rank_a < rank_b))).all()), f"topk {label}: duplicate {b} before {a}")
        both = has_a & has_b
        da = d2.gather(1, rank_a[:, None])[:, 0][both]
        db = d2.gather(1, rank_b[:, None])[:, 0][both]
        require(bool((da.view(torch.int32) == db.view(torch.int32)).all()), f"topk {label}: duplicate bits")
    Qs, ds, idss = Q[rows].double(), d2[rows].double(), ids[rows].long()
    v = valid[idss]
    d64 = ((X[idss].double() - Qs[:, None, :]) ** 2).sum(-1)
    d64 = torch.where(v, d64, INVALID_D2)
    err_pair = float(((ds - d64).abs() - tol[:, None]).max())
    err_rank = float(((d64 - ref[:, :k]).abs() - 2 * tol[:, None]).max())
    require(err_pair <= 0.0, f"topk {label}: a d2 is {err_pair:g} beyond tol from its f64 value")
    require(err_rank <= 0.0, f"topk {label}: a rank is {err_rank:g} beyond 2 tol from f64")
    return float(((ds - d64).abs() / tol[:, None]).max())


def check_topk(Q, X, valid, k: int, label: str, sample=None, dups=()):
    """The kernel and the plain version against f64 on `sample` query rows
    (all when None), and against each other on every row: their d2 within
    2 tol at every rank, so their ids can differ only between items that
    close. Returns (errs, kernel d2, kernel ids)."""
    import torch

    from spark_rapids_ml_torch.ops.topk import fused_topk, topk_plain

    dk, ik = fused_topk(Q, X, valid, k)
    dp, ip = topk_plain(Q, X, valid, k)
    torch.cuda.synchronize()
    rows = torch.arange(Q.shape[0], device=Q.device) if sample is None else sample
    ref, x2max = topk_f64(Q[rows], X, valid, k)
    tol_all = TOPK_RTOL * ((Q.double() ** 2).sum(1) + x2max)
    tol = tol_all[rows]
    e_k = check_topk_result(dk, ik, Q, X, valid, k, rows, ref, tol, f"{label} kernel", dups)
    # duplicates are held exactly in the kernel only: the plain version's exact
    # ties need cuBLAS to give equal columns equal bits, which it does not promise
    e_p = check_topk_result(dp, ip, Q, X, valid, k, rows, ref, tol, f"{label} plain")
    diff = (dk.double() - dp.double()).abs()
    require(bool((diff <= 2 * tol_all[:, None]).all()), f"topk {label}: kernel vs plain d2")
    mism = int((ik != ip).sum())
    log(f"  topk {label}: id mismatches kernel vs plain {mism} of {ik.numel()}; max d2 error "
        f"vs f64 / tol: kernel {e_k:.3f}, plain {e_p:.3f}; max |kernel - plain| d2 "
        f"{float(diff.max()):.4g}")
    return {"max_abs_err": float(diff.max())}, dk, ik


def check_topk_narrow(Q, X, valid, kc, precision: str, label: str, items=None):
    """A narrow form's kernel pool against its plain version's on the same
    inputs (finite queries), as TOPK_INT8_RTOL / topk_narrow_rtol say.
    Returns (errs, kernel d2, kernel ids)."""
    import torch

    from spark_rapids_ml_torch.ops.topk import fused_topk, topk_plain

    dk, ik = fused_topk(Q, X, valid, kc, precision=precision, items=items)
    dp, ip = topk_plain(Q, X, valid, kc, precision=precision, items=items)
    torch.cuda.synchronize()
    n = X.shape[0]
    kk = min(kc, n)
    require(tuple(dk.shape) == tuple(ik.shape) == tuple(dp.shape) == (Q.shape[0], kk),
            f"topk {precision} {label}: shape {tuple(dk.shape)}")
    x2 = (X * X).sum(1)
    x2max = float(x2[valid].max()) if bool(valid.any()) else 0.0
    tol = topk_narrow_rtol(precision, X.shape[1]) * ((Q * Q).sum(1) + x2max)
    diff = (dk.double() - dp.double()).abs()
    require(bool((dk[:, 1:] >= dk[:, :-1]).all()), f"topk {precision} {label}: not ascending")
    require(bool((diff <= tol[:, None]).all()), f"topk {precision} {label}: pool d2 beyond tol")
    dpd = dp.double()
    inf = torch.full_like(dpd[:, :1], float("inf"))
    gap_lo = torch.diff(dpd, dim=1, prepend=-inf)
    gap_hi = torch.diff(dpd, dim=1, append=inf if kk == n else -inf)  # the last rank: unsure
    sure = (gap_lo > 2 * tol[:, None]) & (gap_hi > 2 * tol[:, None])
    bad = int(((ik != ip) & sure).sum())
    require(bad == 0, f"topk {precision} {label}: {bad} ids differ from plain where separated")
    same = torch.equal(dk.view(torch.int32), dp.view(torch.int32)) and torch.equal(ik, ip)
    log(f"  topk {precision} {label}: pool ids differing from plain {int((ik != ip).sum())} of "
        f"{ik.numel()} (separated ranks {int(sure.sum())}, none differ there); max |kernel - "
        f"plain| d2 {float(diff.max()):.4g} = {float((diff / tol[:, None]).max()):.3f} tol; "
        f"bit-equal: {same}")
    return {"max_abs_err": float(diff.max())}, dk, ik


def check_rerank(Q, X, valid, k: int, precision: str, label: str, items=None):
    """exact_knn_single in a narrow form on the card: its (d2, ids) are
    parity_rerank_sq of its ids, bit for bit. Returns (d2, ids)."""
    import torch

    from spark_rapids_ml_torch.ops.knn import exact_knn_single, parity_rerank_sq

    d2, ids = exact_knn_single(Q, X, valid, k, precision=precision, items=items)
    d2b, idsb = parity_rerank_sq(Q, X, valid, ids, k)
    require(torch.equal(d2.view(torch.int32), d2b.view(torch.int32)) and torch.equal(ids, idsb),
            f"rerank {precision} {label}: the returned neighbors are not the re-rank of their ids")
    return d2, ids


# The narrow scan's edges (csrc/topk_narrow.cu, ops/topk.py::narrow_plan):
# padded widths of one chunk, a chunk and a bit, wider than the ring (a stage
# released a chunk at a time, by one or two warpgroups) and past the resident
# query tile (streamed queries at every pool); nq off both query blocks (64,
# 128); n below the pool; pools 9, 18, 250 and 256 (two warpgroups at 9 and 18
# while their queries stay resident, one above).
NARROW_EDGE_D = (1, 7, 24, 256, 257, 500, 1000, 1500)
NARROW_EDGE_SHAPES = ((130, 9_001, 9), (129, 20_011, 18), (65, 7_777, 250), (33, 200, 256))


def phase_small_narrow(torch) -> None:
    """The top-k kernel's bfloat16 and int8 forms (csrc/topk_narrow.cu)
    against their plain versions at the f32 form's small ragged shapes, at
    the narrow scan's edges (NARROW_EDGE_D x NARROW_EDGE_SHAPES, a masked
    fifth of the items: every plan, (consumers, resident queries, a whole
    tile in the ring)) and TOPK_HARD, and the re-rank invariant through
    exact_knn_single."""
    from spark_rapids_ml_torch.ops import topk as topk_mod
    from spark_rapids_ml_torch.ops.topk import fused_topk

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for precision in KNN_FORMS:
        cases, plans = 0, set()
        for nq, n in ((77, 5_003), (100, 50_003)):
            for d in (13, 32, 200):
                Q, X, valid, _ = topk_case(torch, nq, n, d, SEED + d + n, 0.2)
                items = topk_mod.narrow_rows(X, precision)
                for k in (1, 5, 33, 200, 256):
                    check_topk_narrow(Q, X, valid, k, precision, f"nq={nq} n={n} d={d} k={k}",
                                      items)
                    cases += 1
                for k in (1, 10, 200, 205):  # pools of 9, 18, 250 and 256
                    check_rerank(Q, X, valid, k, precision, f"nq={nq} n={n} d={d} k={k}", items)
        for d in NARROW_EDGE_D:
            for nq, n, kc in NARROW_EDGE_SHAPES:
                Q, X, valid, _ = topk_case(torch, nq, n, d, SEED + 300 + d + n, 0.2)
                items = topk_mod.narrow_rows(X, precision)
                plan = topk_mod.narrow_plan(nq, n, items.rows.shape[1], precision, min(kc, n), sms)
                plans.add((plan.consumers, plan.resident, plan.stages >= plan.chunks))
                check_topk_narrow(Q, X, valid, kc, precision,
                                  f"nq={nq} n={n} d={d} pool {kc} ({plan.consumers} warpgroups, "
                                  f"{'resident' if plan.resident else 'streamed'} queries, "
                                  f"{plan.stages} stages)", items)
                cases += 1
        require(plans == {(2, True, True), (2, True, False), (1, True, True), (1, True, False),
                          (1, False, False)},
                f"topk {precision}: the edge cases took the plans {sorted(plans)}")
        Q, X, valid, _ = topk_case(torch, 100, 50_003, 13, SEED + 5, 0.2)
        one = pinned_splits(topk_mod, 1, lambda: fused_topk(Q, X, valid, 200, precision=precision))
        for splits in (2, 7, 64):
            got = pinned_splits(topk_mod, splits,
                                lambda: fused_topk(Q, X, valid, 200, precision=precision))
            require(torch.equal(got[0], one[0]) and torch.equal(got[1], one[1]),
                    f"topk {precision}: {splits} splits differ from one")
        for i, (kind, nq, n, d, k, tail) in enumerate(TOPK_HARD):
            Q, X, valid = topk_hard_case(torch, kind, nq, n, d, SEED + 200 + i, tail)
            label = f"{kind} nq={nq} n={n} d={d} k={k}" + (" masked tail" if tail else "")
            _, dk, ik = check_topk_narrow(Q, X, valid, k, precision, label)
            cases += 1
            if kind == "duplicate":  # equal d2: the valid ids in order, then the sentinel tail
                order = torch.cat([valid.nonzero()[:, 0], (~valid).nonzero()[:, 0]])
                require(bool((ik == order[: min(k, n)].to(ik.dtype)[None, :]).all()),
                        f"topk {precision} {label}: ties not lowest id first")
        log(f"  topk {precision}: {cases} pools held to plain (the plans {sorted(plans)}), 24 "
            f"re-ranks bit-equal to parity_rerank_sq of their ids, 2 / 7 / 64 item ranges "
            f"equal to one")


def phase_small_nonfinite(torch) -> None:
    """A kernel never turns NaN into a number: count with NaN query and item
    rows equals the plain count (NaN rows count nothing); the top-k kernel's
    f32 and narrow forms give the plain version's ids for NaN query rows, and
    never return a NaN item (a NaN norm makes it invalid) while finite items
    fill k; assign and Lloyd send a NaN row to center 0, as their plain
    versions do."""
    from spark_rapids_ml_torch.ops import lloyd as lloyd_mod
    from spark_rapids_ml_torch.ops import select as select_mod
    from spark_rapids_ml_torch.ops.count import count_below_plain, fused_count_below
    from spark_rapids_ml_torch.ops.topk import fused_topk, topk_plain

    nan = float("nan")
    rng = np.random.default_rng(SEED + 300)
    Xh, _ = blobs(5_003, 32, 5, SEED + 300, spread=3.0)
    X = torch.from_numpy(Xh).cuda()
    Q = X[torch.from_numpy(rng.choice(5_003, 1_777)).cuda()].clone()
    qbad, xbad = [0, 63, 64, 1_000], [5, 700, 5_002]
    Q[qbad, 3] = nan
    X[xbad, 0] = nan
    valid = torch.from_numpy(rng.random(5_003) > 0.2).cuda()
    valid[xbad] = True
    eps2 = float(torch.quantile(((Q[100:300, None, :] - X[None, 1000:3000, :]) ** 2).sum(-1)
                                .flatten(), 0.05))
    _, ck, cp, _ = check_count(Q, X, valid, eps2, f"NaN rows nq=1777 n=5003 d=32 eps2={eps2:.4g}")
    require(bool((ck[qbad] == 0).all()) and bool((cp[qbad] == 0).all()),
            "count: a NaN query counted an item")
    require(torch.equal(fused_count_below(X, X, valid, eps2)[xbad].cpu(),
                        torch.zeros(len(xbad), dtype=torch.int32)), "count: a NaN item counted")
    require(torch.equal(count_below_plain(X, X, valid, eps2)[xbad].cpu(),
                        torch.zeros(len(xbad), dtype=torch.int32)), "plain count: a NaN item counted")
    X[xbad, 0] = 1.0  # finite items below: the top-k NaN-query cases
    for precision in ("float32",) + KNN_FORMS:
        for mask in (0.0, 0.2):
            valid_t = torch.from_numpy(rng.random(5_003) >= mask).cuda()
            for k in (5, 200):
                dk, ik = fused_topk(Q, X, valid_t, k, precision=precision)
                dp, ip = topk_plain(Q, X, valid_t, k, precision=precision)
                require(torch.equal(ik[qbad], ip[qbad]),
                        f"topk {precision} k={k} mask={mask}: NaN-query ids differ from plain")
                require(torch.equal(dk[qbad].isnan(), dp[qbad].isnan())
                        and torch.equal(dk[qbad].nan_to_num(), dp[qbad].nan_to_num()),
                        f"topk {precision} k={k} mask={mask}: NaN-query d2 differ from plain")
                clean = Q.clone()
                clean[qbad] = 0.0
                dc, ic = fused_topk(clean, X, valid_t, k, precision=precision)
                ok = torch.ones(Q.shape[0], dtype=torch.bool, device="cuda")
                ok[qbad] = False
                require(torch.equal(dk[ok], dc[ok]) and torch.equal(ik[ok], ic[ok]),
                        f"topk {precision}: NaN queries changed another query's answer")
        X[xbad, 0] = nan
        Qf = Q[100:1_000]  # finite queries
        kn = fused_topk(Qf, X, valid, 200, precision=precision)
        masked = valid.clone()
        masked[xbad] = False
        km = fused_topk(Qf, X, masked, 200, precision=precision)
        require(torch.equal(kn[0], km[0]) and torch.equal(kn[1], km[1]),
                f"topk {precision}: a NaN item is not taken as invalid")
        require(not bool(torch.isin(kn[1], torch.tensor(xbad, device="cuda")).any()),
                f"topk {precision}: a NaN item was returned")
        X[xbad, 0] = 1.0
    C = X[torch.from_numpy(rng.choice(5_003, 20, replace=False)).cuda()].clone()
    Xa = X.clone()
    Xa[[7, 4_001], 2] = nan
    for n_split in (3, 2):
        lk, lp = select_mod.assign(Xa, C, n_split), select_mod.assign_plain(Xa, C, n_split)
        require(int(lk[7]) == int(lk[4_001]) == int(lp[7]) == int(lp[4_001]) == 0,
                f"assign n_split={n_split}: a NaN row is not sent to center 0")
    fine = torch.ones(Xa.shape[0], dtype=torch.bool, device="cuda")
    fine[[7, 4_001]] = False
    two = torch.zeros(20, device="cuda")
    two[0] = 2.0
    for n_split in (3, 2, 1):
        for step in (lloyd_mod.lloyd_step, lloyd_mod.lloyd_step_plain):
            c_all = step(Xa, C, Xa.shape[0], None, n_split)[1]
            c_fine = step(Xa[fine].contiguous(), C, Xa.shape[0] - 2, None, n_split)[1]
            require(torch.equal(c_all - c_fine, two),
                    f"{step.__name__} n_split={n_split}: NaN rows not in center 0")
    log(f"  non-finite: count with {len(qbad)} NaN queries and {len(xbad)} NaN items equal to "
        f"plain (NaN rows count 0); top-k f32 / bf16 / int8 NaN-query ids equal to plain, NaN "
        f"items never returned; assign (n_split 3, 2) and Lloyd (3, 2, 1) put NaN rows in "
        f"center 0")


def phase_small_hist_determinism(torch) -> None:
    """The histogram kernels on real-valued stats (uniform(0, 2) weights times
    normal labels, as a regressor's w y): three launches give the same bits,
    within HIST_RTOL of plain."""
    from spark_rapids_ml_torch.ops import histogram as H

    for n, d, s, width, nbins in [(100_003, 64, 3, 32, 32), (20_011, 7, 5, 300, 256),
                                  (100_003, 64, 2, 1, 32), (10_007, 13, 1, 16, 256)]:
        rng = np.random.default_rng(SEED + 400 + n + d)
        to = lambda a: torch.from_numpy(a).cuda()
        Xb = to(rng.integers(0, nbins, size=(n, d)).astype(np.int32))
        node = to(rng.integers(0, width, size=(n,)).astype(np.int32))
        v = to((rng.uniform(0, 2, (n, 1)) * rng.normal(size=(n, s))).astype(np.float32))
        runs = [H.node_bin_histogram(Xb, node, v, width, nbins) for _ in range(3)]
        require(all(torch_equal_bits(r, runs[0]) for r in runs[1:]),
                f"hist n={n} d={d} s={s} width={width}: launches differ in their bits")
        plain = H.node_bin_histogram_plain(Xb, node, v, width, nbins)
        check_hist(runs[0], plain, H.node_bin_histogram_plain(Xb, node, v.abs(), width, nbins),
                   False, f"real stats n={n} d={d} s={s} width={width} nbins={nbins}")
        seg = node[:, None] * nbins + Xb
        runs = [H.segment_histogram(seg, v, width * nbins) for _ in range(3)]
        require(all(torch_equal_bits(r, runs[0]) for r in runs[1:]),
                f"segment hist n={n} d={d} s={s}: launches differ in their bits")
        check_hist(runs[0], H.segment_histogram_plain(seg, v, width * nbins),
                   H.segment_histogram_plain(seg, v.abs(), width * nbins), False,
                   f"segment real stats n={n} d={d} s={s} n_segments={width * nbins}")
    log("  hist: real-valued stats, 3 launches of each kernel bit-equal at 4 shapes, within "
        f"{HIST_RTOL} of plain")


def phase_small(torch) -> None:
    log("phase 2a: kernels against plain at small ragged shapes")
    n = 10_007  # not a multiple of any block
    n_valid = n - 123
    for d in (3, 130, 256):
        Xh, _ = blobs(n, d, 7, SEED + d, spread=3.0)
        Xh += np.float32(1.5)  # offset columns: the mean correction matters
        X = torch.from_numpy(Xh).cuda()
        check_xtx(X, n_valid, f"n={n} n_valid={n_valid} d={d}")
        check_xtx(X, n, f"n={n} n_valid={n} d={d}")
        rng = np.random.default_rng(SEED + 1)
        w = torch.from_numpy(rng.integers(0, 3, n).astype(np.float32)).cuda()  # zeros too
        for k in (1, 20, 257):
            C = X[torch.from_numpy(rng.choice(n, k, replace=False)).cuda()].clone()
            C += 0.01 * torch.randn(C.shape, device=C.device, generator=torch.Generator("cuda").manual_seed(k))
            check_lloyd(X, C, n_valid, None, f"unit n={n} n_valid={n_valid} d={d} k={k}")
            check_lloyd(X, C, n, w, f"weighted n={n} d={d} k={k}")
            check_assign(X, C, f"n={n} d={d} k={k}")
            phase_split_forms(torch, X, C, w, n_valid, f"n={n} d={d} k={k}", main=False)
    for d in (1, 33, 257):
        Xh, _ = blobs(n, d, 7, SEED + 3 * d, spread=3.0)
        Xh += np.float32(1.5)
        yh = regression_label(Xh, SEED + d)
        X, y = torch.from_numpy(Xh).cuda(), torch.from_numpy(yh).cuda()
        check_xtxy(X, y, n_valid, f"n={n} n_valid={n_valid} d={d}")
        check_xtxy(X, y, n, f"n={n} n_valid={n} d={d}")
        for nv in (n_valid, n):
            check_gram_split(X, y, nv, f"n={n} n_valid={nv} d={d}")
    # the Gram kernel's edges: d off the 128-column tile and the mma depth of 8,
    # one column, one past a tile; n_valid 0, 1 and off every 32-row step,
    # chunk and tile edge
    for d in (1, 7, 129, 257):
        Xh, _ = blobs(n, d, 7, SEED + 5 * d, spread=3.0)
        Xh += np.float32(1.5)
        yh = regression_label(Xh, SEED + 2 * d)
        X, y = torch.from_numpy(Xh).cuda(), torch.from_numpy(yh).cuda()
        for nv in (0, 1, 4_099, n_valid):
            check_xtx(X, nv, f"n={n} n_valid={nv} d={d}")
            check_xtxy(X, y, nv, f"n={n} n_valid={nv} d={d}")
            check_gram_split(X, y, nv, f"n={n} n_valid={nv} d={d}")
        Xs, ys = split_data(torch, 401, d)  # every sum of part products exact
        check_gram_split(Xs, ys, 401, f"n=401 d={d}", SPLIT_RTOL_EXACT)
    nq, n_items = 1_777, 5_003  # Q and X differ, neither a multiple of a tile
    for d in (3, 32, 33, 130):  # d <= 32 keeps the query tile resident
        rng = np.random.default_rng(SEED + 100 + d)
        Xh, _ = blobs(n_items, d, 5, SEED + 100 + d, spread=3.0)
        Qh = Xh[rng.choice(n_items, nq)] + rng.normal(0, 0.3, (nq, d)).astype(np.float32)
        X, Q = torch.from_numpy(Xh).cuda(), torch.from_numpy(Qh).cuda()
        valid = torch.from_numpy(rng.random(n_items) > 0.2).cuda()  # holes
        sample = ((Q[:200, None, :].double() - X[None, :, :].double()) ** 2).sum(-1)
        for q in (0.02, 0.2):  # two eps^2 in one build: a runtime operand
            eps2 = float(torch.quantile(sample.flatten()[:1 << 20], q))
            check_count(Q, X, valid, eps2, f"nq={nq} n={n_items} d={d} eps2={eps2:.4g}")
    phase_small_nearest_edges(torch)
    phase_small_count_edges(torch)
    phase_small_topk(torch)
    phase_small_probe(torch)
    phase_small_narrow(torch)
    phase_small_nonfinite(torch)
    phase_small_hist(torch)
    phase_small_hist_determinism(torch)
    phase_small_no_rows(torch)
    torch.cuda.synchronize()


def phase_small_no_rows(torch) -> None:
    """X with no rows (the empty partition of a multi-process fit): xtx, xtxy,
    the Lloyd step in its unit and weighted forms and assign give zeros (no
    labels) and launch nothing."""
    from spark_rapids_ml_torch.ops import xtwx
    from spark_rapids_ml_torch.ops.lloyd import lloyd_step
    from spark_rapids_ml_torch.ops.select import assign

    counters = launch_counters()
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    for d in (1, 37, 256):
        X = torch.empty((0, d), device="cuda")
        y, w = torch.empty((0,), device="cuda"), torch.empty((0,), device="cuda")
        C = torch.randn((20, d), device="cuda")
        outs = [*xtwx.xtx(X, 0), *xtwx.xtxy(X, y, 0), *lloyd_step(X, C, 0),
                *lloyd_step(X, C, 0, w), *xtwx.xtx(X, 0, 2), *lloyd_step(X, C, 0, None, 1)]
        require(all(bool((t == 0).all()) for t in outs), f"no rows d={d}: a statistic is not 0")
        require(assign(X, C).shape == (0,), f"no rows d={d}: assign returned labels")
    launched = {name: getattr(fn, attr) for name, (fn, attr) in counters.items()
                if getattr(fn, attr)}
    require(not launched, f"no rows: launches {launched}")
    log("  no rows (d 1, 37, 256): xtx, xtxy, the Lloyd forms and assign give zeros, no launch")


def phase_small_nearest_edges(torch) -> None:
    """The nearest-center tile of the Lloyd and assignment kernels
    (csrc/nearest.cuh) at its edges, in all six Lloyd forms (unit and weighted,
    n_split 3, 1, 2) and both assign forms (3, 2), each against its plain
    version (check_lloyd, check_assign): k 1, 8, 9, 20, 24, 25, 81 and 257 (one
    n8 fragment, one past it, the main path's 20 and its pad 24, one past, the
    k-means|| candidates, more than an 88-center chunk and, at d = 256,
    centers that are not resident); d 3, 7, 130, 256 and 513 (off the mma
    depth, whole rows at R 128 to 16, and column chunks where the centers'
    parts crowd the ring); n_valid off the plan's R and so off its stage, blocks ending
    inside a tile; n 1, 63 and 65 around a 64-row tile, n_valid 0 and n - 1."""
    from spark_rapids_ml_torch.ops import lloyd as lloyd_mod
    from spark_rapids_ml_torch.ops import select as select_mod

    n = 10_007
    plans = set()
    for d in (3, 7, 130, 256, 513):
        Xh, _ = blobs(n, d, 7, SEED + 11 * d, spread=3.0)
        X = torch.from_numpy(Xh).cuda()
        rng = np.random.default_rng(SEED + 12 + d)
        w = torch.from_numpy(rng.integers(0, 3, n).astype(np.float32)).cuda()  # zeros too
        for k in (1, 8, 9, 20, 24, 25, 81, 257):
            C = X[torch.from_numpy(rng.choice(n, k, replace=False)).cuda()].clone()
            C += 0.01 * torch.randn(C.shape, device="cuda",
                                    generator=torch.Generator("cuda").manual_seed(k + d))
            for n_split in (3, 1, 2):
                g = lloyd_mod._plan(n, k, d, n_split)
                plans.add((g["R"], g["DC"], g["resident"], g["CK"], g["x_reads"]))
                nv = n - 123 if (n - 123) % g["R"] else n - 124
                check_lloyd(X, C, nv, None, f"edge unit n={n} n_valid={nv} d={d} k={k}", n_split)
                check_lloyd(X, C, n, w, f"edge weighted n={n} d={d} k={k}", n_split)
            for n_split in (3, 2):
                g = select_mod._plan(n, k, d, n_split)
                plans.add((g["R"], g["DC"], g["resident"], g["CK"], g["x_reads"]))
                check_assign(X, C, f"edge n={n} d={d} k={k}", n_split)
    for n_t in (1, 63, 65):
        Xh, _ = blobs(n_t, 7, 3, SEED + n_t, spread=3.0)
        X = torch.from_numpy(Xh).cuda()
        w = torch.from_numpy(np.arange(n_t, dtype=np.float32) % 3).cuda()
        Ch, _ = blobs(9, 7, 3, SEED + 100 + n_t, spread=3.0)  # k = 9 > n at n = 1
        C = torch.from_numpy(Ch).cuda()
        for n_split in (3, 1, 2):
            for nv in sorted({0, n_t - 1, n_t}):
                check_lloyd(X, C, nv, None, f"edge unit n={n_t} n_valid={nv} d=7", n_split)
            check_lloyd(X, C, n_t, w, f"edge weighted n={n_t} d=7", n_split)
        for n_split in (3, 2):
            check_assign(X, C, f"edge n={n_t} d=7", n_split)
    log(f"  nearest tile edges: every form against plain; plans (R, DC, resident, CK, "
        f"x_reads) exercised: {sorted(plans)}")


def phase_small_count_edges(torch) -> None:
    """The tensor-core count at the edges of its tiles: nq and n off the
    128-query and 128-item tiles (and below them), d off the mma depth of 8
    and the 32-column stage (1, 7, 31, 33, 257; 33 and 257 pass the query
    tile through the ring, d <= 32 keeps it in registers), Q a subset of X
    (self pairs) and not, eps2 = 0, and every item invalid."""
    from spark_rapids_ml_torch.ops.count import fused_count_below

    cases = [(1_001, 3_001, 1), (129, 127, 7), (1_001, 3_001, 31), (127, 3_001, 33),
             (1_001, 1_153, 257)]
    for nq, n_items, d in cases:
        rng = np.random.default_rng(SEED + 300 + d)
        Xh, _ = blobs(n_items, d, 5, SEED + 300 + d, spread=3.0)
        X = torch.from_numpy(Xh).cuda()
        valid = torch.from_numpy(rng.random(n_items) > 0.1).cuda()
        for Q, what in ((X[:nq].clone(), "Q = X[:nq]"),
                        (X[torch.from_numpy(rng.choice(n_items, nq)).cuda()]
                         + 0.3 * torch.randn((nq, d), device="cuda"), "Q fresh")):
            sample = ((Q[:100, None, :].double() - X[None, :, :].double()) ** 2).sum(-1)
            for eps2 in (0.0, float(torch.quantile(sample.flatten(), 0.1))):
                check_count(Q, X, valid, eps2, f"{what} nq={nq} n={n_items} d={d} eps2={eps2:.4g}")
        none = torch.zeros(n_items, dtype=torch.bool, device="cuda")
        got = fused_count_below(X[:nq].contiguous(), X, none, 1e30)
        require(int(got.abs().sum()) == 0, f"count d={d}: an invalid item was counted")
    log(f"  count edges: {len(cases)} shapes (nq and n off 128, d 1/7/31/33/257), self "
        f"pairs and fresh queries, eps2 0 and a quantile, every item invalid")


# The IVF probe's small cases: (nq, nlist, d, nprobes). nq and nlist around
# the distance pass's 128-row tiles, d off its 32-column stage and its
# 16-byte copies; pass 2 with the row in shared memory, the row in device
# memory (nlist 60,000), and the sort buffer in device memory (nprobe
# 20,000: 32,768 words); nprobe 1, 256, 257 and nlist.
PROBE_SMALL = [
    (1, 1, 3, (1,)), (77, 300, 13, (1, 5, 256, 257, 300)), (129, 2_100, 256, (1, 262, 2_100)),
    (300, 4_097, 33, (32, 512)), (100, 60_000, 17, (100, 8_192)), (40, 20_000, 8, (20_000,)),
]


def probe_case(torch, nq: int, nlist: int, d: int, seed: int, device="cuda"):
    """Centers from blobs with center 1 repeated at nlist // 2 and nlist - 1,
    half the queries near centers (query 0 within 1e-3 of center 1), the
    rest fresh: (Q, C, their norms, the duplicate pairs)."""
    rng = np.random.default_rng(seed)
    Ch, _ = blobs(nlist, d, 7, seed, spread=3.0)
    dups = ()
    if nlist >= 4:
        Ch[nlist // 2] = Ch[nlist - 1] = Ch[1]
        dups = ((1, nlist // 2), (nlist // 2, nlist - 1))
    near = Ch[rng.integers(0, nlist, nq // 2)] + rng.normal(0, 0.3, (nq // 2, d))
    fresh = Ch[rng.integers(0, nlist, nq - nq // 2)] + rng.normal(0, 2.0, (nq - nq // 2, d))
    Qh = np.concatenate([near, fresh]).astype(np.float32)
    Qh[0] = Ch[min(1, nlist - 1)] + np.float32(1e-3)
    C = torch.from_numpy(Ch).to(device)
    return torch.from_numpy(Qh).to(device), C, torch.sum(C * C, dim=1), dups


def phase_small_probe(torch, device="cuda") -> None:
    """The IVF probe kernel (csrc/probe.cu) against its plain version and f64
    at PROBE_SMALL (check_probe); its query blocks (a small scratch budget:
    128- and 50-query launches) give one launch's bits and count one launch
    a call; NaN query rows give the plain version's ids (all keys equal: ids
    0 .. nprobe - 1), NaN d2, and change no other row. On CPU tensors (a
    rehearsal) the kernel's place is taken by the plain version and nothing
    is counted."""
    from spark_rapids_ml_torch.ops import topk as topk_mod

    t0 = time.perf_counter()
    for nq, nlist, d, nprobes in PROBE_SMALL:
        Q, C, cn, dups = probe_case(torch, nq, nlist, d, SEED + 400 + nlist + d, device)
        for nprobe in nprobes:
            plan = topk_mod.probe_plan(nq, nlist, nprobe)
            check_probe(torch, Q, C, cn, nprobe, f"nq={nq} nlist={nlist} d={d} ({plan.row_smem=}, "
                        f"{plan.sort_smem=}, sort {plan.sort_size})", dups)
    Q, C, cn, _ = probe_case(torch, 300, 2_100, 64, SEED + 401, device)
    one = topk_mod.probe_topk(Q, C, 262, center_norms=cn)
    saved = topk_mod.PROBE_SCRATCH_BYTES
    try:
        for budget, want in ((128 * 2_100 * 4, 128), (50 * 2_100 * 4 + 3, 50)):
            topk_mod.PROBE_SCRATCH_BYTES = budget
            plan = topk_mod.probe_plan(300, 2_100, 262)
            require(plan.q_block == want, f"probe plan at budget {budget}: {plan}")
            before = topk_mod.fused_probe.launches
            got = topk_mod.probe_topk(Q, C, 262, center_norms=cn)
            require(topk_mod.fused_probe.launches == before + (device == "cuda"),
                    f"probe: {topk_mod.fused_probe.launches - before} counts for one call")
            require(torch.equal(got[0], one[0]) and torch.equal(got[1], one[1]),
                    f"probe: {plan.n_blocks} launches of {want} queries differ from one launch")
    finally:
        topk_mod.PROBE_SCRATCH_BYTES = saved
    # a crowded row: 290 copies of one center, more than a counting-sort bin
    # takes (the bitonic sort) and more than nprobe ties at the cut
    Q, C, cn, _ = probe_case(torch, 77, 2_100, 13, SEED + 403, device)
    C[10:300] = C[5]
    Q[:40] = C[5] + 0.01 * torch.arange(13, device=device, dtype=torch.float32)
    cn = torch.sum(C * C, dim=1)
    for nprobe in (40, 257, 400):
        check_probe(torch, Q, C, cn, nprobe, f"crowded nq=77 nlist=2100 d=13",
                    ((5, 10), (10, 299)))
    nan = float("nan")
    Q, C, cn, _ = probe_case(torch, 77, 300, 13, SEED + 402, device)
    bad = [0, 5, 76]
    Qn = Q.clone()
    Qn[bad, 2] = nan
    valid = torch.ones(300, dtype=torch.bool, device=device)
    for nprobe in (5, 257):
        dk, ik = topk_mod.probe_topk(Qn, C, nprobe, center_norms=cn)
        dp, ip = topk_mod.topk_plain(Qn, C, valid, nprobe, x2=cn)
        dc, ic = topk_mod.probe_topk(Q, C, nprobe, center_norms=cn)
        ok = torch.ones(77, dtype=torch.bool, device=device)
        ok[bad] = False
        require(torch.equal(ik[bad], ip[bad]) and bool(dk[bad].isnan().all())
                and bool(dp[bad].isnan().all()),
                f"probe nprobe={nprobe}: NaN-query ids or d2 differ from plain")
        require(torch.equal(dk[ok], dc[ok]) and torch.equal(ik[ok], ic[ok]),
                f"probe nprobe={nprobe}: NaN queries changed another query's answer")
    log("  probe: query blocks of 128 and 50 equal one launch, one count a call; NaN query "
        f"rows give plain's ids and NaN d2, other rows unchanged ({time.perf_counter() - t0:.1f} s "
        "for the probe's cases)")


def topk_case(torch, nq: int, n: int, d: int, seed: int, mask: float):
    """Blobs with queries from X and fresh points, rows 2 and 3 duplicated at
    n // 2 and n // 2 + 1 (kept valid), a random mask: (Q, X, valid, dups)."""
    rng = np.random.default_rng(seed)
    Xh, _ = blobs(n, d, 5, seed, spread=3.0)
    Xh[n // 2], Xh[n // 2 + 1] = Xh[2], Xh[3]
    Qh = np.concatenate([Xh[: nq // 2], Xh[rng.choice(n, nq - nq // 2)]
                         + rng.normal(0, 0.3, (nq - nq // 2, d)).astype(np.float32)])
    valid = rng.random(n) >= mask
    valid[[2, 3, n // 2, n // 2 + 1]] = True
    to = lambda a: torch.from_numpy(a).cuda()
    return to(Qh), to(Xh), to(valid), ((2, n // 2), (3, n // 2 + 1))


def pinned_splits(topk_mod, splits: int, call):
    """`call()` with the top-k wrapper's item ranges pinned to `splits`."""
    topk_mod._pin_splits = splits
    try:
        return call()
    finally:
        topk_mod._pin_splits = None


def phase_small_topk(torch) -> None:
    from spark_rapids_ml_torch.ops import topk as topk_mod
    from spark_rapids_ml_torch.ops.topk import fused_topk

    for nq, n in ((77, 5_003), (100, 50_003)):  # one split, and twelve merged
        for d in (13, 32, 200):
            Q, X, valid, dups = topk_case(torch, nq, n, d, SEED + d + n, 0.2)
            for k in (1, 5, 33, 200, 256):
                check_topk(Q, X, valid, k, f"nq={nq} n={n} d={d} k={k}", dups=dups)
    Q, X, valid, dups = topk_case(torch, 100, 50_003, 13, SEED + 5, 0.2)
    for k in (33, 200):
        one = pinned_splits(topk_mod, 1, lambda: fused_topk(Q, X, valid, k))
        for splits in (2, 7, 64):  # the merge of split pools changes nothing
            got = pinned_splits(topk_mod, splits, lambda: fused_topk(Q, X, valid, k))
            require(torch.equal(got[0], one[0]) and torch.equal(got[1], one[1]),
                    f"topk k={k}: {splits} splits differ from one")
    Q, X, valid, dups = topk_case(torch, 40, 1_000, 13, SEED + 6, 0.0)
    valid[:] = False
    valid[[17, 120, 750]] = True  # k > n_valid: the earliest invalid ids at the sentinel
    check_topk(Q, X, valid, 8, "nq=40 n=1000 n_valid=3 k=8")
    check_topk(Q, X, valid, 256, "nq=40 n=1000 n_valid=3 k=256")
    Q, X, valid, dups = topk_case(torch, 10, 20, 13, SEED + 7, 0.3)
    check_topk(Q, X, valid, 256, "nq=10 n=20 k=256 (clamps to 20)", dups=dups)
    phase_small_topk_hard(torch)


# The selection's hard cases: (kind, nq, n, d, k, masked tail). nq around the
# 64-query tile, n off the 128-item tile and below k, d off the mma depth of 8.
TOPK_HARD = [
    ("descending", 1, 5_003, 3, 200, False), ("descending", 63, 5_003, 33, 256, True),
    ("descending", 64, 20_011, 256, 1, False), ("descending", 65, 20_011, 127, 200, True),
    ("descending", 100, 50_003, 1, 256, False),
    ("duplicate", 1, 777, 3, 256, True), ("duplicate", 65, 5_003, 33, 200, False),
    ("duplicate", 100, 10_007, 256, 1, True), ("duplicate", 64, 150, 127, 200, False),
    ("blobs", 63, 150, 1, 200, True), ("blobs", 65, 1_000, 256, 256, False),
    ("blobs", 100, 9_999, 127, 1, True),
]


def topk_hard_case(torch, kind: str, nq: int, n: int, d: int, seed: int, tail: bool):
    """(Q, X, valid). "descending": items at radii falling with their id around
    queries at (or within 1e-3 of) the origin, so nearly every item is closer
    than every one before it and every candidate passes the running k-th key;
    "duplicate": every item the same point, ties only; "blobs": a mixture.
    With `tail`, the last quarter of the items is invalid."""
    rng = np.random.default_rng(seed)
    if kind == "descending":
        u = rng.standard_normal((n, d))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        Xh = (np.linspace(20.0, 1.0, n)[:, None] * u).astype(np.float32)
        Qh = (1e-3 * rng.standard_normal((nq, d))).astype(np.float32)
        Qh[0] = 0.0
    elif kind == "duplicate":
        Xh = np.repeat(rng.normal(0.0, 3.0, (1, d)), n, axis=0).astype(np.float32)
        Qh = rng.normal(0.0, 3.0, (nq, d)).astype(np.float32)
    else:
        Xh, _ = blobs(n, d, 5, seed, spread=3.0)
        Qh = Xh[rng.choice(n, nq)] + rng.normal(0, 0.3, (nq, d)).astype(np.float32)
    valid = np.ones(n, bool)
    if tail:
        valid[n - n // 4 :] = False
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    return to(Qh), to(Xh), to(valid)


def phase_small_topk_hard(torch) -> None:
    for i, (kind, nq, n, d, k, tail) in enumerate(TOPK_HARD):
        Q, X, valid = topk_hard_case(torch, kind, nq, n, d, SEED + 200 + i, tail)
        label = f"{kind} nq={nq} n={n} d={d} k={k}" + (" masked tail" if tail else "")
        _, dk, ik = check_topk(Q, X, valid, k, label)
        if kind == "duplicate":  # equal d2: the valid ids in order, then the sentinel tail
            order = torch.cat([valid.nonzero()[:, 0], (~valid).nonzero()[:, 0]])
            kk = min(k, n)
            require(bool((ik == order[:kk].to(ik.dtype)[None, :]).all()),
                    f"topk {label}: ties not lowest id first")
            nv = min(kk, int(valid.sum()))
            bits = dk[:, :nv].contiguous().view(torch.int32)
            require(bool((bits == bits[:, :1]).all()), f"topk {label}: tied d2 bits differ")
    log(f"  topk: {len(TOPK_HARD)} hard cases (descending distances, all-duplicate items, "
        f"n < k, masked tails) held to f64 and plain; ties lowest id first")


def check_hist(got, plain, abs_plain, exact: bool, label: str) -> float:
    """Kernel histogram against the plain version: bit for bit when the stats
    are integers, else within HIST_RTOL of each bin's sum of |val|. Returns the
    max abs difference."""
    require(got.shape == plain.shape, f"hist {label}: shape {tuple(got.shape)}")
    err = float((got - plain).abs().max()) if got.numel() else 0.0
    if exact:
        require(bool(torch_equal_bits(got, plain)), f"hist {label}: not bit-equal to plain ({err})")
    else:
        bad = (got - plain).abs() > HIST_RTOL * abs_plain + 1e-30
        require(not bool(bad.any()), f"hist {label}: beyond {HIST_RTOL} of sum |val| ({err})")
    return err


def torch_equal_bits(a, b) -> bool:
    import torch

    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def phase_small_hist(torch) -> None:
    """The node x bin and segment kernels at tests/test_pallas_histogram.py's
    cases (ragged rows, width 300 over several node tiles, odd d, the root
    level), and at 256 bins with s in {1, 2, 3, 5}: integer stats bit for
    bit, normal stats within HIST_RTOL; node ids of -1 and out of range, and
    bins out of range, add nothing. Then the forest's uint8 bins (and int32 at
    257 bins) at the redesigned kernel's edges: n off the stage (1,024 rows)
    and the 32-row group, d 1, 15, 17, 33 and 64 (off the 32-feature tile and
    the 16-byte row copy), widths 1-64, nbins 2, 32, 255, 256 and 257, s 2, 3
    and 5, rows with zero stats (skipped by the kernel) and -0 stats; on
    normal stats also three launches bit-equal."""
    from spark_rapids_ml_torch.ops import histogram as H

    to = lambda a: torch.from_numpy(a).cuda()
    cases = [(700, 4, 3, 8, 16, np.int32), (1024, 2, 5, 256, 8, np.int32),
             (300, 9, 1, 300, 32, np.int32), (50, 3, 2, 1, 4, np.int32),
             (10_007, 13, 1, 16, 256, np.int32), (10_007, 64, 2, 32, 256, np.int32),
             (10_007, 5, 3, 64, 256, np.int32), (100_003, 64, 2, 32, 32, np.int32),
             (20_011, 7, 5, 300, 256, np.int32),
             (10_007, 1, 2, 1, 2, np.uint8), (1_025, 15, 3, 3, 32, np.uint8),
             (20_011, 17, 5, 64, 255, np.uint8), (30_001, 64, 2, 32, 256, np.uint8),
             (4_133, 64, 3, 7, 32, np.uint8), (2_047, 33, 2, 17, 257, np.int32),
             (1_057, 64, 5, 1, 256, np.uint8), (100_003, 64, 3, 32, 32, np.uint8),
             (100_003, 64, 2, 1, 32, np.uint8), (65_537, 17, 2, 2, 32, np.uint8)]
    for n, d, s, width, nbins, dtype in cases:
        rng = np.random.default_rng(SEED + n + d)
        Xb = rng.integers(0, nbins, size=(n, d)).astype(dtype)
        if nbins < 256 or dtype == np.int32:
            Xb[::97, 0] = nbins  # out of range: matches nothing
        node = rng.integers(-1, width + 1, size=(n,)).astype(np.int32)  # -1 and width drop
        label = f"n={n} d={d} s={s} width={width} nbins={nbins} {np.dtype(dtype).name}"
        for exact in (True, False):
            v = (rng.poisson(1.0, (n, s)) if exact else rng.normal(size=(n, s))).astype(np.float32)
            if dtype == np.uint8:
                v[::5] = 0.0  # zero-stat rows
                v[1::10] *= np.float32(-0.0)  # and -0 ones
            args = (to(Xb), to(node), to(v))
            got = H.node_bin_histogram(*args, width, nbins)
            plain = H.node_bin_histogram_plain(*args, width, nbins)
            absp = H.node_bin_histogram_plain(args[0], args[1], args[2].abs(), width, nbins)
            check_hist(got, plain, absp, exact, label)
            if not exact and dtype == np.uint8:
                again = [H.node_bin_histogram(*args, width, nbins) for _ in range(2)]
                require(all(torch_equal_bits(a, got) for a in again),
                        f"hist {label}: launches differ in their bits")
    for n, d, s, n_seg in [(700, 4, 3, 96), (1024, 2, 5, 2048), (50, 3, 1, 7),
                           (100_003, 64, 2, 1024), (20_011, 3, 3, 100_000)]:
        rng = np.random.default_rng(SEED + n + s)
        seg = rng.integers(-1, n_seg + 1, size=(n, d)).astype(np.int32)
        for exact in (True, False):
            v = (rng.poisson(1.0, (n, s)) if exact else rng.normal(size=(n, s))).astype(np.float32)
            sg, vt = torch.from_numpy(seg).cuda(), torch.from_numpy(v).cuda()
            got = H.segment_histogram(sg, vt, n_seg)
            plain = H.segment_histogram_plain(sg, vt, n_seg)
            absp = H.segment_histogram_plain(sg, vt.abs(), n_seg)
            check_hist(got, plain, absp, exact, f"segment n={n} d={d} s={s} n_segments={n_seg}")
    log(f"  hist: {len(cases)} node x bin (int32 and uint8 bins) and 5 segment cases, integer "
        f"stats bit-equal, normal stats within {HIST_RTOL} of sum |val| per bin, uint8 cases "
        f"3 launches bit-equal on normal stats")


# ---------------------------------------------------------------- forests


def forest_data(n: int, d: int, seed: int):
    """benchmark/gen_data.py's ClassificationDataGen recipe (2 classes, 32
    informative features, centroids and column permutation from the base
    seed), chunk i of RF_CHUNK rows drawn from seed + i, straight into one f32
    array on threads: (X f32, label f32). X is column-major, as a frame of
    scalar columns holds it, so building the frame copies without a
    transpose."""
    from concurrent.futures import ThreadPoolExecutor

    base = np.random.default_rng(seed)
    n_inf = d // 2
    centroids = base.normal(scale=2.0, size=(2, n_inf))
    perm = base.permutation(d)
    X = np.empty((n, d), np.float32, order="F")
    y = np.empty((n,), np.float32)

    def chunk(i: int) -> None:
        s, e = i * RF_CHUNK, min(n, (i + 1) * RF_CHUNK)
        rng = np.random.default_rng(seed + i)
        yc = rng.integers(0, 2, size=e - s)
        xc = rng.normal(size=(e - s, d))
        xc[:, :n_inf] += centroids[yc]
        X[s:e] = xc[:, perm]
        y[s:e] = yc

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(chunk, range(-(-n // RF_CHUNK))))
    return X, y


def hist_library(torch, Xb, node, vals, width: int, nbins: int):
    """The library figure: per chunk of RF_LIB_ROWS rows, one index_add_ of
    every (row, feature) pair's stats at its flattened (feature, node, bin)
    index; (d * width * nbins, s) in vals' dtype (f64 vals: the reference)."""
    n, d = Xb.shape
    s = vals.shape[1]
    out = torch.zeros((d * width * nbins, s), dtype=vals.dtype, device=Xb.device)
    base = (torch.arange(d, device=Xb.device) * (width * nbins))[None, :]
    for r0 in range(0, n, RF_LIB_ROWS):
        xb = Xb[r0 : r0 + RF_LIB_ROWS]
        idx = base + xb + (node[r0 : r0 + RF_LIB_ROWS, None] * nbins if node is not None else 0)
        v = vals[r0 : r0 + RF_LIB_ROWS, None, :].expand(xb.shape[0], d, s)
        out.index_add_(0, idx.reshape(-1).long(), v.reshape(-1, s))
    return out


def first_trees(attrs: dict, k: int) -> dict:
    keys = ("feature", "threshold", "is_leaf", "value", "gain", "node_weight")
    return {key: attrs[key][:k] for key in keys}


RF_GAIN_TOL = 1e-5  # tests/test_torch_random_forest.py's GAIN_TOL: a near tie
RF_MP_SAMPLE_ROWS = 1 << 20  # rows of the forest data whose predictions phase 3m compares


def separated_structure(a, b, top2, n_trees: int, depth: int) -> tuple:
    """The structure half of tests/test_torch_random_forest.py's rule for
    real-valued stats, on the heap arrays of forests a and b: wherever a node
    is reached in both and its best gain in a (`top2`, each level's two best
    gains a node, in fit order) is more than RF_GAIN_TOL above its second best
    and 0, the trees split it alike. Returns (the nodes compared, the largest
    value difference at a reached node, that node's weight in a)."""
    it = iter(top2)
    sep = set()
    for i in range(n_trees):
        for t in range(depth):
            top = next(it)
            for w in range(2**t):
                if top[w, 0] > RF_GAIN_TOL and top[w, 0] - top[w, 1] > RF_GAIN_TOL:
                    sep.add((i, 2**t + w))
    compared, worst, worst_w = 0, 0.0, 0.0
    for i in range(n_trees):
        todo = [1]
        while todo:
            slot = todo.pop()
            diff = float(np.abs(a["value"][i][slot] - b["value"][i][slot]).max())
            if diff > worst:
                worst, worst_w = diff, float(a["node_weight"][i][slot])
            if (i, slot) not in sep or a["is_leaf"][i][slot]:
                continue
            compared += 1
            require(not b["is_leaf"][i][slot] and a["feature"][i][slot] == b["feature"][i][slot]
                    and a["threshold"][i][slot] == b["threshold"][i][slot],
                    f"tree {i} slot {slot}: the split differs at a separated node")
            todo += [2 * slot, 2 * slot + 1]
    return compared, worst, worst_w


def forest_moved(torch, workdir, a, b) -> float:
    """The share of the forest data's first RF_MP_SAMPLE_ROWS rows whose
    prediction by forest a differs from forest b's by more than RF_REG_RTOL of
    b's largest |prediction| (phase 3's regressor rule)."""
    from spark_rapids_ml_torch.ops.trees import predict_forest

    from spark_rapids_ml_torch import config as torch_config

    dev = torch.device(str(torch_config.get("device")))
    Xs = np.load(workdir / "rf_X.npy", mmap_mode="r")[:RF_MP_SAMPLE_ROWS]
    Xs = torch.from_numpy(np.array(Xs)).to(dev)
    preds = [predict_forest(Xs, *(torch.tensor(f[k], device=dev) for k in
                                  ("feature", "threshold", "is_leaf", "value")), RF_DEPTH)[:, 0]
             for f in (a, b)]
    return float(((preds[0] - preds[1]).abs() > RF_REG_RTOL * preds[1].abs().max()).double().mean())


def phase_multiprocess_forest(torch, workdir, clf_attrs, reg_attrs, streamed_attrs, launches,
                              device) -> None:
    """Phase 3m's forests: RandomForestClassifier and RandomForestRegressor at
    MP_RF_TREES trees (cut from RF_TREES for the time limit), depth RF_DEPTH,
    RF_BINS bins, on two rank processes each fitting its 60/40 share of the
    forest data that phase_forest wrote to WORKDIR/rf_*.npy, both ranks on
    one card over gloo (and one card a rank over NCCL where there are two).
    Gates: each forest the same bits on both ranks; the classifier the first
    MP_RF_TREES trees of phase 3's single-process fit bit for bit; the
    regressor's nodes split alike wherever the rule of
    tests/test_torch_random_forest.py compares structure
    (separated_structure), and its predictions under phase 3's regressor rule
    (forest_moved: RF_REG_RTOL, RF_REG_MOVED), since the rule's 1e-5 on
    values is below the f32 floor of the carried child stats at this size
    (eps32 x the root's sums over a small node's weight); each rank launched
    the level histogram once a level of each tree. Then the classifier fit
    out-of-core on the ranks (phase 3o): equal bit for bit, edges included,
    to the one-process streamed fit's `streamed_attrs`. The ranks' launches
    are added to `launches`."""
    on_card = device == "cuda"
    runs = [("gloo, one card", "0" if on_card else None)]
    if on_card and torch.cuda.device_count() >= MP_WORLD:
        runs.append(("NCCL, one card a rank", None))
    log(f"phase 3m (forests): {MP_WORLD} rank processes, {MP_RF_TREES} trees (cut from "
        f"{RF_TREES} for the time limit), depth {RF_DEPTH}, {RF_BINS} bins, rows "
        f"{MP_SHARE:.0%} / {1 - MP_SHARE:.0%}")
    for run, visible in runs:
        t0 = time.perf_counter()
        ranks = run_ranks(workdir, MP_WORLD, device, visible, job="forest")
        log(f"  run {run}: {time.perf_counter() - t0:.1f} s with the ranks' start")
        for res in ranks:
            f = res["forest"]
            log(f"    rank {res['rank']}: rows [{f['rows'][0]}, {f['rows'][1]}), backend "
                f"{res['backend']}, {res['device']} ({res['card']})")
            for label in ("RF classifier", "RF regressor", "RF classifier, streamed"):
                log_rank_call(res["rank"], label, f[label])
                hist = f[label]["launches"]["node_bin_hist"]
                if on_card:
                    require(hist == MP_RF_TREES * RF_DEPTH,
                            f"{run}: rank {res['rank']} {label}: {hist} histogram launches")
                require(f[label]["comm"]["comm.collective_ops"]
                        == 3 + (2 if "classifier" in label else 0) + MP_RF_TREES * RF_DEPTH,
                        f"{run}: rank {res['rank']} {label}: collectives {f[label]['comm']}")
                if launches is not None:
                    for name, c in f[label]["launches"].items():
                        launches[name] += c
        got = [res["forest"]["RF classifier, streamed"]["attrs"] for res in ranks]
        require(all(bits_equal(g, streamed_attrs) for g in got),
                f"{run}: the streamed classifier differs from the one-process streamed fit")
        log(f"  {run}: RF classifier, streamed: the same bits on both ranks and the one-process "
            f"streamed fit's (phase 3o) bit for bit, bin edges included")
        for label, ref in (("RF classifier", clf_attrs), ("RF regressor", reg_attrs)):
            got = [res["forest"][label]["attrs"] for res in ranks]
            require(all(bits_equal(g, got[0]) for g in got[1:]),
                    f"{run}: the {label} forests differ across the ranks")
            want = first_trees(ref, MP_RF_TREES)
            require(bits_equal(got[0]["bin_edges"], ref["bin_edges"]),
                    f"{run}: the {label} bin edges differ from the single-process fit's")
            if label == "RF classifier":
                require(bits_equal(first_trees(got[0], MP_RF_TREES), want),
                        f"{run}: the 2-rank classifier differs from the single-process fit's "
                        f"first {MP_RF_TREES} trees")
                log(f"  {run}: RF classifier: the same bits on both ranks and the single-process "
                    f"fit's first {MP_RF_TREES} trees bit for bit (bin edges too)")
            else:
                compared, worst, worst_w = separated_structure(
                    got[0], want, ranks[0]["forest"][label]["top2"], MP_RF_TREES, RF_DEPTH)
                moved = forest_moved(torch, workdir, got[0], want)
                same = {k: bool(np.array_equal(v, want[k]))
                        for k, v in first_trees(got[0], MP_RF_TREES).items()}
                log(f"  {run}: RF regressor: the same bits on both ranks; against the "
                    f"single-process fit's first {MP_RF_TREES} trees: arrays equal {same}, "
                    f"{compared} separated nodes split alike; values at most {worst:.4e} apart "
                    f"(at a node of weight {worst_w:.6g}); rows of the first "
                    f"{RF_MP_SAMPLE_ROWS} whose prediction differs by more than {RF_REG_RTOL} of "
                    f"max |prediction|: {100 * moved:.4f}% (allowed {100 * RF_REG_MOVED:g}%)")
                require(moved <= RF_REG_MOVED, f"{run}: regressor: {moved} of rows moved")


def evaluate_timed(torch, run_path, stages, path_counts, name, model, frame):
    """run_path(f"{name} evaluate", ...) of model.evaluate(frame), with the
    transform that evaluate makes timed on its own under f"{name} transform":
    its seconds (the card synchronized at both ends), evaluate's spans (all of
    them the transform's: the metrics are host work outside the spans) and
    evaluate's launch counts, which are not added to the totals again."""
    seen, call = [], model.transform

    def transform(dataset):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = call(dataset)
        torch.cuda.synchronize()
        seen.append(time.perf_counter() - t0)
        return out

    model.transform = transform
    try:
        ev = run_path(f"{name} evaluate", lambda: model.evaluate(frame))
    finally:
        del model.transform
    require(len(seen) == 1, f"{name} evaluate made {len(seen)} transforms")
    stages[f"{name} transform"] = (seen[0], stages[f"{name} evaluate"][1])
    path_counts[f"{name} transform"] = path_counts[f"{name} evaluate"]
    return ev


def phase_forest(torch, run_path, stages, path_counts, launches, reports) -> list:
    """RandomForestClassifier and RandomForestRegressor at N_RF x D_RF: the
    histogram kernels against plain at the main shape (2b), both estimators'
    fit and transform (3), the kernels' times (4). Returns their JSON rows."""
    import pandas as pd

    from spark_rapids_ml_torch.classification import RandomForestClassifier
    from spark_rapids_ml_torch.core.estimator import FitInputs
    from spark_rapids_ml_torch.ops import histogram as H
    from spark_rapids_ml_torch.ops import trees
    from spark_rapids_ml_torch.parallel.partition import PartitionDescriptor
    from spark_rapids_ml_torch.regression import RandomForestRegressor

    log(f"phase 2b (forest): histogram kernels against plain at {N_RF} x {D_RF}")
    t0 = time.perf_counter()
    Xh, ycls = forest_data(N_RF, D_RF, SEED)
    t1 = time.perf_counter()
    yreg = regression_label(Xh, SEED)
    t2 = time.perf_counter()
    cols = [f"f{j}" for j in range(D_RF)]
    df = pd.DataFrame(Xh, columns=cols)
    t3 = time.perf_counter()
    X = torch.from_numpy(Xh).cuda().contiguous()
    # phase 3m's ranks memory-map the rows: X in row order, written by chunks
    workdir = mp_workdir("phase3m_forest")
    t4 = time.perf_counter()
    Xf = np.lib.format.open_memmap(workdir / "rf_X.npy", mode="w+", dtype=np.float32,
                                   shape=Xh.shape)
    for r0 in range(0, N_RF, RF_CHUNK):
        Xf[r0 : r0 + RF_CHUNK] = Xh[r0 : r0 + RF_CHUNK]
    Xf.flush()
    del Xf, Xh
    np.save(workdir / "rf_ycls.npy", ycls)
    np.save(workdir / "rf_yreg.npy", yreg)
    log(f"  the rows and both labels written for phase 3m's ranks in "
        f"{time.perf_counter() - t4:.1f} s")
    log(f"  data {tuple(X.shape)} f32 in {t1 - t0:.1f} s, the regression label in "
        f"{t2 - t1:.1f} s, a frame of {D_RF} scalar columns in {t3 - t2:.1f} s, X on the "
        f"card in {t4 - t3:.1f} s")
    y_cls = torch.from_numpy(ycls).cuda()
    n = N_RF
    edges = torch.from_numpy(trees.quantile_bin_edges(X, RF_BINS, seed=SEED)).cuda()
    Xb = trees.bin_features(X, edges)
    # tree 0's bootstrap stats of the classifier fit below
    w0 = torch.from_numpy(np.random.default_rng(SEED).poisson(1.0, n).astype(np.float32)).cuda()
    stats = torch.zeros((n, 2), dtype=torch.float32, device="cuda")
    stats.scatter_(1, y_cls.long()[:, None], w0[:, None])
    # one tree at the fit's parameters, each level's histogram held to plain
    errs, level_nodes = {"node_bin_hist": 0.0, "segment_hist": 0.0}, {}

    def checked(Xb_, node_id, values, width, nbins):
        got = H.node_bin_histogram(Xb_, node_id, values, width, nbins)
        plain = H.node_bin_histogram_plain(Xb_, node_id, values, width, nbins)
        errs["node_bin_hist"] = max(errs["node_bin_hist"],
                                    check_hist(got, plain, None, True, f"level width {width}"))
        level_nodes[width] = node_id.clone()
        return got

    trees.node_bin_histogram = checked
    try:
        gen = torch.Generator("cuda").manual_seed(SEED)
        trees.build_tree(Xb, stats, edges, gen, max_depth=RF_DEPTH, nbins=RF_BINS,
                         impurity="gini", k_features=trees.resolve_feature_subset("auto", D_RF, True),
                         min_instances=1, min_info_gain=0.0)
    finally:
        trees.node_bin_histogram = H.node_bin_histogram
    require(sorted(level_nodes) == [2**t for t in range(RF_DEPTH)], "levels of the checked tree")
    require(Xb.dtype == torch.uint8, f"the forest's bins are {Xb.dtype}, not uint8")
    shares = []
    for width, nd in sorted(level_nodes.items()):
        c = torch.bincount(nd.long()[w0 != 0], minlength=width).double()
        top = (c.sort(descending=True).values[:4] / c.sum()).tolist()
        shares.append(f"w{width} " + "/".join(f"{x:.4f}" for x in top))
    log(f"  tree 0's level nodes, the largest four's shares of the rows with nonzero stats: "
        f"{'; '.join(shares)}")
    log(f"  node x bin kernel bit-equal to plain at every level width "
        f"{sorted(level_nodes)} of a tree on 2-class bootstrap stats ({Xb.dtype} bins)")
    # three integer stats (s = 3, the regressor's count) at the root and widest levels
    istats = torch.stack([w0, w0 * y_cls, 2.0 * w0 * (1.0 - y_cls)], 1)
    for width in (1, 2 ** (RF_DEPTH - 1)):
        nd = level_nodes[width]
        errs["node_bin_hist"] = max(errs["node_bin_hist"], check_hist(
            H.node_bin_histogram(Xb, nd, istats, width, RF_BINS),
            H.node_bin_histogram_plain(Xb, nd, istats, width, RF_BINS), None, True,
            f"s=3 integer stats, width {width}"))
    del istats
    log("  node x bin kernel bit-equal to plain on 3 integer stats at widths 1 and 32")
    # the regressor's non-integer stats at the root and widest levels
    rstats = torch.stack([w0, w0 * torch.from_numpy(yreg).cuda(),
                          w0 * torch.from_numpy(yreg).cuda() ** 2], 1)
    for width in (1, 2 ** (RF_DEPTH - 1)):
        # sums of ~n / 32 terms: both f32 results are held to an f64 one, the
        # kernel's error within twice the plain version's
        nd = level_nodes[width]
        got = H.node_bin_histogram(Xb, nd, rstats, width, RF_BINS)
        plain = H.node_bin_histogram_plain(Xb, nd, rstats, width, RF_BINS)
        ref = hist_library(torch, Xb, nd, rstats.double(), width, RF_BINS)
        ref = ref.reshape(D_RF, width, RF_BINS, 3).permute(1, 0, 2, 3)
        e_k, e_p = rel_err(got, ref), rel_err(plain, ref)
        again = [H.node_bin_histogram(Xb, nd, rstats, width, RF_BINS) for _ in range(2)]
        require(all(torch_equal_bits(a, got) for a in again),
                f"regression stats width {width}: launches differ in their bits")
        log(f"  node x bin kernel, regression stats [w, w y, w y^2] at width {width}: max rel err "
            f"vs f64 kernel {e_k:.3e}, plain {e_p:.3e}; max |kernel - plain| "
            f"{float((got - plain).abs().max()):.4g}; 3 launches bit-equal")
        require(e_k <= 2 * e_p + 1e-7, f"regression stats width {width}: kernel err {e_k} vs {e_p}")
    del rstats
    w_top = 2 ** (RF_DEPTH - 1)
    seg = level_nodes[w_top][:, None] * RF_BINS + Xb  # the width-32 level, flattened
    n_seg = w_top * RF_BINS
    got = H.segment_histogram(seg, stats, n_seg)
    plain = H.segment_histogram_plain(seg, stats, n_seg)
    errs["segment_hist"] = check_hist(got, plain, None, True, f"segment n_segments={n_seg}")
    nb = H.node_bin_histogram(Xb, level_nodes[w_top], stats, w_top, RF_BINS)
    require(torch.equal(got, nb.permute(1, 0, 2, 3).reshape(D_RF, n_seg, 2)),
            "segment kernel differs from the node x bin kernel on the same level")
    log(f"  segment kernel bit-equal to plain and to the node x bin kernel at the width-{w_top} "
        f"level flattened ({n_seg} segments)")
    del got, plain, nb, seg
    torch.cuda.synchronize()

    log("phase 3 (forest): RandomForestClassifier and RandomForestRegressor through the estimators")
    params = dict(numTrees=RF_TREES, maxDepth=RF_DEPTH, maxBins=RF_BINS, seed=SEED,
                  featuresCols=cols)
    df["label"] = ycls
    clf = run_path("RF classifier fit", lambda: RandomForestClassifier(**params).fit(df))
    out = run_path("RF classifier transform", lambda: clf.transform(df))
    pred = out["prediction"].to_numpy()
    rows_s = slice(0, n, 997)  # the per-row array columns on a sample of rows
    prob = np.stack(out["probability"].to_numpy()[rows_s])
    raw = np.stack(out["rawPrediction"].to_numpy()[rows_s])
    del out
    acc = float((pred == ycls).mean())
    require(pred.shape == (n,) and prob.shape[1] == 2 and np.isfinite(prob).all(),
            "classifier transform output")
    require(np.allclose(prob.sum(1), 1.0, atol=1e-6) and np.array_equal(raw, prob * RF_TREES),
            "classifier probability / rawPrediction")
    # the transform is the forest's predict on the same rows
    a = clf.get_model_attributes()
    dev = lambda k, dt: torch.tensor(a[k], dtype=dt, device="cuda")
    p_dev = trees.predict_forest(X, dev("feature", torch.int32), dev("threshold", torch.float32),
                                 dev("is_leaf", torch.bool), dev("value", torch.float32), RF_DEPTH)
    require(np.array_equal(np.asarray(p_dev.argmax(1).cpu(), np.float64), pred),
            "classifier transform differs from predict_forest on the staged rows")
    del prob, raw, p_dev

    def plain_fit(est, label):
        """The estimator's fit function on the rows already on the card, with
        the level histogram routed to its plain version."""
        inputs = FitInputs(features=X, row_weight=torch.ones(n, device="cuda"),
                           desc=PartitionDescriptor.build([n], D_RF, padded_m=n),
                           device=X.device, label=label)
        trees.node_bin_histogram = H.node_bin_histogram_plain
        try:
            return est._get_torch_fit_func()(inputs)
        finally:
            trees.node_bin_histogram = H.node_bin_histogram

    est = RandomForestClassifier(**{**params, "numTrees": RF_PLAIN_TREES})
    t0 = time.perf_counter()
    plain_attrs = plain_fit(est, y_cls)
    t_plain_clf = time.perf_counter() - t0
    for key, v in first_trees(plain_attrs, RF_PLAIN_TREES).items():
        require(np.array_equal(v, first_trees(a, RF_PLAIN_TREES)[key]),
                f"classifier: plain-route tree {key} differs from the kernel fit's")
    log(f"  classifier: the plain-route {RF_PLAIN_TREES}-tree fit ({t_plain_clf:.1f} s) equals "
        f"the kernel fit's first {RF_PLAIN_TREES} trees bit for bit; accuracy {acc:.6f}, "
        f"{clf.totalNumNodes} nodes")
    require(acc > 0.6, f"classifier accuracy {acc}")

    df["label"] = yreg
    reg = run_path("RF regressor fit", lambda: RandomForestRegressor(**params).fit(df))
    # evaluate's predictions frame is the transform's output (module header)
    rev = evaluate_timed(torch, run_path, stages, path_counts, "RF regressor", reg, df)
    rpred = rev.predictions["prediction"].to_numpy()
    rmse_ev, r2_ev = rev.rootMeanSquaredError, rev.r2
    del rev  # its predictions frame holds a copy of the 50M rows
    require(rpred.shape == (n,) and np.isfinite(rpred).all(), "regressor transform output")
    rmse_direct = float(np.sqrt(np.mean((rpred.astype(np.float64) - yreg) ** 2)))
    ystd = float(yreg.std())
    est = RandomForestRegressor(**{**params, "numTrees": RF_PLAIN_TREES})
    y_dev = torch.from_numpy(yreg).cuda()
    plain_r = plain_fit(est, y_dev)
    ra = reg.get_model_attributes()
    same = {k: bool(np.array_equal(v, first_trees(ra, RF_PLAIN_TREES)[k]))
            for k, v in first_trees(plain_r, RF_PLAIN_TREES).items()}
    to_dev = lambda at: [torch.tensor(at[k], device="cuda") for k in ("feature", "threshold",
                                                                       "is_leaf", "value")]
    pk = trees.predict_forest(X, *to_dev(first_trees(ra, RF_PLAIN_TREES)), RF_DEPTH)[:, 0]
    pp = trees.predict_forest(X, *to_dev(first_trees(plain_r, RF_PLAIN_TREES)), RF_DEPTH)[:, 0]
    moved = float(((pk - pp).abs() > RF_REG_RTOL * pp.abs().max()).double().mean())
    y_dev = y_dev.double()
    rmse_k2 = float(((pk.double() - y_dev) ** 2).mean().sqrt())
    rmse_p2 = float(((pp.double() - y_dev) ** 2).mean().sqrt())
    n_diff = int((first_trees(ra, RF_PLAIN_TREES)["threshold"]
                  != first_trees(plain_r, RF_PLAIN_TREES)["threshold"]).sum())
    log(f"  regressor: rmse {rmse_ev:.6f} (from its predictions "
        f"{rmse_direct:.6f}; label std {ystd:.4f}), r2 {r2_ev:.6f}; first {RF_PLAIN_TREES} "
        f"trees against the plain-route fit: arrays equal {same}, {n_diff} heap slots with "
        f"another threshold; rows whose prediction differs by more than {RF_REG_RTOL} of max "
        f"|prediction|: {100 * moved:.4f}% (allowed {100 * RF_REG_MOVED:g}%); 2-tree rmse kernel "
        f"{rmse_k2:.6f}, plain {rmse_p2:.6f}")
    require(moved <= RF_REG_MOVED, f"regressor: {moved} of rows moved against the plain route")
    require(abs(rmse_k2 - rmse_p2) <= 1e-3 * rmse_p2, "regressor: 2-tree rmse differs from plain")
    require(abs(rmse_ev - rmse_direct) <= 1e-6 * rmse_direct, "regressor rmse")
    require(rmse_ev < ystd, "regressor does no better than the label mean")
    log(f"phase 3p (forest): save and load of both forests and their estimators, the loaded "
        f"models transforming the first {PERSIST_ROWS} rows; toJSON -> fromJSON")
    prefix = df.iloc[:PERSIST_ROWS]
    phase_persist(torch, run_path, path_counts, {
        "RF classifier": (clf, RandomForestClassifier(**params), prefix, None,
                          {"n_features": D_RF, "num_classes": 2}),
        "RF regressor": (reg, RandomForestRegressor(**params), prefix, None,
                         {"n_features": D_RF}),
    }, tag="_forest")
    del y_dev, rpred, df, prefix
    gc.collect()
    torch.cuda.empty_cache()
    try:
        streamed = phase_streamed_forest(torch, run_path, stages, path_counts, workdir, X, y_cls,
                                         ycls)
        del X, y_cls
        gc.collect()
        torch.cuda.empty_cache()
        phase_multiprocess_forest(torch, workdir, a, ra, streamed, launches, "cuda")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    pc = path_counts
    for label in ("RF classifier fit", "RF regressor fit"):
        require(pc[label]["node_bin_hist"] == RF_TREES * RF_DEPTH,
                f"{label}: {pc[label]['node_bin_hist']} node x bin launches, not "
                f"{RF_TREES * RF_DEPTH}")
    for label in ("RF classifier transform", "RF regressor transform"):
        require(pc[label]["node_bin_hist"] == 0, f"{label} launched the histogram kernel")
    for label in ("RF classifier fit", "RF classifier transform", "RF regressor fit",
                  "RF regressor transform", "RF regressor evaluate"):
        total, spans = stages[label]
        parts = [f"{name} {t:.4f} s ({100 * t / total:.1f}%)" for name, t in spans.items()]
        other = total - sum(spans.values())
        log(f"  {label} {total:.4f} s by stage: {', '.join(parts)}, outside the spans "
            f"{other:.4f} s ({100 * other / total:.1f}%)")
    log(f"  launches per path: {json.dumps({k: pc[k] for k in pc if k.startswith('RF')})}")

    log("phase 4 (forest): histogram times at the main shape (CUDA events; kernels median "
        "of 10, plain and library median of 3)")
    rows = []
    nodes32 = level_nodes[w_top]
    zeros = torch.zeros(n, dtype=torch.int32, device="cuda")
    seg = nodes32[:, None] * RF_BINS + Xb
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = sm_clock_hz()
    # the regressor's stats of tree 0: [w, w y, w y^2]
    rstats = torch.stack([w0, w0 * torch.from_numpy(yreg).cuda(),
                          w0 * torch.from_numpy(yreg).cuda() ** 2], 1)
    nonzero = int((w0 != 0).sum())  # rows the kernel adds (zero-stat rows are skipped)
    timed = {}
    for s_, st in ((2, stats), (3, rstats)):
        for width, nd in ((1, zeros), (w_top, nodes32)):
            k_ms = time_ms(torch, lambda: H.node_bin_histogram(Xb, nd, st, width, RF_BINS))
            p_ms = time_ms(torch, lambda: H.node_bin_histogram_plain(Xb, nd, st, width, RF_BINS), 3, 1)
            l_ms = time_ms(torch, lambda: hist_library(torch, Xb, nd, st, width, RF_BINS), 3, 1)
            nbytes = Xb.element_size() * n * D_RF + 4.0 * n + 4.0 * s_ * n + 4.0 * width * D_RF * RF_BINS * s_
            b_ms, b_by = bound(nbytes, s_ * n * D_RF)
            b32_ms = 1e3 * (4.0 * n * D_RF + 4.0 * n + 4.0 * s_ * n) / PEAK_BYTES
            # shared memory: one 4-byte read and one write per (row, feature, stat)
            # the kernel adds, at 128 bytes a clock an SM
            smem_ms = 1e3 * 8.0 * nonzero * D_RF * s_ / (128.0 * sms * clock)
            g = H._plan(n, D_RF, width, RF_BINS, s_, Xb.element_size(), sms)
            timed[(s_, width)] = (k_ms, p_ms, l_ms, b_ms, b_by)
            log(f"  node_bin_hist s={s_} width {width}: kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  "
                f"library {l_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by}, uint8 bins; {b32_ms:.4f} ms "
                f"with int32 bins); shared-memory figure {smem_ms:.4f} ms ({nonzero} rows with "
                f"nonzero stats, {clock / 1e9:.3f} GHz); earlier design (PR 7) "
                f"{EARLIER_HIST_MS.get((s_, width), 'not measured')} ms; plan dt {g['dt']} wt "
                f"{g['wt']} bt {g['bt']} P {g['P']} R {g['R']}, {g['stage_rows']}-row stages, "
                f"{g['n_chunks']} row ranges x {g['tiles']} tiles, {g['smem']} bytes of shared "
                f"memory a block")
    # the plan's choice (ops/histogram.py HIST_BYTES, MAX_STAGE_ROWS): every
    # level of tree 0 under the wrapper's plan and under one block an SM
    for label, cfg in (("the plan", {}), ("one block an SM", HIST_ONE_BLOCK)):
        saved = {k: getattr(H, k) for k in cfg}
        try:
            for k, v in cfg.items():
                setattr(H, k, v)
            for s_, st in ((2, stats), (3, rstats)):
                t = {w: time_ms(torch, lambda: H.node_bin_histogram(Xb, nd, st, w, RF_BINS), 5, 1)
                     for w, nd in sorted(level_nodes.items())}
                log(f"  node_bin_hist under {label} {cfg}, s={s_}, tree 0's levels: "
                    + ", ".join(f"w{w} {v:.4f}" for w, v in t.items())
                    + f" ms; a tree {sum(t.values()):.4f} ms")
        finally:
            for k, v in saved.items():
                setattr(H, k, v)
    del rstats
    k_ms, p_ms, l_ms, b_ms, b_by = timed[(2, w_top)]
    rows.append({"name": "node_bin_hist", "route": "cuda", "source": SOURCE["node_bin_hist"],
                 "replaces": REPLACES["node_bin_hist"], "launches": launches["node_bin_hist"],
                 "max_abs_err": errs["node_bin_hist"], "ms": k_ms, "plain_ms": p_ms,
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms})
    k_ms = time_ms(torch, lambda: H.segment_histogram(seg, stats, n_seg))
    p_ms = time_ms(torch, lambda: H.segment_histogram_plain(seg, stats, n_seg), 3, 1)
    l_ms = time_ms(torch, lambda: hist_library(torch, seg, None, stats, 1, n_seg), 3, 1)
    b_ms, b_by = bound(4.0 * n * D_RF + 8.0 * n + 4.0 * w_top * D_RF * RF_BINS * 2, 2.0 * n * D_RF)
    g = H._plan(n, D_RF, 1, n_seg, 2, 4, sms)
    log(f"  segment_hist ({n_seg} segments, int32 ids): kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  "
        f"library {l_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by}); earlier design (PR 7) "
        f"{EARLIER_SEGMENT_MS} ms; plan bt {g['bt']} P {g['P']} R {g['R']}, {g['tiles']} tiles")
    rows.append({"name": "segment_hist", "route": "cuda", "source": SOURCE["segment_hist"],
                 "replaces": REPLACES["segment_hist"], "launches": launches["segment_hist"],
                 "max_abs_err": errs["segment_hist"], "ms": k_ms, "plain_ms": p_ms,
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms})
    log(f"  library figure: index_add_ of every (row, feature) pair's stats at its flattened "
        f"(feature, node, bin) index, {-(-n // RF_LIB_ROWS)} chunks of {RF_LIB_ROWS} rows; the "
        f"segment kernel has no launch on the main path (no caller in either package's fit)")
    log(f"  node_bin_hist launches on the main paths: {launches['node_bin_hist']} "
        f"({RF_TREES} trees x {RF_DEPTH} levels per fit)")
    for line in ptxas_lines(reports["hist"]):
        log(f"  ptxas hist: {line}")
    return rows


# ---------------------------------------------------------------- timing


def time_ms(torch, fn, reps: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nbytes: float, flops: float):
    t_b, t_f = nbytes / PEAK_BYTES, flops / PEAK_F32_FLOPS
    return 1e3 * max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def bound_tf32x3(nbytes: float, flops: float):
    """The bound with the products in 3xTF32: three TF32 operations per f32
    operation at the tensor cores' peak."""
    t_b, t_f = nbytes / PEAK_BYTES, 3.0 * flops / PEAK_TF32_FLOPS
    return 1e3 * max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def nearest_bound(n: int, d: int, k: int, n_split: int, kind: str):
    """The bound of a Lloyd or assignment form (kind "unit", "weighted" or
    "assign") at (n, d, k): the larger of its bytes (X, and w, read once; the
    centers and their norms read once; the sums, counts and inertia or the
    labels written once) over the HBM rate, and its operations at the engine
    that takes them: the cross terms 2 n k d in 3xTF32 (three TF32 operations
    each) for the f32 form, in one or three bf16 passes for n_split 1 and 2;
    the rest in f32 on the CUDA cores (|x|² 2 n d, the criterion 3 n k, and
    for Lloyd the update 2 n d a pass of the split, n d more with weights).
    Returns (ms, "bytes" or "operations", the products' ms alone)."""
    nbytes = 4.0 * (n * d + k * d + k + (n if kind == "weighted" else 0))
    nbytes += 4.0 * n if kind == "assign" else 4.0 * (k * d + k + 1)
    prod = 2.0 * n * k * d
    t_prod = 3.0 * prod / PEAK_TF32_FLOPS if n_split == 3 else (
        (1 if n_split == 1 else 3) * prod / PEAK_NARROW_OPS["bfloat16"])
    rest = 2.0 * n * d + 3.0 * n * k
    if kind != "assign":
        rest += 2.0 * n * d * (3 if n_split == 2 else 1) + (n * d if kind == "weighted" else 0)
    t_ops, t_b = t_prod + rest / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_b, t_ops), ("bytes" if t_b >= t_ops else "operations"), 1e3 * t_prod


def time_nearest(torch, X, C, C81, w):
    """Phase 4 of the Lloyd and assignment kernels at the main shape: every
    Lloyd form (unit and weighted, n_split 3, 1, 2) and assign (n_split 3, 2)
    against C (k = 20), and assign against C81 (the k-means|| candidates'
    count, 81 at k = 20): kernel, plain version, the library figure where one
    call computes the same function (assign: cdist and argmin), the bound
    (nearest_bound), the earlier design's time and the launch plan. Returns
    {name: {ms, plain_ms, bound_ms, bound_by, library_ms}} for the k = 20
    forms (the JSON rows' names) and "assign_k81" / "assign_high_k81"."""
    from spark_rapids_ml_torch.ops import _cuda
    from spark_rapids_ml_torch.ops import lloyd as lloyd_mod
    from spark_rapids_ml_torch.ops import select as select_mod

    n, d = X.shape
    out = {}
    forms = []
    for ns in (3, 1, 2):
        forms.append((form_name("lloyd", ns), "unit", ns, C,
                      lambda ns=ns: lloyd_mod.lloyd_step(X, C, n, None, ns),
                      lambda ns=ns: lloyd_mod.lloyd_step_plain(X, C, n, None, ns), None))
        forms.append((form_name("lloyd_weighted", ns), "weighted", ns, C,
                      lambda ns=ns: lloyd_mod.lloyd_step(X, C, n, w, ns),
                      lambda ns=ns: lloyd_mod.lloyd_step_plain(X, C, n, w, ns), None))
    for Ck, tag in ((C, ""), (C81, "_k81")):
        for ns in (3, 2):
            forms.append((form_name("assign", ns) + tag, "assign", ns, Ck,
                          lambda ns=ns, Ck=Ck: select_mod.assign(X, Ck, ns),
                          lambda ns=ns, Ck=Ck: select_mod.assign_plain(X, Ck, ns),
                          (lambda Ck=Ck: torch.cdist(X, Ck).argmin(1)) if ns == 3 else None))
    for name, kind, ns, Ck, kern, plain, lib in forms:
        k = Ck.shape[0]
        ms = time_ms(torch, kern)
        plain_ms = time_ms(torch, plain, 3, 1)
        lib_ms = None if lib is None else time_ms(torch, lib, 3, 1)
        b_ms, b_by, prod_ms = nearest_bound(n, d, k, ns, kind)
        engine = "3xTF32" if ns == 3 else f"{1 if ns == 1 else 3} bf16 pass(es)"
        mod = select_mod if kind == "assign" else lloyd_mod
        plan = (mod._plan(n, k, d, ns, _cuda.sm_count(X)) if hasattr(mod, "_plan")
                else "the earlier tile's")
        earlier = EARLIER_NEAREST_MS.get(name, "not measured")
        log(f"  {name} (k={k}): kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  library "
            f"{'-' if lib_ms is None else f'{lib_ms:.4f} ms'}  bound {b_ms:.4f} ms ({b_by}; "
            f"products in {engine} {prod_ms:.4f} ms); earlier design {earlier} ms; "
            f"launch plan {plan}")
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": lib_ms}
    return out


def nearest_times_main() -> int:
    """Phase 4 of the Lloyd and assignment kernels alone, on the main shape's
    blob data (centers: the mixture's, moved by N(0, 0.5²); 81 rows of X):
    python3 -c 'import chip_smoke; chip_smoke.nearest_times_main()'."""
    import torch

    from spark_rapids_ml_torch.ops import _cuda

    log(f"card: {nvidia_smi()}")
    reports = _cuda.build(["lloyd", "assign"])
    for name in ("lloyd", "assign"):
        for line in ptxas_lines(reports[name]):
            log(f"  ptxas {name}: {line}")
    Xh, centers = blobs(N_MAIN, D_MAIN, K_MAIN, SEED)
    X = torch.from_numpy(Xh).cuda()
    del Xh
    gen = torch.Generator("cuda").manual_seed(SEED)
    C = torch.from_numpy(centers).cuda() + 0.5 * torch.randn(
        centers.shape, device="cuda", generator=gen)
    w = torch.randint(0, 3, (N_MAIN,), device="cuda", generator=gen).float()
    C81 = X[torch.randint(0, N_MAIN, (81,), device="cuda", generator=gen)].clone()
    time_nearest(torch, X, C, C81, w)
    return 0


# ------------------------------------------------------- the streamed fits

N_STREAM_SMALL, D_STREAM_SMALL, K_STREAM_SMALL = 5_003, 37, 5
# 48 rows: less than a kernel's 64-row tile; 1,024: a ragged last batch; 8,192: one batch
STREAM_SMALL_BATCH_ROWS = (48, 1_024, 8_192)
STREAM_BATCH_MAIN = 1_000_000  # nine batches of the main X, the last 388,608 rows
STREAM_CACHE_MAIN = 4 << 30  # caches a prefix of the main X's batches, streams the tail
KM_STREAM_MAX_ITER = 20  # the estimator's default maxIter
H2D_REPS = 3  # copies of X timed per host-to-device route
# the forms the streamed paths take: label -> (config key, value) or None (f32)
STREAM_FORMS = {"f32": None, "high": ("parity_precision", "high"), "fast_math": ("fast_math", True)}


def pin_stream_keys(torch_config, threshold, batch_rows: int, cache_budget) -> None:
    """Set every key of the streamed fits, so that no phase depends on a
    default: cache_budget None turns the device cache off."""
    torch_config.set("stream_threshold_bytes", threshold)
    torch_config.set("stream_batch_rows", batch_rows)
    torch_config.set("cache.enabled", cache_budget is not None)
    torch_config.set("cache.hbm_budget_bytes", cache_budget)
    torch_config.set("ingest.zero_copy", True)
    torch_config.set("ingest.staging_pool_rows", 0)


def pin_in_core(torch_config) -> None:
    """The keys of every phase that does not stream: streaming off, the cache
    off, the other keys as pin_stream_keys sets them."""
    pin_stream_keys(torch_config, 0, STREAM_BATCH_MAIN, None)


def bits_equal(a, b) -> bool:
    """Two results (tensors, arrays, numbers, or tuples and dicts of them) equal
    bit for bit."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(bits_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(bits_equal(x, y) for x, y in zip(a, b))
    if hasattr(a, "cpu"):
        a, b = a.cpu().numpy(), b.cpu().numpy()
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.flags.c_contiguous and b.flags.c_contiguous and not a.dtype.hasobject:
        # the bytes compared in place, 64 MiB at a time: no copy of a phase 3i
        # cell layout (10+ GB) and no mask of its size
        a, b = a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8)
        step = 1 << 26
        return all(np.array_equal(a[i : i + step], b[i : i + step]) for i in range(0, a.size, step))
    return a.tobytes() == b.tobytes()


def check_gate(name: str, got, plain, ref, label: str) -> None:
    """Phase 2a's gate: got within twice the plain route's error of the f64
    reference, plus 1e-6 (relative to the reference's largest entry)."""
    eg, ep = rel_err(got, ref), rel_err(plain, ref)
    log(f"    {name} {label}: rel err vs f64 streamed {eg:.3e} in-core plain {ep:.3e}")
    require(eg <= 2 * ep + 1e-6, f"{name} {label}: streamed rel err {eg} (plain {ep})")


def phase_streamed_small(torch) -> None:
    """Phase 2c: the streamed accumulators (ops/streaming.py) against the
    in-core calls on the card at small ragged shapes, and the same bits across
    runs, cache settings and a sync after every batch."""
    from spark_rapids_ml_torch import config as torch_config
    from spark_rapids_ml_torch.ops import ingest, linalg, linear, streaming, xtwx
    from spark_rapids_ml_torch.ops.lloyd import lloyd_step

    log("phase 2c: streamed accumulators against in-core at small ragged shapes")
    n, d, k = N_STREAM_SMALL, D_STREAM_SMALL, K_STREAM_SMALL
    dev = torch.device("cuda")
    Xh, _ = blobs(n, d, k, SEED + 21, spread=3.0)
    Xh += np.float32(1.5)  # offset columns: the mean correction matters
    yh = regression_label(Xh, SEED + 22)
    wh = np.random.default_rng(SEED + 23).uniform(0.5, 2.0, n).astype(np.float32)
    X, y, w = (torch.from_numpy(a).cuda() for a in (Xh, yh, wh))
    X64, y64, w64 = X.double(), y.double(), w.double()
    C = X[torch.arange(0, n, n // k, device=dev)[:k]].clone()
    # f64 references: the covariance and the normal equations, unit and weighted
    refs = {}
    for tag, wt in (("unit", torch.ones_like(w64)), ("weighted", w64)):
        sw = wt.sum()
        mean = (wt[:, None] * X64).sum(0) / sw
        S2 = (X64 * wt[:, None]).T @ X64
        refs[tag] = {
            "cov": (S2 - sw * torch.outer(mean, mean)) / (sw - 1.0),
            "A": S2, "b": (X64 * wt[:, None]).T @ y64, "xbar": mean,
            "ybar": (wt * y64).sum() / sw,
        }
    for br in STREAM_SMALL_BATCH_ROWS:
        pin_stream_keys(torch_config, 1, br, 1 << 30)
        try:
            for form, key in (("f32", None), ("high", ("parity_precision", "high"))):
                n_split = 3 if key is None else 2
                if key:
                    torch_config.set(*key)
                try:
                    label = f"n={n} d={d} batch rows {br} {form}"
                    for tag, wv in (("unit", None), ("weighted", wh)):
                        ref = refs[tag]
                        cov_s = streaming.streaming_covariance(Xh, wv, br, dev)[0]
                        if tag == "unit":
                            s2, s1 = xtwx.xtx_plain(X, n, n_split)
                            cov_p = linalg.covariance_from_sums(s2, s1, torch.tensor(float(n), device=dev))[0]
                        else:
                            cov_p = linalg.weighted_covariance(X, w)[0]
                        check_gate("covariance", cov_s, cov_p, ref["cov"], f"{tag} {label}")
                        st = streaming.streaming_linreg_stats(Xh, yh, wv, br, dev)
                        if tag == "unit":
                            s2, s1, xty, ys, _ = xtwx.xtxy_plain(X, y, n, n_split)
                            pl = (s2, xty, s1 / n, ys / n)
                        else:
                            pl = linear.linreg_sufficient_stats(X, y, w)[:4]
                        for name, g, p in zip(("A", "b", "xbar", "ybar"), st, pl):
                            check_gate(f"normal equations {name}", g, p, ref[name], f"{tag} {label}")
                    for ns in ((3, 1) if key is None else (2,)):
                        for tag, wv, wt in (("unit", None, None), ("weighted", wh, w)):
                            got = streaming.streaming_lloyd_pass(Xh, wv, C, br, ns)
                            check_lloyd(X, C, n, wt, f"streamed pass {tag} {label}", ns, got=got)
                finally:
                    if key:
                        torch_config.unset(key[0])
            # the same bits: three runs, the cache off and holding a prefix, a
            # sync after every batch; every form of the KMeans fit
            batch_bytes = min(br, n) * (d + 1) * 4
            for form, key in STREAM_FORMS.items():
                if key:
                    torch_config.set(*key)
                try:
                    for tag, wv in (("unit", None), ("weighted", wh)):
                        def fits(sync=False):
                            return (
                                streaming.streaming_kmeans_fit(Xh, wv, k, 10, 1e-4, 1, br, dev,
                                                               sync_each_batch=sync),
                                streaming.streaming_covariance(Xh, wv, br, dev, sync_each_batch=sync),
                                streaming.streaming_linreg_stats(Xh, yh, wv, br, dev,
                                                                 sync_each_batch=sync),
                            )
                        want = fits()
                        runs = [fits(), fits(), fits(sync=True)]
                        for budget in (None, 3 * batch_bytes):
                            torch_config.set("cache.enabled", budget is not None)
                            torch_config.set("cache.hbm_budget_bytes", budget)
                            runs.append(fits())
                        torch_config.set("cache.enabled", True)
                        torch_config.set("cache.hbm_budget_bytes", 1 << 30)
                        same = [bits_equal(r, want) for r in runs]
                        log(f"    same bits, {tag} KMeans fit (n_iter {want[0]['n_iter']}), "
                            f"covariance and normal equations, batch rows {br} {form}: runs 2-3 "
                            f"{same[:2]}, sync each batch {same[2]}, cache off {same[3]}, "
                            f"prefix {same[4]}")
                        require(all(same), f"streamed results differ between runs ({form}, {tag}, "
                                f"batch rows {br}): {same}")
                finally:
                    if key:
                        torch_config.unset(key[0])
        finally:
            pin_in_core(torch_config)
    # the cast after the upload (ops/ingest.py rule 2), per source dtype the
    # device casts: a view of the host array goes up, the bits of the host astype
    ring = ingest.PinnedRing(dev)
    src = np.abs(np.random.default_rng(SEED + 24).normal(0, 60, (1_001, 7)))
    for dt in (np.float16, np.int8, np.int16, np.int32, np.uint8, np.uint16, np.uint32, np.bool_):
        A = src.astype(dt)
        blk = ingest.stage_block(A, 0, len(A), np.float32)
        got = ingest.upload(blk, dev, torch.float32, ring).cpu().numpy()
        require(np.shares_memory(blk, A) and got.tobytes() == A.astype(np.float32).tobytes(),
                f"the device cast of {np.dtype(dt).name} differs from the host astype")
    # the counted copy through the staging pool's two buffers: a strided X
    # streams to the bits of the contiguous one
    Xs = np.repeat(Xh, 2, axis=1)[:, ::2]
    pin_stream_keys(torch_config, 1, 1_024, 3 * 1_024 * d * 4)
    try:
        for a, b in ((streaming.streaming_covariance(Xs, None, 1_024, dev),
                      streaming.streaming_covariance(Xh, None, 1_024, dev)),
                     (streaming.streaming_kmeans_fit(Xs, None, k, 10, 1e-4, 1, 1_024, dev),
                      streaming.streaming_kmeans_fit(Xh, None, k, 10, 1e-4, 1, 1_024, dev))):
            require(bits_equal(a, b), "a strided X streams to other bits than a contiguous one")
    finally:
        pin_in_core(torch_config)
    log("    the device cast of f16, int8-32, uint8-32 and bool views gives the host astype's "
        "bits; a strided X (counted copies through the staging pool) streams to the bits of "
        "the contiguous one")
    # rows past n_valid in a reused full-size buffer: NaN or an earlier batch's
    nv = n - 46
    Xn, yn = X.clone(), y.clone()
    Xn[nv:], yn[nv:] = float("nan"), float("nan")
    for ns in (3, 2):
        require(bits_equal(xtwx.xtx(Xn, nv, ns), xtwx.xtx(X, nv, ns))
                and bits_equal(xtwx.xtxy(Xn, yn, nv, ns), xtwx.xtxy(X, y, nv, ns)),
                f"xtx / xtxy n_split {ns}: NaN rows past n_valid changed the result")
    for ns in (3, 2, 1):
        require(bits_equal(lloyd_step(Xn, C, nv, None, ns), lloyd_step(X, C, nv, None, ns)),
                f"unit lloyd n_split {ns}: NaN rows past n_valid changed the result")
    log(f"    NaN rows past n_valid = {nv} of {n}: xtx, xtxy (n_split 3, 2) and the unit Lloyd "
        f"step (n_split 3, 2, 1) give the bits of finite rows there")
    torch.cuda.synchronize()


def h2d_routes(torch, Xh) -> dict:
    """Host-to-device GB/s of X (a C-contiguous host array) by route: pageable
    `.copy_` (the route of PRs 1-9), the pinned ring at several chunk sizes and
    depths (ops/ingest.py::PinnedRing), ops/ingest.py::upload as staging calls
    it (each the median of H2D_REPS copies), and cudaHostRegister of X in
    place (registration, copy and unregistration timed apart, once)."""
    from spark_rapids_ml_torch.ops import ingest

    dev = torch.device("cuda")
    dst = torch.empty(Xh.shape, dtype=torch.float32, device=dev)
    src = ingest.host_tensor(Xh)
    gb = Xh.nbytes / 1e9
    out = {}

    def timed(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def rates(name, fn, reps: int = H2D_REPS) -> None:
        """GB/s of `reps` copies: the median kept under `name`, the range logged."""
        r = sorted(gb / timed(fn) for _ in range(reps))
        out[name] = statistics.median(r)
        log(f"    H2D {name}: median {out[name]:.3f} GB/s, {r[0]:.3f}-{r[-1]:.3f} over {reps} "
            f"copies of {gb:.3f} GB")

    dst[:1024].copy_(src[:1024])  # the copy engine's first use
    rates("pageable copy_", lambda: dst.copy_(src))
    for chunk_mib in (4, 16, 64, 256):
        for depth in (2, 4, 8):
            ring = ingest.PinnedRing(dev, chunk_mib << 20, depth)
            rates(f"ring {chunk_mib} MiB x {depth}", lambda: ring.copy(Xh, dst).synchronize())
            require(bool(torch.equal(dst[-3:].cpu(), src[-3:])), "ring copy: last rows differ")
            del ring
    # the wrapper as staging calls it: a fresh device tensor, the default ring
    ring = ingest.PinnedRing(dev)
    rates(f"upload, default ring ({ingest.RING_DEPTH} x {ingest.RING_CHUNK_BYTES >> 20} MiB), "
          "fresh tensor", lambda: ingest.upload(Xh, dev, torch.float32, ring))
    del ring
    torch.cuda.empty_cache()
    cudart = torch.cuda.cudart()
    ptr = Xh.ctypes.data
    t0 = time.perf_counter()
    rc = cudart.cudaHostRegister(ptr, Xh.nbytes, 0)
    t_reg = time.perf_counter() - t0
    require(int(getattr(rc, "value", rc)) == 0, f"cudaHostRegister returned {rc}")
    try:
        t = timed(lambda: dst.copy_(src, non_blocking=True))
    finally:
        t0 = time.perf_counter()
        rc = cudart.cudaHostUnregister(ptr)
        t_unreg = time.perf_counter() - t0
    require(int(getattr(rc, "value", rc)) == 0, f"cudaHostUnregister returned {rc}")
    out["registered copy"] = gb / t
    out["registered incl. (un)registration"] = gb / (t + t_reg + t_unreg)
    log(f"    H2D cudaHostRegister in place: register {t_reg:.4f} s, copy {t:.4f} s "
        f"({gb / t:.3f} GB/s), unregister {t_unreg:.4f} s; {gb / (t + t_reg + t_unreg):.3f} GB/s "
        f"all told")
    del dst
    torch.cuda.empty_cache()
    return out


def phase_streamed_main(torch, run_path, stages, path_counts, Xh, X, w_h, frame, pca, beta64):
    """Phase 3s: PCA, KMeans (unit and weighted) and LinearRegression OLS
    streamed through the estimators at the main shape, with the device cache
    off and with a budget that holds a prefix of X's batches. `frame` has the
    main X's rows as its features column, the label and the weight column.
    Returns the H2D rates by route."""
    from spark_rapids_ml_torch import config as torch_config
    from spark_rapids_ml_torch.clustering import KMeans
    from spark_rapids_ml_torch.feature import PCA
    from spark_rapids_ml_torch.ops import device_cache, ingest, streaming
    from spark_rapids_ml_torch.ops.lloyd import lloyd_fit
    from spark_rapids_ml_torch.ops.select import assign
    from spark_rapids_ml_torch.regression import LinearRegression

    log(f"phase 3s: streamed fits at {N_MAIN} x {D_MAIN}, {STREAM_BATCH_MAIN} rows a batch")
    routes = h2d_routes(torch, Xh)
    n_batches = -(-N_MAIN // STREAM_BATCH_MAIN)
    in_flight = streaming.in_flight_bytes(STREAM_BATCH_MAIN, D_MAIN, 4, 2)
    models, peaks = {}, {}
    fits = {
        "PCA": lambda: PCA(k=K_PCA, inputCol="features").fit(Xh),
        "KMeans": lambda: KMeans(k=K_MAIN, seed=1, maxIter=KM_STREAM_MAX_ITER).fit(Xh),
        "KMeans, weighted": lambda: KMeans(k=K_MAIN, seed=1, maxIter=KM_STREAM_MAX_ITER,
                                           weightCol="weight").fit(frame),
        "LinReg OLS": lambda: LinearRegression(standardization=True).fit(frame),
    }
    for cache_tag, budget in (("cache off", None), ("cache 4 GiB", STREAM_CACHE_MAIN)):
        pin_stream_keys(torch_config, 1, STREAM_BATCH_MAIN, budget)
        try:
            for name, fit in fits.items():
                label = f"{name} fit, streamed, {cache_tag}"

                def measured(fit=fit):
                    torch.cuda.synchronize()
                    base = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    device_cache.reset_counters()
                    ingest.reset_counters()
                    out = fit()
                    torch.cuda.synchronize()
                    peaks[label] = (torch.cuda.max_memory_allocated() - base,
                                    dict(device_cache.counters), dict(ingest.counters))
                    return out

                models[label] = run_path(label, measured)
        finally:
            pin_in_core(torch_config)
        for name in fits:
            label = f"{name} fit, streamed, {cache_tag}"
            peak, cache_c, ingest_c = peaks[label]
            total, spans = stages[label]
            attrs = models[label].get_model_attributes()
            passes = attrs.get("n_iter", 1) if name.startswith("KMeans") else 1
            limit = (budget or 0) + in_flight + (1 << 30)
            log(f"  {label}: {total:.4f} s; spans {json.dumps({k: round(v, 4) for k, v in spans.items()})}; "
                f"{passes} pass(es), {cache_c['uploads']} uploads, "
                f"{cache_c['upload_bytes'] / passes / 1e9:.3f} GB uploaded a pass, cache hits "
                f"{cache_c['hits']} misses {cache_c['misses']}; H2D {ingest_c['h2d_bytes'] / 1e9:.3f} GB "
                f"in {ingest_c['h2d_s']:.4f} s of the host's upload calls; peak device memory "
                f"above the fit's start {peak / 1e9:.3f} GB (limit {limit / 1e9:.3f}: cache budget + "
                f"the batches in flight + 1 GB; X is {Xh.nbytes / 1e9:.3f} GB)")
            require(peak <= limit, f"{label}: peak device memory {peak} > {limit}")
            want_hits = 0 if budget is None else (passes - 1) * min(
                n_batches, budget // (STREAM_BATCH_MAIN * (D_MAIN + 1) * 4))
            if name.startswith("KMeans"):
                require(cache_c["hits"] == want_hits,
                        f"{label}: cache hits {cache_c['hits']}, expected {want_hits}")
            counts = path_counts[label]
            kernel = {"PCA": "xtx", "LinReg OLS": "xtxy", "KMeans": "lloyd",
                      "KMeans, weighted": "lloyd_weighted"}[name]
            require(counts[kernel] == n_batches * passes,
                    f"{label}: {counts[kernel]} {kernel} launches, expected {n_batches * passes}")
            if name.startswith("KMeans"):
                require(counts["assign"] >= 1, f"{label}: no assign launch in the init")
    streamed = {label: {k: c for k, c in counts.items() if c}
                for label, counts in path_counts.items() if "streamed" in label}
    log(f"  launches per streamed path: {json.dumps(streamed)}")
    # the cache changes no bit
    for name in fits:
        a = models[f"{name} fit, streamed, cache off"].get_model_attributes()
        b = models[f"{name} fit, streamed, cache 4 GiB"].get_model_attributes()
        require(bits_equal(a, b), f"{name}: the streamed fits with and without the cache differ")
    log("  each streamed fit gives the same bits with the cache off and with 4 GiB")
    # PCA against phase 3's in-core fit
    ps = models["PCA fit, streamed, cache off"]
    ev_rel = float(np.max(np.abs(ps.explained_variance_ - pca.explained_variance_)
                          / np.abs(pca.explained_variance_)))
    comp = float(np.abs(ps.components_ - pca.components_).max())
    log(f"  streamed PCA vs in-core: explained variance rel err {ev_rel:.3e} (tol 1e-4), "
        f"components max abs diff {comp:.3e} (tol 1e-4)")
    require(ev_rel <= 1e-4 and comp <= 1e-4, "streamed PCA differs from the in-core fit")
    # LinearRegression against the f64 solve of phase 3
    lr = models["LinReg OLS fit, streamed, cache off"]
    lr_rel = float(torch.linalg.norm(torch.from_numpy(lr.coefficients).cuda().double() - beta64)
                   / torch.linalg.norm(beta64))
    log(f"  streamed LinReg OLS vs the f64 solve: rel 2-norm err {lr_rel:.3e} (tol 1e-3)")
    require(lr_rel <= 1e-3, f"streamed LinReg OLS coefficients rel err {lr_rel}")
    # KMeans against in-core Lloyd from the streamed fit's initial centers
    scale = float(torch.sqrt(torch.mean(X * X)))
    w_t = torch.from_numpy(w_h).cuda()
    for name, wv, wt in (("KMeans", None, None), ("KMeans, weighted", w_h, w_t)):
        model = models[f"{name} fit, streamed, cache off"]
        n_iter = model.get_model_attributes()["n_iter"]
        init = streaming.streaming_kmeans_init(Xh, wv, K_MAIN, 1, X.device)
        centers, _, n_iter_ic = lloyd_fit(X, torch.ones_like(w_t) if wt is None else wt, init,
                                          1e-4, KM_STREAM_MAX_ITER, wt is None)
        Cs = torch.from_numpy(model.cluster_centers_).cuda()
        diff = float((Cs - centers).abs().max())
        sizes_s = torch.bincount(assign(X, Cs).long(), minlength=K_MAIN)
        sizes_i = torch.bincount(assign(X, centers).long(), minlength=K_MAIN)
        size_diff = int((sizes_s - sizes_i).abs().sum())
        ties = int(near_ties(X, centers, full=True).sum()) if size_diff else 0
        log(f"  streamed {name} vs in-core lloyd_fit from its initial centers: n_iter {n_iter} / "
            f"{n_iter_ic}, centers max abs diff {diff:.3e} (tol {1e-4 * scale:.3e}, 1e-4 x the "
            f"data's rms {scale:.4f}), cluster sizes differ by {size_diff} (near ties {ties}); "
            f"inertia of the last pass {model.inertia_:.6g}")
        require(n_iter == n_iter_ic, f"streamed {name}: n_iter {n_iter} != in-core {n_iter_ic}")
        require(diff <= 1e-4 * scale, f"streamed {name}: centers differ by {diff}")
        require(size_diff <= 2 * ties, f"streamed {name}: cluster sizes differ by {size_diff}")
    return routes, models


def phase_arrow(torch, run_path, stages, Xh, yh, w_h, kmw, ols) -> bool:
    """Phase 3a: LinearRegression OLS and weighted KMeans fitted in-core from a
    pyarrow Table whose features column is a FixedSizeList<float32>[256] view
    of the main X; the models must equal phase 3's fits from pandas frames of
    the same rows, bit for bit. Returns False (and claims nothing) when pyarrow
    is not importable."""
    try:
        import pyarrow as pa
    except ImportError:
        log("phase 3a not run: pyarrow absent")
        return False
    from spark_rapids_ml_torch import config as torch_config
    from spark_rapids_ml_torch.clustering import KMeans
    from spark_rapids_ml_torch.core.dataset import extract_feature_data
    from spark_rapids_ml_torch.regression import LinearRegression

    log(f"phase 3a: Arrow fits at {N_MAIN} x {D_MAIN} (pyarrow {pa.__version__})")
    table = arrow_table(pa, Xh, yh, w_h)
    fd = extract_feature_data(table, input_col="features", label_col="label", weight_col="weight")
    require(np.shares_memory(fd.features, Xh), "the Arrow features are not a view of X")
    pin_in_core(torch_config)
    ols_a = run_path("LinReg OLS fit, Arrow", lambda: LinearRegression(
        standardization=True).fit(table))
    kmw_a = run_path("KMeans fit, weighted, Arrow", lambda: KMeans(
        k=K_MAIN, seed=1, weightCol="weight").fit(table))
    for label, got, want, pandas_label in (
            ("LinReg OLS fit, Arrow", ols_a, ols, "LinReg OLS fit"),
            ("KMeans fit, weighted, Arrow", kmw_a, kmw, "KMeans fit, weighted")):
        spans = stages[label][1]
        log(f"  {label}: {stages[label][0]:.4f} s, extract {spans.get('extract', 0.0):.4f} s "
            f"(from pandas: {stages[pandas_label][1].get('extract', 0.0):.4f} s of "
            f"{stages[pandas_label][0]:.4f} s); spans "
            f"{json.dumps({k: round(v, 4) for k, v in spans.items()})}")
        require(spans.get("extract", 0.0) < 0.1, f"{label}: extract took {spans.get('extract')} s")
        require(bits_equal(got.get_model_attributes(), want.get_model_attributes()),
                f"{label}: the model differs from the pandas fit's")
    log("  each Arrow fit's model equals the pandas fit's bit for bit")
    return True


def arrow_table(pa, Xh, yh, w_h):
    """A pyarrow Table over the main X (a FixedSizeList<float32> column that
    shares X's memory), its label and its weight."""
    feats = pa.FixedSizeListArray.from_arrays(pa.array(Xh.reshape(-1)), Xh.shape[1])
    return pa.table({"features": feats, "label": pa.array(yh), "weight": pa.array(w_h)})


# --------------------------------------- phase 3o: the streamed pairwise tier


def measured_call(torch, peaks, label, call):
    """call() with the peak device memory above its start, the device-cache
    and ingest counters and the pairwise tier's counters recorded under
    peaks[label]."""
    from spark_rapids_ml_torch.ops import device_cache, ingest
    from spark_rapids_ml_torch.ops import pairwise_streaming as ps

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    device_cache.reset_counters()
    ingest.reset_counters()
    ps.reset_counters()
    out = call()
    torch.cuda.synchronize()
    peaks[label] = (torch.cuda.max_memory_allocated() - base, dict(device_cache.counters),
                    dict(ingest.counters), dict(ps.counters))
    return out


def phase_streamed_pairwise(torch, run_path, stages, path_counts, Xh, X, Qh10, query_ids,
                            knn_refs, db_ref) -> None:
    """Phase 3o (kNN, DBSCAN): NearestNeighbors fit on the main items with the
    stream threshold pinned below them (the items stay on the host; the norms
    a tile at a time), then kneighbors at both traffics with the device cache
    off and at STREAM_CACHE_MAIN, each bit-equal to phase 3's in-core f32
    search (knn_refs), launching the top-k kernel once a (query block, item
    tile); and DBSCAN's transform of phase 3's rows streamed, its core
    counts phase 3's one-launch counts bit for bit, its labels phase 3's up
    to the borderline rule (check_db_rule), its rounds phase 3's, the count
    kernel launched once a (query block, tile). Peak device memory: the fit
    under 1 GB above its start, each search under the cache budget plus the
    tiles in flight plus 1 GB."""
    import pandas as pd

    from spark_rapids_ml_torch import config as torch_config
    from spark_rapids_ml_torch.clustering import DBSCAN
    from spark_rapids_ml_torch.knn import NearestNeighbors
    from spark_rapids_ml_torch.ops import dbscan as dbscan_mod
    from spark_rapids_ml_torch.ops import knn as knn_ops
    from spark_rapids_ml_torch.ops import pairwise_streaming as ps

    block = ps.ITEM_BLOCK
    tiles = -(-N_MAIN // block)
    in_flight = ps.tile_bytes(block, D_MAIN)
    log(f"phase 3o: the streamed pairwise tier: NearestNeighbors on {N_MAIN} x {D_MAIN} items "
        f"({Xh.nbytes / 1e9:.3f} GB) in {tiles} tiles of {block} rows, query blocks of "
        f"{ps.KNN_QUERY_BLOCK}; DBSCAN on {N_DB} x {D_DB} in query blocks of "
        f"{ps.DBSCAN_QUERY_BLOCK}; stream_threshold_bytes 1")
    peaks = {}
    pin_stream_keys(torch_config, 1, STREAM_BATCH_MAIN, None)
    try:
        nn = run_path("NearestNeighbors fit, streamed", lambda: measured_call(
            torch, peaks, "NearestNeighbors fit, streamed",
            lambda: NearestNeighbors(k=K_KNN, inputCol="features", idCol="id").fit(Xh)))
    finally:
        pin_in_core(torch_config)
    peak, _, ingest_c, ps_c = peaks["NearestNeighbors fit, streamed"]
    norms = nn.get_model_attributes()["item_norms_sq"]
    same_norms = bits_equal(norms, knn_ops.center_norms_sq(X).cpu())
    log(f"  NearestNeighbors fit, streamed: {stages['NearestNeighbors fit, streamed'][0]:.4f} s "
        f"(in-core {stages['NearestNeighbors fit'][0]:.4f} s); {ps_c['knn.x2_tile_computes']} tile "
        f"norms, H2D {ingest_c['h2d_bytes'] / 1e9:.3f} GB in {ingest_c['h2d_s']:.4f} s; peak "
        f"device memory above its start {peak / 1e9:.4f} GB (limit 1 GB); the norms equal the "
        f"in-core fit's (center_norms_sq of all X) bit for bit: {same_norms}")
    require(nn._staged is None, "the streamed kNN fit staged its items")
    require(peak <= 1 << 30, f"the streamed kNN fit's peak device memory {peak}")
    require(ps_c["knn.x2_tile_computes"] == tiles, "the streamed kNN fit's tile norms")
    qdf = pd.DataFrame({"features": list(Xh[:NQ_KNN])})
    qdf10 = pd.DataFrame({"features": list(Qh10), "id": query_ids})
    for cache_tag, budget in (("cache off", None), ("cache 4 GiB", STREAM_CACHE_MAIN)):
        pin_stream_keys(torch_config, 1, STREAM_BATCH_MAIN, budget)
        try:
            for tag, k, frame in (("bench", K_KNN, qdf), ("k=10", K_KNN10, qdf10)):
                nn.setK(k)
                label = f"NearestNeighbors kneighbors {tag}, streamed, {cache_tag}"
                out = run_path(label, lambda: measured_call(
                    torch, peaks, label, lambda: nn.kneighbors(frame)))
                peak, cache_c, ingest_c, ps_c = peaks[label]
                total, spans = stages[label]
                nq = len(frame)
                want = tiles * -(-nq // ps.KNN_QUERY_BLOCK)
                limit = (budget or 0) + in_flight + (1 << 30)
                got = knn_arrays(out[2])
                log(f"  {label}: {total:.4f} s ({nq / total:.4g} queries/s): stream.ingest "
                    f"{spans.get('stream.ingest', 0.0):.4f} s, the kernel (select) "
                    f"{spans.get('select', 0.0):.4f} s, the merge {spans.get('merge', 0.0):.4f} s, "
                    f"other {total - sum(spans.values()):.4f} s; {cache_c['uploads']} uploads, "
                    f"H2D {ingest_c['h2d_bytes'] / 1e9:.3f} GB in {ingest_c['h2d_s']:.4f} s, cache "
                    f"hits {cache_c['hits']}; {ps_c['knn.x2_tile_computes']} tile norms computed; "
                    f"topk launches {path_counts[label]['topk']} (query blocks x tiles {want}); "
                    f"peak device memory above its start {peak / 1e9:.4f} GB (limit "
                    f"{limit / 1e9:.3f}: cache budget + the tiles in flight + 1 GB)")
                require(bits_equal(got, knn_refs[(tag, "float32")]),
                        f"{label}: differs from phase 3's in-core f32 search")
                require(path_counts[label]["topk"] == want and ps_c["knn.x2_tile_computes"] == 0,
                        f"{label}: {path_counts[label]['topk']} top-k launches, "
                        f"{ps_c['knn.x2_tile_computes']} tile norms")
                require(peak <= limit, f"{label}: peak device memory {peak} > {limit}")
        finally:
            pin_in_core(torch_config)
    log("  streamed kneighbors at both traffics equals phase 3's in-core f32 search bit for "
        "bit, with the device cache off and at 4 GiB")
    del nn

    # DBSCAN: the core counts recorded from the streamed sweep
    counted, real_counts = [], ps._streamed_counts

    def recorded(*args):
        counted.append(real_counts(*args))
        return counted[-1]

    pin_stream_keys(torch_config, 1, STREAM_BATCH_MAIN, STREAM_CACHE_MAIN)
    ps._streamed_counts = recorded
    try:
        db = DBSCAN(eps=DB_EPS, min_samples=DB_MIN_SAMPLES).fit(db_ref["X"])
        rounds0 = dbscan_mod._propagate_labels.rounds
        label = "DBSCAN transform, streamed"
        out = run_path(label, lambda: measured_call(torch, peaks, label,
                                                    lambda: db.transform(db_ref["X"])))
        rounds = dbscan_mod._propagate_labels.rounds - rounds0
    finally:
        ps._streamed_counts = real_counts
        pin_in_core(torch_config)
    peak, cache_c, ingest_c, ps_c = peaks[label]
    total, spans = stages[label]
    db_tiles = -(-N_DB // block)
    want = db_tiles * -(-N_DB // ps.DBSCAN_QUERY_BLOCK)
    log(f"  {label}: {total:.4f} s (in-core {stages['DBSCAN transform'][0]:.4f} s); spans "
        f"{json.dumps({k: round(v, 4) for k, v in spans.items()})}; {rounds} rounds (phase 3: "
        f"{db_ref['rounds']}), count launches {path_counts[label]['count']} (query blocks x tiles "
        f"{want}), {cache_c['uploads']} tile uploads, cache hits {cache_c['hits']}; peak device "
        f"memory above its start {peak / 1e9:.4f} GB")
    require(len(counted) == 1 and bits_equal(counted[0].astype(np.int64), db_ref["counts"]),
            f"{label}: the core counts differ from phase 3's one-launch counts")
    require(rounds == db_ref["rounds"] and ps_c["dbscan.rounds"] == rounds,
            f"{label}: {rounds} rounds, phase 3 {db_ref['rounds']}")
    require(path_counts[label]["count"] == want, f"{label}: count launches")
    check_db_rule(label, counted[0].astype(np.int64), out["prediction"].to_numpy(), db_ref)
    log(f"  {label}: the core counts equal phase 3's one-launch counts bit for bit")



def phase_streamed_forest(torch, run_path, stages, path_counts, workdir, X, y_cls, ycls) -> dict:
    """Phase 3o (forest): RandomForestClassifier at MP_RF_TREES trees, depth
    RF_DEPTH, RF_BINS bins, fit out-of-core on the forest rows (an Arrow view
    of the memory-mapped WORKDIR/rf_X.npy, 12.8 GB of f32) with the stream
    threshold pinned below them: its peak device memory above its start under
    the uint8 bins plus the stats plus the batches in flight plus 1 GB (X is
    never whole on the card); its edges the quantiles of every
    (n // 200,000)-th row; its resident bins bin_features(X, edges) of the
    rows on the card (X, y_cls) bit for bit; its trees the shared growth
    (ops/trees.py::grow_forest) run in-core from those bins and the labels'
    stats bit for bit; RF_DEPTH histogram launches a tree. Returns the
    model's attributes, which phase 3m's ranks are held to."""
    import pyarrow as pa

    from spark_rapids_ml_torch import config as torch_config
    from spark_rapids_ml_torch.classification import RandomForestClassifier
    from spark_rapids_ml_torch.ops import streaming, trees

    Xmm = np.load(workdir / "rf_X.npy", mmap_mode="r")
    n, d = Xmm.shape
    table = pa.table({"features": pa.FixedSizeListArray.from_arrays(pa.array(Xmm.reshape(-1)), d),
                      "label": pa.array(ycls)})
    params = dict(numTrees=MP_RF_TREES, maxDepth=RF_DEPTH, maxBins=RF_BINS, seed=SEED)
    log(f"phase 3o (forest): RandomForestClassifier streamed at {n} x {d} ({Xmm.nbytes / 1e9:.1f} "
        f"GB of f32 on the host), {MP_RF_TREES} trees, depth {RF_DEPTH}, {RF_BINS} bins, "
        f"{STREAM_BATCH_MAIN} rows a batch, stream_threshold_bytes 1")
    grown, real_grow = [], trees.grow_forest

    def recorded(*args, **kwargs):
        grown.append((args, kwargs))
        return real_grow(*args, **kwargs)

    peaks = {}
    label = "RF classifier fit, streamed"
    pin_stream_keys(torch_config, 1, STREAM_BATCH_MAIN, None)
    trees.grow_forest = recorded
    try:
        model = run_path(label, lambda: measured_call(
            torch, peaks, label, lambda: RandomForestClassifier(**params).fit(table)))
    finally:
        trees.grow_forest = real_grow
        pin_in_core(torch_config)
    attrs = model.get_model_attributes()
    peak, _, ingest_c, _ = peaks[label]
    total, spans = stages[label]
    (args, kwargs), = grown
    Xb, stats, edges = args[:3]
    in_flight = streaming.in_flight_bytes(STREAM_BATCH_MAIN, d, 4)
    limit = Xb.numel() + 4 * stats.numel() + in_flight + (1 << 30)
    log(f"  {label}: {total:.4f} s; spans {json.dumps({k: round(v, 4) for k, v in spans.items()})}; "
        f"H2D {ingest_c['h2d_bytes'] / 1e9:.3f} GB in {ingest_c['h2d_s']:.4f} s of the host's "
        f"upload calls; peak device memory above its start {peak / 1e9:.4f} GB (limit "
        f"{limit / 1e9:.4f}: the bins {Xb.numel() / 1e9:.3f} + the stats "
        f"{4 * stats.numel() / 1e9:.3f} + the batches in flight {in_flight / 1e9:.3f} + 1 GB); "
        f"histogram launches {path_counts[label]['node_bin_hist']}")
    require(peak <= limit, f"{label}: peak device memory {peak} > {limit}")
    require(path_counts[label]["node_bin_hist"] == MP_RF_TREES * RF_DEPTH,
            f"{label}: {path_counts[label]['node_bin_hist']} histogram launches")
    sample = torch.from_numpy(np.ascontiguousarray(Xmm[:: max(1, n // 200_000)]))
    edges_ref = trees.quantile_bin_edges(sample, RF_BINS, seed=SEED)
    require(bits_equal(edges, edges_ref) and bits_equal(attrs["bin_edges"], edges_ref),
            f"{label}: the edges differ from the strided sample's quantiles")
    del sample
    t0 = time.perf_counter()
    ref_bins = trees.bin_features(X, torch.from_numpy(edges).to(X.device))
    require(Xb.dtype == torch.uint8 and torch.equal(Xb, ref_bins),
            f"{label}: the resident bins differ from bin_features(X, edges)")
    del ref_bins
    stats_ref = torch.zeros((n, 2), dtype=torch.float32, device=X.device)
    stats_ref.scatter_(1, y_cls.long()[:, None], 1.0)
    require(torch.equal(stats, stats_ref), f"{label}: the row stats differ from the labels'")
    again = real_grow(Xb, stats_ref, edges, *args[3:], **kwargs)
    require(bits_equal(first_trees(again, MP_RF_TREES), first_trees(attrs, MP_RF_TREES)),
            f"{label}: the trees differ from the in-core growth from the same bins")
    log(f"  {label}: the edges are the strided sample's quantiles, the resident uint8 bins "
        f"bin_features(X, edges) of the rows on the card, and the trees the in-core growth from "
        f"those bins (grow_forest), each bit for bit ({time.perf_counter() - t0:.1f} s)")
    del args, kwargs, grown, Xb, stats, stats_ref, table
    return attrs


# ------------------------------------------- phase 3i: approximate nearest neighbors

ANN_NLIST = 4096  # about sqrt(N_MAIN), rounded to a power of two
ANN_NPROBE = 32
ANN_PQ_M = 32  # 8 dimensions a subspace
ANN_PQ_BITS = 8
ANN_REFINE = 2
ANN_K = 10
ANN_COS_ROWS = 1 << 20  # rows of the items the cosine index holds
ANN_PQ_ROWS = 1 << 21  # rows of the items the IVF-PQ index holds (the phase's time)
ANN_DIM = 16  # the intrinsic dimension of a blob of phase 3i's items
ANN_NOISE = 0.1  # the scale of phase 3's noise left in them


def ann_recall(ids, exact) -> float:
    """Mean over queries of |ids ∩ exact| / k (recall@k against the exact
    answer's first k ids)."""
    k = exact.shape[1]
    return float(np.mean([len(np.intersect1d(a[a >= 0], b)) / k for a, b in zip(ids, exact)]))


def probe_sample(torch, nq: int, nprobe: int, d: int, device):
    """The query rows whose lists are held to f64 pair by pair: every row while
    their gathered (rows, nprobe, d) f64 centers take at most 2 GiB, else that
    many rows evenly spaced."""
    m = max(1, min(nq, (1 << 28) // max(nprobe * d, 1)))
    return torch.linspace(0, nq - 1, m, device=device).round().long().unique()


def check_probe(torch, Q, C, cn, nprobe: int, label: str, dups=()):
    """The probe's gate: the kernel's lists (probe_topk, csrc/probe.cu; the
    d2 and ids fused_probe returns the ids of) and the plain probe's
    (topk_plain, the JAX package's exact_full probe) against f64 distances
    to every center (check_topk_result: each d2 within TOPK_RTOL of its f64
    value and each rank within 2 tol of the f64 value at that rank, on the
    probe_sample rows; duplicate centers `dups` in id order at equal bits in
    the kernel), against each other at every rank of every row (d2 within 2
    tol), and their ids equal at every rank whose f64 neighbours on both
    sides lie more than 2 tol away. Returns (kernel lists, plain lists, rows
    whose lists are equal (bool numpy), max |kernel - plain| d2)."""
    from spark_rapids_ml_torch.ops import topk as topk_mod

    nq, d = Q.shape
    nl = C.shape[0]
    p = min(nprobe, nl)
    valid = torch.ones(nl, dtype=torch.bool, device=C.device)
    dk, ik = topk_mod.probe_topk(Q, C, nprobe, center_norms=cn)
    dp, ip = topk_mod.topk_plain(Q, C, valid, p, x2=cn)
    torch.cuda.synchronize()
    ref, c2max = topk_f64(Q, C, valid, p)
    tol = TOPK_RTOL * ((Q.double() ** 2).sum(1) + c2max)
    rows = probe_sample(torch, nq, p, d, Q.device)
    check_topk_result(dk, ik, Q, C, valid, p, rows, ref[rows], tol[rows],
                      f"probe {label} kernel", dups)
    check_topk_result(dp, ip, Q, C, valid, p, rows, ref[rows], tol[rows], f"probe {label} plain")
    diff = (dk.double() - dp.double()).abs()
    require(bool((diff <= 2 * tol[:, None]).all()), f"probe {label}: kernel vs plain d2")
    inf = torch.full((nq, 1), float("inf"), dtype=ref.dtype, device=ref.device)
    ext = torch.cat([ref[:, : p + 1], inf], 1)[:, : p + 1]
    gaps = ext[:, 1:] - ext[:, :-1]  # (nq, p): rank j to rank j + 1
    sep = (torch.cat([inf, gaps[:, : p - 1]], 1) > 2 * tol[:, None]) & (gaps > 2 * tol[:, None])
    require(bool((ik == ip)[sep].all()),
            f"probe {label}: kernel and plain ids differ at a rank with no near tie")
    equal = (ik == ip).all(1)
    err = float(diff.max())
    log(f"  probe {label}: {nq} queries x {nl} centers x {d}, nprobe {p}: lists equal on "
        f"{int(equal.sum())} rows; {int(sep.sum())} of {sep.numel()} ranks with no near tie "
        f"(f64 gaps > 2 tol), their ids equal; {int((ik != ip).sum())} ids differ; "
        f"{len(rows)} rows held to f64; max |kernel - plain| d2 {err:.4g}")
    return ik, ip, equal.cpu().numpy(), err


def ann_plain_search(torch, model, Q, probe, k: int):
    """The same index's search on the card with the plain probe's lists
    (nprobe their width): (distances, item positions) as host arrays."""
    from spark_rapids_ml_torch.ops import knn as knn_ops

    a = model.get_model_attributes()
    dev = Q.device
    g = lambda name: model._dev_get(name, dev)  # noqa: E731
    nprobe = probe.shape[1]
    if "codebooks" in a:
        d, i, pos = knn_ops.ivfpq_search(Q, g("centers"), g("codebooks"), g("codes"),
                                         g("cell_ids"), k * ANN_REFINE, nprobe, probe=probe)
        d, i = knn_ops.pq_refine(Q, g("cells"), pos, i, k)
    else:
        d, i = knn_ops.ivfflat_search(Q, g("centers"), g("cells"), g("cell_ids"), k, nprobe,
                                      probe=probe)
    return d.cpu().numpy(), i.cpu().numpy()


def ann_layout_line(label: str, attrs: dict) -> str:
    sizes = attrs["cell_sizes"]
    cells = attrs["cells"]
    return (f"{label}: {len(sizes)} cells, max_cell {cells.shape[1]} against the mean "
            f"{float(sizes.mean()):.1f} ({cells.shape[1] / max(float(sizes.mean()), 1e-9):.2f}x), "
            f"min {int(sizes.min())}; the padded layout {cells.nbytes / 1e9:.3f} GB "
            f"(the rows alone {int(sizes.sum()) * cells.shape[2] * 4 / 1e9:.3f} GB)")


def ann_spans_line(stages, label: str) -> str:
    total, spans = stages[label]
    parts = ", ".join(f"{name} {t:.3f}" for name, t in spans.items())
    return f"{label} {total:.3f} s: {parts}; outside the spans {total - sum(spans.values()):.3f} s"


def ann_persist(torch, model, frames, label: str, workdir) -> None:
    """Save, load and search: the loaded index searches each traffic
    (frames: (tag, query frame, the original's answer)) to the original's
    bits. The original's device copies are freed first."""
    from spark_rapids_ml_torch.knn import ApproximateNearestNeighborsModel

    model._dev.clear()
    torch.cuda.empty_cache()
    path = str(workdir / label.replace(" ", "_").replace(",", ""))
    t0 = time.perf_counter()
    model.write().overwrite().save(path)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = ApproximateNearestNeighborsModel.load(path)
    t_load = time.perf_counter() - t0
    require(type(loaded) is type(model) and loaded.uid == model.uid, f"{label}: loaded instance")
    a, b = model.get_model_attributes(), loaded.get_model_attributes()
    require(a.keys() == b.keys() and all(bits_equal(a[k], b[k]) for k in a),
            f"{label}: loaded attributes differ")
    require(bits_equal(loaded._item_row_ids, model._item_row_ids), f"{label}: loaded item ids")
    times = []
    for tag, frame, want in frames:
        t0 = time.perf_counter()
        got = knn_arrays(loaded.kneighbors(frame)[2])
        times.append(time.perf_counter() - t0)
        require(bits_equal(got, want), f"{label}: the loaded index's {tag} search differs")
    log(f"  {label} persisted: saved in {t_save:.3f} s ({dir_bytes(path) / 1e9:.3f} GB on disk), "
        f"loaded in {t_load:.3f} s (memory-mapped), searched in "
        f"{', '.join(f'{t:.3f}' for t in times)} s; every traffic the original's bits")
    loaded._dev.clear()
    del loaded
    shutil.rmtree(path, ignore_errors=True)
    torch.cuda.empty_cache()


def ann_items(torch, X, true_centers):
    """Phase 3i's items and queries, on X's device: phase 3's 20-blob mixture
    with each blob a Gaussian of intrinsic dimension ANN_DIM embedded in the
    D_MAIN columns (a latent z ~ N(0, I) through a random ANN_DIM x D_MAIN
    map, each column of variance 1 as phase 3's noise has), plus phase 3's
    own noise (each row of X less its blob's center, replayed from blobs'
    generator) at ANN_NOISE. Latent draws: numpy's generator from SEED + 15.
    The ANN benchmark's queries are the first NQ_KNN rows; the NQ_KNN10
    ann-benchmarks queries half rows of the items, half fresh rows of the
    mixture. Returns (items on the device, their host copy, bench queries,
    k=10 queries, the self rows among the latter)."""
    n, d = X.shape
    labels = np.random.default_rng(SEED)
    labels.normal(0.0, 4.0, (K_MAIN, d))  # blobs' draws, in blobs' order
    labels = torch.from_numpy(labels.integers(0, K_MAIN, n)).to(X.device)
    C = torch.from_numpy(true_centers).to(X.device)
    rng = np.random.default_rng(SEED + 15)
    W = torch.from_numpy((rng.standard_normal((ANN_DIM, d)) / np.sqrt(ANN_DIM)).astype(
        np.float32)).to(X.device)
    Xa = torch.empty_like(X)
    step = 1 << 20
    for s0 in range(0, n, step):
        lab = labels[s0 : s0 + step]
        Z = torch.from_numpy(rng.standard_normal((len(lab), ANN_DIM), dtype=np.float32)).to(X.device)
        Xa[s0 : s0 + step] = C[lab] + Z @ W + ANN_NOISE * (X[s0 : s0 + step] - C[lab])
    del labels
    self_rows = rng.choice(n, NQ_KNN10 // 2, replace=False)
    n_fresh = NQ_KNN10 - NQ_KNN10 // 2
    Zf = torch.from_numpy(rng.standard_normal((n_fresh, ANN_DIM), dtype=np.float32)).to(X.device)
    Ef = torch.from_numpy(rng.standard_normal((n_fresh, d), dtype=np.float32)).to(X.device)
    fresh = C[torch.from_numpy(rng.integers(0, K_MAIN, n_fresh)).to(X.device)] + Zf @ W \
        + ANN_NOISE * Ef
    Q10 = torch.cat([Xa[torch.from_numpy(self_rows).to(X.device)], fresh])
    return Xa, Xa.cpu().numpy(), Xa[:NQ_KNN].contiguous(), Q10, self_rows


def ann_exact(torch, Q, items, k: int):
    """The exact f32 answer: the top-k kernel's ids (int64, host) of Q's k
    nearest rows of `items`, with their norms cached as a fit caches them."""
    from spark_rapids_ml_torch.ops import knn as knn_ops
    from spark_rapids_ml_torch.ops import topk as topk_mod

    valid = torch.ones(items.shape[0], dtype=torch.bool, device=items.device)
    return topk_mod.fused_topk(Q, items, valid, k, x2=knn_ops.center_norms_sq(items))[1] \
        .long().cpu().numpy()


def phase_ann(torch, run_path, stages, path_counts, X, true_centers) -> dict:
    """Phase 3i: ApproximateNearestNeighbors (module header) on ann_items of
    phase 3's X. Returns the IVF-Flat index's centers and norms and the k=10
    queries (phase 4 times the probe at them), and the probe's largest
    |kernel - plain| d2."""
    import pandas as pd

    from spark_rapids_ml_torch import config as torch_config
    from spark_rapids_ml_torch.knn import ApproximateNearestNeighbors
    from spark_rapids_ml_torch.ops import knn as knn_ops
    from spark_rapids_ml_torch.ops import lloyd as lloyd_mod
    from spark_rapids_ml_torch.ops import select as select_mod

    t_phase = time.perf_counter()
    sms = torch.cuda.get_device_properties(0).multi_processor_count if X.is_cuda else 132
    Xa, Xh, Qb, Q10, self_rows = ann_items(torch, X, true_centers)
    log(f"phase 3i: ApproximateNearestNeighbors on {N_MAIN} x {D_MAIN} items: phase 3's 20 "
        f"blobs, each a Gaussian of intrinsic dimension {ANN_DIM} in the {D_MAIN} columns, plus "
        f"phase 3's noise at {ANN_NOISE} (ann_items; cut from BASELINE configs[4]'s 10M x 512, "
        f"20.5 GB before the cells' padding; phase 3's X itself, isotropic in 256 dimensions, "
        f"gives k-means at nlist {ANN_NLIST} one cell a blob: max_cell 418,209, a padded layout "
        f"of 1,754 GB), made in {time.perf_counter() - t_phase:.1f} s; nlist "
        f"{ANN_NLIST}, nprobe {ANN_NPROBE}, k {ANN_K}; traffics: the ANN benchmark's ({NQ_KNN} "
        f"rows of the items) and {NQ_KNN10} ann-benchmarks queries ({NQ_KNN10 // 2} rows, the "
        f"rest fresh)")
    cand = 1 + 2 * 2 * ANN_NLIST
    log(f"  plans: assign at the k-means|| candidates (k={cand}) "
        f"{select_mod._plan(N_MAIN, cand, D_MAIN, 3, sms)}; Lloyd at k={ANN_NLIST} "
        f"{lloyd_mod._plan(N_MAIN, ANN_NLIST, D_MAIN, 3, sms)}; Lloyd at a PQ subspace "
        f"(k=256, d={D_MAIN // ANN_PQ_M}) {lloyd_mod._plan(ANN_PQ_ROWS, 256, D_MAIN // ANN_PQ_M, 3, sms)}")
    t0 = time.perf_counter()
    exact = {rows: {"bench": ann_exact(torch, Qb, Xa[:rows], ANN_K),
                    "k=10": ann_exact(torch, Q10, Xa[:rows], ANN_K)}
             for rows in (N_MAIN, ANN_PQ_ROWS)}
    Xc = knn_ops.unit_rows(Xa[:ANN_COS_ROWS])
    exact["cosine"] = {"bench": ann_exact(torch, knn_ops.unit_rows(Qb), Xc, ANN_K),
                       "k=10": ann_exact(torch, knn_ops.unit_rows(Q10), Xc, ANN_K)}
    del Xc
    require(np.array_equal(exact[N_MAIN]["bench"][:, 0], np.arange(NQ_KNN))
            and np.array_equal(exact[N_MAIN]["k=10"][: NQ_KNN10 // 2, 0], self_rows),
            "phase 3i: a row of the items is not its own exact first neighbor")
    log(f"  the exact answers (the top-k kernel, f32): {time.perf_counter() - t0:.3f} s")
    qdf = pd.DataFrame({"features": list(Xh[:NQ_KNN])})
    qdf10 = pd.DataFrame({"features": list(Q10.cpu().numpy()),
                          "id": np.arange(NQ_KNN10, dtype=np.int64) + 10**9})
    traffics = (("bench", qdf, Qb), ("k=10", qdf10, Q10))
    workdir = mp_workdir("phase3i")
    peaks, out = {}, {}
    params = {"nlist": ANN_NLIST, "nprobe": ANN_NPROBE}
    pq_params = {**params, "M": ANN_PQ_M, "n_bits": ANN_PQ_BITS, "refine_ratio": ANN_REFINE}

    def fit(label, est, data):
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        model = run_path(label, lambda: est.fit(data))
        peaks[label] = torch.cuda.max_memory_allocated() - base
        pc = path_counts[label]
        log(f"  {ann_spans_line(stages, label)}")
        log(f"    launches {json.dumps({k: v for k, v in pc.items() if v})}; peak device memory "
            f"above its start {peaks[label] / 1e9:.3f} GB")
        return model

    def search(label, model, frame):
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        got = knn_arrays(run_path(label, lambda: model.kneighbors(frame))[2])
        peaks[label] = torch.cuda.max_memory_allocated() - base
        nq = len(frame)
        total = stages[label][0]
        log(f"  {ann_spans_line(stages, label)}; {nq / total:.4g} queries/s; peak device memory "
            f"above its start {peaks[label] / 1e9:.3f} GB")
        return got

    def gate_searches(name, model, recall_rows, ex_all):
        """Both traffics: the probe's gate, the search against the plain
        route on the rows whose probe lists are equal, recall@10 against the
        exact answer ex_all (traffic -> ids)."""
        a = model.get_model_attributes()
        C = model._dev_get("centers", X.device)
        cn = model._dev_get("center_norms", X.device)
        for tag, frame, Q in traffics:
            label = f"ANN {name} kneighbors {tag}"
            ids, dist = out[label]
            pc = path_counts[label]
            require(pc["fused_probe"] == 1 and pc["topk"] == 0,
                    f"{label}: the probe launched the top-k kernel {pc['fused_probe']} times "
                    f"(other top-k launches {pc['topk']})")
            pk, pp, equal, err = check_probe(torch, Q, C, cn, ANN_NPROBE, f"{name} {tag}")
            out[f"probe err {name} {tag}"] = err
            pd_, pi = ann_plain_search(torch, model, Q, pp, ANN_K)
            require(ids.shape == pi.shape == (len(frame), ANN_K), f"{label}: shape {ids.shape}")
            require(bits_equal((ids[equal], dist[equal]), (pi[equal], pd_[equal])),
                    f"{label}: differs from the plain-probe search on rows with equal probe lists")
            require(np.isfinite(dist).all() and (ids >= 0).all(), f"{label}: a slot is empty")
            ex = ex_all[tag]
            r_k, r_p = ann_recall(ids, ex), ann_recall(pi, ex)
            r_ke, r_pe = ann_recall(ids[equal], ex[equal]), ann_recall(pi[equal], ex[equal])
            require(r_ke == r_pe, f"{label}: recall {r_ke} != the plain route's {r_pe}")
            log(f"  {label}: recall@{ANN_K} against the exact answer {r_k:.6f} (the plain "
                f"route {r_p:.6f}; on the {int(equal.sum())} rows of equal probe lists "
                f"{r_ke:.6f} = {r_pe:.6f}); bit-equal to the plain-probe search there")
            recall_rows[(name, tag)] = r_k

    def persisted_frames(name):
        return [(tag, frame, out[f"ANN {name} kneighbors {tag}"]) for tag, frame, _ in traffics]

    recalls = {}
    pin_in_core(torch_config)
    # IVF-Flat, in-core
    est = ApproximateNearestNeighbors(k=ANN_K, algorithm="ivfflat", algoParams=params,
                                      inputCol="features", idCol="id")
    flat = fit("ANN IVF-Flat fit", est, Xh)
    log(f"  {ann_layout_line('IVF-Flat', flat.get_model_attributes())}")
    for tag, frame, _ in traffics:
        out[f"ANN IVF-Flat kneighbors {tag}"] = search(f"ANN IVF-Flat kneighbors {tag}", flat, frame)
    gate_searches("IVF-Flat", flat, recalls, exact[N_MAIN])
    # the streamed search: the cells stay on the host
    pin_stream_keys(torch_config, 1, STREAM_BATCH_MAIN, None)
    try:
        label = "ANN IVF-Flat kneighbors bench, streamed"
        got = search(label, flat, qdf)
    finally:
        pin_in_core(torch_config)
    require(path_counts[label]["fused_probe"] == 1, f"{label}: the probe's launches")
    require(bits_equal(got, out["ANN IVF-Flat kneighbors bench"]),
            f"{label}: differs from the in-core search")
    log(f"  {label}: bit-equal to the in-core search (its probe is the in-core search's: "
        f"held above)")
    ann_persist(torch, flat, persisted_frames("IVF-Flat"), "IVF-Flat", workdir)
    probe_C = torch.from_numpy(flat.get_model_attributes()["centers"]).to(X.device)
    probe_cn = torch.from_numpy(flat.get_model_attributes()["center_norms"]).to(X.device)
    del flat
    gc.collect()
    torch.cuda.empty_cache()

    # the streamed IVF-Flat build, 1,000,000-row batches
    pin_stream_keys(torch_config, 1, STREAM_BATCH_MAIN, None)
    try:
        sflat = fit("ANN IVF-Flat fit, streamed", ApproximateNearestNeighbors(
            k=ANN_K, algorithm="ivfflat", algoParams=params, inputCol="features", idCol="id"), Xh)
    finally:
        pin_in_core(torch_config)
    a = sflat.get_model_attributes()
    n_batches = -(-N_MAIN // STREAM_BATCH_MAIN)
    pc = path_counts["ANN IVF-Flat fit, streamed"]
    require(pc["assign"] >= n_batches and pc["lloyd"] >= 1,
            f"the streamed IVF-Flat build's launches {pc}")
    t0 = time.perf_counter()
    lab = select_mod.assign(Xa, torch.from_numpy(a["centers"]).to(X.device)).cpu().numpy()
    # layout_cells_on: layout_cells made on the card (the same bits,
    # tests/test_torch_ann.py), the streamed build's made on the host
    cells_on, ids_on, sizes_on = knn_ops.layout_cells_on(Xa, lab, a["centers"].shape[0])
    require(bits_equal((cells_on.cpu().numpy(), ids_on, sizes_on),
                       (a["cells"], a["cell_ids"], a["cell_sizes"])),
            "the streamed IVF-Flat build's layout differs from layout_cells of one assignment")
    del cells_on
    log(f"  {ann_layout_line('IVF-Flat, streamed', a)}; equal bit for bit to layout_cells of one "
        f"assignment launch against its centers ({time.perf_counter() - t0:.3f} s to check); "
        f"{n_batches} batches of {STREAM_BATCH_MAIN} rows")
    del sflat, a, lab
    gc.collect()

    # IVF-PQ, in-core
    Xpq = Xh[:ANN_PQ_ROWS]
    if ANN_PQ_ROWS < N_MAIN:
        log(f"  IVF-PQ cut to the first {ANN_PQ_ROWS} rows of the items (the phase's time: "
            f"IVF-Flat's build alone takes about a third of it)")
    est = ApproximateNearestNeighbors(k=ANN_K, algorithm="ivfpq", algoParams=pq_params,
                                      inputCol="features", idCol="id")
    pq = fit("ANN IVF-PQ fit", est, Xpq)
    log(f"  {ann_layout_line('IVF-PQ', pq.get_model_attributes())}; codes "
        f"{pq.get_model_attributes()['codes'].nbytes / 1e9:.3f} GB")
    for tag, frame, _ in traffics:
        out[f"ANN IVF-PQ kneighbors {tag}"] = search(f"ANN IVF-PQ kneighbors {tag}", pq, frame)
    gate_searches("IVF-PQ", pq, recalls, exact[ANN_PQ_ROWS])
    ann_persist(torch, pq, persisted_frames("IVF-PQ"), "IVF-PQ", workdir)
    del pq, Xpq
    gc.collect()
    torch.cuda.empty_cache()

    # brute force: exact kNN's answer
    bf = fit("ANN brute_force fit", ApproximateNearestNeighbors(
        k=ANN_K, algorithm="brute_force", inputCol="features", idCol="id"), Xh)
    for tag, frame, _ in traffics:
        label = f"ANN brute_force kneighbors {tag}"
        ids, dist = search(label, bf, frame)
        require(path_counts[label]["topk"] == 1, f"{label}: top-k launches")
        require(np.array_equal(ids, exact[N_MAIN][tag]),
                f"{label}: ids differ from the exact search")
        recalls[("brute_force", tag)] = ann_recall(ids, exact[N_MAIN][tag])
        log(f"  {label}: the exact ids, recall@{ANN_K} {recalls[('brute_force', tag)]}")
    bf._dev.clear()
    del bf
    torch.cuda.empty_cache()

    # cosine IVF-Flat on the first ANN_COS_ROWS rows
    from spark_rapids_ml_torch.knn import ApproximateNearestNeighborsModel

    cos = fit("ANN IVF-Flat cosine fit", ApproximateNearestNeighbors(
        k=ANN_K, algorithm="ivfflat", algoParams=params, metric="cosine", inputCol="features",
        idCol="id"), Xh[:ANN_COS_ROWS])
    for tag, frame, Q in traffics:
        label = f"ANN IVF-Flat cosine kneighbors {tag}"
        ids, dist = out[label] = search(label, cos, frame)
        require(path_counts[label]["fused_probe"] == 1, f"{label}: the probe's launches")
        eu = ApproximateNearestNeighborsModel(**cos.get_model_attributes())
        eu._item_row_ids = cos._item_row_ids
        eu.setInputCol("features").setK(ANN_K)
        eu._set_params(algoParams=params)
        U = knn_ops.unit_rows(Q).cpu().numpy()
        e_ids, e_d = knn_arrays(eu.kneighbors(U)[2])
        require(np.array_equal(ids, e_ids) and bits_equal(dist, (e_d * e_d) / 2.0),
                f"{label}: the cosine distances are not d^2/2 of the euclidean search on the "
                "unit rows")
        recalls[("IVF-Flat cosine", tag)] = ann_recall(ids, exact["cosine"][tag])
        log(f"  {label}: equal to the euclidean search of the unit rows, d^2 / 2, bit for bit; "
            f"distances {float(dist[:, 0].min()):.4g} to {float(dist[:, -1].max()):.4g}; "
            f"recall@{ANN_K} against the exact cosine answer {recalls[('IVF-Flat cosine', tag)]:.6f}")
    # the JAX package's default nprobe, nlist // 8: no nprobe in algoParams
    label = "ANN IVF-Flat cosine kneighbors bench, default nprobe"
    nprobe_d = max(1, ANN_NLIST // 8)
    cos._set_params(algoParams={"nlist": ANN_NLIST})
    try:
        ids, dist = out[label] = search(label, cos, qdf)
    finally:
        cos._set_params(algoParams=params)
    pc = path_counts[label]
    require(pc["fused_probe"] == 1 and pc["topk"] == 0,
            f"{label}: probe launches {pc['fused_probe']}, other top-k launches {pc['topk']}")
    Qu = knn_ops.unit_rows(Qb)
    pk, pp, equal, out[f"probe err {label}"] = check_probe(
        torch, Qu, cos._dev_get("centers", X.device), cos._dev_get("center_norms", X.device),
        nprobe_d, "IVF-Flat cosine bench, default nprobe")
    require(pk.shape[1] == nprobe_d, f"{label}: probe lists of width {pk.shape[1]}")
    pd_, pi = ann_plain_search(torch, cos, Qu, pp, ANN_K)
    require(np.array_equal(ids[equal], pi[equal])
            and bits_equal(dist[equal], (pd_[equal] * pd_[equal]) / 2.0),
            f"{label}: differs from the plain-probe search on rows with equal probe lists")
    r_d = ann_recall(ids, exact["cosine"]["bench"])
    r_32 = recalls[("IVF-Flat cosine", "bench")]
    require(r_d >= r_32, f"{label}: recall@{ANN_K} {r_d} below nprobe {ANN_NPROBE}'s {r_32}")
    recalls[("IVF-Flat cosine, default nprobe", "bench")] = r_d
    log(f"  {label} (nprobe {nprobe_d}): recall@{ANN_K} {r_d:.6f} against nprobe {ANN_NPROBE}'s "
        f"{r_32:.6f}; on the {int(equal.sum())} rows of equal probe lists the plain-probe "
        f"search's ids and d^2 / 2, bit for bit")
    ann_persist(torch, cos, persisted_frames("IVF-Flat cosine"), "IVF-Flat cosine", workdir)
    del cos
    shutil.rmtree(workdir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  recall@{ANN_K} by algorithm and traffic: "
        f"{json.dumps({f'{a} {t}': r for (a, t), r in recalls.items()})}")
    del Xa, Xh
    torch.cuda.empty_cache()
    log(f"phase 3i: {time.perf_counter() - t_phase:.1f} s")
    return {"C": probe_C, "cn": probe_cn, "Q": Q10,
            "err": max(v for k, v in out.items() if k.startswith("probe err"))}


# The probe's nprobe timed at phase 3i's shape: the searches' 32 and the
# JAX package's default at nlist 4,096, nlist // 8
PROBE_TIMED_NPROBE = (ANN_NPROBE, ANN_NLIST // 8)
# The long-row probe: a row of keys too long for shared memory (pass 2 reads
# it from device memory), nprobe 8,192 sorted in shared memory
PROBE_LONG = (1_024, 65_536, 8_192)  # (queries, nlist, nprobe)


def probe_time(torch, C, cn, Q, nprobe: int) -> dict:
    """fused_probe at (Q, C, nprobe): kernel, plain (topk_plain), the library
    figure (cuBLAS addmm and torch.topk) and the bound (the bytes of Q, C,
    the norms and the ids at PEAK_BYTES, or the products and the key's
    operations in 3xTF32 at PEAK_TF32_FLOPS; the d2 scratch is the design's
    own and not counted)."""
    from spark_rapids_ml_torch.ops import topk as topk_mod

    nq, d = Q.shape
    nl = C.shape[0]
    valid = torch.ones(nl, dtype=torch.bool, device=C.device)
    ms = time_ms(torch, lambda: topk_mod.fused_probe(Q, C, nprobe, center_norms=cn))
    plain_ms = time_ms(torch, lambda: topk_mod.topk_plain(Q, C, valid, nprobe, x2=cn), 3, 1)

    def library():
        dd = torch.addmm(cn[None, :], Q, C.T, alpha=-2.0)
        return torch.topk(dd, nprobe, dim=1, largest=False)

    lib_ms = time_ms(torch, library)
    nbytes = 4.0 * (nq * d + nl * d + nl) + 4.0 * nq * nprobe
    b_ms, b_by = bound_tf32x3(nbytes, 2.0 * nq * nl * d + 4.0 * nq * nl)
    plan = topk_mod.probe_plan(nq, nl, nprobe)
    log(f"  fused_probe at {nq} queries x {nl} centers x {d}, nprobe {nprobe}: kernel "
        f"{ms:.4f} ms  plain {plain_ms:.4f} ms  library (addmm + topk) {lib_ms:.4f} ms  bound "
        f"{b_ms:.4f} ms ({b_by}); the d2 scratch {4 * nq * nl / 1e6:.1f} MB written and read "
        f"({1e3 * 8.0 * nq * nl / PEAK_BYTES:.4f} ms at the memory rate); plan {plan}; "
        f"{probe_passes(torch, lambda: topk_mod.fused_probe(Q, C, nprobe, center_norms=cn))}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms}


def probe_passes(torch, call, reps: int = 10) -> str:
    """The device time of each of the probe's two passes over `reps` calls,
    from torch.profiler's CUDA activity (kernel names probe_dist_kernel and
    probe_select_kernel): a line of ms a call, or what the profiler gave."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    got = {}
    for ev in prof.key_averages():
        for name in ("probe_dist_kernel", "probe_select_kernel"):
            if name in ev.key:
                t = getattr(ev, "device_time_total", None)
                t = getattr(ev, "cuda_time_total", 0.0) if t is None else t
                got[name] = got.get(name, 0.0) + t / 1e3 / reps
    if not got:
        return "the passes' device times: the profiler recorded no probe kernel"
    return "the passes' device times (torch.profiler): " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in got.items())


def probe_times(torch, C, cn, Q) -> dict:
    """Phase 4's probe row: at Q (4,096 queries) x the IVF-Flat index's
    4,096 centers x 256, for each PROBE_TIMED_NPROBE, the lists held by
    check_probe, then probe_time (the row takes nprobe 32's); then the
    long-row probe (probe_long)."""
    t0 = time.perf_counter()
    times = {}
    for nprobe in PROBE_TIMED_NPROBE:
        check_probe(torch, Q, C, cn, nprobe, "phase 4")
        times[nprobe] = probe_time(torch, C, cn, Q, nprobe)
    probe_long(torch)
    log(f"  the probe's checks and times: {time.perf_counter() - t0:.1f} s")
    return times[ANN_NPROBE]


def probe_long(torch) -> None:
    """The long-row probe (PROBE_LONG) on centers and queries from blobs
    (SEED + 16, the 20 blobs' spread): held by check_probe, then timed."""
    nq, nl, nprobe = PROBE_LONG
    Xh, _ = blobs(nq + nl, D_MAIN, K_MAIN, SEED + 16)
    C = torch.from_numpy(Xh[:nl]).cuda()
    Q = torch.from_numpy(Xh[nl:]).cuda()
    del Xh
    cn = torch.sum(C * C, dim=1)
    check_probe(torch, Q, C, cn, nprobe, "long row")
    probe_time(torch, C, cn, Q, nprobe)
    del C, Q, cn
    torch.cuda.empty_cache()


# (k, d) of phase 4's weighted k-means++ timings: phase 3's KMeans, IVF-PQ's
# 256-code codebooks over 8-dimensional subspaces
PP_SHAPES = ((K_MAIN, D_MAIN), (256, 8))


def kmeans_pp_times(torch) -> dict:
    """Phase 4: kmeans_init's last step, the weighted k-means++ over the
    k-means|| candidates (1 + 4k rows, two rounds of 2k), on the host
    (ops/kmeans.py::_weighted_kmeans_pp) and on the card
    (_weighted_kmeans_pp_device) from the same rng, at PP_SHAPES; the
    candidates are blobs from SEED, their weights 1-1000. Seconds, median of
    three runs, the device's with its read-back."""
    from spark_rapids_ml_torch.ops import kmeans as km

    out = {}
    for k, d in PP_SHAPES:
        g = np.random.default_rng(SEED)
        n = 1 + 4 * k
        cand = (g.normal(0, 4, (k, d))[g.integers(0, k, n)] + g.normal(size=(n, d))
                ).astype(np.float32)
        w = g.integers(1, 1001, n).astype(np.float32)
        cand_t, w_t = torch.from_numpy(cand).cuda(), torch.from_numpy(w).cuda()
        times = {"host": [], "card": []}
        for _ in range(3):
            t0 = time.perf_counter()
            km._weighted_kmeans_pp(cand, w, k, np.random.default_rng(SEED))
            times["host"].append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            km._weighted_kmeans_pp_device(cand_t, w_t, k, np.random.default_rng(SEED))
            times["card"].append(time.perf_counter() - t0)
        host, card = statistics.median(times["host"]), statistics.median(times["card"])
        log(f"  weighted k-means++ at k {k}, d {d}, {n} candidates: host {host:.6f} s, card "
            f"{card:.6f} s (ops/kmeans.py::PP_HOST_MAX_K = {km.PP_HOST_MAX_K})")
        out[(k, d)] = (host, card)
    return out


def ann_main() -> int:
    """Phase 3i alone, with phase 3's X made anew, and phase 4's probe row
    (about five minutes of command time):
    `python3 -c 'import sys, chip_smoke; sys.exit(chip_smoke.ann_main())'`."""
    import torch

    from spark_rapids_ml_torch import config as torch_config
    from spark_rapids_ml_torch.ops import _cuda
    from spark_rapids_ml_torch.utils import record_spans

    require(torch.cuda.is_available(), "phase 3i needs a CUDA card")
    log(f"card: {nvidia_smi()}")
    t0 = time.perf_counter()
    _cuda.build()
    log(f"built the kernels in {time.perf_counter() - t0:.1f} s")
    pin_in_core(torch_config)
    counters = launch_counters()
    t0 = time.perf_counter()
    Xh, true_centers = blobs(N_MAIN, D_MAIN, K_MAIN, SEED)
    X = torch.from_numpy(Xh).cuda()
    del Xh
    log(f"phase 3's X in {time.perf_counter() - t0:.1f} s")
    stages, path_counts = {}, {}

    def run_path(label, call):
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with record_spans() as spans:
            res = call()
        torch.cuda.synchronize()
        stages[label] = (time.perf_counter() - t1, spans)
        path_counts[label] = {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}
        return res

    probe = phase_ann(torch, run_path, stages, path_counts, X, true_centers)
    probe_times(torch, probe["C"], probe["cn"], probe["Q"])
    kmeans_pp_times(torch)
    log("phase 3i passed")
    return 0


def probe_main() -> int:
    """The IVF probe alone (about a minute of command time): its build and
    ptxas report, phase 2a's probe cases (phase_small_probe), and phase 4's
    probe timings (probe_times, the long-row probe included) on 4,096
    centers and 4,096 queries from blobs (SEED + 17) in place of phase 3i's
    IVF centers: `python3 -c 'import sys, chip_smoke; sys.exit(chip_smoke.probe_main())'`."""
    import torch

    from spark_rapids_ml_torch.ops import _cuda

    require(torch.cuda.is_available(), "the probe needs a CUDA card")
    log(f"card: {nvidia_smi()}")
    t0 = time.perf_counter()
    report = _cuda.build(["probe"])["probe"]
    log(f"built probe.cu in {time.perf_counter() - t0:.1f} s")
    for line in ptxas_lines(report):
        log(f"  ptxas probe: {line}")
    Xh, _ = blobs(ANN_NLIST + NQ_KNN10, D_MAIN, K_MAIN, SEED + 17)
    C = torch.from_numpy(Xh[:ANN_NLIST]).cuda()
    Q = torch.from_numpy(Xh[ANN_NLIST:]).cuda()
    cn = torch.sum(C * C, dim=1)
    phase_small_probe(torch)
    probe_times(torch, C, cn, Q)
    log("probe passed")
    return 0


def narrow_times(torch, X, valid_all, x2_main, traffics, narrow_items, errs=None,
                 launches=None) -> list:
    """Phase 4's rows 6b and 6c: each narrow form at each traffic ((queries,
    k, repetitions)) at its pool width, the kernel (csrc/topk_narrow.cu) and
    its products alone (ops/topk.py::_narrow_scan's products_only variant,
    the epilogue skipped, uncounted), the plain version, the bf16 library
    figure, the bound, the exact re-rank to k beside them, and the launch
    plan. Returns the JSON rows of the first traffic's forms when errs and
    launches are given."""
    from spark_rapids_ml_torch.ops import knn as knn_ops
    from spark_rapids_ml_torch.ops import topk as topk_mod

    n, d = X.shape
    rows = []

    def library_bf16(Q, kk):
        """cuBLAS bf16 addmm (x2 - 2 Q_blk X^T in bf16, KNN_LIB_BLOCK queries
        at a time) and torch.topk of each block, then + q2 on the kc kept."""
        q2 = torch.sum(Q * Q, dim=1)
        Qb = Q.to(torch.bfloat16)
        for s in range(0, Q.shape[0], KNN_LIB_BLOCK):
            dd = torch.addmm(x2_bf16[None, :], Qb[s : s + KNN_LIB_BLOCK], X_bf16.T, alpha=-2.0)
            v = torch.topk(dd, kk, dim=1, largest=False).values
            del dd
            (v.float() + q2[s : s + KNN_LIB_BLOCK, None]).clamp_min_(0.0)

    def rerank_stage(Q, kc, k, precision):
        _, idx = topk_mod.fused_topk(Q, X, valid_all, kc, x2=x2_main, precision=precision,
                                     items=narrow_items[precision])
        return lambda: (
            knn_ops.parity_rerank_sq(Q, X, valid_all,
                                     knn_ops.parity_rerank_sq(Q, X, valid_all, idx, k)[1], k)
            if kc != k else knn_ops.parity_rerank_sq(Q, X, valid_all, idx, k))

    X_bf16 = narrow_items["bfloat16"].rows
    x2_bf16 = x2_main.to(torch.bfloat16)
    sms = torch.cuda.get_device_properties(X.device).multi_processor_count
    for precision in KNN_FORMS:
        name = "topk_" + ("bf16" if precision == "bfloat16" else "int8")
        items = narrow_items[precision]
        esize = items.rows.element_size()
        dp = items.rows.shape[1]
        for Q_t, k, reps in traffics:
            nq_t = Q_t.shape[0]
            kc = topk_mod.oversample_width(k, n, precision)
            plan = topk_mod.narrow_plan(nq_t, n, dp, precision, kc, sms)
            kern = lambda: topk_mod.fused_topk(Q_t, X, valid_all, kc, x2=x2_main,
                                               precision=precision, items=items)
            ms = time_ms(torch, kern, reps, 1)
            prod_ms = time_ms(torch, lambda: topk_mod._narrow_scan(
                Q_t, X, valid_all, kc, x2_main, precision, items, products_only=True), reps, 1)
            plain_ms = time_ms(torch, lambda: topk_mod.topk_plain(
                Q_t, X, valid_all, kc, x2=x2_main, precision=precision, items=items),
                *((3, 1) if nq_t <= NQ_KNN else (2, 0)))
            lib_ms = time_ms(torch, lambda: library_bf16(Q_t, kc), 3, 1)
            rr_ms = time_ms(torch, rerank_stage(Q_t, kc, k, precision), reps, 1)
            # items in the form's type with their norms (and int8 scales) and
            # the mask, the queries likewise, the pool written; the products at
            # the form's dense peak on the tensor cores and the f32 epilogue (4
            # operations a pair) on the CUDA cores, which run at once
            nbytes = (esize * (n + nq_t) * dp + 4.0 * (n + nq_t)
                      * (2 if precision == "int8" else 1) + n + 8.0 * nq_t * kc)
            t_ops = max(2.0 * nq_t * n * d / PEAK_NARROW_OPS[precision],
                        4.0 * nq_t * n / PEAK_F32_FLOPS)
            t_bytes = nbytes / PEAK_BYTES
            b_ms, b_by = 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
            log(f"  {name} at {nq_t} queries, pool {kc} (k={k}): kernel {ms:.4f} ms  products "
                f"alone {prod_ms:.4f} ms  plain {plain_ms:.4f} ms  library (bf16 addmm + topk) "
                f"{lib_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by}); the exact re-rank to k "
                f"{rr_ms:.4f} ms; plan: {plan.consumers} consumer warpgroup(s), queries "
                f"{'resident' if plan.resident else 'streamed'}, {plan.stages} stages of "
                f"{plan.chunks} a tile, {plan.smem} bytes, {plan.n_splits} item ranges")
            if errs is not None and k == traffics[0][1]:
                rows.append({
                    "name": name, "route": "cuda", "source": SOURCE[name],
                    "replaces": REPLACES[name], "launches": launches[name],
                    "max_abs_err": errs[name]["max_abs_err"], "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                })
    return rows


def narrow_main() -> int:
    """The narrow top-k forms alone (a few minutes of command time): the
    build and ptxas report of csrc/topk_narrow.cu, phase 2a's narrow cases
    (phase_small_narrow), and phase 4's rows 6b and 6c (narrow_times) on
    8,388,608 x 256 blobs made on the card (SEED + 19) at both kNN traffics,
    after holding each pool to plain there:
    `python3 -c 'import chip_smoke; raise SystemExit(chip_smoke.narrow_main())'`."""
    import torch

    from spark_rapids_ml_torch.ops import _cuda
    from spark_rapids_ml_torch.ops import topk as topk_mod

    require(torch.cuda.is_available(), "the narrow top-k needs a CUDA card")
    log(f"card: {nvidia_smi()}")
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    reports = _cuda.build(["topk", "topk_narrow"])
    log(f"built topk.cu and topk_narrow.cu in {time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        for line in ptxas_lines(rep):
            log(f"  ptxas {name}: {line}")
    phase_small_narrow(torch)
    g = torch.Generator("cuda").manual_seed(SEED + 19)
    centers = 4.0 * torch.randn((K_MAIN, D_MAIN), device="cuda", generator=g)
    labels = torch.randint(0, K_MAIN, (N_MAIN,), device="cuda", generator=g)
    X = centers[labels] + torch.randn((N_MAIN, D_MAIN), device="cuda", generator=g)
    del labels
    valid_all = torch.ones(N_MAIN, dtype=torch.bool, device="cuda")
    x2 = torch.sum(X * X, dim=1)
    Qk = X[:NQ_KNN].clone()
    fresh = torch.randint(0, K_MAIN, (NQ_KNN10 - NQ_KNN10 // 2,), device="cuda", generator=g)
    Qk10 = torch.cat([X[torch.randperm(N_MAIN, device="cuda", generator=g)[: NQ_KNN10 // 2]],
                      centers[fresh] + torch.randn((len(fresh), D_MAIN), device="cuda",
                                                   generator=g)])
    items = {p: topk_mod.narrow_rows(X, p) for p in KNN_FORMS}
    for precision in KNN_FORMS:
        for Q_t, k in ((Qk, K_KNN), (Qk10, K_KNN10)):
            kc = topk_mod.oversample_width(k, N_MAIN, precision)
            check_topk_narrow(Q_t, X, valid_all, kc, precision,
                              f"nq={Q_t.shape[0]} n={N_MAIN} d={D_MAIN} pool {kc} (k={k})",
                              items[precision])
    narrow_times(torch, X, valid_all, x2, ((Qk, K_KNN, 10), (Qk10, K_KNN10, 3)), items)
    log("narrow top-k passed")
    return 0


# ------------------------------------------------ phase 3m: across processes

MP_WORLD = 2
MP_SHARE = 0.6  # rank 0's share of the rows; rank 1 takes the rest
MP_TIMEOUT = 600  # seconds a rank may run, and the group's collective timeout
MP_SMALL = (5_003, 37)  # the empty-rank case's shape: rank 0 all rows, rank 1 none
# the fits of each rank: label -> input ("array" X, or "table": X, label, weight)
MP_FITS = {"PCA": "array", "KMeans": "array", "KMeans, weighted": "table",
           "LinReg OLS": "table", "LinReg elastic net": "table"}
# the kernels each fit must launch on every rank; in-core KMeans also assign
# (the summary's cluster sizes; the init's weighting runs on rank 0 alone)
MP_KERNELS = {"PCA": ("xtx",), "KMeans": ("lloyd",), "KMeans, weighted": ("lloyd_weighted",),
              "LinReg OLS": ("xtxy",), "LinReg elastic net": ("xtxy",)}
# the 2-rank LinearRegression coefficients are held, relative 2-norm, to the
# f64 solve and to the single-process f32 fit named here (phase 3's in-core
# fits, phase 3s's streamed OLS): a few times the 1.7e-5 to 4.2e-5 that the
# f32 fits show against f64 and against each other, and under the distance
# (logged beside: 1.3e-4 OLS, 2.4e-4 elastic net on an H100) of the f64 fit
# of rank 0's rows alone from the full one
MP_LR_RTOL = 1e-4
MP_LR_SINGLE = {("in-core", "LinReg OLS"): "ols", ("streamed", "LinReg OLS"): "ols_streamed",
                ("in-core", "LinReg elastic net"): "en", ("streamed", "LinReg elastic net"): "en"}
# kNN across the ranks: the all-gather route at phase 3's two traffics (the
# bench's queries all on rank 0, the 4,096 split 60/40) on the main X, and the
# ring through the estimator on X's first MP_RING_ITEMS rows against the next
# MP_RING_QUERIES rows (the estimator's ring threshold), both 60/40
MP_RING_ITEMS = 1 << 20
MP_RING_QUERIES = 65_536
MP_RING_F64_QUERIES = 512  # of the ring's single-process search's queries held to f64
MP_KNN_SMALL_QUERIES = 100  # the empty-rank case's queries: its X's first rows
# the forests across the ranks: phase 3's forest data 60/40, at RF_DEPTH and
# RF_BINS, with numTrees cut from RF_TREES to MP_RF_TREES for the time limit;
# held to the first MP_RF_TREES trees of phase 3's single-process fits
MP_RF_TREES = 4
# DBSCAN across the ranks: phase 3's 262,144 x 32 rows, MP_SHARE / the rest,
# held to phase 3's single-process transform under the borderline rule
# (check_mp_dbscan): a pair is borderline when its f64 d2 lies within
# DB_BAND_ULPS * 2^-23 * (|a|^2 + |b|^2) of eps^2, and only such a pair may fall
# on either side of eps^2 in the ranks' shapes and in one process's. The band
# is held, every run, to cover twice the two d2 errors it stands for
# (dbscan_band): the library f32 d2 of the min-label scan and the count
# kernel's 3xTF32 d2. 16 units is d u (|a|^2 + |b|^2) at d = 32, u = 2^-24: the
# f32 FMA dot product's worst rounding bound on 2 a.b
DB_BAND_ULPS = 16.0
DB_BAND_SAMPLE = 4096  # rows whose f32 d2 against every row are read for the band
DB_MOVED_SHARE = 1e-3  # the most rows whose label may differ from one process's


def knn10_queries(Xh, true_centers):
    """The k = 10 search's NQ_KNN10 queries: rows of X (the first half, each
    its own nearest item) and fresh rows of X's mixture. Returns (queries,
    the rows of X among them)."""
    rng = np.random.default_rng(SEED + 7)
    self_rows = rng.choice(len(Xh), NQ_KNN10 // 2, replace=False)
    fresh = true_centers[rng.integers(0, K_MAIN, NQ_KNN10 - NQ_KNN10 // 2)]
    fresh += rng.standard_normal(fresh.shape, dtype=np.float32)
    return np.concatenate([Xh[self_rows], fresh]), self_rows


def knn_arrays(knn_df):
    """(ids (nq, k) int64, distances (nq, k) f32) of a kneighbors frame;
    (0, 0) arrays for a frame with no rows."""
    if not len(knn_df):
        return np.zeros((0, 0), np.int64), np.zeros((0, 0), np.float32)
    return (np.stack(knn_df["indices"].to_numpy()).astype(np.int64),
            np.stack(knn_df["distances"].to_numpy()).astype(np.float32))


def knn_single_refs(Xh, Q10) -> dict:
    """Phase 3's single-process searches that phase 3m is held to, made anew
    (phase 3m alone): (traffic, form) -> (ids, distances)."""
    from spark_rapids_ml_torch import config as torch_config
    from spark_rapids_ml_torch.knn import NearestNeighbors

    nn = NearestNeighbors(k=K_KNN, inputCol="features").fit(Xh)
    out = {}
    for form in ("float32",) + KNN_FORMS:
        torch_config.set("knn_precision", form)
        try:
            for tag, k, Q in (("bench", K_KNN, Xh[:NQ_KNN]), ("k=10", K_KNN10, Q10)):
                nn.setK(k)
                out[(tag, form)] = knn_arrays(nn.kneighbors(Q)[2])
        finally:
            torch_config.unset("knn_precision")
    return out


def multiprocess_main() -> int:
    """Phase 3m alone on the card, with the single-process fits it is held to
    made first (the build, the main X, PCA in-core and streamed,
    LinearRegression OLS in-core and streamed and elastic net, the f64
    LinearRegression references, the kNN searches in every form; a few
    minutes; not the forests, which phase_forest runs with its data):
    `python3 -c 'import sys, chip_smoke; sys.exit(chip_smoke.multiprocess_main())'`."""
    import torch

    from spark_rapids_ml_torch import config as torch_config
    from spark_rapids_ml_torch.feature import PCA
    from spark_rapids_ml_torch.ops import _cuda
    from spark_rapids_ml_torch.regression import LinearRegression

    require(torch.cuda.is_available(), "phase 3m needs a CUDA card")
    log(f"card: {nvidia_smi()}; {torch.cuda.device_count()} card(s)")
    _cuda.build()
    Xh, true_centers = blobs(N_MAIN, D_MAIN, K_MAIN, SEED)
    yh = regression_label(Xh, SEED)
    w_h = np.random.default_rng(SEED + 2).uniform(0.5, 2.0, N_MAIN).astype(np.float32)
    X, y = torch.from_numpy(Xh).cuda(), torch.from_numpy(yh).cuda()
    pin_in_core(torch_config)
    pca = PCA(k=K_PCA, inputCol="features").fit(Xh)
    pin_stream_keys(torch_config, 1, STREAM_BATCH_MAIN, None)
    pca_s = PCA(k=K_PCA, inputCol="features").fit(Xh)
    frame = labelled_input(Xh, yh, w_h)
    ols_s = LinearRegression().fit(frame)
    pin_in_core(torch_config)
    ols = LinearRegression(standardization=True).fit(frame)
    en = LinearRegression(regParam=EN_REG, elasticNetParam=EN_L1).fit(frame)
    del frame
    _, beta64, en64 = linreg_f64(torch, X, y)
    del y
    Q10, _ = knn10_queries(Xh, true_centers)
    phase_multiprocess(torch, Xh, yh, w_h, X, {
        "pca": pca, "pca_streamed": pca_s, "beta64": beta64.cpu().numpy(),
        "en64": en64["coefficients"], "ols": ols.coefficients, "en": en.coefficients,
        "ols_streamed": ols_s.coefficients, "q10": Q10, "knn": knn_single_refs(Xh, Q10),
        "db": dbscan_single_ref(torch)})
    log("phase 3m passed")
    return 0


def streamed_main() -> int:
    """Phase 3o alone on the card, with the in-core results it is held to
    made first (phase 3's f32 kNN searches and DBSCAN transform with its
    band; the forest rows on the card): the streamed kNN, DBSCAN and
    classifier, not phase 3m's ranks (about five minutes of command time):
    `python3 -c 'import sys, chip_smoke; sys.exit(chip_smoke.streamed_main())'`."""
    import torch

    from spark_rapids_ml_torch import config as torch_config
    from spark_rapids_ml_torch.knn import NearestNeighbors
    from spark_rapids_ml_torch.ops import _cuda
    from spark_rapids_ml_torch.utils import record_spans

    require(torch.cuda.is_available(), "phase 3o needs a CUDA card")
    log(f"card: {nvidia_smi()}")
    _cuda.build()
    counters = launch_counters()
    stages, path_counts = {}, {}

    def run_path(label, call):
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with record_spans() as spans:
            out = call()
        torch.cuda.synchronize()
        stages[label] = (time.perf_counter() - t0, spans)
        path_counts[label] = {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}
        return out

    pin_in_core(torch_config)
    Xh, true_centers = blobs(N_MAIN, D_MAIN, K_MAIN, SEED)
    X = torch.from_numpy(Xh).cuda()
    Q10, _ = knn10_queries(Xh, true_centers)
    query_ids = np.arange(NQ_KNN10, dtype=np.int64) + 10**9
    nn = run_path("NearestNeighbors fit", lambda: NearestNeighbors(
        k=K_KNN, inputCol="features", idCol="id").fit(Xh))
    refs = {}
    for tag, k, Q in (("bench", K_KNN, Xh[:NQ_KNN]), ("k=10", K_KNN10, Q10)):
        nn.setK(k)
        refs[(tag, "float32")] = knn_arrays(nn.kneighbors(Q)[2])
    del nn
    db_ref = dbscan_single_ref(torch)
    stages["DBSCAN transform"] = (float("nan"), {})
    phase_streamed_pairwise(torch, run_path, stages, path_counts, Xh, X, Q10, query_ids, refs,
                            db_ref)
    del Xh, X
    gc.collect()
    torch.cuda.empty_cache()
    Xh, ycls = forest_data(N_RF, D_RF, SEED)
    workdir = mp_workdir("phase3o_forest")
    try:
        Xf = np.lib.format.open_memmap(workdir / "rf_X.npy", mode="w+", dtype=np.float32,
                                       shape=Xh.shape)
        for r0 in range(0, N_RF, RF_CHUNK):
            Xf[r0 : r0 + RF_CHUNK] = Xh[r0 : r0 + RF_CHUNK]
        Xf.flush()
        del Xf
        X = torch.from_numpy(Xh).cuda().contiguous()
        del Xh
        phase_streamed_forest(torch, run_path, stages, path_counts, workdir, X,
                              torch.from_numpy(ycls).cuda(), ycls)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log("phase 3o passed")
    return 0


def dbscan_mp_main() -> int:
    """Phase 3m's DBSCAN alone on the card, with the single-process transform
    it is held to made first (dbscan_single_ref, the band's readings with it):
    two ranks over gloo on one card, then over NCCL one card a rank where two
    cards exist (about two minutes of command time on one card):
    `python3 -c 'import sys, chip_smoke; sys.exit(chip_smoke.dbscan_mp_main())'`."""
    import torch

    from spark_rapids_ml_torch.ops import _cuda

    require(torch.cuda.is_available(), "phase 3m needs a CUDA card")
    log(f"card: {nvidia_smi()}; {torch.cuda.device_count()} card(s)")
    _cuda.build()
    t0 = time.perf_counter()
    ref = dbscan_single_ref(torch)
    log(f"  phase 3's DBSCAN transform and its band: {time.perf_counter() - t0:.1f} s, "
        f"{ref['rounds']} rounds")
    workdir = mp_workdir("phase3m_dbscan")
    np.save(workdir / "db_X.npy", ref["X"])
    runs = [("gloo, one card", "0")]
    if torch.cuda.device_count() >= MP_WORLD:
        runs.append(("NCCL, one card a rank", None))
    else:
        log(f"  the NCCL run (one rank a card) did not take place: "
            f"{torch.cuda.device_count()} card(s)")
    for run, visible in runs:
        t0 = time.perf_counter()
        ranks = run_ranks(workdir, MP_WORLD, "cuda", visible, job="dbscan")
        log(f"  run {run}, DBSCAN: {time.perf_counter() - t0:.1f} s with the ranks' start")
        check_mp_dbscan(run, ranks, ref, None, True, "gloo" if visible is not None else "nccl")
    log("phase 3m DBSCAN passed")
    return 0


def dbscan_single_ref(torch) -> dict:
    """Phase 3's single-process DBSCAN transform that phase 3m is held to,
    made anew (phase 3m alone): its rows, labels and rounds, the count
    kernel's counts, and the rule's band (dbscan_band)."""
    from spark_rapids_ml_torch.clustering import DBSCAN
    from spark_rapids_ml_torch.ops import dbscan as dbscan_mod
    from spark_rapids_ml_torch.ops.count import fused_count_below

    Xdb_h, _ = dbscan_blobs(N_DB, D_DB, K_MAIN, SEED)
    model = DBSCAN(eps=DB_EPS, min_samples=DB_MIN_SAMPLES).fit(Xdb_h)
    rounds = dbscan_mod._propagate_labels.rounds
    labels = model.transform(Xdb_h)["prediction"].to_numpy()
    rounds = dbscan_mod._propagate_labels.rounds - rounds
    Xdb = torch.from_numpy(Xdb_h).cuda()
    valid = torch.ones(N_DB, dtype=torch.bool, device="cuda")
    counts = fused_count_below(Xdb, Xdb, valid, DB_EPS * DB_EPS)
    return {"X": Xdb_h, "labels": labels, "rounds": rounds, "counts": counts.long().cpu().numpy(),
            **dbscan_band(torch, Xdb, counts, mp_rows(N_DB, 0)[1])}


def dbscan_band(torch, X, counts, cut: int) -> dict:
    """The borderline rule's band on phase 3's DBSCAN rows X (on the card):
    "near", each row's pairs whose f64 d2 (of the f32 rows) lies within
    DB_BAND_ULPS units of eps^2, a unit being 2^-23 * (|a|^2 + |b|^2); and the
    two readings, in those units, that the band must cover twice over:
    "f32", the largest error against f64 of the library f32 d2 that the
    min-label scan takes (ops/knn.py::_block_sq_dists) for DB_BAND_SAMPLE rows
    spread over X against every row, at one process's shape, at the ring's
    (rows [0, cut) and the rest padded to as many) and at the streamed
    tier's (its first tile of ITEM_BLOCK rows and its last, padded); "count", the least
    band that explains the count kernel's `counts` against the exact f64
    counts at every row (a row counted m too many has at least m pairs above
    eps^2 counted: the m-th nearest above; too few, below). Fails when a
    reading exceeds half the band."""
    from spark_rapids_ml_torch.ops.knn import _block_sq_dists
    from spark_rapids_ml_torch.ops.pairwise_streaming import ITEM_BLOCK

    t0 = time.perf_counter()
    n, eps2 = X.shape[0], DB_EPS * DB_EPS
    X64 = X.double()
    sq = (X64 * X64).sum(1)
    exact = torch.empty(n, dtype=torch.int64, device=X.device)
    near = torch.empty_like(exact)
    step = max(1, (1 << 27) // n)

    def offsets(rows, lo=0, hi=n):
        """(f64 d2 - eps2) / unit of `rows` (indices) against rows [lo, hi)."""
        d2 = (sq[rows, None] - 2.0 * (X64[rows] @ X64[lo:hi].T) + sq[None, lo:hi]).clamp_min(0.0)
        return (d2 - eps2) / (2.0**-23 * (sq[rows, None] + sq[None, lo:hi]))

    every = torch.arange(n, device=X.device)
    for s in range(0, n, step):
        r = offsets(every[s : s + step])
        exact[s : s + step] = (r <= 0).sum(1)
        near[s : s + step] = (r.abs() <= DB_BAND_ULPS).sum(1)
    delta = counts.long() - exact
    wrong = delta.nonzero()[:, 0]
    count_read = 0.0
    for b in range(0, len(wrong), step):
        rows = wrong[b : b + step]
        r, m = offsets(rows), delta[rows]
        # too many: the pairs above eps2 (r > 0) by distance; too few: those at or below
        side = torch.where((m > 0)[:, None] == (r > 0), r.abs(), torch.inf)
        kth = torch.topk(side, int(m.abs().max()), dim=1, largest=False).values
        count_read = max(count_read, float(kth.gather(1, (m.abs() - 1)[:, None]).max()))
    sample = every[:: max(1, n // DB_BAND_SAMPLE)][:DB_BAND_SAMPLE]
    shard = torch.zeros((cut, X.shape[1]), dtype=X.dtype, device=X.device)
    shard[: n - cut] = X[cut:]
    # the streamed tier's tiles (phase 3o): ITEM_BLOCK rows, the last zero-padded
    tile = min(ITEM_BLOCK, n)
    last = (n - 1) // tile * tile
    tail = torch.zeros((tile, X.shape[1]), dtype=X.dtype, device=X.device)
    tail[: n - last] = X[last:]
    f32_read = 0.0
    for lo, items in ((0, X), (0, X[:cut]), (cut, shard), (0, X[:tile]), (last, tail)):
        hi = min(n, lo + items.shape[0])
        x2 = torch.sum(items * items, dim=1)
        for b in range(0, len(sample), step):
            rows = sample[b : b + step]
            d2 = _block_sq_dists(X[rows], items, x2)[:, : hi - lo].double()
            d64 = offsets(rows, lo, hi)  # in units: back to d2 below
            unit = 2.0**-23 * (sq[rows, None] + sq[None, lo:hi])
            f32_read = max(f32_read, float(((d2 - eps2) / unit - d64).abs().max()))
    ends = int((near > 0).sum())
    log(f"  DBSCAN band: {DB_BAND_ULPS:g} units of 2^-23 (|a|^2 + |b|^2) about eps^2; readings "
        f"in those units: f32 library d2 {f32_read:.4f} (max over {len(sample)} rows x {n}, at "
        f"one process's, the ring's and the stream's tile shapes), count kernel {count_read:.4f} (the least band "
        f"explaining its counts against f64 at every row; {len(wrong)} rows off f64 by "
        f"{int(delta.abs().sum())}); rows at an end of a borderline pair {ends} "
        f"({ends / n:.4%}), borderline pairs {int(near.sum()) // 2}; "
        f"{time.perf_counter() - t0:.1f} s")
    require(f32_read <= DB_BAND_ULPS / 2 and count_read <= DB_BAND_ULPS / 2,
            f"DBSCAN band {DB_BAND_ULPS}: a d2 error reading exceeds half of it "
            f"(f32 {f32_read}, count {count_read})")
    return {"near": near.cpu().numpy(), "band_reads": {"f32": f32_read, "count": count_read}}


def launch_counters() -> dict:
    """kernel name -> (the function holding its launch counter, the counter)."""
    from spark_rapids_ml_torch.ops import count as count_mod
    from spark_rapids_ml_torch.ops import histogram, xtwx
    from spark_rapids_ml_torch.ops import lloyd as lloyd_mod
    from spark_rapids_ml_torch.ops import select as select_mod
    from spark_rapids_ml_torch.ops import topk as topk_mod

    return {
        "xtx": (xtwx.xtx, "launches"),
        "lloyd": (lloyd_mod.lloyd_step, "launches"),
        "lloyd_weighted": (lloyd_mod.lloyd_step, "weighted_launches"),
        "assign": (select_mod.assign, "launches"),
        "xtxy": (xtwx.xtxy, "launches"),
        "count": (count_mod.fused_count_below, "launches"),
        "topk": (topk_mod.fused_topk, "launches"),
        "topk_bf16": (topk_mod.fused_topk, "bf16_launches"),
        "topk_int8": (topk_mod.fused_topk, "int8_launches"),
        "node_bin_hist": (histogram.node_bin_histogram, "launches"),
        "segment_hist": (histogram.segment_histogram, "launches"),
        "lloyd_bf16": (lloyd_mod.lloyd_step, "launches_bf16"),
        "lloyd_high": (lloyd_mod.lloyd_step, "launches_high"),
        "lloyd_weighted_bf16": (lloyd_mod.lloyd_step, "weighted_launches_bf16"),
        "lloyd_weighted_high": (lloyd_mod.lloyd_step, "weighted_launches_high"),
        "assign_high": (select_mod.assign, "launches_high"),
        "xtx_high": (xtwx.xtx, "launches_high"),
        "xtxy_high": (xtwx.xtxy, "launches_high"),
        "fused_probe": (topk_mod.fused_probe, "launches"),
    }


def mp_estimator(label: str):
    """A new estimator of phase 3m's fit `label`, as phases 3 and 3s make it."""
    from spark_rapids_ml_torch.clustering import KMeans
    from spark_rapids_ml_torch.feature import PCA
    from spark_rapids_ml_torch.regression import LinearRegression

    return {
        "PCA": lambda: PCA(k=K_PCA, inputCol="features"),
        "KMeans": lambda: KMeans(k=K_MAIN, seed=1, maxIter=KM_STREAM_MAX_ITER),
        "KMeans, weighted": lambda: KMeans(k=K_MAIN, seed=1, maxIter=KM_STREAM_MAX_ITER,
                                           weightCol="weight"),
        "LinReg OLS": lambda: LinearRegression(standardization=True),
        "LinReg elastic net": lambda: LinearRegression(regParam=EN_REG, elasticNetParam=EN_L1),
    }[label]()


def mp_rows(n: int, rank: int, share: float = MP_SHARE):
    """Rank `rank`'s rows [lo, hi) of n: rank 0 the first share, rank 1 the rest."""
    cut = int(share * n)
    return (0, cut) if rank == 0 else (cut, n)


def labelled_input(Xl, yl, wl):
    """A labelled frame of the rows: an Arrow table over them (a view) when
    pyarrow imports, else a pandas frame."""
    try:
        import pyarrow as pa

        return arrow_table(pa, Xl, yl, wl)
    except ImportError:
        import pandas as pd

        return pd.DataFrame({"features": list(Xl), "label": yl, "weight": wl})


def mp_small_data():
    """The empty-rank case's data, the same on every process: blobs of
    MP_SMALL with a label, a weight and a class label (the label above its
    median)."""
    n, d = MP_SMALL
    X, _ = blobs(n, d, 4, SEED + 11)
    y = regression_label(X, SEED + 11)
    w = np.random.default_rng(SEED + 12).uniform(0.5, 2.0, n).astype(np.float32)
    return X, y, w, (y > np.median(y)).astype(np.float32)


def mp_small_fits(X, y, w, c):
    """The empty-rank case's fits (in-core, and the classifier also
    out-of-core): label -> model attributes; and "NearestNeighbors": the
    (ids, distances) of the kNN search of its first MP_KNN_SMALL_QUERIES rows
    (none on a rank without rows)."""
    from spark_rapids_ml_torch import config as torch_config
    from spark_rapids_ml_torch.classification import RandomForestClassifier
    from spark_rapids_ml_torch.knn import NearestNeighbors
    from spark_rapids_ml_torch.regression import RandomForestRegressor

    table = labelled_input(X, y, w)
    out = {label: mp_estimator(label).fit(X if kind == "array" else table).get_model_attributes()
           for label, kind in MP_FITS.items() if label != "LinReg elastic net"}
    params = dict(numTrees=MP_RF_TREES, maxDepth=RF_DEPTH, maxBins=RF_BINS, seed=SEED)
    out["RF classifier"] = RandomForestClassifier(**params).fit(
        labelled_input(X, c, w)).get_model_attributes()
    pin_stream_keys(torch_config, 1, STREAM_BATCH_MAIN, None)
    try:
        out["RF classifier, streamed"] = RandomForestClassifier(**params).fit(
            labelled_input(X, c, w)).get_model_attributes()
    finally:
        pin_in_core(torch_config)
    out["RF regressor"] = RandomForestRegressor(**params).fit(table).get_model_attributes()
    nn = NearestNeighbors(k=K_KNN10, inputCol="features").fit(X)
    out["NearestNeighbors"] = knn_arrays(nn.kneighbors(X[:MP_KNN_SMALL_QUERIES])[2])
    return out


def rank_call(torch, counters, sync, call):
    """call() with the launch counters and the collective counters zeroed
    just before it and read just after, its stages timed by the port's spans:
    (its result, {seconds, launches, comm, spans})."""
    from spark_rapids_ml_torch.parallel import partitioner
    from spark_rapids_ml_torch.utils import record_spans

    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    partitioner.reset_counters()
    sync()
    t0 = time.perf_counter()
    with record_spans() as spans:
        out = call()
    sync()
    return out, {"seconds": time.perf_counter() - t0,
                 "launches": {name: getattr(fn, attr) for name, (fn, attr) in counters.items()},
                 "comm": dict(partitioner.counters), "spans": dict(spans)}


def rank_knn(torch, part, Xmm, rank, workdir, counters, sync) -> dict:
    """Phase 3m's kNN runs on one rank: (a) NearestNeighbors on its 60/40
    share of the main X (default ids), searched at the bench traffic (the
    queries all on rank 0) and at k = 10 (the 4,096 queries 60/40) in every
    form, by the all-gather route; (b) the ring through the estimator on its
    share of X's first MP_RING_ITEMS rows against its share of the next
    MP_RING_QUERIES, then exact_knn_distributed on the same tensors."""
    import os

    from spark_rapids_ml_torch import config as torch_config
    from spark_rapids_ml_torch.knn import NearestNeighbors
    from spark_rapids_ml_torch.ops.knn import exact_knn_distributed

    out = {}
    lo, hi = mp_rows(Xmm.shape[0], rank)
    Q10 = np.load(os.path.join(workdir, "q10.npy"))
    q10 = Q10[slice(*mp_rows(len(Q10), rank))]
    bench = Xmm[: NQ_KNN if rank == 0 else 0]
    nn, out["fit"] = rank_call(torch, counters, sync, lambda: NearestNeighbors(
        k=K_KNN, inputCol="features").fit(Xmm[lo:hi]))
    for form in ("float32",) + KNN_FORMS:
        torch_config.set("knn_precision", form)
        try:
            for tag, k, Q in (("bench", K_KNN, bench), ("k=10", K_KNN10, q10)):
                nn.setK(k)
                res, out[(tag, form)] = rank_call(torch, counters, sync, lambda: nn.kneighbors(Q))
                out[(tag, form)]["result"] = knn_arrays(res[2])
        finally:
            torch_config.unset("knn_precision")
    del nn
    gc.collect()
    n_ring = min(MP_RING_ITEMS, Xmm.shape[0] - MP_RING_QUERIES)
    ilo, ihi = mp_rows(n_ring, rank)
    qlo, qhi = mp_rows(MP_RING_QUERIES, rank)
    Qr = Xmm[n_ring + qlo : n_ring + qhi]
    nr, out["ring fit"] = rank_call(torch, counters, sync, lambda: NearestNeighbors(
        k=K_KNN10, inputCol="features").fit(Xmm[ilo:ihi]))
    res, out["ring"] = rank_call(torch, counters, sync, lambda: nr.kneighbors(Qr))
    out["ring"]["result"] = knn_arrays(res[2])
    # the all-gather route on the same ranks, items and queries
    X, x2, _ = nr._items_on(nr.device)
    Q = torch.from_numpy(np.ascontiguousarray(Qr)).to(X.device)
    valid = torch.ones((X.shape[0],), dtype=torch.bool, device=X.device)
    (d2, ids), out["ring, all-gather route"] = rank_call(
        torch, counters, sync, lambda: exact_knn_distributed(
            Q, X, valid, K_KNN10, part, nr._layout, x2=x2, ids=nr._ids_on(X.device)))
    # the square root on the host, as kneighbors takes it
    out["ring, all-gather route"]["result"] = (ids.cpu().numpy(), np.sqrt(d2.cpu().numpy()))
    out["ring rows"] = ((ilo, ihi), (qlo, qhi), n_ring)
    return out


def rank_forest(torch, rank, workdir, counters, sync) -> dict:
    """Phase 3m's forest runs on one rank: RandomForestClassifier and
    RandomForestRegressor at MP_RF_TREES trees on its 60/40 share of the
    forest data, from an Arrow table over the memory-mapped rows; then the
    classifier out-of-core (every streaming key pinned)."""
    import os

    import pyarrow as pa

    from spark_rapids_ml_torch import config as torch_config
    from spark_rapids_ml_torch.classification import RandomForestClassifier
    from spark_rapids_ml_torch.regression import RandomForestRegressor

    from spark_rapids_ml_torch.ops import trees

    X = np.load(os.path.join(workdir, "rf_X.npy"), mmap_mode="r")
    lo, hi = mp_rows(X.shape[0], rank)
    params = dict(numTrees=MP_RF_TREES, maxDepth=RF_DEPTH, maxBins=RF_BINS, seed=SEED)
    out = {"rows": (lo, hi)}
    split_gains = trees._split_gains
    for label, est, y in (("RF classifier", RandomForestClassifier, "rf_ycls"),
                          ("RF regressor", RandomForestRegressor, "rf_yreg"),
                          ("RF classifier, streamed", RandomForestClassifier, "rf_ycls")):
        yl = np.load(os.path.join(workdir, f"{y}.npy"), mmap_mode="r")[lo:hi]
        feats = pa.FixedSizeListArray.from_arrays(pa.array(X[lo:hi].reshape(-1)), X.shape[1])
        table = pa.table({"features": feats, "label": pa.array(yl)})
        top2 = []  # the regressor's: each level's two best gains a node (near ties)

        def recorded(*args, **kwargs):
            gain = split_gains(*args, **kwargs)
            top2.append(torch.topk(gain.reshape(gain.shape[0], -1), 2, dim=1).values.cpu().numpy())
            return gain

        if label == "RF regressor":
            trees._split_gains = recorded
        if label.endswith("streamed"):
            pin_stream_keys(torch_config, 1, STREAM_BATCH_MAIN, None)
        try:
            model, out[label] = rank_call(torch, counters, sync, lambda: est(**params).fit(table))
        finally:
            trees._split_gains = split_gains
            pin_in_core(torch_config)
        out[label]["attrs"] = model.get_model_attributes()
        out[label]["top2"] = top2
        del model, table, feats
        gc.collect()
    return out


def rank_main(argv) -> int:
    """One rank of phase 3m: `python3 chip_smoke.py --rank RANK WORLD WORKDIR
    DEVICE [JOB]`. It joins the group through the SRML_TPU_* environment.
    JOB "main" (the default) fits MP_FITS on its rows of WORKDIR/{X,y,w}.npy
    (memory-mapped) in-core and streamed, runs the kNN searches (rank_knn),
    then the empty-rank case; JOB "forest" fits the forests on its rows of
    WORKDIR/rf_*.npy (rank_forest); JOB "dbscan" clusters its rows of
    WORKDIR/db_X.npy (rank_dbscan). It writes WORKDIR/rank<RANK>.pkl."""
    import datetime
    import os
    import pickle

    import torch

    from spark_rapids_ml_torch import config as torch_config
    from spark_rapids_ml_torch.ops import kmeans as kmeans_mod
    from spark_rapids_ml_torch.ops.lloyd import lloyd_step
    from spark_rapids_ml_torch.parallel import bootstrap, partitioner

    rank, world, workdir, device = int(argv[0]), int(argv[1]), argv[2], argv[3]
    job = argv[4] if len(argv) > 4 else "main"
    torch_config.set("device", device)
    bootstrap.init_from_env(device=device, timeout=datetime.timedelta(seconds=MP_TIMEOUT))
    part = partitioner.active_partitioner()
    require((part.process_index, part.process_count) == (rank, world),
            f"rank {rank} of {world} joined as {part.process_index} of {part.process_count}")
    on_card = device == "cuda"
    dev = torch.device("cuda", torch.cuda.current_device()) if on_card else torch.device("cpu")

    def sync():
        if on_card:
            torch.cuda.synchronize()

    counters = launch_counters()
    pin_in_core(torch_config)
    if job in ("forest", "dbscan"):
        run = rank_forest if job == "forest" else rank_dbscan
        out = {"rank": rank, "backend": torch.distributed.get_backend(), "device": str(dev),
               "card": torch.cuda.get_device_name(dev) if on_card else "cpu",
               job: run(torch, rank, workdir, counters, sync)}
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        bootstrap.reset_process_group()
        return 0
    inits = []
    real_init = kmeans_mod.gathered_init

    def recorded_init(*args):
        centers = real_init(*args)
        inits.append(centers.cpu().numpy().copy())
        return centers

    kmeans_mod.gathered_init = recorded_init
    Xmm = np.load(os.path.join(workdir, "X.npy"), mmap_mode="r")
    ymm = np.load(os.path.join(workdir, "y.npy"), mmap_mode="r")
    wmm = np.load(os.path.join(workdir, "w.npy"), mmap_mode="r")
    lo, hi = mp_rows(Xmm.shape[0], rank)
    Xl, yl, wl = Xmm[lo:hi], ymm[lo:hi], wmm[lo:hi]
    table = labelled_input(Xl, yl, wl)
    out = {"rank": rank, "rows": (lo, hi), "backend": torch.distributed.get_backend(),
           "device": str(dev), "card": torch.cuda.get_device_name(dev) if on_card else "cpu",
           "fits": {}}
    for mode in ("in-core", "streamed"):
        if mode == "in-core":
            pin_in_core(torch_config)
        else:
            pin_stream_keys(torch_config, 1, STREAM_BATCH_MAIN, None)
        for label, kind in MP_FITS.items():
            for fn, attr in counters.values():
                setattr(fn, attr, 0)
            partitioner.reset_counters()
            inits.clear()
            sync()
            t0 = time.perf_counter()
            model = mp_estimator(label).fit(Xl if kind == "array" else table)
            sync()
            out["fits"][(mode, label)] = {
                "seconds": time.perf_counter() - t0,
                "attrs": model.get_model_attributes(),
                "init": inits[0] if inits else None,
                "launches": {name: getattr(fn, attr) for name, (fn, attr) in counters.items()},
                "comm": dict(partitioner.counters),
            }
    pin_in_core(torch_config)
    # the first Lloyd step of each KMeans fit from its initial centers, added
    # across the ranks: the parent holds it to the plain step over all of X
    Xd = torch.from_numpy(np.ascontiguousarray(Xl)).to(dev)
    wd = torch.from_numpy(np.ascontiguousarray(wl)).to(dev)
    for label, w_t in (("KMeans", None), ("KMeans, weighted", wd)):
        init = torch.from_numpy(out["fits"][("in-core", label)]["init"]).to(dev)
        step = lloyd_step(Xd, init, Xd.shape[0], w_t)
        out["fits"][("in-core", label)]["first_step"] = tuple(
            t.cpu().numpy() for t in part.all_reduce_sum(*step))
    del Xd, wd
    out["knn"] = rank_knn(torch, part, Xmm, rank, workdir, counters, sync)
    # the empty-rank case: rank 0 holds every row, rank 1 none
    Xs, ys, ws, cs = mp_small_data()
    keep = Xs.shape[0] if rank == 0 else 0
    out["small"] = mp_small_fits(Xs[:keep], ys[:keep], ws[:keep], cs[:keep])
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    bootstrap.reset_process_group()
    return 0


def run_ranks(workdir, world: int, device: str, visible=None, job: str = "main") -> list:
    """Start `world` rank processes of this script (rank_main's JOB `job`) and
    wait for them, each under MP_TIMEOUT; a rank that fails or times out fails
    the phase, after every other rank is killed. Returns each rank's
    results."""
    import os
    import pickle
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(world):
        env = dict(os.environ, SRML_TPU_COORDINATOR=f"127.0.0.1:{port}",
                   SRML_TPU_NUM_PROCESSES=str(world), SRML_TPU_PROCESS_ID=str(r),
                   GLOO_SOCKET_IFNAME="lo", NCCL_SOCKET_IFNAME="lo")
        if visible is not None:
            env["CUDA_VISIBLE_DEVICES"] = visible
        log_path = os.path.join(workdir, f"rank{r}.log")
        with open(log_path, "w") as f:
            procs.append((subprocess.Popen(
                [sys.executable, __file__, "--rank", str(r), str(world), str(workdir), device,
                 job],
                env=env, stdout=f, stderr=subprocess.STDOUT), log_path))
    deadline = time.monotonic() + MP_TIMEOUT
    failed = None
    try:
        while failed is None and any(p.poll() is None for p, _ in procs):
            for r, (p, _) in enumerate(procs):
                if p.poll() not in (None, 0):
                    failed = f"rank {r} exited with {p.returncode}"
            if failed is None and time.monotonic() > deadline:
                failed = f"a rank ran past {MP_TIMEOUT} s"
            time.sleep(0.2)
        if failed is None:
            bad = [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
            failed = f"ranks {bad} failed" if bad else None
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if failed is not None:
        for r, (_, path) in enumerate(procs):
            with open(path) as f:
                log(f"  rank {r} log (tail):\n" + f.read()[-4000:])
        require(False, f"phase 3m: {failed}")
    results = []
    for r in range(world):
        with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def mp_workdir(name: str):
    """A fresh directory build/<name> beside this script for phase 3m's files."""
    from pathlib import Path

    workdir = Path(__file__).resolve().parent / "build" / name
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    return workdir


def sign_aligned_diff(got, want) -> float:
    """Largest |got - want| of two component matrices (rows), each row of got
    turned to want's sign first."""
    signs = np.sign(np.sum(got.astype(np.float64) * want, axis=1))
    return float(np.abs(got * signs[:, None] - want).max())


def log_rank_call(rank: int, label: str, f: dict) -> None:
    """One line of a rank's call: seconds, collectives, bytes and spans."""
    spans = ", ".join(f"{k} {v:.4f}" for k, v in f["spans"].items())
    log(f"    rank {rank} {label}: {f['seconds']:.3f} s, {f['comm']['comm.collective_ops']} "
        f"collectives, {f['comm']['comm.collective_bytes']} bytes; spans {spans}")


def cluster_keys(labels):
    """Each row's cluster id, a noise row its own (-1 - row)."""
    return np.where(labels >= 0, labels, -1 - np.arange(len(labels)))


def disagreeing_rows(a, b):
    """Bool mask of the rows whose cluster (a noise row: itself) is not the
    same set of rows in labelings a and b."""
    _, ia, size_a = np.unique(cluster_keys(a), return_inverse=True, return_counts=True)
    _, ib, size_b = np.unique(cluster_keys(b), return_inverse=True, return_counts=True)
    _, pair, size_ab = np.unique(np.stack([ia, ib], 1), axis=0, return_inverse=True,
                                 return_counts=True)
    both = size_ab[pair.reshape(-1)]
    return (both != size_a[ia]) | (both != size_b[ib])


def dbscan_ring_ops(world: int, rounds: int) -> int:
    """Collectives of one euclidean DBSCAN transform across `world` ranks that
    converged in `rounds` rounds (spark_rapids_ml_torch/ops/dbscan.py's
    header): the descriptor, the count's shifts and the core flags'
    all-gather, each round's shifts and all-gather, the labels' all-gather."""
    return 1 + world + rounds * world + 1


def rank_dbscan(torch, rank, workdir, counters, sync) -> dict:
    """Phase 3m's DBSCAN on one rank: its MP_SHARE share of phase 3's rows
    (WORKDIR/db_X.npy) through DBSCAN(...).fit(...).transform(...), with the
    propagation rounds and the global label vector that the rank compacted."""
    import os

    from spark_rapids_ml_torch.clustering import DBSCAN
    from spark_rapids_ml_torch.ops import dbscan as dbscan_mod

    Xdb = np.load(os.path.join(workdir, "db_X.npy"), mmap_mode="r")
    lo, hi = mp_rows(Xdb.shape[0], rank)
    Xl = np.ascontiguousarray(Xdb[lo:hi])
    compact, count, seen, hops = dbscan_mod._compact_labels, dbscan_mod.fused_count_below, [], []

    def recorded(out):
        labels = compact(out)
        seen.append(labels)
        return labels

    def counted(*args):
        c = count(*args)
        hops.append(c.cpu().numpy())
        return c

    model = DBSCAN(eps=DB_EPS, min_samples=DB_MIN_SAMPLES).fit(Xl)
    rounds = dbscan_mod._propagate_labels.rounds
    dbscan_mod._compact_labels, dbscan_mod.fused_count_below = recorded, counted
    try:
        out, f = rank_call(torch, counters, sync, lambda: model.transform(Xl))
    finally:
        dbscan_mod._compact_labels, dbscan_mod.fused_count_below = compact, count
    f.update(rows=(lo, hi), labels=out["prediction"].to_numpy(),
             rounds=dbscan_mod._propagate_labels.rounds - rounds, global_labels=seen,
             counts=np.sum(hops, axis=0, dtype=np.int64))
    return f


def check_mp_dbscan(run, ranks, ref, launches, on_card, backend=None) -> None:
    """Phase 3m's DBSCAN gates: both ranks compacted the same global label
    vector, and each returned its slice of it; the rounds of phase 3 on both
    ranks; the count kernel launched once a hop on each rank (each holds
    rows); the ring's collectives. Against phase 3's single-process transform
    (ref), under the borderline rule (DB_BAND_ULPS; ref["near"] counts each
    row's borderline pairs): the eps-counts summed over the ring's hops equal
    phase 3's one-launch counts at every row, but by at most a row's
    borderline pairs at their ends; a core flag flips only at such an end;
    the labels are equal as numbers at every row but the ends and the rows of
    a cluster, in either labeling, holding a flipped row; and at most
    DB_MOVED_SHARE of the rows take another label. `backend`, where given,
    is the one every rank must have run on."""
    for res in ranks:
        f = res["dbscan"]
        log_rank_call(res["rank"], f"DBSCAN transform ({f['rows'][1] - f['rows'][0]} rows, "
                      f"{f['rounds']} rounds; {res['backend']}, {res['device']}, {res['card']})", f)
        require(backend is None or res["backend"] == backend,
                f"{run}: DBSCAN rank {res['rank']} backend {res['backend']}, not {backend}")
        if launches is not None:
            for name, c in f["launches"].items():
                launches[name] += c
    glob = [r["dbscan"]["global_labels"] for r in ranks]
    require(all(len(g) == 1 for g in glob), f"{run}: DBSCAN compacted {[len(g) for g in glob]} times")
    require(all(bits_equal(g[0], glob[0][0]) for g in glob),
            f"{run}: DBSCAN: the ranks compacted different global label vectors")
    for r in ranks:
        f = r["dbscan"]
        lo, hi = f["rows"]
        require(bits_equal(f["labels"], glob[0][0][lo:hi]),
                f"{run}: DBSCAN rank {r['rank']} returned other labels than its rows' global ones")
        require(f["rounds"] == ref["rounds"],
                f"{run}: DBSCAN rank {r['rank']} ran {f['rounds']} rounds, phase 3 {ref['rounds']}")
        want_ops = dbscan_ring_ops(len(ranks), f["rounds"])
        require(f["comm"]["comm.collective_ops"] == want_ops
                and f["comm"] == ranks[0]["dbscan"]["comm"],
                f"{run}: DBSCAN rank {r['rank']} collectives {f['comm']} (want {want_ops} ops)")
        if on_card:
            require(f["launches"]["count"] == len(ranks),
                    f"{run}: DBSCAN rank {r['rank']} launched count {f['launches']['count']} "
                    f"times, not once a hop ({len(ranks)})")
    check_db_rule(f"{run}: DBSCAN across {len(ranks)} ranks",
                  np.concatenate([r["dbscan"]["counts"] for r in ranks]),
                  np.concatenate([r["dbscan"]["labels"] for r in ranks]), ref)
    log(f"  {run}: DBSCAN {ranks[0]['dbscan']['rounds']} rounds on every rank (phase 3: "
        f"{ref['rounds']}); {ranks[0]['dbscan']['comm']['comm.collective_ops']} collectives, "
        f"{ranks[0]['dbscan']['comm']['comm.collective_bytes']} bytes a rank")


def check_db_rule(run, counts, got, ref) -> None:
    """The borderline rule against phase 3's single-process transform (ref;
    ref["near"] counts each row's borderline pairs): the eps-counts `counts`
    equal ref's one-launch counts at every row, but by at most a row's
    borderline pairs at their ends; a core flag flips only at such an end;
    the labels `got` are equal as numbers at every row but the ends and the
    rows of a cluster, in either labeling, holding a flipped row; and at most
    DB_MOVED_SHARE of the rows take another label."""
    near = ref["near"]
    ends = near > 0
    off = np.abs(counts - ref["counts"])
    flips = (counts >= DB_MIN_SAMPLES) != (ref["counts"] >= DB_MIN_SAMPLES)
    log(f"  {run}: eps-counts against phase 3's one-launch counts: {int((off > 0).sum())} rows "
        f"differ ({int((off > near).sum())} by more than their borderline pairs), "
        f"{int(flips.sum())} core flips ({int((flips & ~ends).sum())} at rows with no "
        f"borderline pair)")
    require(not (off > near).any(),
            f"{run}: DBSCAN counts differ from one launch's beyond the borderline pairs")
    require(not (flips & ~ends).any(), f"{run}: DBSCAN core flips at rows with no borderline pair")
    allowed = ends | flips
    for labels in (got, ref["labels"]):
        keys = cluster_keys(labels)
        allowed |= np.isin(keys, keys[flips])
    moved = got != ref["labels"]
    log(f"  {run}: labels of {len(got)} rows against phase 3's single-process transform: "
        f"{int(moved.sum())} rows take another label (at most {DB_MOVED_SHARE * len(got):g}), "
        f"{int((moved & ~allowed).sum())} of them out of the rule's reach; rows the rule reaches "
        f"{int(allowed.sum())} ({allowed.mean():.4%}; borderline pair ends {int(ends.sum())}); "
        f"rows in another cluster {int(disagreeing_rows(got, ref['labels']).sum())}")
    require(not (moved & ~allowed).any(),
            f"{run}: DBSCAN labels differ from the single process out of the rule's reach")
    require(moved.sum() <= DB_MOVED_SHARE * len(got),
            f"{run}: DBSCAN labels differ from the single process at {int(moved.sum())} rows")


def check_ring_ref(torch, X, n_ring: int, ring_ref) -> None:
    """Hold the ring's single-process search (X's MP_RING_QUERIES rows after
    the first n_ring against those rows, k = K_KNN10: the top-k kernel at that
    query count) as check_topk holds the kernel: every query to the plain
    version, d2 within 2 tol at every rank; every pair's d2 within tol of its
    f64 value; and the ranks of MP_RING_F64_QUERIES queries, spread over the
    rows and the last one with them, to f64. The ring and the
    all-gather route are held to this search bit for bit, so their chain of
    gates ends at the plain version. Its d2 are its distances squared in f64,
    within a relative 2^-23 of the kernel's d2, far inside TOPK_RTOL."""
    from spark_rapids_ml_torch.ops.topk import topk_plain

    Q, items = X[n_ring : n_ring + MP_RING_QUERIES], X[:n_ring]
    nq = Q.shape[0]
    valid = torch.ones(n_ring, dtype=torch.bool, device=X.device)
    ids = torch.from_numpy(ring_ref[0]).to(X.device)
    d2 = torch.from_numpy(ring_ref[1]).to(X.device).double() ** 2
    t0 = time.perf_counter()
    dp, ip = topk_plain(Q, items, valid, K_KNN10)
    rows = torch.cat([torch.arange(0, nq, max(1, nq // MP_RING_F64_QUERIES), device=X.device),
                      torch.tensor([nq - 1], device=X.device)])
    ref, x2max = topk_f64(Q[rows], items, valid, K_KNN10)
    tol_all = TOPK_RTOL * ((Q.double() ** 2).sum(1) + x2max)
    label = f"the ring's single-process search nq={nq} n={n_ring} k={K_KNN10}"
    e_k = check_topk_result(d2, ids, Q, items, valid, K_KNN10, rows, ref, tol_all[rows],
                            f"{label} kernel")
    e_p = check_topk_result(dp, ip, Q, items, valid, K_KNN10, rows, ref, tol_all[rows],
                            f"{label} plain")
    diff = (d2 - dp.double()).abs()
    require(bool((diff <= 2 * tol_all[:, None]).all()), f"topk {label}: kernel vs plain d2")
    # every query's pairs against their f64 d2, so an id can differ from the
    # plain version's only for an item as near
    e_all = 0.0
    for lo in range(0, nq, 8192):
        sl = slice(lo, lo + 8192)
        d64 = ((items[ids[sl]].double() - Q[sl, None, :].double()) ** 2).sum(-1)
        e_all = max(e_all, float(((d2[sl] - d64).abs() / tol_all[sl, None]).max()))
    require(e_all <= 1.0, f"topk {label} kernel: a d2 is {e_all:g} tol from its f64 value")
    log(f"  topk {label}: id mismatches kernel vs plain {int((ids != ip.long()).sum())} of "
        f"{ids.numel()}; max d2 error vs f64 / tol: every pair {e_all:.3f}, ranks on "
        f"{rows.numel()} queries kernel {e_k:.3f}, plain {e_p:.3f}; max |kernel - plain| d2 "
        f"{float(diff.max()):.4g}; {time.perf_counter() - t0:.1f} s")


def check_mp_knn(torch, run, ranks, X, refs, ring_ref, n_ring, launches, on_card) -> None:
    """Phase 3m's kNN gates: (a) the all-gather route at both traffics in
    every form against phase 3's single-process searches (refs["knn"]): f32
    bit for bit; bf16 and int8 the re-rank invariant bit for bit, each
    distance at most the single-process narrow search's, recall@k against f32
    at least KNN_RECALL_GATE; (b) the ring against the single-process search
    of the same items and queries and against exact_knn_distributed on the
    same ranks, bit for bit; the launches and collectives of each call."""
    from spark_rapids_ml_torch.ops.knn import parity_rerank_sq

    valid = torch.ones(X.shape[0], dtype=torch.bool, device=X.device)
    queries = {"bench": X[:NQ_KNN], "k=10": torch.from_numpy(refs["q10"]).to(X.device)}
    for res in ranks:
        for label, f in res["knn"].items():
            if isinstance(f, dict):
                log_rank_call(res["rank"], f"kNN {label}", f)
                if launches is not None:
                    for name, c in f["launches"].items():
                        launches[name] += c

    def gathered(key):
        parts = [r["knn"][key]["result"] for r in ranks if r["knn"][key]["result"][0].size]
        return np.concatenate([p[0] for p in parts]), np.concatenate([p[1] for p in parts])

    for (tag, form), (ids1, dist1) in refs["knn"].items():
        ids, dist = gathered((tag, form))
        k = ids1.shape[1]
        name = {"float32": "topk", "bfloat16": "topk_bf16", "int8": "topk_int8"}[form]
        comm = [r["knn"][(tag, form)]["comm"] for r in ranks]
        require(all(c == comm[0] for c in comm) and comm[0]["comm.collective_ops"] == 3,
                f"{run}: kNN {tag} {form}: collectives {comm}")
        if on_card:
            for r in ranks:
                require(r["knn"][(tag, form)]["launches"][name] >= 1,
                        f"{run}: rank {r['rank']} kNN {tag} {form} launched no {name}")
        if form == "float32":
            require(bits_equal(ids, ids1) and bits_equal(dist, dist1),
                    f"{run}: kNN {tag} f32 differs from the single-process search")
            log(f"  {run}: kNN {tag} ({ids.shape[0]} queries, k={k}) f32, all-gather route: "
                "the single-process ids and distances bit for bit")
            continue
        d2r, ids_r = parity_rerank_sq(queries[tag], X, valid,
                                      torch.from_numpy(ids).to(X.device).int(), k)
        require(bits_equal(ids_r.cpu().numpy().astype(np.int64), ids)
                and bits_equal(np.sqrt(d2r.cpu().numpy()), dist),
                f"{run}: kNN {tag} {form}: the distances are not the re-rank of the ids")
        above = int((dist > dist1).sum())
        ids32 = refs["knn"][(tag, "float32")][0]
        recall = float(np.mean([len(np.intersect1d(a, b)) / k for a, b in zip(ids, ids32)]))
        log(f"  {run}: kNN {tag} {form}, all-gather route: re-rank invariant bit for bit; "
            f"{above} distances above the single-process {form} search's; recall@{k} against f32 "
            f"{recall:.6f} (gate {KNN_RECALL_GATE[form]}; single process "
            f"{float(np.mean([len(np.intersect1d(a, b)) / k for a, b in zip(ids1, ids32)])):.6f})")
        require(above == 0, f"{run}: kNN {tag} {form}: a distance above the single-process one")
        require(recall >= KNN_RECALL_GATE[form], f"{run}: kNN {tag} {form}: recall {recall}")
    ring, via_ag = gathered("ring"), gathered("ring, all-gather route")
    require(bits_equal(ring[0], ring_ref[0]) and bits_equal(ring[1], ring_ref[1]),
            f"{run}: the kNN ring differs from the single-process search")
    require(bits_equal(ring[0], via_ag[0]) and bits_equal(ring[1], via_ag[1]),
            f"{run}: the kNN ring differs from the all-gather route")
    for r in ranks:
        f = r["knn"]["ring"]
        require(f["comm"]["comm.collective_ops"] == len(ranks),
                f"{run}: rank {r['rank']} ring collectives {f['comm']}")
        if on_card:
            require(f["launches"]["topk"] == len(ranks),
                    f"{run}: rank {r['rank']} ring launched topk {f['launches']['topk']} times")
    log(f"  {run}: kNN ring ({MP_RING_QUERIES} queries 60/40 against {n_ring} items 60/40, "
        f"k={K_KNN10}): the single-process search and the all-gather route bit for bit")


def phase_multiprocess(torch, Xh, yh, w_h, X, refs, launches=None, device="cuda") -> None:
    """Phase 3m: PCA, KMeans (unit and weighted) and LinearRegression (OLS,
    elastic net) across two rank processes, each fitting its ragged share of
    the rows (MP_SHARE) through the estimators, in-core and streamed; the kNN
    searches (rank_knn, check_mp_knn); then an empty-rank case at MP_SMALL
    (those fits, both forests and a kNN search). X is Xh on `device`; `refs`
    holds the single-process results the fits are held to: "pca" and
    "pca_streamed" (models), "beta64" and "en64" (f64 OLS and elastic-net
    coefficients), "ols", "en" and "ols_streamed" (the f32 fits'
    coefficients, MP_LR_SINGLE), "q10" (the k = 10 queries) and "knn"
    (phase 3's searches, (traffic, form) -> (ids, distances)). The ranks'
    kernel launches are added to `launches`. The forests' runs are
    phase_multiprocess_forest's, with their data in phase_forest."""
    import os

    from spark_rapids_ml_torch.ops.lloyd import lloyd_fit
    from spark_rapids_ml_torch.ops.select import assign

    n, d = Xh.shape
    log(f"phase 3m: {MP_WORLD} rank processes at {n} x {d}, rows {MP_SHARE:.0%} / "
        f"{1 - MP_SHARE:.0%}, in-core and streamed ({STREAM_BATCH_MAIN} rows a global batch)")
    workdir = mp_workdir("phase3m")
    t0 = time.perf_counter()
    for name, a in (("X", Xh), ("y", yh), ("w", w_h), ("q10", refs["q10"]),
                    ("db_X", refs["db"]["X"])):
        np.save(workdir / f"{name}.npy", a)
    log(f"  wrote X, y and w ({(Xh.nbytes + yh.nbytes + w_h.nbytes) / 1e9:.3f} GB) for the "
        f"ranks to memory-map in {time.perf_counter() - t0:.1f} s")
    # the ring's single-process reference: the same items and queries in one process
    from spark_rapids_ml_torch.knn import NearestNeighbors

    n_ring = min(MP_RING_ITEMS, n - MP_RING_QUERIES)
    t0 = time.perf_counter()
    nn_ring = NearestNeighbors(k=K_KNN10, inputCol="features").fit(Xh[:n_ring])
    ring_ref = knn_arrays(nn_ring.kneighbors(Xh[n_ring : n_ring + MP_RING_QUERIES])[2])
    del nn_ring
    log(f"  the ring's single-process search ({MP_RING_QUERIES} queries, X's rows after the "
        f"first {n_ring}, against those rows, k={K_KNN10}): {time.perf_counter() - t0:.3f} s "
        "with its fit")
    check_ring_ref(torch, X, n_ring, ring_ref)
    on_card = device == "cuda"
    runs = [("gloo, one card", "0" if on_card else None)]
    if on_card:
        gc.collect()
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        log(f"  the card's free memory before the ranks start: {free / 1e9:.3f} of "
            f"{total / 1e9:.3f} GB")
        if torch.cuda.device_count() >= MP_WORLD:
            runs.append(("NCCL, one card a rank", None))
        else:
            log(f"  the NCCL run (one rank a card) did not take place: "
                f"{torch.cuda.device_count()} card(s)")
    Xs, ys, ws, cs = mp_small_data()
    small_ref = mp_small_fits(Xs, ys, ws, cs)
    # what the LinearRegression gates must tell apart: the f64 fits of rank
    # 0's rows alone, as a reduction that lost rank 1's part would give
    cut = mp_rows(n, 0)[1]
    _, beta_part, en_part = linreg_f64(torch, X[:cut], torch.from_numpy(yh[:cut]).to(X.device))
    part_rel = {
        label: float(np.linalg.norm(np.asarray(got, np.float64) - refs[key])
                     / np.linalg.norm(refs[key]))
        for label, got, key in (("LinReg OLS", beta_part.cpu().numpy(), "beta64"),
                                ("LinReg elastic net", en_part["coefficients"], "en64"))}
    del beta_part, en_part
    scale = float(torch.sqrt(torch.mean(X * X)))
    w_t = torch.from_numpy(w_h).to(X.device)
    ones = torch.ones_like(w_t)
    try:
        for run, visible in runs:
            t0 = time.perf_counter()
            ranks = run_ranks(workdir, MP_WORLD, device, visible)
            log(f"  run {run}: {time.perf_counter() - t0:.1f} s with the ranks' start")
            for res in ranks:
                fits = res["fits"]
                lo, hi = res["rows"]
                log(f"    rank {res['rank']}: rows [{lo}, {hi}), backend {res['backend']}, "
                    f"{res['device']} ({res['card']}); fit s / collectives / bytes: " + "; ".join(
                        f"{mode} {label} {f['seconds']:.3f} / {f['comm']['comm.collective_ops']} / "
                        f"{f['comm']['comm.collective_bytes']}" for (mode, label), f in fits.items()))
                if on_card:
                    want = "gloo" if visible is not None else "nccl"
                    require(res["backend"] == want, f"{run}: rank {res['rank']} backend {res['backend']}")
                for (mode, label), f in fits.items():
                    summary = ("assign",) if mode == "in-core" and "KMeans" in label else ()
                    for kernel in MP_KERNELS[label] + summary:
                        if on_card:
                            require(f["launches"][kernel] >= 1,
                                    f"{run}: rank {res['rank']} {mode} {label} launched no {kernel}")
                    if launches is not None:
                        for name, c in f["launches"].items():
                            launches[name] += c
            check_mp_knn(torch, run, ranks, X, refs, ring_ref, n_ring, launches, on_card)
            t0 = time.perf_counter()
            db_ranks = run_ranks(workdir, MP_WORLD, device, visible, job="dbscan")
            log(f"  run {run}, DBSCAN: {time.perf_counter() - t0:.1f} s with the ranks' start")
            check_mp_dbscan(run, db_ranks, refs["db"], launches, on_card,
                            ("gloo" if visible is not None else "nccl") if on_card else None)
            r0, r1 = ranks[0]["fits"], ranks[1]["fits"]
            for key in r0:
                require(bits_equal(r0[key]["attrs"], r1[key]["attrs"]),
                        f"{run}: {key} models differ across the ranks")
                require(bits_equal(r0[key]["init"], r1[key]["init"]) if r0[key]["init"] is not None
                        else r1[key]["init"] is None, f"{run}: {key} initial centers differ")
            log(f"  {run}: every fit gives the same bits on both ranks")
            for mode, ref in (("in-core", refs["pca"]), ("streamed", refs["pca_streamed"])):
                a = r0[(mode, "PCA")]["attrs"]
                ev = float(np.max(np.abs(a["explained_variance"] - ref.explained_variance_)
                                  / np.abs(ref.explained_variance_)))
                comp = sign_aligned_diff(a["components"], ref.components_)
                log(f"    {mode} PCA vs the single-process fit: explained variance rel err "
                    f"{ev:.3e}, components (sign-aligned) max abs diff {comp:.3e} (tol 1e-4)")
                require(ev <= 1e-4 and comp <= 1e-4, f"{run}: {mode} PCA differs")
            for mode in ("in-core", "streamed"):
                for label, want in (("LinReg OLS", refs["beta64"]),
                                    ("LinReg elastic net", refs["en64"])):
                    c = r0[(mode, label)]["attrs"]["coefficients"].astype(np.float64)
                    rel = float(np.linalg.norm(c - want) / np.linalg.norm(want))
                    one = refs[MP_LR_SINGLE[(mode, label)]]
                    rel1 = float(np.linalg.norm(c - one) / np.linalg.norm(one))
                    log(f"    {mode} {label} vs the f64 solve: rel 2-norm err {rel:.3e}; vs the "
                        f"single-process {MP_LR_SINGLE[(mode, label)]} fit {rel1:.3e} (tol "
                        f"{MP_LR_RTOL:g} each; rank 0's rows alone are "
                        f"{part_rel[label]:.3e} from the f64 solve)")
                    require(rel <= MP_LR_RTOL, f"{run}: {mode} {label} coefficients rel err {rel}")
                    require(rel1 <= MP_LR_RTOL,
                            f"{run}: {mode} {label} differs from the single-process fit by {rel1}")
            for mode in ("in-core", "streamed"):
                for label, wt in (("KMeans", None), ("KMeans, weighted", w_t)):
                    f = r0[(mode, label)]
                    init = torch.from_numpy(f["init"]).to(X.device)
                    if mode == "in-core":
                        # real-valued weights added in another order: the
                        # counts within 1e-6 of the total weight
                        check_lloyd(X, init, n, wt, f"{run} 2-rank first step {label}",
                                    got=tuple(torch.from_numpy(np.asarray(t)).to(X.device)
                                              for t in f["first_step"]),
                                    counts_atol=0.0 if wt is None else 1e-6 * float(wt.sum()))
                    centers, _, n_iter = lloyd_fit(X, ones if wt is None else wt, init, 1e-4,
                                                   KM_STREAM_MAX_ITER, wt is None)
                    C2 = torch.from_numpy(f["attrs"]["cluster_centers"]).to(X.device)
                    diff = float((C2 - centers).abs().max())
                    sizes2 = torch.bincount(assign(X, C2).long(), minlength=K_MAIN)
                    sizes1 = torch.bincount(assign(X, centers).long(), minlength=K_MAIN)
                    size_diff = int((sizes2 - sizes1).abs().sum())
                    ties = int(near_ties(X, centers, full=True).sum()) if size_diff else 0
                    log(f"    {mode} {label}: 2-rank Lloyd vs the single-process lloyd_fit from the "
                        f"2-rank initial centers: n_iter {f['attrs']['n_iter']} / {n_iter}, centers "
                        f"max abs diff {diff:.3e} (tol {1e-4 * scale:.3e}), cluster sizes differ by "
                        f"{size_diff} (near ties {ties})")
                    require(f["attrs"]["n_iter"] == n_iter, f"{run}: {mode} {label} n_iter")
                    require(diff <= 1e-4 * scale, f"{run}: {mode} {label} centers differ by {diff}")
                    require(size_diff <= 2 * ties, f"{run}: {mode} {label} cluster sizes")
            for label, want in small_ref.items():
                for res in ranks:
                    got = res["small"][label]
                    if label == "NearestNeighbors" and res["rank"] > 0:  # no queries
                        require(got[0].size == 0 and got[1].size == 0,
                                f"{run}: the empty-rank kNN search returned rows on rank "
                                f"{res['rank']}")
                        continue
                    require(bits_equal(got, want),
                            f"{run}: the empty-rank {label} differs from the single-process fit")
            log(f"  {run}: the empty-rank case ({MP_SMALL[0]} x {MP_SMALL[1]}, rank 1 with no rows) "
                f"gives the single-process models bit for bit: {', '.join(small_ref)} (the kNN "
                f"search of {MP_KNN_SMALL_QUERIES} queries on rank 0, none on rank 1)")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is False; this smoke test needs a CUDA card")
        return 1
    try:
        import spark_rapids_ml_torch  # noqa: F401
    except ImportError:
        log("FAIL: spark_rapids_ml_torch is not importable; run from the repository root")
        return 1
    import pandas as pd

    from spark_rapids_ml_torch import config as torch_config
    from spark_rapids_ml_torch.clustering import DBSCAN, KMeans
    from spark_rapids_ml_torch.feature import PCA
    from spark_rapids_ml_torch.knn import NearestNeighbors
    from spark_rapids_ml_torch.ops import _cuda, xtwx
    from spark_rapids_ml_torch.ops import count as count_mod
    from spark_rapids_ml_torch.ops import dbscan as dbscan_mod
    from spark_rapids_ml_torch.ops import knn as knn_ops
    from spark_rapids_ml_torch.ops import lloyd as lloyd_mod
    from spark_rapids_ml_torch.ops import topk as topk_mod
    from spark_rapids_ml_torch.ops.pca import _pca_from_cov
    from spark_rapids_ml_torch.regression import LinearRegression
    from spark_rapids_ml_torch.utils import record_spans

    counters = launch_counters()
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)

    # every phase sets the streaming keys: in-core here, phases 2c, 3s and 3a
    # their own (and back to in-core after them)
    pin_in_core(torch_config)
    log("phase 1: setup")
    log(f"  card: {smi}")
    log(f"  python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    reports = _cuda.build()
    log(f"  built {len(reports)} kernels in {time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        for line in ptxas_lines(rep):
            log(f"    {name}: {line}")

    phase_small(torch)
    phase_streamed_small(torch)

    log("phase 2b: kernels against plain at the main paths' shapes")
    t0 = time.perf_counter()
    Xh, true_centers = blobs(N_MAIN, D_MAIN, K_MAIN, SEED)
    yh = regression_label(Xh, SEED)
    Xdb_h, truth_db = dbscan_blobs(N_DB, D_DB, K_MAIN, SEED)
    log(f"  data {Xh.shape} f32 with its label, and {Xdb_h.shape} f32, made in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    X = torch.from_numpy(Xh).cuda()
    torch.cuda.synchronize()
    t_h2d = time.perf_counter() - t0
    log(f"  host-to-device copy of X (pageable numpy, as the estimators staged it before "
        f"the pinned ring): "
        f"{t_h2d:.3f} s, {Xh.nbytes / t_h2d / 1e9:.3f} GB/s")
    y = torch.from_numpy(yh).cuda()
    errs = {}
    errs["xtx"] = check_xtx(X, N_MAIN, f"n={N_MAIN} d={D_MAIN}")
    check_xtx(X, N_MAIN - 5, f"n={N_MAIN} n_valid={N_MAIN - 5} d={D_MAIN}")
    errs["xtxy"] = check_xtxy(X, y, N_MAIN, f"n={N_MAIN} d={D_MAIN}")
    check_xtxy(X, y, N_MAIN - 5, f"n={N_MAIN} n_valid={N_MAIN - 5} d={D_MAIN}")
    gen = torch.Generator("cuda").manual_seed(SEED)
    C = torch.from_numpy(true_centers).cuda()
    C = C + 0.5 * torch.randn(C.shape, device="cuda", generator=gen)
    errs["lloyd"] = check_lloyd(X, C, N_MAIN, None, f"unit n={N_MAIN} k={K_MAIN}")
    w = torch.randint(0, 3, (N_MAIN,), device="cuda", generator=gen).float()
    errs["lloyd_weighted"] = check_lloyd(X, C, N_MAIN, w, f"weighted n={N_MAIN} k={K_MAIN}")
    errs["assign"] = check_assign(X, C, f"n={N_MAIN} k={K_MAIN}")
    C81 = X[torch.randint(0, N_MAIN, (81,), device="cuda", generator=gen)].clone()
    for n_split in (3, 2):  # the k-means|| candidates' count at k = 20
        check_assign(X, C81, f"n={N_MAIN} k=81", n_split)
    # the bf16-split forms: the main data, then flip_data and split_data
    errs.update(phase_split_forms(torch, X, C, w, N_MAIN, f"n={N_MAIN} k={K_MAIN}", main=True))
    del w
    errs.update(check_gram_split(X, y, N_MAIN, f"n={N_MAIN} d={D_MAIN}"))
    Xs, ys = split_data(torch, N_MAIN, D_MAIN)
    check_gram_split(Xs, ys, N_MAIN, f"n={N_MAIN} d={D_MAIN}", SPLIT_RTOL_MAIN)
    del Xs, ys
    torch.cuda.empty_cache()
    Xdb = torch.from_numpy(Xdb_h).cuda()
    valid_db = torch.ones(N_DB, dtype=torch.bool, device="cuda")
    eps2_db = DB_EPS * DB_EPS
    errs["count"], counts_k, counts_p, near_db = check_count(
        Xdb, Xdb, valid_db, eps2_db, f"nq=n={N_DB} d={D_DB} eps2={eps2_db:g}"
    )
    # kNN queries. The benchmark's: the first NQ_KNN rows of X, each its own
    # nearest item, all held to f64. The k = 10 search's: rows of X and fresh
    # rows of X's mixture, a sample held to f64.
    valid_all = torch.ones(N_MAIN, dtype=torch.bool, device="cuda")
    Qk = X[:NQ_KNN].clone()
    errs["topk"], d2_knn, ids_knn = check_topk(
        Qk, X, valid_all, K_KNN, f"nq={NQ_KNN} n={N_MAIN} d={D_MAIN} k={K_KNN}")
    require(bool((ids_knn[:, 0].cpu() == torch.arange(NQ_KNN)).all()),
            "topk: a row of X queried is not its own nearest item")
    Qh_knn10, self_rows = knn10_queries(Xh, true_centers)
    Qk10 = torch.from_numpy(Qh_knn10).cuda()
    sample = torch.arange(0, NQ_KNN10, NQ_KNN10 // KNN_F64_QUERIES, device="cuda")
    _, d2_knn10, ids_knn10 = check_topk(
        Qk10, X, valid_all, K_KNN10, f"nq={NQ_KNN10} n={N_MAIN} d={D_MAIN} k={K_KNN10}",
        sample=sample)
    require(bool((ids_knn10[: NQ_KNN10 // 2, 0].cpu() == torch.from_numpy(self_rows)).all()),
            "topk: a row of X queried is not its own nearest item")
    # the narrow forms at both traffics: pools against plain, the re-rank
    # invariant, self-queries first; each form's item operand made once
    narrow_items = {}
    for precision in KNN_FORMS:
        t0 = time.perf_counter()
        narrow_items[precision] = topk_mod.narrow_rows(X, precision)
        torch.cuda.synchronize()
        log(f"  {precision} copy of the items: {time.perf_counter() - t0:.3f} s, "
            f"{narrow_items[precision].rows.nbytes / 1e9:.3f} GB")
        name = "topk_" + ("bf16" if precision == "bfloat16" else "int8")
        for Q_t, k, n_self in ((Qk, K_KNN, NQ_KNN), (Qk10, K_KNN10, NQ_KNN10 // 2)):
            kc = topk_mod.oversample_width(k, N_MAIN, precision)
            label = f"nq={Q_t.shape[0]} n={N_MAIN} d={D_MAIN} pool {kc} (k={k})"
            err, _, _ = check_topk_narrow(Q_t, X, valid_all, kc, precision, label,
                                          narrow_items[precision])
            if k == K_KNN:
                errs[name] = err
            _, ids_r = check_rerank(Q_t, X, valid_all, k, precision, label, narrow_items[precision])
            want_self = torch.arange(NQ_KNN) if k == K_KNN else torch.from_numpy(self_rows)
            require(bool((ids_r[:n_self, 0].cpu() == want_self).all()),
                    f"topk {precision}: a row of X queried is not its own nearest item")
    torch.cuda.synchronize()

    log("phase 3: main paths through the estimators")
    stages, launches, path_counts = {}, {name: 0 for name in counters}, {}

    def run_path(label, call):
        """One call with every launch counter zeroed just before it and read just
        after, its stages timed by the spans."""
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with record_spans() as spans:
            out = call()
        torch.cuda.synchronize()
        stages[label] = (time.perf_counter() - t0, spans)
        path_counts[label] = {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}
        for name, c in path_counts[label].items():
            launches[name] += c
        return out

    def under(key, value, call):
        """call() with the config key set to value, restored after."""
        torch_config.set(key, value)
        try:
            return call()
        finally:
            torch_config.unset(key)

    pca = run_path("PCA fit", lambda: PCA(k=K_PCA, inputCol="features").fit(Xh))
    proj = run_path("PCA transform", lambda: pca.transform(Xh))
    pca_hi = run_path("PCA fit, high", lambda: under(
        "parity_precision", "high", lambda: PCA(k=K_PCA, inputCol="features").fit(Xh)))
    km = run_path("KMeans fit", lambda: KMeans(k=K_MAIN, seed=1).fit(Xh))
    pred = run_path("KMeans transform", lambda: km.transform(Xh))
    rows_h = list(Xh)  # per-row views of X, no copy: the DataFrames' feature column
    w_h = np.random.default_rng(SEED + 2).uniform(0.5, 2.0, N_MAIN).astype(np.float32)
    df_w = pd.DataFrame({"features": rows_h, "weight": w_h})
    kmw = run_path("KMeans fit, weighted", lambda: KMeans(k=K_MAIN, seed=1, weightCol="weight").fit(df_w))
    # the split forms through KMeans: label -> (model, the f32 fit, n_split)
    km_forms = {}
    for key, value, n_split in (("fast_math", True, 1), ("parity_precision", "high", 2)):
        tag = "fast_math" if n_split == 1 else "high"
        km_forms[f"KMeans fit, {tag}"] = (run_path(f"KMeans fit, {tag}", lambda: under(
            key, value, lambda: KMeans(k=K_MAIN, seed=1).fit(Xh))), km, n_split)
        km_forms[f"KMeans fit, weighted, {tag}"] = (run_path(
            f"KMeans fit, weighted, {tag}", lambda: under(key, value, lambda: KMeans(
                k=K_MAIN, seed=1, weightCol="weight").fit(df_w))), kmw, n_split)
    del df_w
    df_lr = pd.DataFrame({"features": rows_h, "label": yh})
    # evaluate transforms the frame through the entry point (its predictions
    # frame is the transform's output), so no transform of its own runs here:
    # the one inside evaluate is timed as "<name> transform"
    # both fits read all of X; each evaluate (its transform) the first N_LR_HIGH
    # rows, cut from all of them to make room in the run's time for phase 3i
    df_lr1 = pd.DataFrame({"features": rows_h[:N_LR_HIGH], "label": yh[:N_LR_HIGH]})
    ols = run_path("LinReg OLS fit", lambda: LinearRegression(standardization=True).fit(df_lr))
    ols_ev = evaluate_timed(torch, run_path, stages, path_counts, "LinReg OLS", ols, df_lr1)
    en = run_path("LinReg elastic net fit",
                  lambda: LinearRegression(regParam=EN_REG, elasticNetParam=EN_L1).fit(df_lr))
    en_ev = evaluate_timed(torch, run_path, stages, path_counts, "LinReg elastic net", en, df_lr1)
    del df_lr
    ols1 = run_path("LinReg OLS fit, 1M rows",
                    lambda: LinearRegression(standardization=True).fit(df_lr1))
    ols1_hi = run_path("LinReg OLS fit, 1M rows, high", lambda: under(
        "parity_precision", "high", lambda: LinearRegression(standardization=True).fit(df_lr1)))
    del df_lr1, rows_h
    db = run_path("DBSCAN fit", lambda: DBSCAN(eps=DB_EPS, min_samples=DB_MIN_SAMPLES).fit(Xdb_h))
    dbscan_mod._propagate_labels.rounds = 0
    db_out = run_path("DBSCAN transform", lambda: db.transform(Xdb_h))
    rounds = dbscan_mod._propagate_labels.rounds
    nn = run_path("NearestNeighbors fit", lambda: NearestNeighbors(
        k=K_KNN, inputCol="features", idCol="id").fit(Xh))
    qdf = pd.DataFrame({"features": list(Xh[:NQ_KNN])})  # the benchmark's query frame
    _, _, knn_df = run_path("NearestNeighbors kneighbors", lambda: nn.kneighbors(qdf))
    joined = run_path("NearestNeighbors join", lambda: nn.exactNearestNeighborsJoin(qdf, distCol="dist"))
    nn.setK(K_KNN10)
    query_ids = np.arange(NQ_KNN10, dtype=np.int64) + 10**9
    qdf10 = pd.DataFrame({"features": list(Qh_knn10), "id": query_ids})
    _, _, knn_df10 = run_path("NearestNeighbors kneighbors k=10", lambda: nn.kneighbors(qdf10))
    joined10 = run_path("NearestNeighbors join k=10",
                        lambda: nn.exactNearestNeighborsJoin(qdf10, distCol="dist"))
    narrow_out = {}  # (form, k) -> (knn_df, joined)
    for precision in KNN_FORMS:
        torch_config.set("knn_precision", precision)
        try:
            for k, q_frame in ((K_KNN, qdf), (K_KNN10, qdf10)):
                nn.setK(k)
                tag = f" {precision}" + ("" if k == K_KNN else " k=10")
                out = run_path(f"NearestNeighbors kneighbors{tag}", lambda: nn.kneighbors(q_frame))
                jn = run_path(f"NearestNeighbors join{tag}",
                              lambda: nn.exactNearestNeighborsJoin(q_frame, distCol="dist"))
                narrow_out[(precision, k)] = (out[2], jn)
        finally:
            torch_config.unset("knn_precision")
    log(f"  launches per path: {json.dumps(path_counts)}")
    n_iter = km.summary.numIter
    t_pca, t_pca_tr = stages["PCA fit"][0], stages["PCA transform"][0]
    t_km, t_km_tr = stages["KMeans fit"][0], stages["KMeans transform"][0]
    log(f"  PCA fit {t_pca:.3f} s ({N_MAIN / t_pca:.4g} rows/s), transform {t_pca_tr:.3f} s")
    log(f"  KMeans fit {t_km:.3f} s ({N_MAIN / t_km:.4g} rows/s), n_iter {n_iter}, "
        f"transform {t_km_tr:.3f} s, inertia {km.inertia_:.6g}")
    log(f"  KMeans fit, weighted: {stages['KMeans fit, weighted'][0]:.3f} s, n_iter "
        f"{kmw.summary.numIter}, inertia {kmw.inertia_:.6g}")
    for label, (total, spans) in stages.items():
        parts = [f"{name} {t:.4f} s ({100 * t / total:.1f}%)" for name, t in spans.items()]
        other = total - sum(spans.values())
        log(f"  {label} {total:.4f} s by stage: {', '.join(parts)}, "
            f"outside the spans {other:.4f} s ({100 * other / total:.1f}%)")
    pc = path_counts
    require(pc["PCA fit"]["xtx"] >= 1, "the PCA fit did not launch the xtx kernel")
    require(pc["KMeans fit"]["lloyd"] == n_iter,
            f"lloyd launches {pc['KMeans fit']['lloyd']} != n_iter {n_iter}")
    require(pc["KMeans fit"]["assign"] + pc["KMeans transform"]["assign"] >= 2,
            "KMeans did not launch the assign kernel twice")
    require(pc["KMeans fit, weighted"]["lloyd_weighted"] == kmw.summary.numIter >= 1,
            "the weighted KMeans fit did not launch the weighted Lloyd form once per iteration")
    for label in ("LinReg OLS fit", "LinReg elastic net fit", "LinReg OLS fit, 1M rows"):
        require(pc[label]["xtxy"] == 1, f"{label} did not launch the xtxy kernel once")
    # the split forms' fits: each form's counter moved, and no other form's
    for label, (model, _, n_split) in km_forms.items():
        base = "lloyd" if "weighted" not in label else "lloyd_weighted"
        assign_form = "assign_high" if n_split == 2 else "assign"
        steps = {ns: pc[label][form_name(base, ns)] for ns in (1, 2, 3)}
        want = {ns: model.summary.numIter if ns == n_split else 0 for ns in (1, 2, 3)}
        require(steps == want and want[n_split] >= 1,
                f"{label}: Lloyd launches by n_split {steps}, n_iter {model.summary.numIter}")
        require(pc[label][assign_form] >= 2 and pc[label]["assign_high" if n_split == 1 else
                                                          "assign"] == 0,
                f"{label}: the assignment did not run at the parity tier's form")
    require(pc["PCA fit, high"]["xtx_high"] == 1 and pc["PCA fit, high"]["xtx"] == 0,
            "the PCA fit under high did not launch the xtx n_split 2 form once")
    hi = pc["LinReg OLS fit, 1M rows, high"]
    require(hi["xtxy_high"] == 1 and hi["xtxy"] == 0,
            "the LinReg fit under high did not launch the xtxy n_split 2 form once")
    require(pc["DBSCAN transform"]["count"] == 1, "DBSCAN did not launch the count kernel once")
    for label in ("NearestNeighbors kneighbors", "NearestNeighbors join",
                  "NearestNeighbors kneighbors k=10", "NearestNeighbors join k=10"):
        require(pc[label]["topk"] == 1, f"{label} did not launch the top-k kernel once")
    for precision in KNN_FORMS:
        name = "topk_" + ("bf16" if precision == "bfloat16" else "int8")
        for call in ("kneighbors", "join"):
            for tag in (f" {precision}", f" {precision} k=10"):
                label = f"NearestNeighbors {call}{tag}"
                require(pc[label][name] == 1 and pc[label]["topk"] == 0,
                        f"{label} did not launch the {precision} form once (and no other)")

    # PCA and KMeans outputs: shapes, finiteness, agreement with plain versions
    P = np.stack(proj["pca_features"].to_numpy())
    require(P.shape == (N_MAIN, K_PCA) and np.isfinite(P).all(), "PCA transform output")
    s2_p, s1_p = xtwx.xtx_plain(X, N_MAIN)
    mean = s1_p / N_MAIN
    cov = (s2_p - N_MAIN * torch.outer(mean, mean)) / (N_MAIN - 1.0)
    ev_plain = _pca_from_cov(cov, K_PCA)[0].double().cpu().numpy()
    ev_rel = float(np.max(np.abs(pca.explained_variance_ - ev_plain) / np.abs(ev_plain)))
    log(f"  PCA explained variance {pca.explained_variance_} vs plain fit: rel err {ev_rel:.3e}")
    require(ev_rel <= 1e-4, f"PCA explained variance rel err {ev_rel}")
    ev_hi = float(np.max(np.abs(pca_hi.explained_variance_ - pca.explained_variance_)
                         / np.abs(pca.explained_variance_)))
    log(f"  PCA under high: explained variance {pca_hi.explained_variance_}, rel diff from the "
        f"f32 fit {ev_hi:.3e} (tol 1e-4)")
    require(ev_hi <= 1e-4, f"PCA under high: explained variance rel diff {ev_hi}")
    for label, (model, ref, n_split) in km_forms.items():
        check_kmeans_form(model, ref, X, n_split, label)
    labels = pred["prediction"].to_numpy()
    require(labels.shape == (N_MAIN,) and labels.min() >= 0 and labels.max() < K_MAIN,
            "KMeans transform labels")
    require(km.summary.clusterSizes == np.bincount(labels, minlength=K_MAIN).tolist(),
            "KMeans cluster sizes disagree with its transform")
    w_dev = torch.from_numpy(w_h).cuda()
    for label, model, wt in (("KMeans", km, None), ("weighted KMeans", kmw, w_dev)):
        Ck = torch.from_numpy(model.cluster_centers_).cuda().double()
        c2 = (Ck * Ck).sum(1)
        inertia64 = 0.0
        for s in range(0, N_MAIN, 1 << 20):
            x = X[s : s + (1 << 20)].double()
            d2 = ((x * x).sum(1, keepdim=True) - 2.0 * (x @ Ck.T) + c2).clamp_min(0).min(1).values
            inertia64 += float(d2.sum() if wt is None else (wt[s : s + (1 << 20)].double() * d2).sum())
        in_rel = abs(model.inertia_ - inertia64) / inertia64
        log(f"  {label} inertia vs f64 recomputation against its centers: rel err {in_rel:.3e}")
        require(in_rel <= 1e-5, f"{label} inertia rel err {in_rel}")
        require(np.isfinite(model.cluster_centers_).all(), f"{label} centers finite")
    del proj, pred, P, w_dev

    # LinearRegression: coefficients against f64 solves of the same data on the card
    stats64, beta64, en64 = linreg_f64(torch, X, y)
    xbar64, ybar64 = stats64[2], stats64[3]
    ols_rel = float(torch.linalg.norm(torch.from_numpy(ols.coefficients).cuda().double() - beta64)
                    / torch.linalg.norm(beta64))
    icpt64 = float(ybar64 - xbar64 @ beta64)
    log(f"  LinReg OLS coefficients vs an f64 normal-equation solve: rel 2-norm err "
        f"{ols_rel:.3e}; intercept {ols.intercept:.6f} (f64 {icpt64:.6f})")
    require(ols_rel <= 1e-3, f"LinReg OLS coefficients rel err {ols_rel}")
    en_rel = float(np.linalg.norm(en.coefficients - en64["coefficients"])
                   / np.linalg.norm(en64["coefficients"]))
    en_iter = en.get_model_attributes()["n_iter"]
    t_solve = stages["LinReg elastic net fit"][1].get("solve", 0.0)
    log(f"  LinReg elastic net: n_iter {en_iter} (the f64 solve of the same statistics: "
        f"{en64['n_iter']}), coefficients vs f64 FISTA rel 2-norm err {en_rel:.3e}; solve span "
        f"{t_solve:.4f} s, {1e3 * t_solve / max(en_iter, 1):.4f} ms per FISTA iteration incl. "
        f"its host read")
    require(en_rel <= 1e-3, f"LinReg elastic net coefficients rel err {en_rel}")
    for label, ev in (("OLS", ols_ev), ("elastic net", en_ev)):
        p = ev.predictions["prediction"].to_numpy()
        log(f"  LinReg {label}: r2 {ev.r2:.8f}, rmse {ev.rootMeanSquaredError:.6f} "
            f"(label noise std {LR_NOISE}), mae {ev.meanAbsoluteError:.6f}")
        require(p.shape == (N_LR_HIGH,) and np.isfinite(p).all(), f"LinReg {label} predictions")
        require(ev.r2 > 0.99, f"LinReg {label} evaluate: r2 {ev.r2}")
    hi_rel = float(np.linalg.norm(ols1_hi.coefficients - ols1.coefficients)
                   / np.linalg.norm(ols1.coefficients))
    log(f"  LinReg OLS on {N_LR_HIGH} rows under high: coefficients vs the f32 fit rel 2-norm "
        f"diff {hi_rel:.3e} (tol 1e-3, as against f64 above); intercept {ols1_hi.intercept:.6f} (f32 "
        f"{ols1.intercept:.6f})")
    require(hi_rel <= 1e-3, f"LinReg OLS under high: coefficients rel diff {hi_rel}")
    # OLS leaves the label noise; the penalized fit, biased, can only leave more
    ols_rmse, en_rmse = ols_ev.rootMeanSquaredError, en_ev.rootMeanSquaredError
    require(abs(ols_rmse - LR_NOISE) <= 0.05 * LR_NOISE, f"LinReg OLS rmse {ols_rmse}")
    require(en_rmse >= ols_rmse, f"LinReg elastic net rmse {en_rmse} < OLS {ols_rmse}")

    # DBSCAN: labels against a run of the same propagation from the plain count's
    # core mask; clusters pure in the blobs that made them
    got = db_out["prediction"].to_numpy()
    core_k = (counts_k >= DB_MIN_SAMPLES) & valid_db
    core_p = (counts_p >= DB_MIN_SAMPLES) & valid_db
    flipped = (core_k != core_p).nonzero()[:, 0]
    ref = dbscan_mod.labels_from_core(Xdb, valid_db, core_p, eps2_db)
    allowed = np.zeros(N_DB, bool)
    if len(flipped):  # the flipped rows and their eps-neighbors
        from spark_rapids_ml_torch.ops.knn import _block_sq_dists

        allowed = (_block_sq_dists(Xdb[flipped], Xdb) <= eps2_db).any(0).cpu().numpy()
    differ = got != ref
    log(f"  DBSCAN: {len(flipped)} core flips between the kernel's and the plain count "
        f"(queries with near-eps pairs {int((near_db > 0).sum())}); labels differ from the "
        f"plain-count run at {int(differ.sum())} rows, {int((differ & ~allowed).sum())} "
        f"outside the flips' neighborhoods")
    require(bool((counts_k != counts_p).logical_or(core_k == core_p).all()),
            "DBSCAN core flips where the counts agree")
    require(not (differ & ~allowed).any(), "DBSCAN labels differ from the plain-count run")
    db_band = dbscan_band(torch, Xdb, counts_k, mp_rows(N_DB, 0)[1])
    n_clusters = int(got.max()) + 1
    noise = float((got == -1).mean())
    impure = sum(len(np.unique(truth_db[got == c])) != 1 for c in range(n_clusters))
    t_prop = stages["DBSCAN transform"][1].get("propagate", 0.0)
    log(f"  DBSCAN eps {DB_EPS} min_samples {DB_MIN_SAMPLES}: {n_clusters} clusters, noise "
        f"{100 * noise:.3f}% (uniform rows {100 * DB_NOISE:.1f}%), core {100 * float(core_k.float().mean()):.2f}%, "
        f"{impure} clusters mixing blobs; {rounds} propagation rounds in {t_prop:.4f} s, "
        f"{t_prop / max(rounds, 1):.4f} s per round")
    require(n_clusters >= K_MAIN and impure == 0, "DBSCAN clusters do not follow the blobs")
    require(DB_NOISE <= noise <= 0.25, f"DBSCAN noise share {noise}")
    require(bool(np.all(got[truth_db == -1] == -1)), "DBSCAN labels a uniform noise row")

    log("phase 3p: save and load of phase 3's models and their estimators, the loaded models "
        f"transforming a prefix of the rows ({PERSIST_ROWS}; DBSCAN {PERSIST_DB_ROWS})")
    phase_persist(torch, run_path, path_counts, {
        "PCA": (pca, PCA(k=K_PCA, inputCol="features"), Xh[:PERSIST_ROWS], None, None),
        "KMeans": (km, KMeans(k=K_MAIN, seed=1), Xh[:PERSIST_ROWS], "assign", None),
        "LinReg OLS": (ols, LinearRegression(standardization=True), Xh[:PERSIST_ROWS], None, None),
        "LinReg elastic net": (en, LinearRegression(regParam=EN_REG, elasticNetParam=EN_L1),
                               Xh[:PERSIST_ROWS], None, None),
        "DBSCAN": (db, DBSCAN(eps=DB_EPS, min_samples=DB_MIN_SAMPLES), Xdb_h[:PERSIST_DB_ROWS],
                   "count", None),
    })

    # NearestNeighbors: each answer is phase 2b's kernel answer on the same
    # data; user ids carried; each row of X queried finds itself first
    def check_knn(label, knn_df, joined, qids, nq, k, d2_k, ids_k, self_rows):
        ids = np.stack(knn_df["indices"].to_numpy())
        dist = np.stack(knn_df["distances"].to_numpy())
        require(ids.shape == (nq, k) and ids.dtype == np.int64, f"{label} indices")
        require(np.array_equal(knn_df["query_id"].to_numpy(), qids), f"{label} query ids")
        require(np.array_equal(ids, ids_k.cpu().numpy()), f"{label} ids differ from the kernel's")
        np.testing.assert_allclose(dist, d2_k.sqrt().cpu().numpy(), rtol=1e-6)
        require(np.array_equal(ids[: len(self_rows), 0], self_rows),
                f"{label}: a row of X is not its own first neighbor")
        require(len(joined) == nq * k and list(joined.columns) == ["query_id", "item_id", "dist"],
                f"{label} exactNearestNeighborsJoin shape")
        require(np.array_equal(joined["item_id"].to_numpy(), ids.reshape(-1))
                and np.array_equal(joined["query_id"].to_numpy(), np.repeat(qids, k)),
                f"{label} exactNearestNeighborsJoin rows")
        self_d = dist[: len(self_rows), 0]
        t_kn = stages[f"NearestNeighbors kneighbors{label}"][0]
        t_join = stages[f"NearestNeighbors join{label}"][0]
        log(f"  NearestNeighbors{label} ({nq} queries, k={k}): kneighbors {t_kn:.3f} s "
            f"({nq / t_kn:.4g} queries/s), join {t_join:.3f} s; self-distances max "
            f"{float(self_d.max()):.4g} (mean {float(self_d.mean()):.4g}), nearest other item "
            f"at {float(dist[:, 1].min()):.4g} to {float(dist[:, 1].max()):.4g}")

    log(f"  NearestNeighbors fit {stages['NearestNeighbors fit'][0]:.3f} s")
    check_knn("", knn_df, joined, np.arange(NQ_KNN), NQ_KNN, K_KNN, d2_knn, ids_knn,
              np.arange(NQ_KNN))
    check_knn(" k=10", knn_df10, joined10, query_ids, NQ_KNN10, K_KNN10, d2_knn10, ids_knn10,
              self_rows)

    # the narrow forms through the estimator: recall@k against the f32 answer
    # of this run, every returned distance within the f32 form's tolerance of
    # f64 (held on a sample of queries), self-queries first, the join's rows
    x2max_main = float((X * X).sum(1).max())
    for precision in KNN_FORMS:
        for k, f32_df, qh, qids, self_r in ((K_KNN, knn_df, Xh[:NQ_KNN], np.arange(NQ_KNN),
                                             np.arange(NQ_KNN)),
                                            (K_KNN10, knn_df10, Qh_knn10, query_ids, self_rows)):
            tag = f" {precision}" + ("" if k == K_KNN else " k=10")
            got_df, jn = narrow_out[(precision, k)]
            ids = np.stack(got_df["indices"].to_numpy())
            dist = np.stack(got_df["distances"].to_numpy())
            ids32 = np.stack(f32_df["indices"].to_numpy())
            nq = len(qids)
            require(ids.shape == (nq, k) and np.array_equal(got_df["query_id"].to_numpy(), qids),
                    f"kneighbors{tag}: shape or query ids")
            recall = float(np.mean([len(np.intersect1d(ids[i], ids32[i])) / k for i in range(nq)]))
            gate = KNN_RECALL_GATE[precision]
            require(recall >= gate, f"kneighbors{tag}: recall@{k} {recall} < gate {gate}")
            require(np.array_equal(ids[: len(self_r), 0], self_r),
                    f"kneighbors{tag}: a row of X is not its own first neighbor")
            rows = np.arange(0, nq, max(1, nq // KNN_F64_QUERIES))
            Qs = torch.from_numpy(qh[rows]).cuda().double()
            ids_t = torch.from_numpy(ids[rows]).cuda()
            d64 = ((X[ids_t].double() - Qs[:, None, :]) ** 2).sum(-1)
            tol = TOPK_RTOL * ((Qs * Qs).sum(1) + x2max_main)
            d_got = torch.from_numpy(dist[rows]).cuda().double() ** 2
            worst = float(((d_got - d64).abs() / tol[:, None]).max())
            require(worst <= 1.0, f"kneighbors{tag}: a distance is {worst} tol off f64")
            require(np.array_equal(jn["item_id"].to_numpy(), ids.reshape(-1))
                    and np.array_equal(jn["dist"].to_numpy(), dist.reshape(-1)),
                    f"join{tag}: rows differ from kneighbors'")
            spans = stages[f"NearestNeighbors kneighbors{tag}"][1]
            require(spans.attrs.get("select", {}).get("precision") == precision,
                    f"kneighbors{tag}: the select span does not name the form")
            log(f"  NearestNeighbors{tag} ({nq} queries, k={k}): kneighbors "
                f"{stages[f'NearestNeighbors kneighbors{tag}'][0]:.3f} s (select "
                f"{spans.get('select', 0.0):.4f} s, rerank {spans.get('rerank', 0.0):.4f} s, the "
                f"items' copy {spans.get('narrow_items', 0.0):.4f} s), join "
                f"{stages[f'NearestNeighbors join{tag}'][0]:.3f} s; recall@{k} against f32 "
                f"{recall:.6f} (gate {gate}); distances at most {worst:.4f} tol off f64")
    # phase 3m's kNN runs are held to these searches: keep their answers
    knn_refs = {("bench", "float32"): knn_arrays(knn_df), ("k=10", "float32"): knn_arrays(knn_df10)}
    for precision in KNN_FORMS:
        for tag, k in (("bench", K_KNN), ("k=10", K_KNN10)):
            knn_refs[(tag, precision)] = knn_arrays(narrow_out[(precision, k)][0])
    del nn, knn_df, joined, knn_df10, joined10, narrow_out
    torch.cuda.empty_cache()
    ann_probe = phase_ann(torch, run_path, stages, path_counts, X, true_centers)

    # the streamed fits (phase 3s) take their labelled input from an Arrow
    # table when pyarrow imports (no extraction), else from a pandas frame
    try:
        import pyarrow as pa

        frame = arrow_table(pa, Xh, yh, w_h)
    except ImportError:
        frame = pd.DataFrame({"features": list(Xh), "label": yh, "weight": w_h})
    routes, streamed = phase_streamed_main(torch, run_path, stages, path_counts, Xh, X, w_h,
                                           frame, pca, beta64)
    del frame
    arrow_ran = phase_arrow(torch, run_path, stages, Xh, yh, w_h, kmw, ols)
    log(f"  H2D GB/s by route: {json.dumps({k: round(v, 3) for k, v in routes.items()})}; "
        f"phase 3a {'ran' if arrow_ran else 'not run'}")
    db_ref = {"X": Xdb_h, "labels": db_out["prediction"].to_numpy(), "rounds": rounds,
              "counts": counts_k.long().cpu().numpy(), **db_band}
    phase_streamed_pairwise(torch, run_path, stages, path_counts, Xh, X, Qh_knn10, query_ids,
                            knn_refs, db_ref)
    phase_multiprocess(torch, Xh, yh, w_h, X, {
        "pca": pca, "pca_streamed": streamed["PCA fit, streamed, cache off"],
        "beta64": beta64.cpu().numpy(), "en64": en64["coefficients"],
        "ols": ols.coefficients, "en": en.coefficients,
        "ols_streamed": streamed["LinReg OLS fit, streamed, cache off"].coefficients,
        "q10": Qh_knn10, "knn": knn_refs, "db": db_ref},
        launches)
    del streamed

    log("phase 4: times at the main paths' shapes (CUDA events, median of 10; 3 for topk "
        "at 4,096 queries and in one item range)")
    n, d, k = N_MAIN, D_MAIN, K_MAIN
    Cm = torch.from_numpy(km.cluster_centers_).cuda().contiguous()
    w_t = torch.from_numpy(w_h).cuda()
    rows = []
    x2_main = torch.sum(X * X, dim=1)

    def topk_library(Q, kk):
        """cuBLAS addmm (x2 - 2 Q_blk X^T, KNN_LIB_BLOCK queries at a time) and
        torch.topk of each block, then + q2 on the k kept."""
        q2 = torch.sum(Q * Q, dim=1)
        for s in range(0, Q.shape[0], KNN_LIB_BLOCK):
            d = torch.addmm(x2_main[None, :], Q[s : s + KNN_LIB_BLOCK], X.T, alpha=-2.0)
            v = torch.topk(d, kk, dim=1, largest=False).values
            del d
            (v + q2[s : s + KNN_LIB_BLOCK, None]).clamp_min_(0.0)

    def count_library(Q, eps2):
        """cuBLAS addmm (x2 - 2 Q_blk X^T, COUNT_LIB_BLOCK queries at a
        time), + q2, then compare and sum per block."""
        x2 = torch.sum(Xdb * Xdb, dim=1)
        q2 = torch.sum(Q * Q, dim=1)
        out = torch.empty(Q.shape[0], dtype=torch.int64, device=Q.device)
        for s in range(0, Q.shape[0], COUNT_LIB_BLOCK):
            d = torch.addmm(x2[None, :], Q[s : s + COUNT_LIB_BLOCK], Xdb.T, alpha=-2.0)
            d.add_(q2[s : s + COUNT_LIB_BLOCK, None])
            out[s : s + COUNT_LIB_BLOCK] = (d <= eps2).sum(1)
            del d
        return out

    def topk_bytes_flops(nq, kk):
        # X, its norms and the mask, Q and its norms read once; d2 and ids written
        return (4.0 * (N_MAIN * D_MAIN + N_MAIN + nq * D_MAIN + nq) + N_MAIN + 8.0 * nq * kk,
                2.0 * nq * N_MAIN * D_MAIN + 4.0 * nq * N_MAIN)

    specs = {
        "xtx": (
            lambda: xtwx.xtx(X, n), lambda: xtwx.xtx_plain(X, n), lambda: X.T @ X,
            # S2 is symmetric: its d(d+1)/2 distinct entries take one FMA per row
            4.0 * (n * d + d * d + d), n * d * (d + 1.0) + n * d,
        ),
        "xtxy": (
            lambda: xtwx.xtxy(X, y, n), lambda: xtwx.xtxy_plain(X, y, n),
            # three ATen/cuBLAS calls together: X.T @ X, X.T @ y and X.sum(0)
            lambda: (X.T @ X, X.T @ y, X.sum(0)),
            4.0 * (n * (d + 1) + d * d + 2 * d + 2), n * d * (d + 1.0) + 3.0 * n * d + 2.0 * n,
        ),
        "count": (
            lambda: count_mod.fused_count_below(Xdb, Xdb, valid_db, eps2_db),
            lambda: count_mod.count_below_plain(Xdb, Xdb, valid_db, eps2_db),
            # query-blocked addmm, compare and sum: the (n, n) distance matrix
            # of one call would be 275 GB
            lambda: count_library(Xdb, eps2_db),
            4.0 * (2 * N_DB * D_DB + 2 * N_DB) + N_DB,
            2.0 * N_DB * N_DB * D_DB + 4.0 * N_DB * N_DB,
        ),
        "topk": (
            # with the items' cached norms, as kneighbors calls it and as the
            # library figure has them
            lambda: topk_mod.fused_topk(Qk, X, valid_all, K_KNN, x2=x2_main),
            lambda: topk_mod.topk_plain(Qk, X, valid_all, K_KNN, x2=x2_main),
            lambda: topk_library(Qk, K_KNN),
            *topk_bytes_flops(NQ_KNN, K_KNN),
        ),
    }
    for name, (kern, plain, lib, nbytes, flops) in specs.items():
        ms = time_ms(torch, kern)
        plain_ms = time_ms(torch, plain, 3, 1)
        lib_ms = None if lib is None else time_ms(torch, lib, *((3, 1) if name == "count" else ()))
        b_ms, b_by = bound(nbytes, flops)
        tc = ""
        if name in TF32X3:
            tc_ms, tc_by = bound_tf32x3(nbytes, flops)
            tc = f", 3xTF32 bound {tc_ms:.4f} ms ({tc_by})"
        if name == "count":
            # the kernel's own types: its products in 3xTF32 (three TF32 operations
            # each at the tensor cores' peak), its criterion (4 a pair) in f32
            prod, crit = 2.0 * N_DB * N_DB * D_DB, 4.0 * N_DB * N_DB
            t_o = 3.0 * prod / PEAK_TF32_FLOPS + crit / PEAK_F32_FLOPS
            t_b = nbytes / PEAK_BYTES
            tc = (f": products in 3xTF32 {1e3 * 3.0 * prod / PEAK_TF32_FLOPS:.4f} ms + criterion "
                  f"in f32 {1e3 * crit / PEAK_F32_FLOPS:.4f} ms, the row's bound; f32 CUDA-core "
                  f"bound {b_ms:.4f} ms; earlier design (f32 FMA, PR 7) {EARLIER_COUNT_MS} ms; "
                  f"launch plan {count_mod._plan(N_DB, N_DB, D_DB)}")
            b_ms, b_by = 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")
        log(f"  {name}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  library "
            f"{'-' if lib_ms is None else f'{lib_ms:.4f} ms'}  bound {b_ms:.4f} ms ({b_by}){tc}")
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE[name], "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": errs[name]["max_abs_err"],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms,
        })
    # the Lloyd and assignment forms on the nearest-center tile: kernel, plain,
    # library, bound at the engine each form's products take (time_nearest)
    for name, t_row in time_nearest(torch, X, Cm, C81, w_t).items():
        if name in REPLACES:  # the k = 81 figures are logged, not rows
            rows.append({
                "name": name, "route": "cuda", "source": SOURCE[name],
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": errs[name]["max_abs_err"], **t_row,
            })
    # the Gram kernels' bf16-split forms: kernel, plain, bound (the bytes, or their
    # part products at the bf16 tensor-core peak and the rest in f32, whichever
    # is longer)
    f32_ms = {r["name"]: r["ms"] for r in rows}
    split_specs = {}
    split_specs["xtx_high"] = (
        lambda: xtwx.xtx(X, n, 2), lambda: xtwx.xtx_plain(X, n, 2),
        4.0 * (n * d + d * d + d), 3 * (n * d * (d + 1.0) + n * d), 0.0)
    split_specs["xtxy_high"] = (
        lambda: xtwx.xtxy(X, y, n, 2), lambda: xtwx.xtxy_plain(X, y, n, 2),
        4.0 * (n * (d + 1) + d * d + 2 * d + 2), 3 * (n * d * (d + 1.0) + 3.0 * n * d + 2.0 * n),
        0.0)
    for name, (kern, plain, nbytes, bf16_ops, f32_ops) in split_specs.items():
        ms = time_ms(torch, kern)
        plain_ms = time_ms(torch, plain, 3, 1)
        t_b = nbytes / PEAK_BYTES
        t_o = bf16_ops / PEAK_NARROW_OPS["bfloat16"] + f32_ops / PEAK_F32_FLOPS
        b_ms, b_by = 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")
        base = name.rsplit("_", 1)[0]
        log(f"  {name}: kernel {ms:.4f} ms (the f32 form {f32_ms[base]:.4f} ms)  plain "
            f"{plain_ms:.4f} ms  library none  bound {b_ms:.4f} ms ({b_by}; the part products "
            f"alone at the bf16 peak {1e3 * bf16_ops / PEAK_NARROW_OPS['bfloat16']:.4f} ms)")
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE[name], "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": errs[name]["max_abs_err"],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
        })
    log("  split forms' library figure: none. No one PyTorch call computes the two-part bf16 "
        "split (a bf16 matmul rounds its operands once and its result to bf16), and none a "
        "fused Lloyd step in any form")
    log(f"  count library figure: cuBLAS addmm of blocks of {COUNT_LIB_BLOCK} queries against "
        f"all items, + q2, compare and sum (one call would build the (n, n) distance matrix, "
        f"{4.0 * N_DB * N_DB / 1e9:.0f} GB at n = {N_DB})")
    log(f"  topk library figure: cuBLAS addmm of blocks of up to {KNN_LIB_BLOCK} queries against "
        f"all items ({4.0 * KNN_LIB_BLOCK * N_MAIN / 1e9:.1f} GB tile) and torch.topk per block")
    # the top-k kernel at the k = 10 traffic, and at both with the items in one
    # range against the wrapper's rule (the kernel is warm: no warm-up)
    b_ms, b_by = bound(*topk_bytes_flops(NQ_KNN10, K_KNN10))
    tc_ms, tc_by = bound_tf32x3(*topk_bytes_flops(NQ_KNN10, K_KNN10))
    ms10 = time_ms(torch, lambda: topk_mod.fused_topk(Qk10, X, valid_all, K_KNN10, x2=x2_main), 3, 0)
    plain10 = time_ms(torch, lambda: topk_mod.topk_plain(Qk10, X, valid_all, K_KNN10, x2=x2_main), 3, 1)
    lib10 = time_ms(torch, lambda: topk_library(Qk10, K_KNN10), 3, 1)
    log(f"  topk at {NQ_KNN10} queries, k={K_KNN10}: kernel {ms10:.4f} ms  plain {plain10:.4f} ms  "
        f"library {lib10:.4f} ms  bound {b_ms:.4f} ms ({b_by}), 3xTF32 bound {tc_ms:.4f} ms "
        f"({tc_by})")
    topk_ms = next(r["ms"] for r in rows if r["name"] == "topk")
    for Q_t, kk, auto_ms in ((Qk, K_KNN, topk_ms), (Qk10, K_KNN10, ms10)):
        nq_t = Q_t.shape[0]
        auto_splits = topk_mod._splits(nq_t, N_MAIN, kk, _cuda.sm_count(Q_t))[0]
        one_ms = pinned_splits(topk_mod, 1, lambda: time_ms(
            torch, lambda: topk_mod.fused_topk(Q_t, X, valid_all, kk, x2=x2_main), 3, 0))
        log(f"  topk item ranges at {nq_t} queries, k={kk}: the rule's {auto_splits} ranges "
            f"{auto_ms:.4f} ms, one range {one_ms:.4f} ms ({one_ms / auto_ms:.3f}x)")
    # the pools' share at the benchmark's traffic: its queries and item ranges at k = 10
    ms_small_k = time_ms(torch, lambda: topk_mod.fused_topk(Qk, X, valid_all, K_KNN10, x2=x2_main))
    log(f"  topk at {NQ_KNN} queries: k={K_KNN} {topk_ms:.4f} ms, k={K_KNN10} {ms_small_k:.4f} ms")
    # as PRs 3 and 4 timed it: the wrapper also computes the items' norms
    ms_norms = time_ms(torch, lambda: topk_mod.fused_topk(Qk, X, valid_all, K_KNN))
    ms10_norms = time_ms(torch, lambda: topk_mod.fused_topk(Qk10, X, valid_all, K_KNN10), 3, 1)
    log(f"  topk with the items' norms computed in the wrapper (as PRs 3-4 timed it): "
        f"{NQ_KNN} queries, k={K_KNN} {ms_norms:.4f} ms; {NQ_KNN10} queries, k={K_KNN10} "
        f"{ms10_norms:.4f} ms")
    # the narrow forms (rows 6b, 6c): kernel, products alone, plain, the
    # re-rank beside them, the bf16 library figure, the bound
    rows += narrow_times(torch, X, valid_all, x2_main, ((Qk, K_KNN, 10), (Qk10, K_KNN10, 3)),
                         narrow_items, errs, launches)
    # the IVF coarse probe: fused_probe at phase 3i's k=10 queries against the
    # IVF-Flat index's centers
    rows.append({"name": "fused_probe", "route": "cuda", "source": SOURCE["fused_probe"],
                 "replaces": REPLACES["fused_probe"], "launches": launches["fused_probe"],
                 "max_abs_err": ann_probe["err"],
                 **probe_times(torch, ann_probe["C"], ann_probe["cn"], ann_probe["Q"])})
    del ann_probe
    kmeans_pp_times(torch)
    sms = _cuda.sm_count(X)
    for kk in (K_KNN10, K_KNN, topk_mod.K_MAX):
        log(f"  topk at k={kk}: {topk_mod._smem_bytes(kk)} bytes of dynamic shared memory a "
            f"block (ops/topk.py::_smem_bytes), {topk_mod._buffer_keys(kk)}-key candidate "
            f"buffers, one block per SM; item ranges at {NQ_KNN} / {NQ_KNN10} queries: "
            f"{topk_mod._splits(NQ_KNN, N_MAIN, kk, sms)[0]} / "
            f"{topk_mod._splits(NQ_KNN10, N_MAIN, kk, sms)[0]}")
    log(f"  xtx/xtxy: {xtwx.SMEM_BYTES} bytes of dynamic shared memory a block, one block "
        f"per SM; {xtwx._chunks(N_MAIN, 3, sms)[1]} row chunks x 3 tiles at d = {D_MAIN}")
    for name in ("xtx", "topk", "topk_narrow", "probe", "count", "lloyd", "assign"):
        for line in ptxas_lines(reports[name]):
            log(f"  ptxas {name}: {line}")

    # the Lloyd loop's per-iteration host sync: the same iterations with the
    # convergence read every iteration and with one read at the end
    def lloyd_loop(iters: int, sync_each: bool) -> float:
        centers = Cm.clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            sums, counts, _ = lloyd_mod.lloyd_step(X, centers, n)
            new = torch.where(counts[:, None] > 0, sums / counts.clamp(min=1.0)[:, None], centers)
            shift2 = torch.max(torch.sum((new - centers) ** 2, dim=1))
            centers = new
            if sync_each:
                bool(shift2 > 0)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / iters

    lloyd_loop(2, True)
    it_sync = statistics.median(lloyd_loop(10, True) for _ in range(3))
    it_async = statistics.median(lloyd_loop(10, False) for _ in range(3))
    log(f"  Lloyd iteration: {1e3 * it_sync:.4f} ms with the per-iteration sync, "
        f"{1e3 * it_async:.4f} ms without: sync cost {1e3 * (it_sync - it_async):.4f} ms/iter "
        f"({100 * (it_sync - it_async) * n_iter / t_km:.3f}% of the KMeans fit)")
    log(f"  KMeans fit: {n_iter} Lloyd iterations of {1e3 * it_sync:.4f} ms = "
        f"{100 * it_sync * n_iter / t_km:.3f}% of the {t_km:.3f} s fit; its Lloyd loop "
        f"span was {stages['KMeans fit'][1]['lloyd_loop']:.4f} s")

    # the forests run last, on rows of their own: free the earlier paths' data
    del Xh, X, y, x2_main, specs, split_specs, Xdb, Qk, Qk10, narrow_items
    gc.collect()
    torch.cuda.empty_cache()
    rows += phase_forest(torch, run_path, stages, path_counts, launches, reports)

    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:  # one rank of phase 3m (rank_main)
        sys.exit(rank_main(sys.argv[2:]))
    sys.exit(main())
