"""PyTorch port, the narrow forms' top-k kernel (spark_rapids_ml_torch/csrc/
topk_narrow.cu) as far as the CPU reaches it: its launch plan
(ops/topk.py::narrow_plan, narrow_smem_bytes), the grid's cover of (query
block, item range) pairs, and, emulated in plain Python, the two pieces of its
selection that the f32 scan does not have: the ranges' shared bounds and the
ranked merge of a 32-key buffer into a pool (warp_merge32). The kernel's plain
version, topk_plain, is held to the JAX package's Pallas kernel in interpret
mode by tests/test_torch_topk.py; the kernel itself to topk_plain on the card
(chip_smoke.py phase_small_narrow and phase 2b)."""

import math

import numpy as np
import pytest

from spark_rapids_ml_torch.ops import topk

FORMS = {"bfloat16": (2, 8), "int8": (1, 16)}  # bytes a column, padding of a row
SMS = 132  # H100 SXM


def _padded(d, precision):
    per = FORMS[precision][1]
    return -(-d // per) * per


@pytest.mark.parametrize("precision", list(FORMS))
@pytest.mark.parametrize("d", [1, 7, 24, 256, 257, 4096])
def test_plan_fits_one_block_at_every_pool(precision, d):
    """At every narrow pool width (9 to 256) the plan's shared memory fits one
    block (SMEM_BLOCK, 232,448 bytes) with a ring of at least two stages, and
    the figure is narrow_smem_bytes of the plan."""
    dp = _padded(d, precision)
    chunks = -(-dp * FORMS[precision][0] // topk.NARROW_CHUNK_BYTES)
    for k in range(9, topk.K_MAX + 1):
        plan = topk.narrow_plan(4096, 8_388_608, dp, precision, k, SMS)
        assert plan.smem == topk.narrow_smem_bytes(plan.consumers, k, plan.stages, plan.chunks,
                                                   plan.resident)
        assert plan.smem <= topk.SMEM_BLOCK
        assert plan.chunks == chunks and plan.stages >= topk.NARROW_MIN_STAGES
        # the ring is as deep as the block allows: one stage more would not fit
        assert topk.narrow_smem_bytes(plan.consumers, k, plan.stages + 1, plan.chunks,
                                      plan.resident) > topk.SMEM_BLOCK
        assert plan.q_block == plan.consumers * topk.NARROW_Q_TILE


@pytest.mark.parametrize("precision, k, consumers, stages", [
    ("bfloat16", 18, 2, 6), ("int8", 18, 2, 8), ("bfloat16", 250, 1, 3), ("int8", 250, 1, 4),
])
def test_stage_depth_at_the_main_pools(precision, k, consumers, stages):
    """The main traffics' plans at d = 256: pool 18 (4,096 queries, k = 10) two
    warpgroups and 1.5 (bf16) or 4 (int8) whole tiles in the ring; pool 250
    (100 queries, k = 200) one warpgroup, its pools leaving 3 or 4 stages.
    The queries stay resident in both."""
    plan = topk.narrow_plan(4096 if k == 18 else 100, 8_388_608, 256, precision, k, SMS)
    assert (plan.consumers, plan.stages, plan.resident) == (consumers, stages, True)
    assert plan.chunks == (4 if precision == "bfloat16" else 2)


@pytest.mark.parametrize("precision", list(FORMS))
@pytest.mark.parametrize("k", [9, 18, 250, 256])
def test_queries_resident_up_to_the_width_that_fits(precision, k):
    """The query tile is resident while one warpgroup's resident chunks leave
    the ring two stages, and streams through the ring above that width; the
    switch happens once as d grows, and two warpgroups need a resident tile."""
    per = FORMS[precision][1]
    seen_streamed = False
    for dp in range(per, 6000, per):
        plan = topk.narrow_plan(4096, 10**7, dp, precision, k, SMS)
        fits = topk.narrow_smem_bytes(1, k, topk.NARROW_MIN_STAGES, plan.chunks,
                                      True) <= topk.SMEM_BLOCK
        assert plan.resident == fits
        assert plan.consumers == 1 or plan.resident
        seen_streamed |= not plan.resident
        assert plan.resident or seen_streamed
        if seen_streamed:
            assert not plan.resident


@pytest.mark.parametrize("nq, n, k, precision", [
    (4096, 8_388_608, 18, "bfloat16"), (100, 8_388_608, 250, "int8"), (1, 1, 9, "int8"),
    (129, 20_011, 18, "bfloat16"), (65, 7_777, 250, "bfloat16"), (33, 200, 200, "int8"),
    (130, 9_001, 9, "int8"), (257, 1_000_003, 256, "bfloat16"),
])
def test_grid_covers_every_query_block_and_item_range_once(nq, n, k, precision):
    """The blocks' (query slice, item slice), as the kernel reads blockIdx.x:
    every (query block, item range) pair once, the query slices cover [0, nq)
    and the item ranges [0, n) in whole 128-item tiles."""
    plan = topk.narrow_plan(nq, n, 256, precision, min(k, n), SMS)
    blocks = list(plan.blocks(nq, n))
    q_blocks = -(-nq // plan.q_block)
    assert len(blocks) == q_blocks * plan.n_splits
    pairs = {(qs.start, its.start) for qs, its in blocks}
    assert len(pairs) == len(blocks)
    assert plan.per % topk.ITEM_TILE == 0
    for b, (qs, its) in enumerate(blocks):
        assert qs.start == (b % q_blocks) * plan.q_block  # query blocks run fastest
        assert its.start < its.stop <= n
    for r in range(plan.n_splits):
        covered = np.zeros(nq, bool)
        for qs, its in blocks:
            if its.start == r * plan.per:
                assert not covered[qs].any()
                covered[qs] = True
        assert covered.all()
    starts = sorted({its.start for _, its in blocks})
    assert starts == [r * plan.per for r in range(plan.n_splits)]
    assert max(its.stop for _, its in blocks) == n


def test_plan_rejects_the_f32_form():
    with pytest.raises(ValueError, match="narrow_plan"):
        topk.narrow_plan(100, 1000, 256, "float32", 10, SMS)


def _scan_with_shared_bounds(keys, k, n_splits, rng, shared=True):
    """The kernel's selection across item ranges, emulated: each range scans
    its keys in tiles, in an order that interleaves the ranges at random, and
    keeps the k smallest it has accepted; a key is accepted only below its
    range's bound, the least of its own k-th key and, with `shared`, the
    shared bounds (csrc/topk_narrow.cu): the least k-th key of any full pool,
    and the largest of every range's key at rank ceil(k / n_splits) - 1 once
    every range has one. Returns the merged pools' k smallest and the number
    of keys accepted."""
    ranges = np.array_split(keys, n_splits)
    m = -(-k // n_splits) - 1
    pools = [np.empty(0, keys.dtype) for _ in ranges]
    pos = [0] * n_splits
    least_kth, rank_m = math.inf, [math.inf] * n_splits
    accepted = 0
    while any(p < len(r) for p, r in zip(pos, ranges)):
        r = int(rng.choice([i for i in range(n_splits) if pos[i] < len(ranges[i])]))
        tile = ranges[r][pos[r] : pos[r] + 16]
        pos[r] += len(tile)
        bound = pools[r][k - 1] if len(pools[r]) >= k else math.inf
        if shared:
            bound = min(bound, least_kth, max(rank_m))
        take = tile[tile < bound]
        accepted += len(take)
        pools[r] = np.sort(np.concatenate([pools[r], take]))[:k]
        if len(pools[r]) >= k:
            least_kth = min(least_kth, pools[r][k - 1])
        if len(pools[r]) > m:
            rank_m[r] = pools[r][m]
    return np.sort(np.concatenate(pools))[:k], accepted


@pytest.mark.parametrize("n, k, n_splits, seed", [
    (5_000, 18, 33, 0), (5_000, 250, 66, 1), (2_000, 9, 3, 2), (3_000, 256, 7, 3),
    (600, 200, 2, 4), (10_000, 18, 132, 5),
])
def test_shared_bounds_keep_the_merged_pools_exact(n, k, n_splits, seed):
    """Unique keys (the kernel's (d2 bits, id) keys are unique) scanned by
    ranges that share their bounds give the exact k smallest after the merge,
    and accept no more keys than ranges that keep their own bounds."""
    rng = np.random.default_rng(seed)
    keys = rng.permutation(np.arange(10 * n, dtype=np.int64))[:n]
    want = np.sort(keys)[:k]
    got, shared = _scan_with_shared_bounds(keys, k, n_splits, np.random.default_rng(seed))
    alone, own = _scan_with_shared_bounds(keys, k, n_splits, np.random.default_rng(seed),
                                          shared=False)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(alone, want)
    assert shared <= own


def _warp_merge32(pool, buf, k):
    """csrc/topk_narrow.cu::warp_merge32 step for step on lists: the buffer
    sorted across 32 lanes (empty lanes at KEY_EMPTY), each key's rank in the
    pool by binary search, the pool shifted from the top in rounds of 32 by
    the count of buffer keys ranked at or below each position (a halving
    search over the lanes, the shuffle's lane index wrapping at 32), then the
    buffer keys written at rank + lane."""
    empty = 2**64 - 1
    c = len(buf)
    b = sorted(buf) + [empty] * (32 - c)
    pos = [int(np.searchsorted(np.array(pool, dtype=np.uint64), np.uint64(v))) for v in b]
    out = list(pool)
    first = pos[0]
    for s in range((k - 1) // 32, first // 32 - 1, -1):
        moves = []
        for lane in range(32):
            j = 32 * s + lane
            below, step = 0, 32
            while step:
                if below + step <= c and pos[(below + step - 1) % 32] <= j:
                    below += step
                step >>= 1
            if j < k and j >= first and j + below < k:
                moves.append((j + below, out[j]))
        for dst, v in moves:  # every lane reads before any lane writes
            out[dst] = v
    for lane in range(c):
        if pos[lane] + lane < k:
            out[pos[lane] + lane] = b[lane]
    return out


@pytest.mark.parametrize("seed", range(8))
def test_ranked_merge_equals_a_sorted_merge(seed):
    """The ranked merge of up to 32 keys into a sorted pool of k keys (full or
    partly empty) gives the k smallest of both, for pools of 1 to 256."""
    rng = np.random.default_rng(seed)
    empty = 2**64 - 1
    for _ in range(150):
        k = int(rng.integers(1, topk.K_MAX + 1))
        universe = [int(v) for v in rng.choice(10**7, k + 32, replace=False)]
        fill = int(rng.integers(0, k + 1))
        pool = sorted(universe[:fill]) + [empty] * (k - fill)
        buf = universe[k : k + int(rng.integers(1, 33))]
        assert _warp_merge32(pool, buf, k) == sorted(pool + buf)[:k]
