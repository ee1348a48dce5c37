#
# Fused nearest-center assignment (counterpart of the JAX package's
# ops/pallas_select.py::fused_assign): labels = argmin over k of
# max(|x|² − 2·x·c + |c|², 0), the first index winning a tie.
#
# `assign` launches the CUDA kernel csrc/assign.cu for tensors on the card and
# runs `assign_plain`, the same function in plain PyTorch, for tensors on the
# CPU. The kernel's design and its bound on the H100 are in the source's header
# and in csrc/nearest.cuh, the tile it shares with the Lloyd kernel;
# `nearest_plan` picks that tile's launch for both (`_plan` here, and
# ops/lloyd.py::_plan).
#
# The cross term x·c takes `n_split` (ops/_precision.py): 3 full f32, or 2 the
# two-part bf16 split, which the callers pass under parity_precision="high"
# (ops/kmeans.py::kmeans_predict; `fast_math` leaves the assignment at the
# parity tier, as the JAX package's `_assign_n_split` does). |x|² and |c|² stay
# unrounded f32. `sq_dists` is the library product, full f32 at either tier.
#

from __future__ import annotations

import torch

from . import _cuda
from ._precision import F32, dot_multipass, pdot

# The nearest-center tile's geometry (csrc/nearest.cuh): 16 or 8 warps
# (nearest_threads), R / 16 warp rows of 16 rows each, the warps of a warp row
# splitting its depth; a warp holds the n8 fragments of a chunk of CK centers,
# one of CENTER_CHUNKS.
ROW_TILES = (64, 32, 16)  # R of whole rows, in the order the plan tries them
CHUNK_COLS = (64, 32)  # DC of a stage that holds part of a row
TALL = (128, (128, 64, 32))  # an assignment's R, and its DC, tried before the rest
MAX_STAGES = 4  # NT_MAX_STAGES
CENTER_CHUNKS = (24, 88)  # NT_CK_SMALL, NT_CK_LARGE: k = 20 pads to 24, k = 81 to 88
MAX_SMEM_BYTES = 227 * 1024  # NT_MAX_SMEM: the most a block may use on the H100
# n_split -> (the mma's depth, a lane's 32-bit words of center parts per
# fragment and k-step, the staged rows' pad in floats)
FORM = {F32: (8, 4, 4), 2: (16, 4, 8), 1: (16, 2, 8)}


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def nearest_threads(CK: int) -> int:
    """Threads of a block (nearest.cuh's nt_threads): 16 warps with 24-center
    chunks, 8 with 88."""
    return 512 if CK == CENTER_CHUNKS[0] else 256


def nearest_smem(n_split: int, k: int, d: int, R: int, S: int, DC: int, resident: bool,
                 CK: int, sums_smem: bool = False, lloyd: bool = False) -> int:
    """Bytes of dynamic shared memory of the tile at this plan (nearest.cuh's
    nt_layout): the centers' parts (all k, in whole chunks, by every column when
    resident; one chunk of CK by DC columns otherwise), the ring of S stages of
    R rows by DC + pad columns, the warps' partial cross terms and norms, eight
    per-row arrays and the sorted rows, and, for a Lloyd step with sums_smem,
    its sums and counts."""
    kstep, words, pad = FORM[n_split]
    d_pad = _up(d, DC)
    frags = (-(-_up(k, 8) // CK) if resident else 1) * CK // 8
    ksteps = (d_pad if resident else DC) // kstep
    parts = frags * ksteps * 32 * words * 4
    ring = S * R * (DC + pad) * 4
    WM = R // 16
    WS = nearest_threads(CK) // 32 // WM  # warps sharing a warp row
    slots = (WS // 2) * WM if WS > 1 else 0  # the tree's partial sums
    comb = slots * (CK // 8) * 32 * 16 + slots * 32 * 8
    rows = 12 * R * 4
    sums = _up((k * d + k) * 4, 16) if (lloyd and sums_smem) else 0
    return parts + ring + comb + rows + sums


def nearest_plan(n_rows: int, k: int, d: int, n_split: int, lloyd: bool, sms: int) -> dict:
    """The tile's launch for n_rows rows of width d against k centers at
    n_split (csrc/nearest.cuh). It tries, in order: the centers resident (all
    k, split once a block, in chunks of CK = 24 centers where k pads to at
    most 24, else 88), then not (chunks of CK centers read and split for each
    tile, 88 before 24); then the stage's shape: for an assignment with one
    center chunk, tiles of 128 rows first (whole rows, then 128, 64 or 32
    columns of them: X is read once either way, and the taller tile spreads
    each tile's fixed cost over more rows); then whole rows (DC = d padded to
    16) at R = 64, 32, 16, then chunks of 64 or 32 columns at R = 64; for a
    Lloyd step its sums in registers (one chunk of 24 centers, whole rows of
    at most 256 columns, R <= 64), in shared memory, or in device memory; the
    most stages, down to 2, that fit MAX_SMEM_BYTES. The first that fits is
    the plan: the centers are resident exactly where their parts fit beside
    the smallest ring. One block an SM, each over a contiguous range of
    rows_per_block rows (a multiple of R). x_reads: how often each element of
    X is read from device memory (1 with whole rows, which stay in their
    stage for every center chunk; with chunked rows once per center chunk, and
    for Lloyd once more by the update)."""
    k_pad = _up(k, 8)
    d16 = _up(d, 16)
    rest = [(R, d16) for R in ROW_TILES] + [(64, dc) for dc in CHUNK_COLS if dc < d16]
    tall_r, tall_dc = TALL
    tall = [(tall_r, d16)] + [(tall_r, dc) for dc in tall_dc if dc < d16]
    small, large = CENTER_CHUNKS
    chunks = [small] if k_pad <= small else [large, small]
    for resident in (True, False):
        cks = chunks[:1] if resident else chunks
        shapes = [(R, DC, CK) for CK in cks if not lloyd and -(-k_pad // CK) == 1
                  for R, DC in tall] + [(R, DC, CK) for R, DC in rest for CK in cks]
        for R, DC, CK in shapes:
            n_cc = -(-k_pad // CK)
            # a Lloyd step with one chunk of 24 centers and whole rows of at
            # most 256 columns keeps its sums in registers
            in_regs = CK == small and n_cc == 1 and DC == d16 and d <= 256 and R <= 64
            for sums_smem in ((True, False) if lloyd and not in_regs else (False,)):
                for S in range(MAX_STAGES, 1, -1):
                    smem = nearest_smem(n_split, k, d, R, S, DC, resident, CK, sums_smem,
                                        lloyd)
                    if smem > MAX_SMEM_BYTES:
                        continue
                    whole = DC == d16
                    tiles = max(1, -(-n_rows // R))
                    rows_per_block = -(-tiles // min(sms, tiles)) * R
                    return dict(
                        R=R, S=S, DC=DC, resident=resident, CK=CK, sums_smem=sums_smem,
                        sums=("registers" if in_regs else "shared memory" if sums_smem
                              else "device memory") if lloyd else None,
                        smem=smem, blocks=-(-max(n_rows, 1) // rows_per_block),
                        rows_per_block=rows_per_block, whole=whole, center_chunks=n_cc,
                        column_chunks=-(-d // DC),
                        x_reads=1 if whole else n_cc + (1 if lloyd else 0),
                    )
    raise ValueError(f"the nearest-center tile cannot place k={k}, d={d} at n_split {n_split}")


def _plan(n: int, k: int, d: int, n_split: int = F32, sms: int = 132) -> dict:
    """The assignment kernel's launch (csrc/assign.cu srml_assign): nearest_plan
    for n rows."""
    return nearest_plan(n, k, d, n_split, False, sms)


def sq_dists(X: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(n, k) clamped squared euclidean distances, by the matmul expansion."""
    x2 = torch.sum(X * X, dim=1, keepdim=True)
    c2 = torch.sum(centers * centers, dim=1)
    return torch.clamp(x2 - 2.0 * pdot(X, centers.T) + c2, min=0.0)


def assign_plain(X: torch.Tensor, centers: torch.Tensor, n_split: int = F32) -> torch.Tensor:
    """Plain PyTorch version of the kernel (torch.argmin returns the first index
    of a tie)."""
    x2 = torch.sum(X * X, dim=1, keepdim=True)
    c2 = torch.sum(centers * centers, dim=1)
    d2 = torch.clamp(x2 - 2.0 * dot_multipass(X, centers.T, n_split) + c2, min=0.0)
    return torch.argmin(d2, dim=1).to(torch.int32)


# the launch counter of each form: n_split -> attribute of assign
COUNTERS = {F32: "launches", 2: "launches_high"}


def assign(X: torch.Tensor, centers: torch.Tensor, n_split: int = F32) -> torch.Tensor:
    """int32 (n,) index of the nearest of centers (k, d) for each row of X (n, d)
    f32, the cross term at n_split (2 or 3)."""
    n, d = X.shape
    k = centers.shape[0]
    _cuda.require(X, "X", (n, d))
    _cuda.require(centers, "centers", (k, d))
    if k < 1:
        raise ValueError("assign needs at least one center")
    if n_split not in COUNTERS:
        raise ValueError(f"the assignment kernel takes n_split 2 or 3, got {n_split}")
    if _cuda.device_kind(X, centers) == "cpu":
        return assign_plain(X, centers, n_split)
    g = _plan(n, k, d, n_split, _cuda.sm_count(X))
    fn = _cuda.entry("assign")
    c2 = torch.sum(centers * centers, dim=1)
    labels = torch.empty((n,), dtype=torch.int32, device=X.device)
    _cuda.check(
        fn(X.data_ptr(), n, d, centers.data_ptr(), c2.data_ptr(), k, labels.data_ptr(),
           g["R"], g["S"], g["DC"], int(g["resident"]), g["CK"], g["rows_per_block"],
           g["blocks"], g["smem"], n_split, _cuda.stream_of(X)),
        "assign kernel",
    )
    _cuda.count_launch(assign, COUNTERS[n_split])
    return labels


assign.launches = 0  # f32 form
assign.launches_high = 0  # n_split 2
