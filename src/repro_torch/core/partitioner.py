"""Static-sparsity partitioner, pattern and value halves (PopSparse §3.2).

``plan_packing`` is the one-time host analysis of a static pattern: which
``(tm, tk)`` tiles are non-empty and where each logical ``b x b`` block
lands.  ``pack_values`` is the value half: a scatter of the ``[nnz, b,
b]`` blocks into the ``[T, tm, tk]`` tile stack in kernel-visit order.
The metadata arrays equal the JAX package's for the same pattern and tile
size; the CUDA bsmm kernel walks them with ``tm = tk = b``.
``plan_transpose``/``apply_transpose`` are the pattern and value halves
of the transposed pattern the backward's dL/dx product runs on.
``plan_swizzle``/``plan_packing_balanced`` bin the row-tiles by their
tile counts (sorted-snake dealing) into the visit schedule of the
balanced walk; ``balance_report`` measures a count profile's skew.
``plan_evolution``/``apply_evolution`` are the pattern and value halves
of a topology update (old pattern -> new pattern, RigL).
``plan_k_shards``/``apply_k_shards`` are the pattern and value halves of
the k-partition that tensor parallelism shards a static pattern by
(paper Fig. 1a lifted to several cards): ``balanced_k_splits`` places
``q`` uneven split positions over the block columns so each shard owns
about the same number of blocks, ``even_k_splits`` the fixed equal
splits; their metadata equals the JAX package's for the same pattern.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.bsr import BlockSparseMatrix, check_unique_blocks


@dataclasses.dataclass(frozen=True)
class PackingPlan:
    """Host metadata of a static pattern's tile packing."""

    tile_rows: np.ndarray     # [T] int32, row-major order
    tile_cols: np.ndarray     # [T] int32
    block_slot: np.ndarray    # [nnz] tile-stack slot of each logical block
    in_r: np.ndarray          # [nnz] block row within its tile
    in_c: np.ndarray          # [nnz] block col within its tile
    tm: int
    tk: int
    grid: Tuple[int, int]     # (Mt, Kt)
    shape: Tuple[int, int]    # (m, k)
    block_size: int
    nnz_blocks: int

    @property
    def num_tiles(self) -> int:
        return int(self.tile_rows.shape[0])

    @property
    def occupancy(self) -> float:
        dense_area = self.num_tiles * self.tm * self.tk
        nnz_area = self.nnz_blocks * self.block_size ** 2
        return float(nnz_area) / dense_area if dense_area else 0.0

    def row_ptr(self) -> np.ndarray:
        """CSR row pointer ``[Mt + 1]`` over the row-sorted tiles: the
        tiles of row-tile ``r`` are ``row_ptr[r]:row_ptr[r + 1]``."""
        counts = np.bincount(self.tile_rows, minlength=self.grid[0])
        return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)


def plan_packing(row_idx: np.ndarray, col_idx: np.ndarray,
                 shape: Tuple[int, int], block_size: int,
                 tm: int = 128, tk: int = 128) -> PackingPlan:
    """Which tiles exist and where each logical block lands.  Every
    output row-tile gets at least one tile (a zero tile at column 0 for
    an empty row), so the walk writes every output block."""
    m, k = shape
    b = block_size
    if tm % b or tk % b:
        raise ValueError(f"tile ({tm},{tk}) not divisible by block {b}")
    mt, kt = -(-m // tm), -(-k // tk)
    rpb, cpb = tm // b, tk // b

    rows = np.asarray(row_idx)
    cols = np.asarray(col_idx)
    check_unique_blocks(rows, cols, (-(-m // b), -(-k // b)))
    t_r, t_c = rows // rpb, cols // cpb
    lin = t_r * kt + t_c
    uniq = np.unique(lin)
    present_rows = set((uniq // kt).tolist())
    pad = np.asarray([r * kt for r in range(mt) if r not in present_rows],
                     dtype=uniq.dtype)
    uniq = np.sort(np.concatenate([uniq, pad]))
    # slot of each block's tile: uniq is sorted, so a binary search gives
    # the same map as a dict over its entries
    slots = np.searchsorted(uniq, lin)

    return PackingPlan(
        tile_rows=(uniq // kt).astype(np.int32),
        tile_cols=(uniq % kt).astype(np.int32),
        block_slot=slots.astype(np.int64),
        in_r=(rows % rpb).astype(np.int64),
        in_c=(cols % cpb).astype(np.int64),
        tm=tm, tk=tk, grid=(mt, kt), shape=(m, k), block_size=b,
        nnz_blocks=len(rows))


def pack_index(plan: PackingPlan, device) -> torch.Tensor:
    """Where each logical block lands in the tile stack viewed as
    ``[T * rpb * cpb, b, b]`` blocks (long, on ``device``).  A caller
    that packs often keeps it: building it copies from the host, which
    waits for the device."""
    b = plan.block_size
    rpb, cpb = plan.tm // b, plan.tk // b
    flat = (plan.block_slot * rpb + plan.in_r) * cpb + plan.in_c
    return torch.as_tensor(flat, dtype=torch.long, device=device)


def pack_values(plan: PackingPlan, values: torch.Tensor,
                index: torch.Tensor | None = None) -> torch.Tensor:
    """Scatter ``[nnz, b, b]`` blocks into the ``[T, tm, tk]`` tile
    stack laid out in kernel-visit order (pad tiles stay zero).
    ``index`` is ``pack_index(plan, values.device)``, if the caller keeps
    one.  The pattern's blocks are unique (``check_unique_blocks``), so
    the scatter is a copy."""
    b = plan.block_size
    rpb, cpb = plan.tm // b, plan.tk // b
    if index is None:
        index = pack_index(plan, values.device)
    blocks = torch.zeros((plan.num_tiles * rpb * cpb, b, b),
                         dtype=values.dtype, device=values.device)
    blocks.index_copy_(0, index, values)
    # [T, rpb, cpb, b, b] -> [T, rpb * b, cpb * b]
    return blocks.reshape(plan.num_tiles, rpb, cpb, b, b).permute(
        0, 1, 3, 2, 4).reshape(plan.num_tiles, plan.tm, plan.tk)


@dataclasses.dataclass(frozen=True)
class TransposePlan:
    """Host analysis of a pattern's transpose: ``W^T`` holds the same
    nnz blocks re-sorted row-major in ``(col, row)`` coordinates, each
    block transposed.  ``perm`` is the value permutation (applied per
    call while weights train); ``row_idx``/``col_idx`` are the
    transposed pattern's metadata."""

    perm: np.ndarray        # [nnz] source block of transposed slot z
    row_idx: np.ndarray     # [nnz] int32 (block rows of W^T == cols of W)
    col_idx: np.ndarray     # [nnz] int32 (block cols of W^T == rows of W)
    shape: Tuple[int, int]  # (k, m), the transposed logical shape
    block_size: int


def plan_transpose(row_idx: np.ndarray, col_idx: np.ndarray,
                   shape: Tuple[int, int],
                   block_size: int) -> TransposePlan:
    """Pattern phase of the backward transpose, computed once per
    pattern.  The value phase is ``apply_transpose``."""
    rows = np.asarray(row_idx, np.int64)
    cols = np.asarray(col_idx, np.int64)
    perm = np.lexsort((rows, cols))      # row-major in (col, row) coords
    m, k = shape
    return TransposePlan(perm, cols[perm].astype(np.int32),
                         rows[perm].astype(np.int32), (k, m), block_size)


def apply_transpose(plan: TransposePlan, values: torch.Tensor,
                    perm: torch.Tensor | None = None) -> torch.Tensor:
    """Value phase: permute the ``[nnz, b, b]`` blocks into the
    transposed pattern's row-major order and transpose each block.
    ``perm`` is ``plan.perm`` already on ``values``' device, if the
    caller keeps one."""
    if perm is None:
        perm = torch.as_tensor(plan.perm, dtype=torch.long,
                               device=values.device)
    return values[perm].transpose(1, 2)


@dataclasses.dataclass(frozen=True)
class SwizzlePlan:
    """Row-swizzle pre-pass (Gale et al. 2020 §5.1, row binning): assign
    row-tiles to ``num_bins`` equal-work bins by sorted-snake dealing
    over their tile counts, so a balanced kernel grid can walk one bin
    per (parallel) grid lane with near-equal steps per lane.

    ``order`` is the swizzled visit order (bins concatenated, row-tiles
    ascending within a bin); ``inverse`` is its inverse permutation.
    The balanced kernel writes each row-tile at its original position,
    so no runtime un-permute runs.
    """

    order: np.ndarray       # [R] row-tiles in visit order
    inverse: np.ndarray     # [R] inverse permutation of ``order``
    bin_of: np.ndarray      # [R] owning bin per row-tile
    num_bins: int
    steps_per_bin: int      # max per-bin tile count (the padded lane length)
    loads: np.ndarray       # [num_bins] tile count per bin


def plan_swizzle(row_counts: np.ndarray,
                 num_bins: int | None = None) -> SwizzlePlan:
    """Bin row-tiles so per-bin work (tile counts) is equalized.

    Sorted-snake dealing: sort rows by count descending, deal them into
    bins boustrophedon (0..B-1, B-1..0, ...).  For power-law row
    profiles this bounds the max-bin load close to the mean -- the
    row-swizzle load balance of Gale et al. without any runtime cost.
    """
    counts = np.asarray(row_counts, np.int64)
    r = int(counts.size)
    nb = min(int(num_bins) if num_bins else 8, max(r, 1))
    nb = max(nb, 1)
    order_desc = np.argsort(-counts, kind="stable")
    bin_of = np.zeros(r, np.int32)
    for i, row in enumerate(order_desc):
        pos, rnd = i % nb, i // nb
        bin_of[row] = pos if rnd % 2 == 0 else nb - 1 - pos
    loads = np.bincount(bin_of, weights=counts,
                        minlength=nb).astype(np.int64)
    order = np.lexsort((np.arange(r), bin_of))
    inverse = np.argsort(order)
    steps = int(loads.max()) if r else 0
    return SwizzlePlan(order.astype(np.int64), inverse.astype(np.int64),
                       bin_of, nb, steps, loads)


@dataclasses.dataclass(frozen=True)
class BalancedPacking:
    """Swizzle-composed tile packing (plan-first contract): the base
    row-major ``PackingPlan`` (``pack_values`` layout is unchanged) plus
    the per-bin visit schedule the balanced kernel walks.

    ``visit_slot[g, s]`` is the tile-stack slot bin ``g`` multiplies at
    step ``s`` -- or ``base.num_tiles``, the appended all-zero pad tile,
    once the bin's real work is exhausted.  Pad steps keep the bin's
    last real row so the walk's flush fires once, at the lane end.
    ``visit_rows`` carries *original* row-tile ids: the inverse swizzle
    permutation is applied to the output by construction.
    """

    base: PackingPlan
    swizzle: SwizzlePlan
    visit_slot: np.ndarray   # [num_bins, steps] int32
    visit_rows: np.ndarray   # [num_bins, steps] int32 (original row-tiles)
    visit_cols: np.ndarray   # [num_bins, steps] int32

    @property
    def num_bins(self) -> int:
        return int(self.visit_slot.shape[0])

    @property
    def steps_per_bin(self) -> int:
        return int(self.visit_slot.shape[1])


def plan_packing_balanced(row_idx: np.ndarray, col_idx: np.ndarray,
                          shape: Tuple[int, int], block_size: int,
                          tm: int = 128, tk: int = 128,
                          num_bins: int | None = None) -> BalancedPacking:
    """Pattern phase of the balanced (row-swizzled) packing: the base
    ``plan_packing`` metadata plus the snake-binned visit schedule.
    Host-only, runs once per pattern."""
    base = plan_packing(row_idx, col_idx, shape, block_size, tm, tk)
    mt = base.grid[0]
    counts = np.bincount(base.tile_rows, minlength=mt)
    sw = plan_swizzle(counts, num_bins)
    nb, steps = sw.num_bins, sw.steps_per_bin
    # base.tile_rows is sorted row-major: each row-tile's slots are one
    # contiguous range
    starts = np.searchsorted(base.tile_rows, np.arange(mt), side="left")
    ends = np.searchsorted(base.tile_rows, np.arange(mt), side="right")
    visit_slot = np.full((nb, steps), base.num_tiles, np.int32)  # pad tile
    visit_rows = np.zeros((nb, steps), np.int32)
    visit_cols = np.zeros((nb, steps), np.int32)
    for g in range(nb):
        rows_g = np.flatnonzero(sw.bin_of == g)
        slots = np.concatenate([np.arange(starts[r], ends[r])
                                for r in rows_g]) if rows_g.size else \
            np.zeros(0, np.int64)
        t = slots.size
        visit_slot[g, :t] = slots
        visit_rows[g, :t] = base.tile_rows[slots]
        visit_cols[g, :t] = base.tile_cols[slots]
        if t:                      # pad keeps the lane's last real row
            visit_rows[g, t:] = visit_rows[g, t - 1]
    return BalancedPacking(base, sw, visit_slot, visit_rows, visit_cols)


@dataclasses.dataclass(frozen=True)
class EvolvePlan:
    """Host analysis of a pattern evolution (old -> new), the pattern
    half of a RigL topology update on a static plan: for each block of
    the new pattern, its slot in the old values stack, or -1 for a grown
    block.  ``apply_evolution`` is the value half."""

    src_slot: np.ndarray      # [nnz_new] int64; -1 marks a grown block
    carried: int              # blocks present in both patterns
    dropped: int              # old blocks absent from the new pattern
    grown: int                # new blocks absent from the old pattern
    # src_slot on each device it was applied on
    _dev: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

    def slots_on(self, device) -> torch.Tensor:
        """``src_slot`` on ``device`` (copied once per device)."""
        key = str(device)
        src = self._dev.get(key)
        if src is None:
            src = self._dev[key] = torch.as_tensor(
                self.src_slot, dtype=torch.long, device=device)
        return src


def plan_evolution(old_rows: np.ndarray, old_cols: np.ndarray,
                   new_rows: np.ndarray, new_cols: np.ndarray,
                   grid: Tuple[int, int]) -> EvolvePlan:
    """Map each new-pattern block to its old values slot (host, once per
    topology step).  Neither pattern needs to be sorted; both must be
    duplicate-free (``check_unique_blocks``)."""
    kb = grid[1]
    check_unique_blocks(old_rows, old_cols, grid)
    check_unique_blocks(new_rows, new_cols, grid)
    old_lin = (np.asarray(old_rows, np.int64) * kb
               + np.asarray(old_cols, np.int64))
    new_lin = (np.asarray(new_rows, np.int64) * kb
               + np.asarray(new_cols, np.int64))
    if old_lin.size:
        order = np.argsort(old_lin)
        pos = np.minimum(np.searchsorted(old_lin[order], new_lin),
                         old_lin.size - 1)
        found = old_lin[order][pos] == new_lin
        src = np.where(found, order[pos], -1).astype(np.int64)
    else:
        src = np.full(new_lin.size, -1, np.int64)
    carried = int((src >= 0).sum())
    return EvolvePlan(src, carried, int(old_lin.size) - carried,
                      int(new_lin.size) - carried)


def apply_evolution(plan: EvolvePlan, old: torch.Tensor) -> torch.Tensor:
    """Value half of a topology update: carry any per-slot ``[nnz_old,
    ...]`` tensor (the values, an optimizer's master copy or moments)
    into the new pattern's ``[nnz_new, ...]`` slots with one gather on
    its device.  Carried slots are bit-equal, grown slots are zero."""
    nnz_new = int(plan.src_slot.shape[0])
    if old.shape[0] == 0:
        return old.new_zeros((nnz_new,) + tuple(old.shape[1:]))
    src = plan.slots_on(old.device)
    keep = (src >= 0).reshape((-1,) + (1,) * (old.dim() - 1))
    return old[src.clamp_min(0)].masked_fill(~keep, 0)


def balance_report(counts: np.ndarray) -> dict:
    """Load-balance diagnostics (used by tests + benchmarks)."""
    counts = np.asarray(counts)
    if counts.size == 0:
        # degenerate pattern (no owners): a zeroed report, not a crash
        return {"max": 0, "min": 0, "mean": 0.0, "imbalance": 0.0,
                "padding_waste": 0.0, "frac_empty": 0.0, "cv": 0.0}
    mx, mn, mean = counts.max(), counts.min(), counts.mean()
    return {
        "max": int(mx), "min": int(mn), "mean": float(mean),
        # max/mean alone hides all-empty owners (min=0 still reports a
        # finite ratio): frac_empty + cv surface that skew honestly
        "imbalance": float(mx / mean) if mean else 0.0,
        "padding_waste": float((mx * len(counts) - counts.sum())
                               / max(1, counts.sum())),
        "frac_empty": float((counts == 0).mean()),
        "cv": float(counts.std() / mean) if mean else 0.0,
    }


def balanced_k_splits(block_mask: np.ndarray, q: int) -> np.ndarray:
    """``q`` uneven split positions over the block columns balancing the
    blocks each shard owns: boundaries ``[q + 1]`` with
    ``boundaries[0] = 0`` and ``boundaries[q] = Kb`` (paper Fig. 1a: the
    splits adapt to the known pattern).

    Each boundary is placed greedily on the prefix sum of the column
    counts.  One that lands on a plateau of the prefix (a run of empty
    columns) slides along it toward the even-split position, so the
    empty columns spread over the shards instead of piling onto the last
    ones; where the remaining shards would get no column, it is clamped
    back toward the even position."""
    col_nnz = np.asarray(block_mask, bool).sum(axis=0)
    kb = len(col_nnz)
    if q > kb:
        raise ValueError(f"q={q} partitions > {kb} block columns")
    total = int(col_nnz.sum())
    prefix = np.concatenate([[0], np.cumsum(col_nnz)])
    boundaries = [0]
    for p in range(1, q):
        target = total * p / q
        e = int(round(kb * p / q))           # the even-split position
        jlo = int(np.searchsorted(prefix, target, side="left"))
        jhi = jlo
        while jhi + 1 <= kb and prefix[jhi + 1] == prefix[jlo]:
            jhi += 1
        j = min(max(e, jlo), jhi)
        # leave a column for each of the remaining partitions
        j = max(j, boundaries[-1] + 1)
        hi = kb - (q - p)
        if j > hi:
            j = max(boundaries[-1] + 1, min(hi, e))
        boundaries.append(j)
    boundaries.append(kb)
    return np.asarray(boundaries, np.int64)


def even_k_splits(kb: int, q: int) -> np.ndarray:
    """Fixed equal splits over ``kb`` block columns (paper §3.3, the
    dynamic mode's): the last may be smaller."""
    size = -(-kb // q)
    return np.minimum(np.arange(q + 1) * size, kb).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class ShardedBlocks:
    """The blocks stacked per k-shard, padded to a common ``slots``
    count with zero blocks at (row 0, the shard's first column), so a
    padding slot adds exactly zero; shard ``j`` owns ``real_counts[j]``
    blocks, in its first slots."""

    values: torch.Tensor     # [q, slots, b, b]
    row_idx: np.ndarray      # [q, slots] int32
    col_idx: np.ndarray      # [q, slots] int32 (global block column)
    boundaries: np.ndarray
    shape: Tuple[int, int]
    block_size: int
    real_counts: np.ndarray  # [q]

    @property
    def q(self) -> int:
        return int(self.values.shape[0])

    @property
    def slots(self) -> int:
        return int(self.values.shape[1])


@dataclasses.dataclass(frozen=True)
class KShardPlan:
    """Host analysis of a k-partition, the pattern half of
    ``shard_blocks_by_k``: the split boundaries and each block's shard
    and slot.  ``apply_k_shards`` is the value half."""

    boundaries: np.ndarray   # [q + 1] block-column split positions
    row_idx: np.ndarray      # [q, slots] int32 (padding: row 0)
    col_idx: np.ndarray      # [q, slots] int32 (padding: owned column)
    dst_q: np.ndarray        # [nnz] destination shard, in src_order
    dst_slot: np.ndarray     # [nnz] destination slot, in src_order
    src_order: np.ndarray    # [nnz] source blocks, stable by owner
    shape: Tuple[int, int]
    block_size: int
    real_counts: np.ndarray  # [q] blocks each shard owns
    balanced: bool = True    # nnz-balanced splits, or even ones
    # the index arrays on each device they were applied on
    _dev: Dict[str, Tuple[torch.Tensor, ...]] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

    @property
    def q(self) -> int:
        return int(self.row_idx.shape[0])

    @property
    def slots(self) -> int:
        return int(self.row_idx.shape[1])

    def shard_source(self, j: int) -> np.ndarray:
        """The source blocks (operand order) shard ``j`` owns, in the
        order of its slots."""
        start = int(self.real_counts[:j].sum())
        return self.src_order[start:start + int(self.real_counts[j])]

    def shard_pattern(self, j: int) -> Tuple[np.ndarray, np.ndarray]:
        """``(row_idx, col_idx)`` of shard ``j``'s own blocks (no
        padding), over the full grid."""
        c = int(self.real_counts[j])
        return self.row_idx[j, :c].copy(), self.col_idx[j, :c].copy()

    def indices_on(self, device) -> Tuple[torch.Tensor, ...]:
        """``(dst_q, dst_slot, src_order)`` on ``device`` (copied once)."""
        key = str(device)
        hit = self._dev.get(key)
        if hit is None:
            hit = self._dev[key] = tuple(
                torch.as_tensor(a, dtype=torch.long, device=device)
                for a in (self.dst_q, self.dst_slot, self.src_order))
        return hit


def plan_k_shards(bsr: BlockSparseMatrix, q: int, *,
                  balanced: bool = True) -> KShardPlan:
    """Pattern half of ``shard_blocks_by_k``: the boundaries and every
    block's destination."""
    mask = np.zeros(bsr.grid, bool)
    rows = np.asarray(bsr.row_idx, np.int64)
    cols = np.asarray(bsr.col_idx, np.int64)
    mask[rows, cols] = True
    kb = mask.shape[1]
    if q < 1 or q > kb:
        raise ValueError(f"q={q} k-shards outside [1, {kb} block "
                         f"columns] for shape {bsr.shape} at block "
                         f"{bsr.block_size}")
    bounds = (balanced_k_splits(mask, q) if balanced
              else even_k_splits(kb, q))
    owner = np.searchsorted(bounds, cols, side="right") - 1
    counts = np.bincount(owner, minlength=q)
    slots = max(int(counts.max()) if len(counts) else 1, 1)
    row_out = np.zeros((q, slots), np.int32)
    col_out = np.repeat(bounds[:q, None], slots, axis=1).astype(np.int32)
    src_order = np.argsort(owner, kind="stable")
    dst_q = owner[src_order]
    # each block's slot: its rank among its shard's blocks
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    dst_slot = np.arange(len(dst_q)) - starts[dst_q]
    row_out[dst_q, dst_slot] = rows[src_order]
    col_out[dst_q, dst_slot] = cols[src_order]
    return KShardPlan(bounds, row_out, col_out, dst_q, dst_slot, src_order,
                      tuple(bsr.shape), bsr.block_size, counts, balanced)


def apply_k_shards(plan: KShardPlan, values: torch.Tensor) -> ShardedBlocks:
    """Value half: the ``[nnz, b, b]`` blocks scattered into the stacked
    ``[q, slots, b, b]`` shard layout on their device (differentiable in
    ``values``)."""
    b = plan.block_size
    dq, ds, src = plan.indices_on(values.device)
    out = values.new_zeros((plan.q, plan.slots, b, b)).index_put(
        (dq, ds), values[src])
    return ShardedBlocks(out, plan.row_idx, plan.col_idx, plan.boundaries,
                         plan.shape, b, plan.real_counts)


def shard_blocks_by_k(bsr: BlockSparseMatrix, q: int, *,
                      balanced: bool = True) -> ShardedBlocks:
    """The blocks over ``q`` k-partitions: nnz-balanced uneven splits
    (``balanced=True``, the static mode's) or fixed equal splits (the
    dynamic mode's, to measure the imbalance the paper attributes to
    it).  ``plan_k_shards`` then ``apply_k_shards``."""
    return apply_k_shards(plan_k_shards(bsr, q, balanced=balanced),
                          bsr.values)
