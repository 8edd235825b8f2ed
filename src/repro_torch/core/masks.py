"""Block-mask generators.

All masks are **host** ``numpy`` bool arrays over the block grid
``[m/b, k/b]`` -- they describe compile-time (static) sparsity patterns in
the sense of PopSparse §3.2.  Runtime (dynamic) patterns are produced on
device by the dynamic encoder in ``dynamic_sparse.py``.
"""
from __future__ import annotations

import numpy as np


def _grid(m: int, k: int, b: int) -> tuple[int, int]:
    if m % b or k % b:
        raise ValueError(f"({m},{k}) not divisible by block {b}")
    return m // b, k // b


def random_block_mask(m: int, k: int, b: int, density: float, *,
                      seed: int = 0, clustered: bool = False) -> np.ndarray:
    """Uniform random block mask with exactly ``round(density*Mb*Kb)`` blocks.

    ``clustered=True`` biases block placement into contiguous 128-aligned
    tiles -- the TPU-relevant regime discussed in DESIGN.md §2 (tile
    occupancy), which has no IPU analogue.
    """
    mb, kb = _grid(m, k, b)
    total = mb * kb
    # density=0.0 means *empty*, not "at least one block"
    nnz = 0 if density == 0.0 else max(1, int(round(density * total)))
    nnz = min(nnz, total)
    rng = np.random.default_rng(seed)
    mask = np.zeros((mb, kb), bool)
    if nnz == 0:
        return mask
    if not clustered:
        flat = rng.choice(total, size=nnz, replace=False)
        mask.flat[flat] = True
        return mask
    # clustered: fill whole (tile x tile) super-blocks first
    tile = max(1, 128 // b)
    mt, kt = -(-mb // tile), -(-kb // tile)
    per_tile = min(tile, mb) * min(tile, kb)
    n_tiles = max(1, nnz // per_tile)
    choice = rng.choice(mt * kt, size=min(n_tiles, mt * kt), replace=False)
    placed = 0
    for c in choice:
        ti, tj = divmod(c, kt)
        r0, c0 = ti * tile, tj * tile
        sub = mask[r0:r0 + tile, c0:c0 + tile]
        sub[...] = True
        placed += sub.size
        if placed >= nnz:
            break
    # trim overshoot with the seeded rng: clearing the highest-index set
    # bits would systematically deplete bottom-right tiles
    extra = int(mask.sum()) - nnz
    if extra > 0:
        on = np.flatnonzero(mask)
        mask.flat[rng.choice(on, size=extra, replace=False)] = False
    return mask


def _rows_from_profile(weights: np.ndarray, nnz: int, kb: int,
                       rng: np.random.Generator) -> np.ndarray:
    """Allocate ``nnz`` blocks over rows proportionally to ``weights``
    (largest-remainder rounding, per-row cap ``kb``)."""
    w = np.asarray(weights, np.float64)
    w = w / w.sum()
    ideal = w * nnz
    counts = np.floor(ideal).astype(np.int64)
    counts = np.minimum(counts, kb)
    rem = nnz - int(counts.sum())
    # hand out the remainder by largest fractional part, skipping rows
    # already at the kb cap (shuffle first so ties break by the rng)
    order = rng.permutation(len(w))
    order = order[np.argsort(-(ideal - np.floor(ideal))[order],
                             kind="stable")]
    for r in order:
        if rem <= 0:
            break
        if counts[r] < kb:
            counts[r] += 1
            rem -= 1
    while rem > 0:       # every high-remainder row capped: spill anywhere
        for r in order:
            if rem <= 0:
                break
            if counts[r] < kb:
                counts[r] += 1
                rem -= 1
    return counts


def _mask_from_row_counts(counts: np.ndarray, mb: int, kb: int,
                          rng: np.random.Generator) -> np.ndarray:
    mask = np.zeros((mb, kb), bool)
    for r in range(mb):
        c = int(counts[r])
        if c > 0:
            mask[r, rng.choice(kb, size=c, replace=False)] = True
    return mask


def power_law_block_mask(m: int, k: int, b: int, density: float, *,
                         alpha: float = 1.2, seed: int = 0) -> np.ndarray:
    """Skewed block mask with a power-law row profile (row ``i`` gets
    weight ``(i+1)^-alpha``, rows shuffled).  This is the realistic-DL
    regime of Gale et al. 2020 (arxiv 2006.10901): a few hot rows hold
    most of the nnz, so uniform tile walks serialize on them -- the
    pattern family the row-swizzle pre-pass exists for."""
    mb, kb = _grid(m, k, b)
    total = mb * kb
    nnz = 0 if density == 0.0 else max(1, int(round(density * total)))
    nnz = min(nnz, total)
    rng = np.random.default_rng(seed)
    if nnz == 0:
        return np.zeros((mb, kb), bool)
    weights = (np.arange(1, mb + 1, dtype=np.float64)) ** -alpha
    weights = weights[rng.permutation(mb)]
    counts = _rows_from_profile(weights, nnz, kb, rng)
    return _mask_from_row_counts(counts, mb, kb, rng)


def dlmc_block_mask(m: int, k: int, b: int, density: float, *,
                    sigma: float = 1.0, seed: int = 0) -> np.ndarray:
    """DLMC-style row-profile sampling: per-row nnz drawn from a
    lognormal profile (Gale et al.'s Deep Learning Matrix Collection
    shows pruned-transformer rows are heavy-tailed, not uniform).
    ``sigma`` controls the spread; ``sigma=0`` degenerates to uniform
    rows."""
    mb, kb = _grid(m, k, b)
    total = mb * kb
    nnz = 0 if density == 0.0 else max(1, int(round(density * total)))
    nnz = min(nnz, total)
    rng = np.random.default_rng(seed)
    if nnz == 0:
        return np.zeros((mb, kb), bool)
    weights = rng.lognormal(mean=0.0, sigma=sigma, size=mb)
    counts = _rows_from_profile(weights, nnz, kb, rng)
    return _mask_from_row_counts(counts, mb, kb, rng)


def banded_block_mask(m: int, k: int, b: int, bandwidth_blocks: int) -> np.ndarray:
    """Block band matrix: |i - j| <= bandwidth_blocks."""
    mb, kb = _grid(m, k, b)
    i = np.arange(mb)[:, None]
    j = np.arange(kb)[None, :]
    return np.abs(i - j) <= bandwidth_blocks


def butterfly_block_mask(m: int, k: int, b: int) -> np.ndarray:
    """Pixelated-butterfly style mask (Dao et al. 2021, cited in paper §6):
    union of a block-diagonal and a flat butterfly (stride) pattern."""
    mb, kb = _grid(m, k, b)
    n = max(mb, kb)
    mask = np.zeros((mb, kb), bool)
    i = np.arange(mb)
    mask[i, np.minimum(i, kb - 1)] = True
    stride = 1
    while stride < n:
        j = (np.arange(mb) ^ stride)
        ok = j < kb
        mask[np.arange(mb)[ok], j[ok]] = True
        stride *= 2
    return mask


def local_global_attention_mask(q_blocks: int, kv_blocks: int, *,
                                window_blocks: int, global_blocks: int,
                                causal: bool = True) -> np.ndarray:
    """Local+global block attention mask (BigBird/Longformer family).

    This is how the paper's *static* block sparsity powers the sub-
    quadratic ``long_500k`` configs (DESIGN.md §3): each query block
    attends to a local band plus the first ``global_blocks`` key blocks.
    """
    i = np.arange(q_blocks)[:, None]
    j = np.arange(kv_blocks)[None, :]
    local = np.abs(i - j) < window_blocks
    glob = j < global_blocks
    mask = local | glob
    if causal:
        mask &= j <= i
    return mask


def magnitude_block_mask(weights: np.ndarray, b: int, density: float) -> np.ndarray:
    """Top-``density`` blocks by L1 block magnitude (structured pruning,
    paper §1 'block (Gray et al., 2017)')."""
    m, k = weights.shape
    mb, kb = _grid(m, k, b)
    blocked = np.abs(np.asarray(weights, np.float64)).reshape(mb, b, kb, b)
    score = blocked.sum(axis=(1, 3))
    nnz = max(1, int(round(density * mb * kb)))
    thresh_idx = np.argsort(score, axis=None)[::-1][:nnz]
    mask = np.zeros((mb, kb), bool)
    mask.flat[thresh_idx] = True
    return mask


def block_diagonal_mask(mb: int, kb: int, groups: int) -> np.ndarray:
    """Block-diagonal (grouped GEMM) structure -- MoE's sparsity pattern."""
    mask = np.zeros((mb, kb), bool)
    rs, cs = mb // groups, kb // groups
    for g in range(groups):
        mask[g * rs:(g + 1) * rs, g * cs:(g + 1) * cs] = True
    return mask
