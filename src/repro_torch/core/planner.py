"""Dynamic-sparsity planner (PopSparse §3.3, Appendix A.2).

A copy of the JAX package's ``core/planner.py`` (which imports no JAX)
kept in the port so the port imports nothing of the JAX package.  With
dynamic sparsity only ``d_max`` is known when a plan is built; the
planner chooses how many equal parts to divide each of (m, k, n) into
(``q^m, q^k, q^n``) and sizes fixed buckets for the non-zero values:

    N_nonzero = m * k * d_max / (q^m * q^k)        (+ headroom)

The analytic cost model over (q^m, q^k, q^n) keeps the reference's
constants unchanged, so the port's plans (bucket sizes, grouped tile
capacities, overflow probabilities) equal the reference's number for
number.  Those constants describe the reference's TPU v5e target, not
the H100: they rank partitionings here, they are not a time estimate
for this port.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

# the reference's TPU v5e constants (kept so plans match it exactly)
PEAK_FLOPS_BF16 = 197e12
HBM_BW = 819e9
ICI_BW = 50e9
HEADROOM = 1.25  # paper: "some extra headroom is given in the size of these buckets"


@dataclasses.dataclass(frozen=True)
class DynamicPlan:
    q_m: int
    q_k: int
    q_n: int
    bucket_blocks: int     # non-zero-block capacity per (q_m x q_k) bucket
    nnz_max_blocks: int    # total block slots across buckets (>= true nnz)
    est_seconds: float
    shape: Tuple[int, int, int]   # (m, k, n)
    block_size: int
    d_max: float

    @property
    def total_partitions(self) -> int:
        return self.q_m * self.q_k * self.q_n


def _divisor_candidates(dim_blocks: int, limit: int) -> list[int]:
    cands = set()
    q = 1
    while q <= min(dim_blocks, limit):
        cands.add(q)
        q *= 2
    for q in range(1, min(dim_blocks, limit) + 1):
        if dim_blocks % q == 0:
            cands.add(q)
    return sorted(cands)


def _cost(m: int, k: int, n: int, d_max: float, b: int,
          q_m: int, q_k: int, q_n: int, bytes_per_el: int,
          units: int) -> float:
    """Estimated step time for one unit, paper-style phase decomposition."""
    parts_mk = q_m * q_k
    bucket_blocks = math.ceil(m * k * d_max / (b * b) / parts_mk * HEADROOM)
    # compute: bucket FLOPs on this unit's n-slice
    flops = 2.0 * bucket_blocks * b * b * (n / q_n)
    t_compute = flops / PEAK_FLOPS_BF16
    # distribution phase: move dense input slice + bucket into local memory
    in_bytes = (k / q_k) * (n / q_n) * bytes_per_el
    bucket_bytes = bucket_blocks * b * b * bytes_per_el + bucket_blocks * 8
    t_dist = (in_bytes + bucket_bytes) / HBM_BW
    # reduction across q_k partial outputs (log-tree on ICI when sharded)
    out_bytes = (m / q_m) * (n / q_n) * bytes_per_el
    t_reduce = out_bytes * max(0, q_k - 1) / max(q_k, 1) / ICI_BW
    # propagation headroom: imbalance risk grows with parts_mk (paper worst
    # case needs up to q_m*q_k extra exchange+compute steps); model the
    # expected overhead as a mild superlinear penalty.
    t_prop = t_compute * 0.1 * math.log2(max(2, parts_mk))
    return t_compute + t_dist + t_reduce + t_prop


def plan_dynamic(m: int, k: int, n: int, *, d_max: float, block_size: int,
                 units: int = 16, bytes_per_el: int = 2) -> DynamicPlan:
    """Pick (q^m, q^k, q^n) minimizing the analytic cost model.

    ``units`` is the parallel-unit budget (q^m*q^k*q^n <= units), e.g. the
    ``model`` mesh-axis size for a TP deployment or a per-chip grid budget.
    """
    b = block_size
    mb, kb, nb = m // b, k // b, max(1, n // b)
    best = None
    for q_m in _divisor_candidates(mb, units):
        for q_k in _divisor_candidates(kb, units // q_m):
            rem = units // (q_m * q_k)
            if rem < 1:
                continue
            for q_n in _divisor_candidates(nb, rem):
                c = _cost(m, k, n, d_max, b, q_m, q_k, q_n,
                          bytes_per_el, units)
                if best is None or c < best[0]:
                    best = (c, q_m, q_k, q_n)
    assert best is not None
    c, q_m, q_k, q_n = best
    parts_mk = q_m * q_k
    bucket = math.ceil(m * k * d_max / (b * b) / parts_mk * HEADROOM)
    return DynamicPlan(q_m, q_k, q_n, bucket, bucket * parts_mk, c,
                       (m, k, n), b, d_max)


def nnz_max_blocks(m: int, k: int, block_size: int, d_max: float) -> int:
    """Total block-slot budget implied by ``d_max`` (no partitioning)."""
    grid = (m // block_size) * (k // block_size)
    return max(1, math.ceil(grid * d_max))


# ---------------------------------------------------------------------------
# Grouped-route capacity planning (paper §3.3 bucket sizing applied to the
# dynamic_grouped tile slots): capacity = expected occupancy + headroom,
# NOT the safe worst case -- overflow is accepted and accounted for.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GroupedCapacityPlan:
    """Planned tile capacity for the ``dynamic_grouped`` route.

    tile            physical tile side (a block multiple)
    expected_tiles  analytic E[#distinct non-empty tiles] for a uniform
                    random pattern at ``d_max``
    worst_tiles     safe worst case: every slot in its own tile, capped
                    at the tile grid
    tiles_cap       the planned capacity actually allocated:
                    min(worst, ceil(expected * headroom))
    headroom        the multiplicative slack over the expectation (the
                    paper's "some extra headroom")
    overflow_p      analytic P[#distinct tiles > tiles_cap] (normal
                    approximation over per-tile occupancy)
    """

    tile: int
    expected_tiles: float
    worst_tiles: int
    tiles_cap: int
    headroom: float
    overflow_p: float

    def as_dict(self) -> dict:
        return {"tile": self.tile,
                "expected_tiles": round(self.expected_tiles, 3),
                "worst_tiles": self.worst_tiles,
                "tiles_cap": self.tiles_cap,
                "headroom": self.headroom,
                "overflow_p": round(self.overflow_p, 6)}


def expected_grouped_tiles(m: int, k: int, block_size: int, density: float,
                           tile: int) -> float:
    """E[#distinct non-empty (tile x tile) tiles] for a uniform random
    block pattern: each tile holds ``(tile/b)^2`` logical blocks and is
    non-empty with probability ``1 - (1 - d)^per_tile``."""
    mt, kt = max(1, m // tile), max(1, k // tile)
    per_tile = (tile // block_size) ** 2
    d = min(max(density, 0.0), 1.0)
    p = 1.0 - (1.0 - d) ** per_tile
    return mt * kt * p


def grouped_overflow_probability(m: int, k: int, block_size: int,
                                 density: float, tile: int,
                                 tiles_cap: int,
                                 slots: Optional[int] = None) -> float:
    """Analytic P[#distinct non-empty tiles > tiles_cap] under the same
    random-pattern model (normal approximation with per-tile Bernoulli
    variance -- slightly conservative vs the true without-replacement
    pattern, which has less spread).  ``slots`` is the operand's
    block-slot capacity: distinct tiles can never exceed it, so a
    ``tiles_cap`` at (or above) that bound provably cannot overflow."""
    mt, kt = max(1, m // tile), max(1, k // tile)
    per_tile = (tile // block_size) ** 2
    d = min(max(density, 0.0), 1.0)
    p = 1.0 - (1.0 - d) ** per_tile
    n_tiles = mt * kt
    hard_max = n_tiles if slots is None else min(n_tiles, int(slots))
    if tiles_cap >= hard_max:
        return 0.0
    mu = n_tiles * p
    var = n_tiles * p * (1.0 - p)
    if var <= 0.0:
        return 0.0 if tiles_cap >= mu else 1.0
    z = (tiles_cap + 0.5 - mu) / math.sqrt(var)
    return 0.5 * (1.0 - math.erf(z / math.sqrt(2.0)))


def plan_grouped_capacity(m: int, k: int, block_size: int, d_max: float,
                          *, tile: int, slots: Optional[int] = None,
                          headroom: float = HEADROOM) -> GroupedCapacityPlan:
    """Size the ``dynamic_grouped`` tile-slot bucket the paper's way:
    expected occupancy times ``headroom``, clamped to the safe worst
    case.  ``slots`` is the operand's block-slot capacity (defaults to
    the ``d_max`` budget); the worst case is one tile per slot, capped
    at the tile grid."""
    mt, kt = max(1, m // tile), max(1, k // tile)
    if slots is None:
        slots = nnz_max_blocks(m, k, block_size, d_max)
    worst = max(1, min(int(slots), mt * kt))
    expected = expected_grouped_tiles(m, k, block_size, d_max, tile)
    cap = max(1, min(worst, math.ceil(expected * headroom)))
    return GroupedCapacityPlan(
        tile=tile, expected_tiles=expected, worst_tiles=worst,
        tiles_cap=cap, headroom=float(headroom),
        overflow_p=grouped_overflow_probability(m, k, block_size, d_max,
                                                tile, cap, slots=slots))
