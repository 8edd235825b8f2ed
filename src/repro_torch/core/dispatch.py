"""Route decisions of the plan layer, priced by H100 time models of the
kernels' walks, and the serving price on them.

Counterpart of the JAX package's ``core/dispatch.py``: the decision
record (``Decision``) and its process-level cache keyed by the logical
problem (``_cache_key``: shape, ``n``, block, density bucket, dtype,
mode, measure, device type and the pattern's bucketed skew), the skew
signal (``pattern_balance``, ``_skew_factor``), the candidate sets
(``_candidates``, ``sddmm_candidates``), the measured race
(``measure_callable``) and ``decide``; plus ``price_tokens``, the serving
engine's admission and padding price.

The reference prices with its calibrated TPU model; no TPU figure
carries over.  Here ``_estimate`` prices a route with the H100 time
model of the walk its kernel takes for the problem (``walk_seconds``
beside each kernel's ``walk()`` in ``kernels/{bsmm/ops.py,
bsmm/balanced.py, dsmm/ops.py, gmm/ops.py, sddmm/ops.py,
dense_mm/ops.py}``): a per-launch constant plus the larger of the
operations at the walk's rate and the bytes at its bandwidth, over the
non-zero tiles, stages or slots the walk really visits (``WalkCounts``,
from the pattern where the plan has one).  A ``*_torch`` route (a
plain version, raced on the CPU only) is priced as its card
counterpart, so the analytic verdict on the CPU equals the card's and
the CPU tests can hold it.  The constants are fitted by hand to the
``[kernel]`` and ``[table3]`` rows that ``chip_smoke.py`` measures on an
NVIDIA H100 80GB HBM3 at a 700.00 W power limit (``PERF.md`` lists them
beside the model).

A calibration corrects the hand-tuned models (``CostCoeffs``, the
reference's layer): ``_estimate`` prices a route as ``scale[route] *
t_raw + fixed_us[route]`` over the raw walk model (``_estimate_raw``),
keyed by the card's route (a plain version takes its card route's
terms), and the skew knees come from the active coefficients.  The
coefficients are fitted from a committed corpus of ``chip_smoke.py``
runs by ``repro_torch.analysis.calibrate`` into
``src/repro_torch/analysis/baselines/cost_coeffs.json`` and read at
import (``$REPRO_TORCH_COST_COEFFS`` names another file); without one
the identity instance reproduces the hand-tuned model bit for bit.  A
non-identity calibration's digest joins every decision key, plan
fingerprint and disk key, so a refit orphans stale verdicts.

Measured races (``PlanContext(measure=True)``) time every candidate on
the card with CUDA events after one warm-up call, a sleep kernel holding
the stream while the launches are queued and the inputs rotated across
copies so that L2 is cold; on the CPU with the host clock.  Nothing
measures while a CUDA graph is being captured: the verdict is then
analytic.

The reference's deprecated entry points over the plan (``spmm``,
``spmm_nt``, ``matmul``, ``batched_matmul``, ``explain``,
``format_explain``) are kept as thin shims over ``repro_torch.sparse``:
they take a ``PlanContext`` where the reference takes its
``DispatchContext`` (the port has no separate dispatch policy), plan on
the activations' device and run the plan (the hand-written kernels on a
card, their plain versions on the CPU).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import json
import math
import os
import threading
import time
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import partitioner
from repro_torch.core import planner as planner_lib
from repro_torch.kernels import contract as contract_lib
from repro_torch.kernels.bsmm import balanced as bal_ops
from repro_torch.kernels.bsmm import ops as bsmm_ops
from repro_torch.kernels.dense_mm import ops as dmm_ops
from repro_torch.kernels.dsmm import ops as dsmm_ops
from repro_torch.kernels.gmm import ops as gmm_ops
from repro_torch.kernels.sddmm import ops as sddmm_ops

ROUTE = "dense_cuda"
# dL/dvalues of a static plan: the block SDDMM, or the dense product
# dy^T . x through dense_mm followed by a gather of the pattern's blocks
SDDMM_FAMILIES = ("sddmm", "sddmm_dense")

# the balanced walks price as their parent's (uniform) walk on the same
# tiles times the card's overhead: bsmm_balanced's in
# ``bsmm.balanced.walk_seconds`` (on its own walk: it has no decode walk),
# the grouped pair's here (the Table 3 rows: 1.005 to 1.047)
_GROUPED_BALANCED_OVERHEAD = 1.03
# the sparse walks serialise a block-row's work (a thread block, or a
# warp's rows, per tile-row), so their time grows with the pattern's row
# imbalance beyond what their counts see.  On the card the balanced walks
# pay it too (PERF.md: their time over the uniform walk's grows with the
# skew), so every sparse family is skew-sensitive; dense and SDDMM are not
_SKEW_SENSITIVE = ("static", "static_balanced", "dynamic",
                   "dynamic_grouped", "dynamic_grouped_balanced")
# the skew factor's knees, fitted by hand to chip_smoke.py's skew-grid
# rows (uniform, DLMC-like and power-law masks at 4096 x 4096, b 16, d =
# 1/32; the uniform walk's time over its count model: mma 1.00 / 1.26 /
# 1.50, ffma 1.00 / 1.12 / 1.37 at row imbalance 2 / 13 / 32; NVIDIA H100
# 80GB HBM3, 700.00 W).  The reference's form, the card's numbers
SKEW_KNEES = {"imb_knee": 2.0, "imb_slope": 0.015, "cv_knee": 0.25,
              "cv_slope": 0.0, "cap": 3.0}
# the device densify of a runtime pattern on the dense route
# (``DynamicOperand.to_dense``: zeros, an accumulating ``index_put_`` of
# the slots, the block permute, and the transposed copy dense_mm takes):
# a launch, then DENSIFY_PASSES passes over W at HBM rate, fitted by hand
# to chip_smoke.py's [race] dynamic rows (llama's FFN, d_max 1/8, b 16,
# bf16, N 2048: the dense route 0.465 / 0.409 ms, dense_mm's model 0.129,
# so 33 / 27 passes; NVIDIA H100 80GB HBM3, 700.00 W)
_DENSIFY_LAUNCH = 5e-6
DENSIFY_PASSES = 30.0
_HBM = 3.35e12
# measured races: each candidate is timed in MEASURE_WINDOWS windows of
# at least MEASURE_REPS launches (one launch of a served projection is
# ~10-50 us), its time the median window, each launch on the next of
# the input copies that hold ROTATE_BYTES (past the H100's 50 MB L2; at
# most MAX_COPIES sets, as chip_smoke.py's timings), so L2 is cold
MEASURE_WINDOWS = 5
MEASURE_REPS = 10
ROTATE_BYTES = 160 * 2 ** 20
MAX_COPIES = 64
# a measured winner displaces the model's pick only when it is faster by
# more than this share: above the spread of one plan's candidate times
# between two runs on the card (llama's 12 served FFN plans x 3 leading
# candidates, chip_smoke.py's [race] remeasured rows: up to 12.3 %, at N
# 4; NVIDIA H100 80GB HBM3, 700.00 W), so a verdict within the noise
# stays the analytic one and a restart replays the same route
MEASURE_MARGIN = 0.15


def family(route: str) -> str:
    """``static_balanced_cuda`` -> ``static_balanced``; a tensor-parallel
    route (``static_tp``, ``static_tp_shardmap``: no device suffix) is
    its own family."""
    if route.startswith("static_tp"):
        return route
    return route.rsplit("_", 1)[0]


def card_route(route: str) -> str:
    """The card's route of ``route``'s family (``static_torch`` ->
    ``static_cuda``): the key of its calibration terms."""
    return family(route) + "_cuda"


# ---------------------------------------------------------------------------
# Calibrated cost coefficients (fitted by repro_torch.analysis.calibrate)
# ---------------------------------------------------------------------------

_COEFFS_ENV = "REPRO_TORCH_COST_COEFFS"
COEFFS_PATH = os.path.normpath(os.path.join(
    os.path.dirname(__file__), "..", "analysis", "baselines",
    "cost_coeffs.json"))
# the hand-tuned skew constants, in the order of the coefficients' fields
_SKEW_FIELDS = ("imb_knee", "imb_slope", "cv_knee", "cv_slope", "cap")


@dataclasses.dataclass(frozen=True, eq=False)
class CostCoeffs:
    """Corrections to the hand-tuned H100 walk models, fitted from a
    committed corpus of card runs by ``repro_torch.analysis.calibrate``.

    ``_estimate`` prices a route as ``scale[route] * t_raw +
    fixed_us[route]`` over the raw walk model ``t_raw``
    (``_estimate_raw``), keyed by the card's route; the skew
    knee/slope/cap fields replace ``SKEW_KNEES``.  ``digest`` (a content
    hash of the fitted values) joins every decision cache key and,
    through ``_cache_key``, every plan fingerprint and disk key, so a
    refit orphans stale verdicts.  The identity instance (no
    coefficients file) is the hand-tuned model: it reads ``SKEW_KNEES``,
    reproduces every estimate bit for bit and leaves the keys as they
    were.  Compared by identity (it keys the price memo)."""

    route_scale: Dict[str, float] = dataclasses.field(default_factory=dict)
    route_fixed_us: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    skew_imb_knee: float = SKEW_KNEES["imb_knee"]
    skew_imb_slope: float = SKEW_KNEES["imb_slope"]
    skew_cv_knee: float = SKEW_KNEES["cv_knee"]
    skew_cv_slope: float = SKEW_KNEES["cv_slope"]
    skew_cap: float = SKEW_KNEES["cap"]
    version: int = 0
    digest: str = ""             # "" == identity (no coefficients file)

    @property
    def is_identity(self) -> bool:
        return not self.digest

    def skew(self) -> Dict[str, float]:
        """The skew constants in ``SKEW_KNEES``'s form (``SKEW_KNEES``
        itself for the identity)."""
        if self.is_identity:
            return SKEW_KNEES
        return {"imb_knee": self.skew_imb_knee,
                "imb_slope": self.skew_imb_slope,
                "cv_knee": self.skew_cv_knee,
                "cv_slope": self.skew_cv_slope, "cap": self.skew_cap}

    def apply(self, route: str, seconds: float) -> float:
        return (self.route_scale.get(route, 1.0) * seconds
                + self.route_fixed_us.get(route, 0.0) * 1e-6)


IDENTITY_COEFFS = CostCoeffs()


def coeffs_digest(routes: Dict[str, dict], skew: Dict[str, float],
                  version: int) -> str:
    """Content hash over the values that change estimates (per-route
    diagnostics such as ``n_obs`` are excluded, so a refit that lands on
    the same coefficients keeps cached verdicts valid)."""
    payload = {
        "version": int(version),
        "routes": {r: [round(float(v.get("scale", 1.0)), 6),
                       round(float(v.get("fixed_us", 0.0)), 6)]
                   for r, v in sorted(routes.items())},
        "skew": [round(float(skew.get(k, SKEW_KNEES[k])), 6)
                 for k in _SKEW_FIELDS],
    }
    return hashlib.sha256(
        json.dumps(payload, sort_keys=True).encode()).hexdigest()[:12]


def load_cost_coeffs(path: Optional[str] = None) -> CostCoeffs:
    """Parse a ``cost_coeffs.json`` (``path``, else
    ``$REPRO_TORCH_COST_COEFFS``, else the committed file).  A file that
    is missing or does not parse gives the identity: the hand-tuned
    model."""
    path = path or os.environ.get(_COEFFS_ENV) or COEFFS_PATH
    try:
        with open(path) as f:
            blob = json.load(f)
        routes = blob.get("routes", {})
        skew = blob.get("skew", {})
        version = int(blob.get("version", 1))
        return CostCoeffs(
            route_scale={r: float(v.get("scale", 1.0))
                         for r, v in routes.items()},
            route_fixed_us={r: float(v.get("fixed_us", 0.0))
                            for r, v in routes.items()},
            **{f"skew_{k}": float(skew.get(k, SKEW_KNEES[k]))
               for k in _SKEW_FIELDS},
            version=version,
            digest=coeffs_digest(routes, skew, version))
    except (OSError, ValueError, TypeError, AttributeError):
        return IDENTITY_COEFFS


_coeffs = load_cost_coeffs()


def cost_coeffs() -> CostCoeffs:
    """The active calibration (identity when no coefficients file)."""
    return _coeffs


def set_cost_coeffs(coeffs: Optional[CostCoeffs]):
    """Install ``coeffs`` as the active calibration (None reloads the
    file).  Clears the decision cache and the price memo: every estimate
    changes, and the digest in the keys with it.  Plans already built
    keep their verdicts (their keys hold the old digest); an engine keeps
    the prices it was built with."""
    global _coeffs
    _coeffs = coeffs if coeffs is not None else load_cost_coeffs()
    clear_cache()
    _price.cache_clear()


def _torch_dtype(dtype) -> torch.dtype:
    return dtype if isinstance(dtype, torch.dtype) else getattr(
        torch, contract_lib.dtype_name(dtype))


# ---------------------------------------------------------------------------
# Tiles the kernels walk
# ---------------------------------------------------------------------------

def kernel_tile(b: int) -> Tuple[int, int]:
    """``(tile, split)`` the static kernels (bsmm, bsmm_balanced, sddmm)
    walk blocks of ``b`` at, as the reference's ``pack_tiles`` maps any
    block onto MXU tiles: each ``b x b`` block split exactly into
    ``split x split`` sub-blocks of ``g = b / split``, the largest kernel
    tile that divides ``b`` (else 2 where ``b`` is even, else 1;
    ``contract.sub_block``), and the sub-blocks walked as tiles of ``g``
    or, below the smallest tile, packed into 4 x 4 tiles.  So b in {4,
    ..., 64} walks as it is, b in {1, 2} packs into 4 x 4 tiles, b = 128
    splits into four 64 x 64 blocks, b = 3 or 5 into 1 x 1 blocks packed
    4 x 4, b = 6 into 2 x 2 blocks packed 4 x 4, b = 12, 24, 48, 96 into
    4, 8, 16, 32."""
    tiles = bsmm_ops.TILE_SIZES
    g = contract_lib.sub_block(b, tiles)
    return next(t for t in tiles if t % g == 0), b // g


def walk_shape(m: int, k: int, tile: int) -> Tuple[int, int]:
    """``(m, k)`` padded to a multiple of ``tile`` (where ``b`` divides
    them and the 4 x 4 packing tile does not: b = 3, m = 99)."""
    return dsmm_ops.padded(m, tile), dsmm_ops.padded(k, tile)


def dynamic_tile(m: int, k: int, b: int, route: str) -> int:
    """The block the dsmm kernel walks for a dynamic route: the grouped
    routes' packed tile (``gmm.ops.grouped_tile``); else ``b`` where the
    kernel takes it, or the block ``dsmm.ops.kernel_operand`` brings it
    to (split into the largest kernel block dividing ``b``, re-blocked
    into 4 x 4 below that)."""
    if family(route) in ("dynamic_grouped", "dynamic_grouped_balanced"):
        return gmm_ops.grouped_tile(m, k, b)
    if b in dsmm_ops.BLOCK_SIZES:
        return b
    return max(contract_lib.sub_block(b, dsmm_ops.BLOCK_SIZES),
               dsmm_ops.BLOCK_SIZES[0])


def split_pattern(rows, cols, b: int, split: int):
    """``(rows, cols, b / split)`` of the pattern with every block split
    into ``split x split`` sub-blocks: block z's sub-block (i, j) at ``z *
    split^2 + i * split + j`` (the order ``plan.split_blocks`` gives the
    values)."""
    rows = np.asarray(rows, np.int32)
    cols = np.asarray(cols, np.int32)
    if split == 1:
        return rows, cols, b
    i, j = (a.reshape(1, -1) for a in np.meshgrid(
        np.arange(split), np.arange(split), indexing="ij"))
    return ((rows[:, None] * split + i).reshape(-1).astype(np.int32),
            (cols[:, None] * split + j).reshape(-1).astype(np.int32),
            b // split)


def grouped_capacity(m: int, k: int, b: int, density: float, *,
                     headroom: float, policy: str = "planned"):
    """``(tile, capacity plan, tiles_cap, clamped)`` of a dynamic problem
    on the grouped routes: the planned bucket (paper §3.3: expected
    distinct tiles at ``d_max`` times the headroom; ``policy="worst"``
    the safe worst case), of the sub-blocks the pack takes where the tile
    is not a block multiple, clamped to the tile grid."""
    t = gmm_ops.grouped_tile(m, k, b)
    slots = planner_lib.nnz_max_blocks(m, k, b, density)
    g = b if t % b == 0 else contract_lib.sub_block(b, dsmm_ops.BLOCK_SIZES)
    mp, kp = walk_shape(m, k, t)
    capplan = planner_lib.plan_grouped_capacity(
        mp, kp, g, density, tile=t, slots=slots * (b // g) ** 2,
        headroom=headroom)
    requested = (capplan.tiles_cap if policy == "planned"
                 else capplan.worst_tiles)
    cap, clamped = gmm_ops.clamped_tiles_cap(requested, mp, kp, t,
                                             warn=False)
    return t, capplan, cap, clamped


@dataclasses.dataclass(frozen=True)
class WalkCounts:
    """What each candidate walk visits for one problem.

    tile, tiles, stages   the static walks (bsmm, bsmm_balanced): the
                          kernel tile, its packing's tiles (pad tiles of
                          empty rows included) and the mma walk's stages
    slot_block, slots,    the dsmm slot walk: the block it walks, its
    row_slots             slots and the most slots of one block-row
    grouped_tile,         the grouped routes: the packed tile and the
    grouped_tiles         tile slots the pack fills (exact for a static
                          pattern, the planned capacity for a runtime one)
    blocks                SDDMM: the blocks it samples, at ``tile``
    """

    tile: int
    tiles: int
    stages: int
    slot_block: int
    slots: int
    row_slots: int
    grouped_tile: int
    grouped_tiles: int
    blocks: int


def _unique_tiles(rows, cols, per: int):
    """The distinct tiles of ``per x per`` blocks covering the blocks."""
    tr = np.asarray(rows, np.int64) // per
    tc = np.asarray(cols, np.int64) // per
    if tr.size == 0:
        return tr, tc
    key = np.unique(tr * (int(tc.max()) + 1) + tc)
    return key // (int(tc.max()) + 1), key % (int(tc.max()) + 1)


def static_counts(rows, cols, m: int, k: int, b: int) -> WalkCounts:
    """``WalkCounts`` of a static pattern (numpy)."""
    rows = np.asarray(rows, np.int32)
    cols = np.asarray(cols, np.int32)
    t, split = kernel_tile(b)
    er, ec, eb = split_pattern(rows, cols, b, split)
    mp, _ = walk_shape(m, k, t)
    tr, tc = _unique_tiles(er, ec, t // eb)
    tiles = tr.size + (mp // t - np.unique(tr).size)
    stages = (bsmm_ops.mma_stage_count(tr, tc, t)
              if t in bsmm_ops.MMA_BLOCKS else 0)
    # the dsmm slot walk: split into the kernel's block, re-blocked below
    # 4 (each sub-block its own slot)
    db = dynamic_tile(m, k, b, "dynamic")
    if b in dsmm_ops.BLOCK_SIZES:
        sr, sb = rows, b
    else:
        g = contract_lib.sub_block(b, dsmm_ops.BLOCK_SIZES)
        sr, _, sb = split_pattern(rows, cols, b, b // g)
    srow = np.asarray(sr, np.int64) // (db // sb)
    row_slots = int(np.bincount(srow).max()) if srow.size else 0
    tg = gmm_ops.grouped_tile(m, k, b)
    gr, gc, gb = (rows, cols, b) if tg % b == 0 else (er, ec, eb)
    gt, _ = _unique_tiles(gr, gc, tg // gb)
    # the pack's tiles, a pad tile for each empty tile-row included (as
    # ``plan_packing`` counts them)
    gtiles = gt.size + walk_shape(m, k, tg)[0] // tg - np.unique(gt).size
    return WalkCounts(tile=t, tiles=int(tiles), stages=int(stages),
                      slot_block=db, slots=int(srow.size),
                      row_slots=row_slots, grouped_tile=tg,
                      grouped_tiles=int(gtiles),
                      blocks=int(tr.size if eb < t else er.size))


def dynamic_counts(m: int, k: int, b: int, density: float, *,
                   headroom: float = planner_lib.HEADROOM,
                   policy: str = "planned") -> WalkCounts:
    """``WalkCounts`` of a runtime pattern at capacity ``density``: the
    slots the capacity holds (its fullest block-row taken as the mean),
    the grouped routes' planned tile capacity."""
    db = dynamic_tile(m, k, b, "dynamic")
    split = (1 if b in dsmm_ops.BLOCK_SIZES
             else b // contract_lib.sub_block(b, dsmm_ops.BLOCK_SIZES))
    slots = planner_lib.nnz_max_blocks(m, k, b, density) * split * split
    rows_w = max(1, dsmm_ops.padded(m, db) // db)
    tg, _, cap, _ = grouped_capacity(m, k, b, density, headroom=headroom,
                                     policy=policy)
    t, _ = kernel_tile(b)
    return WalkCounts(tile=t, tiles=0, stages=0, slot_block=db,
                      slots=slots, row_slots=-(-slots // rows_w),
                      grouped_tile=tg, grouped_tiles=cap, blocks=0)


# ---------------------------------------------------------------------------
# Skew
# ---------------------------------------------------------------------------

def pattern_balance(operand) -> Tuple[float, float]:
    """(imbalance, cv) of a static pattern's work per tile-row of the
    port's bsmm walks (``row_balance``); runtime (dynamic) and dense
    operands report (1.0, 0.0)."""
    from repro_torch.core.bsr import BlockSparseMatrix
    if not isinstance(operand, BlockSparseMatrix):
        return (1.0, 0.0)
    m, k = operand.shape
    return row_balance(operand.row_idx, m, k, operand.block_size)


def row_balance(rows, m: int, k: int, b: int) -> Tuple[float, float]:
    """(imbalance, cv) of the (sub-)blocks per tile-row of a pattern with
    block-rows ``rows``: a tile-row of ``kernel_tile(b)`` rows is one
    thread block of the bsmm decode and ffma walks and one warp's rows of
    the mma walk, so its count is the serial work the skew factor
    prices."""
    t, split = kernel_tile(b)
    er, _, eb = split_pattern(rows, np.zeros_like(np.asarray(rows)), b,
                              split)
    per = max(1, t // eb)
    mt = max(1, walk_shape(m, k, t)[0] // (per * eb))
    counts = np.bincount(np.asarray(er, np.int64) // per, minlength=mt)
    rep = partitioner.balance_report(counts)
    return (rep["imbalance"], rep["cv"])


def _skew_factor(imbalance: float, cv: float,
                 coeffs: Optional[CostCoeffs] = None) -> float:
    """The slowdown of a skew-sensitive walk on a pattern of this row
    imbalance and cv (the knees of ``coeffs``, the active calibration
    when None: ``SKEW_KNEES`` for the identity): 1 below the knees,
    linear above them, capped.  A uniform random mask's sampling noise
    (imbalance ~1.2-2) sits below the knee."""
    c = (coeffs or _coeffs).skew()
    return min(c["cap"],
               1.0 + c["imb_slope"] * max(0.0, imbalance - c["imb_knee"])
               + c["cv_slope"] * max(0.0, cv - c["cv_knee"]))


# ---------------------------------------------------------------------------
# Analytic estimates (the H100 walk models)
# ---------------------------------------------------------------------------

def _dense_seconds(m: int, k: int, n: int, dtype) -> float:
    if n <= 0 or m <= 0:
        return 0.0
    return dmm_ops.walk_seconds(dmm_ops.walk(n, k, m, dtype).name, n, k, m,
                                dtype)


def _sparse_seconds(fam: str, m: int, k: int, n: int, dtype,
                    counts: WalkCounts) -> float:
    dt = _torch_dtype(dtype)
    if fam in ("static", "static_balanced"):
        t = counts.tile
        mp, kp = walk_shape(m, k, t)
        if fam == "static":
            return bsmm_ops.walk_seconds(
                bsmm_ops.walk(t, dt, n), n, mp, kp, t, counts.tiles,
                counts.stages, dt)
        return bal_ops.walk_seconds(bal_ops.walk(t, dt), n, mp, kp, t,
                                    counts.tiles, counts.stages, dt)
    if fam == "dynamic":
        db = counts.slot_block
        mp, kp = walk_shape(m, k, db)
        return dsmm_ops.encode_seconds(counts.slots) + dsmm_ops.walk_seconds(
            dsmm_ops.walk(db, dt), n, mp, kp, db, counts.slots,
            counts.row_slots, dt)
    tg = counts.grouped_tile
    mp, kp = walk_shape(m, k, tg)
    sec = gmm_ops.grouped_seconds(n, mp, kp, tg, counts.grouped_tiles, dt)
    if fam == "dynamic_grouped_balanced":
        sec *= _GROUPED_BALANCED_OVERHEAD
    return sec


def _sddmm_seconds(fam: str, m: int, k: int, n: int, dtype,
                   counts: WalkCounts) -> float:
    dt = _torch_dtype(dtype)
    es = dt.itemsize
    if fam == "sddmm_dense":
        # dy^T (a transposed copy), the dense product, the block gather
        nnz_area = float(counts.blocks) * counts.tile ** 2
        return (_dense_seconds(k, n, m, dt)
                + 2 * _DENSIFY_LAUNCH
                + (2.0 * n * m + 2.0 * nnz_area) * es / _HBM)
    t = counts.tile
    mp, kp = walk_shape(m, k, t)
    return sddmm_ops.walk_seconds(sddmm_ops.walk(t, dt), n, mp, kp, t,
                                  counts.blocks, dt)


def _estimate(route: str, m: int, k: int, n: int, b: int = 1,
              density: float = 1.0, dtype="float32", *,
              imbalance: float = 1.0, cv: float = 0.0,
              counts: Optional[WalkCounts] = None,
              kind: str = "static",
              coeffs: Optional[CostCoeffs] = None) -> float:
    """Calibrated seconds of one ``route`` call: the raw walk model
    (``_estimate_raw``) corrected by the card route's affine terms of
    ``coeffs`` (the active calibration when None).  The identity returns
    the raw model unchanged."""
    c = coeffs or _coeffs
    return c.apply(card_route(route), _estimate_raw(
        route, m, k, n, b, density, dtype, imbalance=imbalance, cv=cv,
        counts=counts, kind=kind, coeffs=c))


def _estimate_raw(route: str, m: int, k: int, n: int, b: int = 1,
                  density: float = 1.0, dtype="float32", *,
                  imbalance: float = 1.0, cv: float = 0.0,
                  counts: Optional[WalkCounts] = None,
                  kind: str = "static",
                  coeffs: Optional[CostCoeffs] = None) -> float:
    """Seconds of one ``route`` call for ``[m, k] . [k, n]`` (``y[n, m] =
    x[n, k] . W^T``) on the H100: the time model of the walk its kernel
    takes for the problem (a ``*_torch`` route priced as its card
    counterpart).  ``counts`` are what the sparse walks visit (default:
    a runtime pattern at capacity ``density``); ``imbalance``/``cv`` the
    pattern's skew (``pattern_balance``), which scales the
    skew-sensitive walks by ``_skew_factor``.  The dense route of a
    runtime pattern (``kind="dynamic"``) densifies it each call.  SDDMM
    routes price the dL/dvalues product of ``W [m, k]``'s pattern
    against ``dy [n, m]`` and ``x [n, k]``."""
    from repro_torch.sparse.spec import ADMISSIBLE, SUFFIX
    fam, _, suffix = route.rpartition("_")
    families = ADMISSIBLE["static"] + SDDMM_FAMILIES
    if "_" + suffix not in SUFFIX.values() or fam not in families:
        raise ValueError(f"no H100 model for route {route!r}; priced "
                         f"routes: {families} with a suffix of "
                         f"{tuple(SUFFIX.values())}")
    if n <= 0 or m <= 0:
        return 0.0
    if fam == "dense":
        sec = _dense_seconds(m, k, n, dtype)
        if kind == "dynamic":
            sec += _DENSIFY_LAUNCH + DENSIFY_PASSES * m * k * _torch_dtype(
                dtype).itemsize / _HBM
        return sec
    if counts is None:
        counts = dynamic_counts(m, k, b, density)
    if fam in SDDMM_FAMILIES:
        return _sddmm_seconds(fam, m, k, n, dtype, counts)
    skew = (_skew_factor(imbalance, cv, coeffs) if fam in _SKEW_SENSITIVE
            else 1.0)
    return _sparse_seconds(fam, m, k, n, dtype, counts) * skew


@functools.lru_cache(maxsize=65536)
def _price(shapes: Tuple[Tuple[int, int], ...], n_tokens: int,
           dtype: str, coeffs: CostCoeffs) -> float:
    return sum(_estimate(ROUTE, m, k, n_tokens, dtype=dtype, coeffs=coeffs)
               for m, k in shapes)


def price_tokens(shapes: Iterable[Tuple[int, int]], n_tokens: int, *,
                 dtype="float32", route: str = ROUTE,
                 coeffs: Optional[CostCoeffs] = None) -> float:
    """Model-seconds on the H100 for pushing ``n_tokens`` tokens through a
    stack of ``[m, k]`` matmuls: the serving engine's admission and
    padding price (the reference's ``price_tokens``, priced by the card's
    model of the dense route; memoized, as the ladder and every admission
    ask for it).  ``shapes`` holds one ``(m, k)`` pair per matmul the
    tokens flow through; ``coeffs`` the calibration to price under (the
    active one when None).  Pricing never measures."""
    if route != ROUTE:
        raise ValueError(f"no H100 price for route {route!r}; priced "
                         f"route: {ROUTE!r}")
    n_tokens = int(n_tokens)
    if n_tokens <= 0:
        return 0.0
    return _price(tuple((int(m), int(k)) for m, k in shapes), n_tokens,
                  contract_lib.dtype_name(dtype), coeffs or _coeffs)


# ---------------------------------------------------------------------------
# Decision cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Decision:
    route: str
    est_seconds: Dict[str, float]     # per-candidate estimate
    source: str                       # "analytic" | "measured" | "forced"
    key: Tuple


_decision_cache: Dict[Tuple, Decision] = {}
_cache_lock = threading.Lock()


def cache_stats() -> dict:
    return {"entries": len(_decision_cache),
            "keys": sorted(_decision_cache, key=repr)}


def clear_cache():
    with _cache_lock:
        _decision_cache.clear()


def _density_bucket(density: float) -> float:
    """Bucket density to the nearest power of two (Table 3 uses 1/2^k
    grids); keeps the cache key stable across nnz jitter."""
    if density <= 0:
        return 0.0
    if density >= 1.0:
        return 1.0
    return 2.0 ** round(math.log2(density))


def _cache_key(kind: str, m: int, k: int, n: int, b: int, density: float,
               dtype, mode: str = "auto", measure: bool = False,
               device_type: str = "cuda",
               skew: Tuple[float, float] = (1.0, 0.0)) -> Tuple:
    """The decision cache key.  ``skew`` is the pattern's (imbalance, cv)
    from ``pattern_balance``, bucketed to one decimal so nnz jitter does
    not split the key: a skewed pattern's verdict must not answer for a
    uniform one.  The device type names the candidates (the card's
    kernels or their plain versions) and ``measure`` the verdict's
    unit.  A non-identity calibration adds its digest: a refit changes
    every estimate, so it orphans the verdicts made under the old one."""
    key = (kind, m, k, n, b, _density_bucket(density),
           contract_lib.dtype_name(dtype), mode, bool(measure), device_type)
    imb, cv = (round(float(skew[0]), 1), round(float(skew[1]), 1))
    if (imb, cv) != (1.0, 0.0):
        key += ("skew", imb, cv)
    if not _coeffs.is_identity:
        key += ("coeffs", _coeffs.digest)
    return key


# ---------------------------------------------------------------------------
# Candidates, measurement, decide
# ---------------------------------------------------------------------------

def _candidates(kind: str, mode: str = "auto",
                device_type: str = "cuda") -> Tuple[str, ...]:
    """The routes a plan of ``kind`` races under ``mode`` on a device of
    ``device_type``: under "auto" every family the kind admits, as the
    card's hand-written kernels (``*_cuda``) on a card and as their plain
    versions (``*_torch``) on the CPU, so nothing plain joins a card's
    path; an explicit family or route is the one route ``port_route``
    maps it to (a forced verdict)."""
    from repro_torch.sparse.spec import ADMISSIBLE, SUFFIX, port_route
    if mode != "auto":
        return (port_route(kind, mode, device_type),)
    if device_type not in SUFFIX:
        raise ValueError(f"no route for device type {device_type!r}")
    return tuple(f + SUFFIX[device_type] for f in ADMISSIBLE[kind])


def sddmm_candidates(device_type: str = "cuda") -> Tuple[str, ...]:
    """The dL/dvalues routes of a static plan: the block SDDMM and the
    dense product followed by a gather, as kernels or plain versions."""
    from repro_torch.sparse.spec import SUFFIX
    if device_type not in SUFFIX:
        raise ValueError(f"no route for device type {device_type!r}")
    return tuple(f + SUFFIX[device_type] for f in SDDMM_FAMILIES)


def capturing() -> bool:
    """Is a CUDA graph being captured on the current stream?"""
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


def _copies(args: Sequence) -> list:
    """``args`` and clones of its tensors: enough sets to hold
    ``ROTATE_BYTES``, at most ``MAX_COPIES``."""
    nbytes = sum(a.numel() * a.element_size() for a in args
                 if isinstance(a, torch.Tensor))
    n = max(2, min(MAX_COPIES, math.ceil(ROTATE_BYTES / max(nbytes, 1))))
    sets = [tuple(args)]
    for _ in range(n - 1):
        sets.append(tuple(a.clone() if isinstance(a, torch.Tensor) else a
                          for a in args))
    return sets


def measure_callable(fn: Callable, *args, windows: Optional[int] = None,
                     lock=None, build_lock=None) -> float:
    """Seconds per call of ``fn(*args)``: the one timing harness of every
    measured race (the forward race in ``decide``, the backward races
    and ``remeasure_plan`` in the plan layer).  One warm-up call first
    (it builds the kernel and any walk metadata).  On a card the device
    time by CUDA events, the median of ``windows`` windows
    (``MEASURE_WINDOWS`` when None): in
    each a sleep kernel holds the stream while the launches are queued,
    every copy of the tensor arguments (``_copies``) once and at least
    ``MEASURE_REPS`` launches, the first on a copy the warm-up did not
    touch, so L2 is cold.  On the CPU the host clock.  Raises under a
    CUDA-graph capture (callers price analytically there).

    ``lock`` (a context manager: the serving engine's device lock) is
    held around the warm-up and around each window, and let go between
    them, so a serving thread waits at most one window.  ``build_lock``
    (the engine's capture lock; ``lock`` when None) is held while the
    copies are made and released: they launch nothing that is timed, so
    serving goes on, but no CUDA-graph capture may see their
    allocations."""
    guard = lock if lock is not None else contextlib.nullcontext()
    build_guard = build_lock if build_lock is not None else guard
    dev = next((a.device for a in args if isinstance(a, torch.Tensor)),
               torch.device("cpu"))
    if dev.type != "cuda":
        with guard:
            fn(*args)
            t0 = time.perf_counter()
            for _ in range(MEASURE_REPS):
                fn(*args)
            return (time.perf_counter() - t0) / MEASURE_REPS
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("measure_callable under a CUDA-graph capture")
    with build_guard:
        sets = _copies(args)
    reps = max(MEASURE_REPS, len(sets))
    with guard:
        fn(*args)
        torch.cuda.synchronize(dev)
    times = []
    i = 1
    for _ in range(MEASURE_WINDOWS if windows is None else max(1, windows)):
        with guard:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(int(4e7))
            start.record()
            for _ in range(reps):
                fn(*sets[i % len(sets)])
                i += 1
            end.record()
            torch.cuda.synchronize(dev)
            times.append(start.elapsed_time(end) / 1e3 / reps)
    with build_guard:
        del sets
    return float(np.median(times))


def measured_pick(measured: Dict[str, float], prior: str) -> str:
    """The route a measured race installs: the fastest candidate where it
    beats ``prior`` (the model's pick) by more than ``MEASURE_MARGIN``,
    else ``prior``, so timings within the noise between runs do not flip
    a verdict."""
    best = min(measured, key=measured.get)
    if prior in measured and \
            measured[best] >= measured[prior] * (1.0 - MEASURE_MARGIN):
        return prior
    return best


def decide(spec, device_type: str, *, counts: Optional[WalkCounts] = None,
           skew: Tuple[float, float] = (1.0, 0.0),
           candidates: Optional[Sequence[str]] = None,
           measure: bool = False,
           runner: Optional[Callable[[str], Tuple[Callable, tuple]]] = None,
           cache: bool = True,
           agree: Optional[Callable[[Dict[str, float]], Dict[str, float]]]
           = None) -> Decision:
    """Pick the route for ``spec`` (an ``OpSpec``) on ``device_type``.
    A pure function of the cache key; fills the process-level cache.
    ``candidates`` default to ``_candidates(spec.kind, spec.mode)`` (the
    plan layer passes those whose kernel contracts admit the problem);
    each is priced by ``_estimate`` on ``counts`` and ``skew``.  With
    ``measure`` and a ``runner`` (route -> the callable the plan would
    run and its arguments) every candidate is timed by
    ``measure_callable`` and ``measured_pick`` installs the fastest
    where it beats the model's pick past the noise ("measured"); a single
    candidate is "forced"; else the model's minimum ("analytic").  A
    candidate that fails to build or launch raises: no candidate is
    dropped quietly.  ``agree`` maps the measured times to the ones every
    rank of a mesh decides on (the plan layer's, over a concrete mesh:
    ranks that time the same calls apart must still pick one route)."""
    key = _cache_key(spec.kind, spec.m, spec.k, spec.n, spec.block_size,
                     spec.density, spec.dtype, spec.mode,
                     measure and runner is not None, device_type, skew)
    if cache:
        hit = _decision_cache.get(key)
        if hit is not None:
            return hit
    cands = tuple(candidates if candidates is not None
                  else _candidates(spec.kind, spec.mode, device_type))
    if not cands:
        raise ValueError(f"no route admits {spec}")
    est = {r: _estimate(r, spec.m, spec.k, spec.n, spec.block_size,
                        spec.density, spec.dtype, imbalance=skew[0],
                        cv=skew[1], counts=counts, kind=spec.kind)
           for r in cands}
    if len(cands) == 1:
        dec = Decision(cands[0], est, "forced", key)
    elif measure and runner is not None:
        measured = {}
        for r in cands:
            fn, args = runner(r)
            measured[r] = measure_callable(fn, *args)
            del fn, args
        if agree is not None:
            measured = agree(measured)
        dec = Decision(measured_pick(measured, min(est, key=est.get)),
                       measured, "measured", key)
    else:
        dec = Decision(min(est, key=est.get), est, "analytic", key)
    if cache:
        with _cache_lock:
            dec = _decision_cache.setdefault(key, dec)
    return dec


# ---------------------------------------------------------------------------
# The reference's deprecated entry points: shims over the plan
# ---------------------------------------------------------------------------

def spmm(operand, x: torch.Tensor, *, ctx=None) -> torch.Tensor:
    """``Y = W . X`` with ``x [k, n]`` -> ``[m, n]``; ``operand`` a
    ``BlockSparseMatrix``, a ``DynamicOperand`` or a dense ``W [m, k]``.
    Plans ``operand`` for ``n`` columns under ``ctx`` (a ``PlanContext``;
    the ambient one when None) and runs the plan, so the numbers are the
    plan path's; differentiable in the operand's values and ``x``."""
    from repro_torch import sparse as sparse_api
    dense = isinstance(operand, torch.Tensor)
    if dense and operand.dim() != 2:
        raise ValueError(f"operand must be [m, k], got shape "
                         f"{tuple(operand.shape)}")
    if x.dim() != 2:
        raise ValueError(f"x must be [k, n], got shape {tuple(x.shape)}")
    k = operand.shape[1]
    if x.shape[0] != k:
        raise ValueError(f"X rows {x.shape[0]} != operand k {k}")
    if dense:
        return sparse_api.matmul(x.t(), operand.t(), ctx=ctx).t()
    return sparse_api.spmm(operand, x, ctx=ctx)


def spmm_nt(operand, x: torch.Tensor, *, ctx=None) -> torch.Tensor:
    """Activation-major form ``x [..., k] -> [..., m]`` (``y = x .
    W^T``)."""
    from repro_torch import sparse as sparse_api
    if isinstance(operand, torch.Tensor):
        return sparse_api.matmul(x, operand.t(), ctx=ctx)
    return sparse_api.spmm_nt(operand, x, ctx=ctx)


def matmul(x: torch.Tensor, w: torch.Tensor, *, ctx=None) -> torch.Tensor:
    """``y = x . w`` for activation-major dense layers: ``x [..., k]``,
    ``w [k, n]``; ``sparse.matmul`` (the dense_mm kernel on a card)."""
    from repro_torch import sparse as sparse_api
    return sparse_api.matmul(x, w, ctx=ctx)


def batched_matmul(a: torch.Tensor, b: torch.Tensor, *,
                   ctx=None) -> torch.Tensor:
    """Batched dense ``[..., C, D] @ [..., D, F]`` (MoE expert GEMMs);
    ``sparse.batched_matmul`` (the gmm kernel on a card)."""
    from repro_torch import sparse as sparse_api
    return sparse_api.batched_matmul(a, b, ctx=ctx)


def explain(operand, n: int, *, ctx=None, device=None) -> dict:
    """The decision report for ``operand @ [k, n]`` under the
    reference's keys: the problem (with the pattern's skew), the mode,
    ``pallas_admissible``, each candidate's modelled (or measured)
    seconds, the route chosen, its source, ``cached`` and the cache key.

    Where the keys mean something else on this card: ``pallas_admissible``
    is whether a hand-written kernel is admissible (True on a card, where
    every candidate is one; False on the CPU, where the candidates are
    their plain versions); candidates are named by the port's routes
    (``static_cuda``, ``dense_torch``, ...); ``imbalance`` and ``cv`` are
    the port's skew (``pattern_balance``: work per tile-row of its bsmm
    walk, not per tile of the reference's TPU walk); ``cached`` says whether the
    plan, and with it its decision, was already in the memory cache.
    The reference decides without caching; the port plans, and the plan
    is then cached as any ``plan()`` call's is.  A dense operand is
    ``W [m, k]``, as in ``spmm``."""
    from repro_torch import sparse as sparse_api
    if isinstance(operand, torch.Tensor):
        operand = operand.t()
    hits = sparse_api.cache_stats().get("plan_hits", 0)
    p = sparse_api.plan(operand, int(n), device=device, ctx=ctx)
    cached = sparse_api.cache_stats().get("plan_hits", 0) > hits
    rep = p.explain()
    imb, cv = pattern_balance(operand)
    return {
        "problem": dict(rep["problem"], imbalance=round(imb, 3),
                        cv=round(cv, 3)),
        "mode": rep["mode"],
        "pallas_admissible": rep["pallas_admissible"],
        "candidates": rep["candidates"],
        "chosen": rep["chosen"],
        "source": rep["source"],
        "cached": cached,
        "cache_key": rep["cache_key"],
    }


def format_explain(report: dict) -> str:
    """``explain``'s report as text, in the reference's layout."""
    p = report["problem"]
    lines = [f"dispatch {p['kind']} ({p['m']}x{p['k']}) @ ({p['k']}x"
             f"{p['n']}) b={p['block_size']} d={p['density']} "
             f"{p['dtype']} [mode={report['mode']}]"]
    for route, sec in report["candidates"].items():
        mark = "->" if route == report["chosen"] else "  "
        lines.append(f"  {mark} {route:<15} {sec * 1e6:10.2f} us")
    lines.append(f"   ({report['source']}"
                 f"{', cached' if report['cached'] else ''})")
    return "\n".join(lines)
