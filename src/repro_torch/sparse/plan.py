"""Plan-first sparse matmul API: static, dynamic and dense kinds.

``plan(operand, n, device=..., ctx=...)`` runs every one-time step for a
matmul operand and returns a ``MatmulPlan`` that executes with no
further decisions.  Counterpart of the JAX package's ``sparse/plan.py``
(``_static_executor``/``_dynamic_executor``/``_dense_executor`` at
``plan.py:1051-1275``, ``spmm``/``spmm_nt``/``matmul`` at
``plan.py:1987-2023``), with these cuts:

* the route race (``_decide``, in the reference's order): an in-process
  re-planned verdict (``remeasure_plan``), then the disk cache
  (``sparse.cache``, ``PlanContext(persist=, cache_dir=)``), then
  ``core.dispatch.decide``: under ``mode="auto"`` every route whose
  kernel contracts admit the problem is priced by the H100 model of the
  walk it would launch (the card's hand-written kernels, ``*_cuda``, on a
  card; their plain versions, ``*_torch``, on the CPU, priced as the
  card's), or timed on the device with ``PlanContext(measure=True)`` and
  concrete inputs (``plan(..., x=)``; never under a CUDA-graph capture,
  where the verdict stays analytic).  A family or JAX route id maps to
  one route (``spec.port_route``, a "forced" verdict).  The verdict, its
  estimates and its source ("analytic", "measured" or "forced") ride on
  the plan and persist with its capacity and backward sections, so a
  restart re-plans with zero decisions and zero measurements;
* a static plan runs ``partitioner.plan_packing`` once at the tile the
  kernels walk (``kernel_tile``: each b x b block split exactly into
  sub-blocks of g, the largest kernel tile dividing b, else 2 or 1, and
  those packed into 4 x 4 tiles where g < 4; ``static_balanced``:
  ``plan_packing_balanced``, with a bin count picked for the card) and
  keeps its walk on the device, on m and k padded to the tile where b
  divides them and the tile does not; where the bsmm kernels walk "mma"
  (a card, 16-bit, tile in {16, 32, 64}) it records that walk's schedule
  too, for the forward and for the dL/dx product over the transposed
  pattern (``bsmm.ops.mma_schedule``); it is cached per (pattern, shape,
  dtype, device, route) and serves any ``n``;
* ``plan`` checks the contract of every kernel the plan will launch at
  the block it walks, and raises then, with the contract's reason, for
  a problem no kernel takes (on the CPU too, for the card's kernels);
* a dynamic plan is keyed by the problem (m, k, capacity, b, dtype,
  device, route and the capacity knobs), never by the pattern: a new
  mask every step reuses one plan.  The grouped routes size their tile
  bucket with ``planner.plan_grouped_capacity``, count every overflow
  exactly (``capacity_report``) and escalate to worst-case capacity once
  the overflow frequency passes ``overflow_threshold``;
* under autograd a static plan runs the planned backward of
  ``_planned_vjp`` (``plan.py:1431-1450``) whatever its forward route,
  on the routes its backward race picked (``_grad_decide``): dL/dx races
  the static candidates on the transposed ``[k, m]`` problem (the bsmm
  walk on the transposed pattern, or a forward-only plan of ``W^T`` on
  another route), dL/dvalues the block SDDMM against the dense product
  ``dy^T . x`` through dense_mm followed by a gather.  A
  dynamic plan mirrors ``_dynamic_planned_vjp`` (``plan.py:1453-1485``):
  the kernel forward, the gather / einsum / ``index_add_`` pair backward
  in plain PyTorch, as the JAX package leaves it to XLA
  (``dynamic_torch`` is that formulation forward and backward).  A dense
  plan mirrors ``_dense_planned_vjp``: dense_mm forward, two
  ``torch.matmul`` products backward;
* ``batched_matmul`` (MoE's expert GEMMs, ``plan.py:2026-2035``) plans
  the per-slice ``[C, D] @ [D, F]`` problem once.  The reference vmaps
  dense_mm over the batch axes, which on the TPU makes the batch a grid
  axis of one kernel; on a card route ``dense_cuda`` runs that one
  launch as the gmm kernel over ``a.reshape(E * C, D)`` with one expert
  id per row tile (on the tensor-core walk ``tm`` = C for C <= 128, so
  each expert's weights stream once per column tile; above that, and on
  the FMA walk above 64, the largest multiple of 8 <= the limit dividing
  C, else C's largest divisor).  Under autograd it runs
  ``_BatchedMatmulFn``: dL/da by the gmm kernel again on each expert's
  ``b^T`` (a contiguous copy), same ids and row tile, dL/db by
  ``torch.bmm`` (the reference leaves both products to XLA).
  ``dense_torch`` is ``torch.matmul``;
* ``record_dropped`` folds a non-plan capacity stream (MoE's routing
  drops, ``"moe_dispatch"``) into ``capacity_report()``.  A value on
  the card is kept as a device scalar and read at the next
  ``capacity_report()`` (one host read for all of them), so a forward
  that records once per layer never waits for the device.
  ``dropped_history`` gives a stream's values one per call, in call
  order.  Under a CUDA-graph capture (``core.capture``) the value is
  noted for the graph, which queues a copy of it after every replay
  (``queue_dropped``); ``PlanContext(telemetry=False)`` records nothing;
* the plan-first lifecycle of the reference's serving engine:
  ``use_ctx`` installs an ambient ``PlanContext`` for every call that
  passes none (``plan.py:1836-1857``); a ``ctx.pool`` label registers
  every plan used under it, cache hits included, for ``pool_plans``
  (``:281``, ``:1890-1895``); ``cache_stats`` counts plans built, cache
  hits, route decisions, measurements and the disk cache's hits, misses,
  writes and stale drops; ``plan_report`` lists every cached plan's
  forward and backward routes with their source and ``from_disk``
  (``:206``); ``explain`` / ``format_plan`` report a plan the way the
  reference's do (``:485``, ``:625``); ``MatmulPlan.roofline`` and
  ``roofline_report`` price every candidate against the H100's roofline
  (``:523-557``, ``:252-278``);
  ``analytic_plans`` / ``remeasure_plan`` upgrade analytic verdicts to
  measured ones on synthesized inputs (``:291-404``);
* evolution (``:574-625``, ``:1612-1826``): ``MatmulPlan.evolve`` moves
  a static spmm plan onto a new pattern (a RigL topology step) by
  building its walk again on the parent's route (packing, split blocks,
  the bsmm mma schedules, the balanced bins, the backward's metadata)
  and inheriting its forward and backward verdicts: zero decisions,
  zero measurements, unless the pattern's profile drifted past
  ``ctx.evolve_drift`` or ``rerace=True``, when ``plan`` races again.
  The profile is what the H100 walk models price: the block density,
  the occupancy of the kernel tiles (1.0 for b in 4..64, which walk
  unpacked, but for pad tiles of empty rows; below 4 the 4 x 4 packing's)
  and the skew factor of the pattern's row imbalance
  (``dispatch._skew_factor``); the reference's occupancy of 128-wide
  MXU tiles prices nothing here.  ``carry_values`` maps the parent's
  values into the new slots.  The lineage (parent and root keys,
  generation, drift, the carried / dropped / grown counts) rides in
  ``explain()["evolution"]``, ``plan_report`` (``#gen<n>`` keys and
  ``totals["evolution"]``) and the persisted record.  An evolve marks
  its parent *superseded* (``supersede_epoch``): a CUDA graph that holds
  it is re-captured before its next replay (``serve/graphs.py``).  The
  parent leaves the plan cache for a table of weak references, so it
  stays live while a module, a pool entry or a graph holds it (the other
  layers of an LM sharing its pattern) and is freed after: the table
  does not grow with the generation;
* tensor parallelism (``:773-1034``): with ``ctx.mesh`` (or ``tp_q``) a
  static pattern's k range is sharded over ``q`` cards
  (``partitioner.plan_k_shards``, nnz-balanced unless
  ``tp_balanced=False``).  ``static_tp`` computes every shard's partial
  on this device and sums them; ``static_tp_shardmap`` (a concrete
  ``DeviceMesh`` whose ``tp_axis`` has size ``q``) computes this rank's
  shard and all-reduces over the axis's group.  Each shard is a static
  plan of the full ``[m, k]`` shape holding its k range's blocks, built
  with the TP plan on the device's static route (so a partial is one
  bsmm launch, its backward bsmm on the transposed shard and the
  SDDMM); a shard that owns no block adds zeros.  Under "auto" with a
  mesh the TP routes join the race priced by ``_tp_estimate`` (the
  static route's H100 model over ``q`` plus the output reduction over
  NVLink), or timed with ``measure``; the mode "static_tp" races both
  TP routes, "static_tp_shardmap" forces the explicit one.  The verdict
  is keyed on the mesh's axis names and sizes; ``explain()["tp"]``,
  ``format_plan``'s ``tp:`` lines and ``tp_report`` report it.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import weakref
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import capture, dispatch, masks, partitioner
from repro_torch.core import tp as tp_lib
from repro_torch.core import planner as planner_lib
from repro_torch.core.bsr import (BlockSparseMatrix, check_unique_blocks,
                                  pattern_key)
from repro_torch.core.dispatch import (dynamic_tile, kernel_tile,  # noqa: F401
                                       split_pattern, walk_shape)
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.core.dynamic_sparse import (DynamicOperand, _dspmm,
                                             dspmm_backward)
from repro_torch.kernels import contract as contract_lib
from repro_torch.kernels.bsmm import balanced as bal_ops
from repro_torch.kernels.bsmm import ops as bsmm_ops
from repro_torch.kernels.dense_mm import ops as dmm_ops
from repro_torch.kernels.dsmm import ops as dsmm_ops
from repro_torch.kernels.gmm import balanced as gmm_balanced
from repro_torch.kernels.gmm import ops as gmm_ops
from repro_torch.kernels.sddmm import ops as sddmm_ops
from repro_torch.sparse import cache as cache_lib
from repro_torch.launch.mesh import is_concrete
from repro_torch.sparse.spec import (ADMISSIBLE, SUFFIX, TP_ROUTES,
                                     CapacityStats, OpSpec, PlanContext,
                                     port_route, sddmm_route)

ROUTES = {("static", "cuda"): "static_cuda",
          ("static", "cpu"): "static_torch",
          ("dense", "cuda"): "dense_cuda",
          ("dense", "cpu"): "dense_torch"}
# route of the static kind's dL/dvalues product, by device type
SDDMM_ROUTES = {"cuda": "sddmm_cuda", "cpu": "sddmm_torch"}
# every route an unsharded plan can run, by device type (a verdict read
# back from disk must name one of them, or one of ``TP_ROUTES``)
PLAN_ROUTES = {dt: tuple(f + sfx for f in ADMISSIBLE["static"])
               for dt, sfx in SUFFIX.items()}


def route_device(dev: torch.device) -> str:
    """The device type whose routes a plan on ``dev`` races and runs: a
    meta operand plans as a card's does (the card's routes, the analytic
    race on the H100 walk models, the walks a card takes), and each
    kernel's meta branch accounts for the launch a card would make (the
    dry-run, ``launch/dryrun.py``)."""
    return "cuda" if dev.type == "meta" else dev.type


# the card-to-card link the TP routes' output reduction crosses: the
# NVLink rate of the NVIDIA H100 SXM datasheet (900 GB/s per card), a
# datasheet value, not measured here
NVLINK_BYTES_PER_S = 900e9
# bins of the balanced walks where the card does not pick (the
# reference's default)
DEFAULT_BINS = 8

Operand = Union[BlockSparseMatrix, DynamicOperand, torch.Tensor]
_family = dispatch.family


@dataclasses.dataclass
class MatmulPlan:
    """One operand's executable plan.

    ``kind`` is ``"static"`` (block-sparse ``W [m, k]``, applied as
    ``y = x . W^T``), ``"dynamic"`` (a ``DynamicOperand`` of the same
    logical shape, its pattern passed per call) or ``"dense"`` (``w [k,
    m]``, applied as ``y = x . w``).  ``n`` is the activation row count
    the plan was built for; it runs at any other ``n`` as well.
    ``artifacts`` holds the JAX plan's report fields (``nnz_blocks``,
    ``packing_tiles``, ``swizzle_*``, ``bucket_blocks``,
    ``nnz_max_blocks``, ``grouped_tile``, ``grouped_tiles_cap``,
    ``capacity``, ``grad``).  ``source`` is how ``route`` was chosen
    ("analytic": the H100 model's minimum; "measured": timed on the
    device, the model's pick unless another candidate beats it past the
    noise; "forced": one candidate), ``est_seconds`` each candidate's
    modelled or measured seconds, ``from_disk`` whether the verdict came
    from the persistent cache (or the re-planner)."""

    kind: str
    route: str
    m: int
    k: int
    n: int
    dtype: torch.dtype
    device: torch.device
    packing: Optional[partitioner.PackingPlan] = None
    row_ptr: Optional[torch.Tensor] = None      # [Mt + 1] int32
    tile_rows: Optional[torch.Tensor] = None    # [T] int32
    tile_cols: Optional[torch.Tensor] = None    # [T] int32
    pack_index: Optional[torch.Tensor] = None   # [nnz] long
    grad: Optional["GradPlan"] = None           # static kind only
    spec: Optional[OpSpec] = None
    ctx: PlanContext = dataclasses.field(default_factory=PlanContext)
    key: str = ""
    artifacts: Dict[str, Any] = dataclasses.field(default_factory=dict)
    capacity_stats: Optional[CapacityStats] = None
    block_size: int = 1
    # static_balanced: the visit schedule on the device, each [bins, steps]
    visit: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None
    # static routes on a card whose kernel walks "mma" at the plan's
    # dtype: the walk's schedule on the device (bsmm's groups of rows,
    # or static_balanced's bins), recorded once with the plan
    mma: Optional[bsmm_ops.MmaSchedule] = None
    # a static pattern on a dynamic or dense route: its block indices
    # (operand order) on the device and its block count
    pattern_dev: Optional[Tuple[torch.Tensor, torch.Tensor,
                                torch.Tensor]] = None
    # grouped routes: tile side and tile capacity
    tile: int = 0
    tiles_cap: int = 0
    # batched_matmul on the card: the gmm row tile and, per slice count
    # E, the expert id of each row tile on the device (built once)
    row_tile: int = 0
    expert_ids: Dict[int, torch.Tensor] = dataclasses.field(
        default_factory=dict)
    # static kind: each b x b block walked as split x split blocks of
    # b / split (``kernel_tile``); ``packing`` and ``grad`` are then the
    # split pattern's
    split: int = 1
    # static kind: (m, k) padded to the tile the kernels walk
    walk_shape: Tuple[int, int] = (0, 0)
    # the in-memory cache key the plan was stored under (pool entries)
    mem_key: tuple = dataclasses.field(default=(), repr=False)
    source: str = "analytic"
    est_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)
    from_disk: bool = False
    # static kind: the host pattern (row_idx, col_idx) in operand order
    pattern: Optional[Tuple[np.ndarray, np.ndarray]] = dataclasses.field(
        default=None, repr=False)
    # the supersede epoch at which an evolve last moved a holder off this
    # plan (0: never); a graph captured before it replays a stale pattern
    superseded: int = 0
    # the TP routes: the k-partition and the shards this process runs
    tp: Optional["TPShards"] = None

    @property
    def grad_routes(self) -> Dict[str, str]:
        """Routes of the backward products: dL/dx and dL/dvalues."""
        if self.tp is not None:
            return dict(self.tp.grad_routes)
        if self.spec is not None and self.spec.op == "batched_matmul" \
                and self.route != "dense_torch":
            return dict(_BATCHED_GRAD_ROUTES)
        if self.kind == "dense":
            return {"dx": "torch_matmul", "dw": "torch_matmul"}
        if self.kind == "dynamic":
            if _family(self.route) == "dynamic" \
                    and self.device.type == "cpu":
                return {"dx": "dynamic_torch", "dvalues": "dynamic_torch"}
            return {"dx": "torch_gather_index_add",
                    "dvalues": "torch_gather_einsum"}
        return {"dx": self.grad.dx_route, "dvalues": self.grad.dv_route}

    def explain(self) -> dict:
        """The decision report (the reference's ``MatmulPlan.explain``
        schema): the problem, the candidates' estimates (modelled or
        measured), the chosen route and its source, the disk provenance,
        the backward verdicts, the roofline of every candidate
        (``roofline``), the plan's one-time artifacts, the evolution
        lineage (``evolution``, None for a plan that was not evolved) and
        the tensor-parallel race (``tp``, None without a mesh or
        ``tp_q``)."""
        return _explain(self)

    def roofline(self, *, flag_headroom: float = 2.0) -> dict:
        """Roofline efficiency of every raced forward candidate on the
        H100's peaks at the plan's dtype: how close each route's time
        (measured where the verdict is measured, the H100 model's
        otherwise) sits to the bound of the work it executes
        (``OpSpec.roofline_cost``).  ``routes[r]["flagged"]`` marks a
        route leaving more than ``flag_headroom`` x on the table;
        ``kernel_work`` collects them: kernels to make faster, not shapes
        to avoid.  The TP routes are left out: their times price ``q``
        cards and a reduction (``explain()["tp"]``)."""
        from repro_torch.analysis import roofline as roofline_lib
        routes = {}
        for route, est in self.est_seconds.items():
            if route in TP_ROUTES:
                continue
            eff = roofline_lib.route_efficiency(
                est, self.spec.roofline_cost(route), dtype=self.spec.dtype,
                flag_headroom=flag_headroom)
            routes[route] = {
                "achieved_us": round(eff["achieved_seconds"] * 1e6, 3),
                "bound_us": round(eff["bound_seconds"] * 1e6, 3),
                "dominant": eff["dominant"],
                "efficiency": round(eff["efficiency"], 4),
                "headroom": round(eff["headroom"], 2),
                "flagged": eff["flagged"],
            }
        return {
            "hw": roofline_lib.H100.name,
            "flag_headroom": flag_headroom,
            "source": self.source,
            "chosen": routes.get(self.route),
            "routes": routes,
            "kernel_work": sorted(r for r, e in routes.items()
                                  if e["flagged"]),
        }

    def capacity_report(self) -> Optional[dict]:
        """Planned capacity + running overflow stats (None for routes
        without a planned bucket)."""
        if self.capacity_stats is None:
            return None
        return dict(self.artifacts.get("capacity", {}),
                    stats=self.capacity_stats.report())

    def evolve(self, new_pattern, *, rerace: Optional[bool] = None,
               x: Optional[torch.Tensor] = None) -> "MatmulPlan":
        """This static spmm plan moved onto ``new_pattern`` (a RigL
        topology step), for the same problem, device and context.

        Builds the walk of the new pattern on this plan's route (tile
        packing, split blocks, the mma schedules, the balanced bins and
        the backward's metadata) and inherits the forward and backward
        verdicts: zero decisions and zero measurements.  Races again
        (``plan``, measured with ``ctx.measure`` and ``x``) when the
        pattern's profile drifted past ``ctx.evolve_drift`` from the one
        the verdicts were raced on, or with ``rerace=True``;
        ``rerace=False`` suppresses the drift trip.  Evolving the same
        plan onto the same pattern again returns the plan the first call
        built while it is live.  The result is registered under its own
        key; this plan is marked superseded (``supersede_epoch``) and
        stays live while something holds it.

        ``new_pattern`` is a static ``BlockSparseMatrix`` (values
        ignored), a bool block mask over the grid, or a ``(row_idx,
        col_idx)`` pair.  ``carry_values`` on the result maps the old
        values into its slots."""
        if self.kind != "static" or self.spec.op != "spmm":
            raise ValueError(
                f"evolve() moves static spmm plans; this plan is "
                f"kind={self.kind!r} op={self.spec.op!r} (a dynamic "
                f"pattern is runtime data: change the operand, not the "
                f"plan)")
        if self.pattern is None:
            raise ValueError("cannot evolve a plan without its concrete "
                             "pattern; plan the operand")
        return _evolve_plan(self, _as_static_bsr(new_pattern, self), rerace,
                            x)

    def carry_values(self, old_values: torch.Tensor) -> torch.Tensor:
        """The parent pattern's ``[nnz_old, b, b]`` values in this evolved
        plan's slots (one gather on their device): carried blocks keep
        their values bit for bit, grown blocks start at zero (RigL)."""
        ep = self.artifacts.get("_evolve")
        if ep is None:
            raise ValueError("carry_values() needs an evolved plan (the "
                             "result of plan.evolve(...))")
        return partitioner.apply_evolution(ep, old_values)

    # -- static kind -------------------------------------------------------

    def pack(self, values: torch.Tensor, *, held: bool = False
             ) -> torch.Tensor:
        """``[nnz, b, b]`` block values -> what the route walks: the
        ``[T, b, b]`` tile stack (``static``; pad tiles for empty rows
        are zero), the stack plus the schedule's zero tile
        (``static_balanced``), the values themselves (the dynamic
        routes) or ``W^T [k, m]`` (``dense``).  Serving packs once per
        weight load.  A TP plan packs the shards this process runs, one
        stack after the other; ``held``: ``values`` are this rank's
        shard's blocks only, in its slot order (``TPShards.pack``)."""
        if self.tp is not None:
            return self.tp.pack(values, held=held)
        if held:
            raise ValueError("held values need a static_tp_shardmap plan")
        family = _family(self.route)
        if family in ("static", "static_balanced"):
            tiles = partitioner.pack_values(
                self.packing, split_blocks(values, self.split),
                self.pack_index)
            if family == "static_balanced":
                tiles = bal_ops.pad_tiles(tiles)
            return tiles.contiguous()
        if family == "dense":
            rows, cols, _ = self.pattern_dev
            b = self.block_size
            w = values.new_zeros((self.m // b, self.k // b, b, b))
            w[rows.long(), cols.long()] = values
            return w.permute(0, 2, 1, 3).reshape(self.m, self.k).t(
                ).contiguous()
        return values

    def run_packed(self, packed: torch.Tensor, x2: torch.Tensor
                   ) -> torch.Tensor:
        """Static kind on ``pack(values)``: ``x2 [N, k] -> [N, m]``."""
        if self.tp is not None:
            return self.tp.run_packed(packed, x2, self.m)
        family = _family(self.route)
        mp, kp = self.walk_shape
        if family == "static":
            return _crop(bsmm_ops.bsmm_nt(
                dsmm_ops.pad_cols(x2, kp), packed, self.row_ptr,
                self.tile_cols, self.tile_rows, mp, self.mma), self.m)
        if family == "static_balanced":
            vr, vc, vs = self.visit
            return _crop(bal_ops.bsmm_balanced(
                dsmm_ops.pad_cols(x2, kp), packed, vr, vc, vs, mp,
                self.mma), self.m)
        if family == "dense":
            return dmm_ops.dense_mm(x2.contiguous(), packed)
        rows, cols, nnz = self.pattern_dev
        op = DynamicOperand(packed, rows, cols, nnz, (self.m, self.k),
                            self.block_size)
        return self.run_dynamic(op, x2)

    def spmm_nt(self, payload, x2: torch.Tensor, *,
                held: bool = False) -> torch.Tensor:
        """``x2 [N, k] -> x2 . W^T [N, m]``, differentiable in both
        operands through the planned backward.  ``payload`` is the
        ``[nnz, b, b]`` values (static kind) or the ``DynamicOperand``
        (dynamic kind); ``held`` as ``pack`` takes it (dL/dvalues then
        covers the held blocks only)."""
        if self.kind == "dynamic":
            return self._dynamic_nt(payload, x2)
        if _needs_grad(payload, x2):
            self._check_differentiable()
            if self.tp is None:
                if held:
                    raise ValueError("held values need a "
                                     "static_tp_shardmap plan")
                return _StaticSpmmFn.apply(payload, x2, self)
            group = self.tp.group
            if group is None:
                return _TPSpmmFn.apply(payload, x2, self, held)
            return tp_lib.reduce_from_group(_TPSpmmFn.apply(
                payload, tp_lib.copy_to_group(x2, group), self, held),
                group)
        return self.run_packed(self.pack(payload, held=held), x2)

    def grad_dx(self, values: torch.Tensor, dy2: torch.Tensor
                ) -> torch.Tensor:
        """dL/dx of the static kind on the route its race picked: ``dy2
        [N, m] -> dy2 . W [N, k]``."""
        g = self.grad
        if _family(g.dx_route) == "static":
            return self.spmm_t(values, dy2)
        q = g.dx_plan
        v_t = values[g.dx_perm].transpose(1, 2)
        return q.run_packed(q.pack(v_t), dy2)

    def grad_dvalues(self, dy2: torch.Tensor, x2: torch.Tensor
                     ) -> torch.Tensor:
        """dL/dvalues of the static kind on the route its race picked:
        ``[nnz, b, b]`` block-sampled ``dy2^T . x2`` in operand order."""
        g = self.grad
        if _family(g.dv_route) == "sddmm":
            return self.sddmm(dy2, x2)
        b = self.block_size
        rt = torch.result_type(dy2, x2)
        dw = dmm_ops.dense_mm(dy2.to(rt).t().contiguous(),
                              x2.to(rt).contiguous())        # [m, k]
        rows, cols = g.dv_pattern
        return dw.reshape(self.m // b, b, self.k // b, b).permute(
            0, 2, 1, 3)[rows, cols]

    def spmm_t(self, values: torch.Tensor, dy2: torch.Tensor
               ) -> torch.Tensor:
        """dL/dx of the static kind: ``dy2 [N, m] -> dy2 . W [N, k]``,
        the bsmm walk over the transposed pattern's tile stack."""
        g = self.grad
        mp, kp = self.walk_shape
        return _crop(bsmm_ops.bsmm_nt(
            dsmm_ops.pad_cols(dy2, mp), self.pack_t(values), g.row_ptr,
            g.tile_cols, g.tile_rows, kp, g.mma), self.k)

    def pack_t(self, values: torch.Tensor) -> torch.Tensor:
        """``W^T``'s ``[T', b, b]`` tile stack: the values permuted into
        the transposed pattern's order, each block transposed, packed
        for the bsmm walk (a device gather per call while training)."""
        g = self.grad
        return partitioner.pack_values(
            g.packing, partitioner.apply_transpose(
                g.transpose, split_blocks(values, self.split), g.perm),
            g.pack_index).contiguous()

    def sddmm(self, dy2: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        """dL/dvalues of the static kind: ``[nnz, b, b]`` block-sampled
        ``dy2^T . x2`` in the pattern's lexsort order."""
        g = self.grad
        t = g.sddmm_block
        mp, kp = self.walk_shape
        dv = sddmm_ops.sddmm(dsmm_ops.pad_cols(dy2, mp),
                             dsmm_ops.pad_cols(x2, kp), g.block_row_ptr,
                             g.col_idx, g.row_idx, t)
        if g.gather is not None:
            # sampled on the t x t tiles the blocks were packed into: the
            # blocks, in operand order, through the forward's pack index
            b = self.packing.block_size
            r = t // b
            dv = dv.reshape(-1, r, b, r, b).permute(0, 1, 3, 2, 4).reshape(
                -1, b, b)[g.gather]
        elif g.unsort is not None:
            dv = dv[g.unsort]
        return merge_blocks(dv, self.split)

    # -- dense kind --------------------------------------------------------

    def matmul(self, x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Dense kind: ``x2 [N, k] . w [k, m]``, differentiable in both
        operands."""
        if _needs_grad(x2, w):
            self._check_differentiable()
            return _DenseMatmulFn.apply(x2, w)
        return dmm_ops.dense_mm(x2.contiguous(), w.contiguous())

    def batched_matmul(self, a: torch.Tensor, b: torch.Tensor
                       ) -> torch.Tensor:
        """``op="batched_matmul"``: ``a [..., C, D] @ b [..., D, F]`` with
        the same leading axes, in one gmm launch on a card or
        ``torch.matmul`` on the CPU.  Under autograd on a card the
        planned backward of ``_BatchedMatmulFn`` runs (dL/da by gmm on
        b transposed, dL/db by ``torch.bmm``)."""
        lead = a.shape[:-2]
        if (tuple(a.shape[-2:]) + (b.shape[-1],) != (self.m, self.k, self.n)
                or b.shape[:-2] != lead or b.shape[-2] != self.k):
            raise ValueError(f"plan expects [..., {self.m}, {self.k}] @ "
                             f"[..., {self.k}, {self.n}] with equal leading "
                             f"axes; got {tuple(a.shape)} @ {tuple(b.shape)}")
        if self.route == "dense_torch":
            return torch.matmul(a, b)
        e = int(np.prod(lead, dtype=np.int64))
        a3 = a.reshape(e, self.m, self.k)
        b3 = b.reshape(e, self.k, self.n)
        if _needs_grad(a, b):
            self._check_differentiable()
            y = _BatchedMatmulFn.apply(a3, b3, self)
        else:
            y = self.gmm(a3, b3)
        return y.reshape(*lead, self.m, self.n)

    def gmm(self, a3: torch.Tensor, b3: torch.Tensor) -> torch.Tensor:
        """One gmm launch: ``a3 [E, C, D] @ b3 [E, D, F] -> [E, C, F]``,
        each expert a run of ``C / row_tile`` row tiles.  The expert ids
        are built once per E (``[E, C]`` is the layout of the forward and
        of dL/da alike)."""
        e, c, d = a3.shape
        ids = self.expert_ids.get(e)
        if ids is None:
            ids = self.expert_ids[e] = torch.arange(
                e, dtype=torch.int32, device=self.device).repeat_interleave(
                    c // self.row_tile)
        y = gmm_ops.gmm_cuda(a3.reshape(e * c, d).contiguous(),
                             b3.contiguous(), ids, tm=self.row_tile)
        return y.reshape(e, c, b3.shape[-1])

    # -- dynamic routes ----------------------------------------------------

    def _dynamic_nt(self, op: DynamicOperand, x2: torch.Tensor
                    ) -> torch.Tensor:
        if tuple(op.shape) != (self.m, self.k) \
                or op.block_size != self.block_size:
            raise ValueError(f"plan expects a {self.m}x{self.k} operand at "
                             f"block {self.block_size}; got {op.shape} at "
                             f"block {op.block_size}")
        if _needs_grad(op.values, x2):
            self._check_differentiable()
            if self.route != "dynamic_torch":
                return _DynamicSpmmFn.apply(op.values, op.row_idx,
                                            op.col_idx, op.nnz, x2, self)
        return self.run_dynamic(op, x2)

    def run_dynamic(self, op: DynamicOperand, x2: torch.Tensor
                    ) -> torch.Tensor:
        """Forward of a dynamic route on ``op``: ``x2 [N, k] -> [N, m]``.
        Only ``dynamic_torch`` is differentiable itself: ``_dspmm``
        carries its own backward (the JAX dynamic_xla route's native
        vjp); the kernel routes get theirs from ``_DynamicSpmmFn``."""
        family = _family(self.route)
        if self.route == "dynamic_torch":
            return _dspmm(op.values, op.row_idx, op.col_idx, x2.t(),
                          self.m // self.block_size, self.block_size).t()
        if family == "dynamic":
            return dsmm_ops.dsmm(op, x2)
        if family == "dense":
            return dmm_ops.dense_mm(x2.contiguous(),
                                    op.to_dense().t().contiguous())
        spmm = (gmm_balanced.balanced_spmm
                if family == "dynamic_grouped_balanced"
                else gmm_ops.grouped_spmm)
        stats = self.capacity_stats
        if stats is None or not self.ctx.telemetry:
            return spmm(op, x2, tile=self.tile, tiles_cap=self.tiles_cap)
        y, st = spmm(op, x2, tile=self.tile, tiles_cap=self.tiles_cap,
                     return_stats=True)
        # one host read of the four counters (waits for the device)
        total, dropped, blocks, frac = torch.stack(
            [v.to(torch.float64) for v in st]).tolist()
        stats.record(int(total), int(dropped), int(blocks), frac)
        return y

    def _check_differentiable(self):
        if not self.ctx.differentiable:
            raise ValueError(
                f"plan route {self.route!r} was built with "
                f"PlanContext(differentiable=False) and has no backward; "
                f"re-plan with differentiable=True")


@dataclasses.dataclass
class GradPlan:
    """A static plan's backward metadata, built once with the plan.

    ``transpose``/``packing`` are ``W^T``'s pattern and its
    ``plan_packing`` at the kernel's tile; ``row_ptr``/``tile_rows``/
    ``tile_cols`` its walk on the device (and ``mma`` the tensor-core
    walk's schedule where the plan records one), ``perm`` the value
    permutation.
    ``block_row_ptr``/``row_idx``/``col_idx`` are the CSR runs, in
    lexsort order, that the SDDMM samples at block ``sddmm_block``: the
    forward pattern's own blocks (``unsort`` maps them back to the
    operand's block order where that differs) or, for blocks below the
    kernel's tiles, the forward packing's tiles (``gather`` then picks
    each block out of them).  With a split plan all of it is the split
    pattern's."""

    transpose: partitioner.TransposePlan
    packing: partitioner.PackingPlan
    perm: torch.Tensor           # [nnz] long
    pack_index: torch.Tensor     # [nnz] long, into W^T's tile stack
    row_ptr: torch.Tensor        # [Kt + 1] int32
    tile_rows: torch.Tensor      # [T'] int32
    tile_cols: torch.Tensor      # [T'] int32
    block_row_ptr: torch.Tensor  # [Mt + 1] int32
    row_idx: torch.Tensor        # [nnz] int32
    col_idx: torch.Tensor        # [nnz] int32
    sddmm_block: int
    unsort: Optional[torch.Tensor] = None  # [nnz] long
    gather: Optional[torch.Tensor] = None  # [nnz] long
    mma: Optional[bsmm_ops.MmaSchedule] = None  # W^T's, as MatmulPlan.mma
    # the routes the backward race picked (``_grad_decide``): dL/dx on the
    # bsmm walk above, or on ``dx_plan`` (a forward-only plan of W^T on
    # another route, fed the values permuted by ``dx_perm`` and each block
    # transposed); dL/dvalues by the SDDMM above, or by the dense product
    # and a gather of the blocks at ``dv_pattern`` (operand order)
    dx_route: str = ""
    dv_route: str = ""
    dx_plan: Optional["MatmulPlan"] = None
    dx_perm: Optional[torch.Tensor] = None       # [nnz] long
    dv_pattern: Optional[Tuple[torch.Tensor, torch.Tensor]] = None


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad
                                           for t in tensors)


class _StaticSpmmFn(torch.autograd.Function):
    """``_planned_vjp``: forward runs the plan's route on the packed
    values; backward runs the dvalues and dx routes the plan's backward
    race picked, each cast to its operand's dtype."""

    @staticmethod
    def forward(ctx, values, x2, plan_):
        ctx.plan = plan_
        x2 = x2.contiguous()
        ctx.save_for_backward(values, x2)
        return plan_.run_packed(plan_.pack(values), x2)

    @staticmethod
    def backward(ctx, dy2):
        values, x2 = ctx.saved_tensors
        p = ctx.plan
        dv = dx = None
        if ctx.needs_input_grad[0]:
            dv = p.grad_dvalues(dy2, x2).to(values.dtype)
        if ctx.needs_input_grad[1]:
            dx = p.grad_dx(values, dy2).to(x2.dtype)
        return dv, dx, None


@dataclasses.dataclass
class TPShards:
    """A TP plan's shards: the k-partition (``meta``) and, for each shard
    this process runs (all ``q`` on ``static_tp``, its rank's on
    ``static_tp_shardmap``), a static plan of the full shape holding
    that shard's blocks (None where it owns none), its blocks' slots in
    the operand's values on the device, and its tile count in the packed
    stack.  ``group`` is the process group the explicit route reduces
    over."""

    meta: partitioner.KShardPlan
    shards: Tuple[int, ...]
    plans: Tuple[Optional["MatmulPlan"], ...]
    src: Tuple[torch.Tensor, ...]
    tiles: Tuple[int, ...]
    grad_routes: Dict[str, str]
    group: Any = None

    def pack(self, values: torch.Tensor, *, held: bool = False
             ) -> torch.Tensor:
        """The shards' stacks back to back from the operand's values, or,
        ``held``, from the one shard's own blocks (a rank of a
        model-parallel LM holds only those, in ``shard_source`` order)."""
        if held and len(self.shards) != 1:
            raise ValueError("held values need the explicit route's one "
                             "shard a rank")
        parts = [p.pack(values if held else values[src])
                 for p, src in zip(self.plans, self.src) if p is not None]
        if not parts:
            return values.new_zeros((0, 1, 1))
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def partials(self, packed: torch.Tensor, x2: torch.Tensor, m: int
                 ) -> torch.Tensor:
        """This process's shards' partials summed in the output dtype (a
        bsmm launch each; zeros where no shard here owns a block)."""
        y, off = None, 0
        for p, t in zip(self.plans, self.tiles):
            if p is None:
                continue
            part = p.run_packed(packed[off:off + t], x2)
            y = part if y is None else y + part
            off += t
        return x2.new_zeros((x2.shape[0], m)) if y is None else y

    def run_packed(self, packed: torch.Tensor, x2: torch.Tensor, m: int
                   ) -> torch.Tensor:
        y = self.partials(packed, x2, m)
        if self.group is not None:
            import torch.distributed as dist
            y = y.contiguous()
            dist.all_reduce(y, group=self.group)
        return y


class _TPSpmmFn(torch.autograd.Function):
    """The partials of the shards this process runs under autograd,
    summed.  Backward, per shard, on the routes of its static plan:
    dL/dvalues by the SDDMM into its blocks' slots (zeros at the blocks
    of shards run elsewhere), dL/dx by bsmm on the transposed shard,
    summed.  The explicit route wraps it in ``core/tp.py``'s conjugate
    pair: ``copy_to_group`` on the input (its gradient all-reduced) and
    ``reduce_from_group`` on the output (all-reduced, its gradient taken
    as it comes)."""

    @staticmethod
    def forward(ctx, values, x2, plan_, held=False):
        ctx.plan, ctx.held = plan_, held
        x2 = x2.contiguous()
        ctx.save_for_backward(values, x2)
        return plan_.tp.partials(plan_.pack(values, held=held), x2,
                                 plan_.m)

    @staticmethod
    def backward(ctx, dy2):
        values, x2 = ctx.saved_tensors
        tp = ctx.plan.tp
        dy2 = dy2.contiguous()
        dv = dx = None
        if ctx.needs_input_grad[0]:
            dv = torch.zeros_like(values)
            for p, src in zip(tp.plans, tp.src):
                if p is not None:
                    g = p.grad_dvalues(dy2, x2).to(values.dtype)
                    if ctx.held:
                        dv = g
                    else:
                        dv.index_copy_(0, src, g)
        if ctx.needs_input_grad[1]:
            for p, src in zip(tp.plans, tp.src):
                if p is not None:
                    part = p.grad_dx(values if ctx.held else values[src],
                                     dy2)
                    dx = part if dx is None else dx + part
            dx = x2.new_zeros(x2.shape) if dx is None else dx.to(x2.dtype)
        return dv, dx, None, None


class _DynamicSpmmFn(torch.autograd.Function):
    """``_dynamic_planned_vjp``: forward runs the plan's dynamic route
    (the dsmm walk, direct or on packed tiles); backward is the runtime
    gather / einsum / ``index_add_`` pair over the operand's own slots.
    Integer index and count tensors get no gradient."""

    @staticmethod
    def forward(ctx, values, row_idx, col_idx, nnz, x2, plan_):
        ctx.plan = plan_
        x2 = x2.contiguous()
        ctx.save_for_backward(values, row_idx, col_idx, x2)
        op = DynamicOperand(values, row_idx, col_idx, nnz,
                            (plan_.m, plan_.k), plan_.block_size)
        return plan_.run_dynamic(op, x2)

    @staticmethod
    def backward(ctx, dy2):
        values, row_idx, col_idx, x2 = ctx.saved_tensors
        p = ctx.plan
        dv, dx = dspmm_backward(values, row_idx, col_idx, x2.t(), dy2.t(),
                                p.m // p.block_size, p.block_size)
        return (dv.to(values.dtype), None, None, None,
                dx.t().to(x2.dtype), None)


# the backward products of batched_matmul on the gmm route
_BATCHED_GRAD_ROUTES = {"dx": "gmm_cuda", "dvalues": "torch_bmm"}


class _BatchedMatmulFn(torch.autograd.Function):
    """The planned backward of ``batched_matmul`` on a card: the gmm
    launch forward; dL/da[e] = dy[e] . b[e]^T by the gmm kernel again,
    on a contiguous copy of b transposed per expert, with the forward's
    expert ids and row tile; dL/db[e] = a[e]^T . dy[e] by ``torch.bmm``.
    The reference runs every backward product of ``batched_matmul`` in
    XLA (only spmm relaxes its differentiable gate, ``_selection_ctx``),
    so ``torch.bmm`` stands for XLA's dot there; dL/da keeps the
    hand-written kernel on the backward path.  A failed gmm build or
    launch raises: there is no fallback."""

    @staticmethod
    def forward(ctx, a3, b3, plan_):
        ctx.plan = plan_
        ctx.save_for_backward(a3, b3)
        return plan_.gmm(a3, b3)

    @staticmethod
    def backward(ctx, dy):
        a3, b3 = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[0]:
            da = ctx.plan.gmm(dy.to(b3.dtype),
                              b3.transpose(-1, -2)).to(a3.dtype)
        if ctx.needs_input_grad[1]:
            db = torch.bmm(a3.transpose(-1, -2), dy.to(a3.dtype)).to(
                b3.dtype)
        return da, db, None


class _DenseMatmulFn(torch.autograd.Function):
    """``_dense_planned_vjp`` (matmul form): dense_mm forward,
    ``torch.matmul`` for both backward products."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return dmm_ops.dense_mm(x2.contiguous(), w.contiguous())

    @staticmethod
    def backward(ctx, dy):
        x2, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.matmul(dy, w.t()).to(x2.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.matmul(x2.t(), dy).to(w.dtype)
        return dx, dw


_LOCK = threading.Lock()
_PLANS: Dict[Tuple, MatmulPlan] = {}
# plan pools: ctx.pool label -> the mem keys of every plan used under it,
# in first-use order (a dict as an ordered set)
_POOLS: Dict[str, Dict[Tuple, None]] = {}
# the ambient PlanContext of use_ctx, per thread
_CTX_STATE = threading.local()
# running overflow telemetry per plan key: outlives plan objects, so an
# escalation survives the eviction it causes
_CAPACITY: Dict[str, CapacityStats] = {}
# record_dropped values still on the card, per stream, read at the next
# capacity_report (or once a stream holds _DROPS_FOLD_AT of them)
_DROPS: Dict[str, list] = {}
_DROPS_FOLD_AT = 4096
# every folded record_dropped value per stream, one per call in call
# order (the newest _DROPS_LOG_LEN), for dropped_history
_DROPS_LOG: Dict[str, collections.deque] = {}
_DROPS_LOG_LEN = 1 << 16
# the re-planner's verdict overlay: plan key -> the measured record
# (``remeasure_plan``); ``_decide`` reads it before the disk cache
_REPLANNED: Dict[str, dict] = {}
# a static pattern's skew and walk counts, per (pattern key, m, k, b)
_PATTERN_INFO: Dict[Tuple, Tuple[Tuple[float, float],
                                  dispatch.WalkCounts]] = {}
_PATTERN_INFO_MAX = 1024
# plans an evolve moved off, by mem key, kept while something else holds
# them (a module's plans, a graph, an autograd context)
_SUPERSEDED: "weakref.WeakValueDictionary[Tuple, MatmulPlan]" = \
    weakref.WeakValueDictionary()
# bumped by every evolve (``MatmulPlan.superseded``)
_EPOCH = 0
# process-wide evolution telemetry (plan_report()["totals"]["evolution"])
_EVOLUTION: Dict[str, int] = {"evolves": 0, "reraces": 0, "drift_trips": 0}


def cache_stats() -> Dict[str, int]:
    """Plan and decision counters since ``reset`` (``sparse.cache``:
    plans built, cache hits, route decisions, measured races, disk hits,
    misses, writes and stale drops) and the plans held (``cached``)."""
    stats = cache_lib.cache_stats()
    with _LOCK:
        stats["cached"] = len(_PLANS)
    return stats


def configure(cache_dir: Optional[str] = None) -> None:
    """Set the process-default persistent cache directory."""
    cache_lib.configure(cache_dir)


@contextlib.contextmanager
def use_ctx(ctx: PlanContext):
    """Install ``ctx`` as the ambient planning context of this thread:
    every ``plan``/``matmul``/``spmm_nt``/``batched_matmul`` call without
    an explicit ``ctx`` (and ``record_dropped``) picks it up.  The serving
    engine wraps its programs with it, so its pool label, telemetry and
    persistence policy never leak into process-global state."""
    prev = getattr(_CTX_STATE, "ctx", None)
    _CTX_STATE.ctx = ctx
    try:
        yield ctx
    finally:
        _CTX_STATE.ctx = prev


def current_ctx() -> PlanContext:
    """The ambient ``PlanContext`` (``use_ctx``), else the default."""
    ctx = getattr(_CTX_STATE, "ctx", None)
    return ctx if ctx is not None else _DEFAULT_CTX


_DEFAULT_CTX = PlanContext()


def _register(mem_key: Tuple, ctx: PlanContext) -> None:
    if ctx.pool and ctx.cache:
        with _LOCK:
            _POOLS.setdefault(ctx.pool, {})[mem_key] = None


def note_use(p: MatmulPlan) -> None:
    """A plan cached by its caller (``SparseLinear``) is used again: it
    joins the ambient pool, as a ``plan()`` hit would, and a capture in
    progress keeps it alive."""
    _register(p.mem_key, current_ctx())
    capture.hold_plan(p)


def _cached(mem_key: Tuple) -> Optional[MatmulPlan]:
    """The plan cached at ``mem_key``: the plan cache's, else a
    superseded plan something still holds."""
    hit = _PLANS.get(mem_key)
    return _SUPERSEDED.get(mem_key) if hit is None else hit


def is_live(p: MatmulPlan) -> bool:
    """Is ``p`` still the plan cache's plan for its problem (not dropped
    by ``reset``, an escalation or a re-planned verdict)?  A plan an
    evolve superseded stays live while something holds it.  Always true
    for a plan built with ``PlanContext(cache=False)``."""
    return not p.ctx.cache or _cached(p.mem_key) is p


def supersede_epoch() -> int:
    """The count of plan supersessions (evolves) in this process: a
    plan with ``superseded`` above the value a holder saw was left by
    some module since (``MatmulPlan.superseded``)."""
    return _EPOCH


def pool_plans(pool: str) -> list:
    """Every live plan used under ``ctx.pool == pool``, in first-use
    order.  Plans dropped from the in-memory cache (``reset``, a capacity
    escalation, a re-planner upgrade) drop out until their holder plans
    again."""
    with _LOCK:
        keys = list(_POOLS.get(pool, ()))
        plans = [_cached(k) for k in keys]
    return [p for p in plans if p is not None]


def _batched_grad(p: MatmulPlan) -> Optional[dict]:
    """The backward section of a differentiable ``batched_matmul`` plan
    on the gmm route (``_BatchedMatmulFn``: one formulation, forced), in
    the static plans' ``explain`` schema; None for any other plan."""
    if not (p.ctx.differentiable and p.spec is not None
            and p.spec.op == "batched_matmul" and p.route != "dense_torch"):
        return None
    return {"mode": "planned",
            **{side: {"route": route, "source": "forced"}
               for side, route in _BATCHED_GRAD_ROUTES.items()},
            "from_disk": False}


def _grad_report(p: MatmulPlan) -> dict:
    """A plan's backward section: "planned" with the routes autograd runs
    and their source, "unavailable" for a forward-only plan."""
    if not p.ctx.differentiable:
        return {"mode": "unavailable"}
    grad = p.artifacts.get("grad") or _batched_grad(p)
    if grad is not None:
        return grad
    # dynamic and dense plans: one formulation each (forced)
    return {"mode": "planned",
            **{name: {"route": route, "source": "forced"}
               for name, route in p.grad_routes.items()},
            "from_disk": False}


def plan_report() -> dict:
    """Every plan this process holds with its forward route, the route's
    ``source`` ("analytic", "measured" or "forced") and ``from_disk``,
    its kind, op, the routes of its backward products (``grad``:
    ``mode`` "planned" with each product's route and source when
    autograd runs them, "unavailable" for a forward-only plan) and its
    evolution lineage, plus the totals (``evolution``: evolves, re-races
    and drift trips since ``reset``, evolved plans held, their highest
    generation).  An evolved plan's entry is ``<key>#gen<n>``: the
    generations of one chain may share a key."""
    with _LOCK:
        plans = list(_PLANS.values()) + list(_SUPERSEDED.values())
        evo = dict(_EVOLUTION)
    per = {}
    for p in plans:
        ev = p.artifacts.get("evolution")
        per[p.key if not ev else f"{p.key}#gen{ev['generation']}"] = {
            "route": p.route, "source": p.source,
            "from_disk": bool(p.from_disk), "op": p.spec.op,
            "kind": p.kind, "grad": _grad_report(p), "evolution": ev}
    routes = collections.Counter(r["route"] for r in per.values())
    sources = collections.Counter(r["source"] for r in per.values())
    planned = [r["grad"] for r in per.values()
               if r["grad"]["mode"] == "planned"]
    evolved = [r["evolution"] for r in per.values() if r["evolution"]]
    return {
        "per_plan": per,
        "totals": {
            "plans": len(per),
            "grad_planned": len(planned),
            "grad_measured": sum(1 for g in planned
                                 if g["dx"].get("source") == "measured"),
            "grad_from_disk": sum(1 for g in planned if g.get("from_disk")),
            "by_route": dict(sorted(routes.items())),
            "by_source": dict(sorted(sources.items())),
            "evolution": dict(evo, evolved_plans=len(evolved),
                              max_generation=max(
                                  (e["generation"] for e in evolved),
                                  default=0)),
        },
    }


def roofline_report() -> dict:
    """Roofline efficiency of every plan this process holds: the chosen
    route's achieved-against-bound share and the union of the routes
    flagged for leaving more than 2x on the table (``kernel_work``); the
    serving engine folds it into ``plan_report()``."""
    with _LOCK:
        plans = list(_PLANS.values())
    per = {}
    flagged = set()
    for p in plans:
        r = p.roofline()
        per[p.key] = {"route": p.route, "chosen": r["chosen"],
                      "kernel_work": r["kernel_work"]}
        flagged.update(r["kernel_work"])
    chosen_eff = [r["chosen"]["efficiency"] for r in per.values()
                  if r["chosen"]]
    return {
        "per_plan": per,
        "totals": {
            "plans": len(per),
            "chosen_flagged": sum(1 for r in per.values()
                                  if r["chosen"] and r["chosen"]["flagged"]),
            "min_chosen_efficiency": (round(min(chosen_eff), 4)
                                      if chosen_eff else None),
            "kernel_work_routes": sorted(flagged),
        },
    }


def tp_report() -> dict:
    """Every tensor-parallel decision this process holds: per plan the
    raced TP candidates, the source of their times, the crossover (best
    unsharded over best TP time; > 1: past it) with the route and its
    disk provenance, and the totals.  The serving engine folds it into
    ``plan_report()``."""
    with _LOCK:
        plans = list(_PLANS.values())
    per = {}
    for p in plans:
        tp = p.artifacts.get("tp")
        if tp:
            per[p.key] = dict(tp, route=p.route, from_disk=p.from_disk)
    return {
        "per_plan": per,
        "totals": {
            "tp_planned": len(per),
            "tp_chosen": sum(1 for r in per.values() if r["chosen"]),
            "measured": sum(1 for r in per.values()
                            if r["source"] == "measured"),
        },
    }


def reset() -> None:
    """Forget every cached plan, decision, pool, re-planned verdict and
    capacity stat, and zero the counters.  Disk cache files survive:
    this is what a fresh process sees."""
    with _LOCK:
        _PLANS.clear()
        _SUPERSEDED.clear()
        _SHARD_META.clear()
        _POOLS.clear()
        _CAPACITY.clear()
        _DROPS.clear()
        _DROPS_LOG.clear()
        _REPLANNED.clear()
        for k in _EVOLUTION:
            _EVOLUTION[k] = 0
    cache_lib.reset()
    dispatch.clear_cache()


def reset_telemetry() -> None:
    """Zero the running ``capacity_report()`` counters and the evolution
    totals without forgetting plans: stats of cached plans are zeroed in
    place (their plans keep recording), orphaned ones dropped."""
    with _LOCK:
        _DROPS.clear()
        _DROPS_LOG.clear()
        for k in _EVOLUTION:
            _EVOLUTION[k] = 0
        live = {id(p.capacity_stats) for p in _PLANS.values()
                if p.capacity_stats is not None}
        for key in list(_CAPACITY):
            stats = _CAPACITY[key]
            if id(stats) not in live:
                del _CAPACITY[key]
            else:
                stats.reset_counts()


def _stream(name: str) -> CapacityStats:
    with _LOCK:
        stats = _CAPACITY.get(name)
        if stats is None:
            stats = _CAPACITY[name] = CapacityStats(name)
        return stats


def _fold_drops() -> None:
    """Read every pending device value (one host read) into its
    stream."""
    with _LOCK:
        pending = {k: v for k, v in _DROPS.items() if v}
        _DROPS.clear()
    for name, vals in pending.items():
        _log_drops(name, torch.cat(vals).double().tolist())


def _log_drops(name: str, fracs) -> None:
    stats = _stream(name)
    with _LOCK:
        log = _DROPS_LOG.setdefault(
            name, collections.deque(maxlen=_DROPS_LOG_LEN))
        log.extend(fracs)
    for frac in fracs:
        stats.record(0, 0, 0, frac)


def record_dropped(name: str, dropped_frac) -> None:
    """Fold one step's dropped fraction of a non-plan capacity bucket
    (MoE's routing ``dropped_frac``) into the ``name`` stream of
    ``capacity_report()``: fraction only, so ``overflow_calls`` counts
    through ``frac > 0`` and the tile totals stay uninflated.  A host
    value is recorded now; a tensor on the card is kept on the card and
    read at the next ``capacity_report()``, so no call here waits for
    the device (the reference's eager call syncs, its traced call
    records nothing).  Under a capture record (``core.capture``) the
    value is noted for the captured graph, which queues a copy of it
    after each replay; under an ambient ``telemetry=False`` nothing is
    recorded, nor in a forward recomputed for the backward (its first
    run recorded it)."""
    if not current_ctx().telemetry or capture.is_recomputing():
        return
    rec = capture.active()
    if isinstance(dropped_frac, torch.Tensor) \
            and (rec is not None or dropped_frac.device.type != "cpu"):
        frac = dropped_frac.detach().float().reshape(-1)
        if frac.numel() != 1:
            frac = frac.amax().reshape(1)
        if rec is not None:
            rec.drops.setdefault(name, []).append(frac)
        else:
            queue_dropped(name, frac)
        return
    if rec is not None:
        rec.drops.setdefault(name, []).append(
            torch.tensor([float(np.asarray(dropped_frac).max())]))
        return
    if isinstance(dropped_frac, torch.Tensor):
        dropped_frac = dropped_frac.detach().float().numpy()
    _fold_drops()                 # earlier calls' card values first
    _log_drops(name, [float(np.asarray(dropped_frac).max())])


def queue_dropped(name: str, fracs: torch.Tensor) -> None:
    """Queue device values of stream ``name`` (a 1-d tensor, one value a
    call, in call order) for the next fold."""
    with _LOCK:
        pend = _DROPS.setdefault(name, [])
        pend.append(fracs)
        full = len(pend) >= _DROPS_FOLD_AT
    if full:
        _fold_drops()


def dropped_history(name: str) -> list:
    """Every value ``record_dropped`` took for stream ``name`` since the
    last ``reset_telemetry``, one float per call in call order (the
    newest 65536).  Reads the card once, like ``capacity_report``."""
    _fold_drops()
    with _LOCK:
        return list(_DROPS_LOG.get(name, ()))


def capacity_report() -> dict:
    """Overflow telemetry of every planned-capacity problem run in this
    process (and of the ``record_dropped`` streams), per plan key and in
    total."""
    _fold_drops()
    with _LOCK:
        per_key = {k: s.report() for k, s in _CAPACITY.items()}
    return {
        "per_plan": per_key,
        "totals": {
            "calls": sum(r["calls"] for r in per_key.values()),
            "overflow_calls": sum(r["overflow_calls"]
                                  for r in per_key.values()),
            "tiles_dropped_total": sum(r["tiles_dropped_total"]
                                       for r in per_key.values()),
            "escalated_plans": sum(1 for r in per_key.values()
                                   if r["escalated"]),
        },
    }


def _on_dev(a, dev) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a, np.int32), device=dev)


def _crop(y: torch.Tensor, m: int) -> torch.Tensor:
    """The first ``m`` columns of a product walked on a padded shape."""
    return y[:, :m] if y.shape[1] != m else y


def _check_contract(route: str, spec: OpSpec, block: int) -> None:
    """Raise, at plan time, if the kernel that ``route`` (or its card
    counterpart, for a CPU route) launches refuses the problem at the
    block it will walk (on ``m`` and ``k`` padded to that block)."""
    c = contract_lib.contract_for_route(route.replace(SUFFIX["cpu"],
                                                      SUFFIX["cuda"]))
    if c is None:
        return
    m, k = walk_shape(spec.m, spec.k, block)
    why = c.admits(m, k, spec.n, block, spec.dtype)
    if why is not None:
        raise ValueError(
            f"plan: route {route} ({c.kernel} kernel) cannot take "
            f"{spec.m}x{spec.k} at block {spec.block_size} (walked as "
            f"{block}): {why}")


def _check_plan_contracts(route: str, spec: OpSpec,
                          ctx: PlanContext) -> None:
    """Every kernel the plan will launch admits it, at the block that
    kernel walks (the static backward's bsmm and sddmm too, where the
    plan is differentiable).  A TP plan launches the static route's."""
    if route in TP_ROUTES:
        route = "static_cuda"
    family = _family(route)
    b = spec.block_size
    if spec.kind != "dense" and family in ("static", "static_balanced"):
        _check_contract(route, spec, kernel_tile(b)[0])
    elif spec.kind != "dense" and family != "dense":
        _check_contract(route, spec, dynamic_tile(spec.m, spec.k, b, route))
    if spec.kind == "static" and ctx.differentiable:
        for grad_route in (ROUTES[("static", "cuda")], SDDMM_ROUTES["cuda"]):
            _check_contract(grad_route, spec, kernel_tile(b)[0])


def split_blocks(values: torch.Tensor, split: int) -> torch.Tensor:
    """``[nnz, b, b]`` -> ``[nnz * split^2, b / split, b / split]``:
    block z's sub-block (i, j) at ``(z * split + i) * split + j``."""
    if split == 1:
        return values
    nnz, b, _ = values.shape
    c = b // split
    return values.reshape(nnz, split, c, split, c).permute(
        0, 1, 3, 2, 4).reshape(nnz * split * split, c, c)


def merge_blocks(values: torch.Tensor, split: int) -> torch.Tensor:
    """The inverse of ``split_blocks``."""
    if split == 1:
        return values
    c = values.shape[-1]
    nnz = values.shape[0] // (split * split)
    return values.reshape(nnz, split, split, c, c).permute(
        0, 1, 3, 2, 4).reshape(nnz, split * c, split * c)


def _grad_metadata(er, ec, eb: int, meta, shape, t: int, mma: bool,
                   dev: torch.device) -> "GradPlan":
    """The backward's metadata of a static pattern walked at tile ``t``
    (sub-blocks ``er, ec`` of ``eb``, packed as ``meta``): ``W^T``'s
    packing and walk for dL/dx, the SDDMM's runs for dL/dvalues.  The
    backward verdicts are set by ``_attach_grad``."""
    mp = walk_shape(shape[0], shape[1], t)[0]
    tp = partitioner.plan_transpose(er, ec, shape, eb)
    tmeta = partitioner.plan_packing(tp.row_idx, tp.col_idx, tp.shape,
                                     eb, t, t)
    unsort = gather = None
    if eb < t:
        # dL/dvalues is sampled on the forward packing's tiles
        s_rows, s_cols = meta.tile_rows, meta.tile_cols
        gather = partitioner.pack_index(meta, dev)
    else:
        order = np.lexsort((ec, er))
        s_rows, s_cols = er[order], ec[order]
        if not np.array_equal(order, np.arange(order.size)):
            unsort = torch.as_tensor(np.argsort(order), device=dev)
    return GradPlan(
        transpose=tp, packing=tmeta,
        perm=torch.as_tensor(tp.perm, dtype=torch.long, device=dev),
        pack_index=partitioner.pack_index(tmeta, dev),
        row_ptr=_on_dev(tmeta.row_ptr(), dev),
        tile_rows=_on_dev(tmeta.tile_rows, dev),
        tile_cols=_on_dev(tmeta.tile_cols, dev),
        block_row_ptr=_on_dev(sddmm_ops.block_row_ptr(s_rows, mp // t), dev),
        row_idx=_on_dev(s_rows, dev), col_idx=_on_dev(s_cols, dev),
        sddmm_block=t, unsort=unsort, gather=gather,
        mma=bsmm_ops.packing_schedule(tmeta, dev) if mma else None)


def _build_static(bsr: BlockSparseMatrix, n: int, dev: torch.device,
                  route: str, ctx: PlanContext,
                  with_grad: bool = True) -> MatmulPlan:
    """A static plan on ``route``; ``with_grad`` builds its backward's
    metadata (a race candidate and the dL/dx plan of W^T do without)."""
    m, k = bsr.shape
    b = bsr.block_size
    rows = np.asarray(bsr.row_idx, np.int32)
    cols = np.asarray(bsr.col_idx, np.int32)
    t, split = kernel_tile(b)
    mp, kp = walk_shape(m, k, t)
    # the pattern the static kernels walk: the operand's, or its split
    # (block z's sub-block (i, j) at z * split^2 + i * split + j, as
    # split_blocks orders the values)
    er, ec, eb = split_pattern(rows, cols, b, split)
    meta = partitioner.plan_packing(er, ec, (m, k), eb, t, t)
    # the bsmm kernels walk "mma" at this tile and dtype (at every n past
    # the decode walk's): record its schedules once, on the device
    mma = (route_device(dev) == "cuda"
           and bal_ops.walk(t, bsr.dtype) == "mma")
    p = MatmulPlan(kind="static", route=route, m=m, k=k, n=n,
                   dtype=bsr.dtype, device=dev, packing=meta,
                   row_ptr=_on_dev(meta.row_ptr(), dev),
                   tile_rows=_on_dev(meta.tile_rows, dev),
                   tile_cols=_on_dev(meta.tile_cols, dev),
                   pack_index=partitioner.pack_index(meta, dev),
                   ctx=ctx, block_size=b, split=split, walk_shape=(mp, kp),
                   pattern=(rows, cols))
    if with_grad:
        p.grad = _grad_metadata(er, ec, eb, meta, (m, k), t, mma, dev)
    art: Dict[str, Any] = {"nnz_blocks": len(rows),
                           "packing_tiles": meta.num_tiles,
                           "packing_occupancy": meta.occupancy,
                           "kernel_tile": t, "block_split": split,
                           "sub_block": eb, "walk_shape": (mp, kp)}
    family = _family(route)
    if family == "static" and mma:
        p.mma = bsmm_ops.packing_schedule(meta, dev)
    if family == "static_balanced":
        # on the mma walk a bin is a group of its rows: ceil(mb / R) bins;
        # the visit schedule of the plain version and the ffma walk is
        # built at the same count (any count gives the same result)
        if mma:
            bins = bal_ops.mma_bins(meta.grid[0], t)
        elif route_device(dev) == "cuda":
            bins = bal_ops.card_bins(meta.grid[0], n, t)
        else:
            bins = DEFAULT_BINS
        bm = partitioner.plan_packing_balanced(er, ec, (m, k), eb, t, t,
                                               num_bins=bins)
        rep = partitioner.balance_report(bm.swizzle.loads)
        art.update(swizzle_bins=bm.num_bins,
                   swizzle_steps_per_bin=bm.steps_per_bin,
                   swizzle_imbalance=rep["imbalance"], swizzle_cv=rep["cv"])
        p.visit = tuple(_on_dev(a, dev) for a in (
            bm.visit_rows, bm.visit_cols, bm.visit_slot))
        if mma:
            p.mma = bal_ops.balanced_schedule(bm, dev)
    if p.mma is not None:
        art.update(mma_groups=p.mma.groups, mma_stages=p.mma.stages)
    elif family != "static":
        # a dynamic or dense route on a static pattern: the pattern's
        # slots, all valid (capacity = nnz)
        p.pattern_dev = (_on_dev(rows, dev), _on_dev(cols, dev),
                         torch.tensor(len(rows), dtype=torch.int32,
                                      device=dev))
        if family in ("dynamic_grouped", "dynamic_grouped_balanced"):
            tg = gmm_ops.grouped_tile(m, k, b)
            # a static pattern's exact tile count is known at plan time
            # (of its sub-blocks, where the tile is not a block multiple)
            gr, gc, gb = (rows, cols, b) if tg % b == 0 else (er, ec, eb)
            p.tile = tg
            p.tiles_cap = partitioner.plan_packing(gr, gc, (m, k), gb,
                                                   tg, tg).num_tiles
            art.update(grouped_tile=tg, grouped_tiles_cap=p.tiles_cap)
    p.artifacts = art
    return p


def _build_dynamic(spec: OpSpec, dev: torch.device, route: str,
                   ctx: PlanContext, key: str,
                   disk_capacity: Optional[dict] = None) -> MatmulPlan:
    m, k, b = spec.m, spec.k, spec.block_size
    dplan = planner_lib.plan_dynamic(m, k, spec.n, d_max=spec.density,
                                     block_size=b, units=ctx.units)
    art: Dict[str, Any] = dict(bucket_blocks=dplan.bucket_blocks,
                               nnz_max_blocks=dplan.nnz_max_blocks,
                               q_m=dplan.q_m, q_k=dplan.q_k, q_n=dplan.q_n)
    p = MatmulPlan(kind="dynamic", route=route, m=m, k=k, n=spec.n,
                   dtype=getattr(torch, spec.dtype), device=dev, spec=spec,
                   ctx=ctx, key=key, artifacts=art, block_size=b)
    if _family(route) not in ("dynamic_grouped", "dynamic_grouped_balanced"):
        return p
    # planned capacity (paper §3.3 bucket sizing): expected distinct
    # tiles at d_max times the headroom, not the safe worst case
    t, capplan, _, _ = dispatch.grouped_capacity(
        m, k, b, spec.density, headroom=ctx.resolved_headroom())
    with _LOCK:
        stats = _CAPACITY.get(key)
        if stats is None:
            stats = _CAPACITY[key] = CapacityStats(
                key, tiles_cap=capplan.tiles_cap,
                worst_tiles=capplan.worst_tiles,
                overflow_threshold=ctx.overflow_threshold)
    stats.overflow_threshold = ctx.overflow_threshold
    # a persisted escalation (a disk record at policy "worst") carries
    # across restarts: the guardrail's verdict is part of the plan
    if disk_capacity is not None and disk_capacity.get("policy") == "worst":
        stats.escalated = True
    # guardrail: an escalated problem re-plans at worst-case capacity
    policy = ("worst" if (ctx.capacity_policy == "worst" or stats.escalated)
              else "planned")
    _, _, cap, clamped = dispatch.grouped_capacity(
        m, k, b, spec.density, headroom=ctx.resolved_headroom(),
        policy=policy)
    stats.tiles_cap = cap
    stats.worst_tiles = capplan.worst_tiles
    stats.clamped = stats.clamped or clamped
    art.update(grouped_tile=t, grouped_tiles_cap=cap,
               capacity=dict(capplan.as_dict(), policy=policy, tiles_cap=cap,
                             clamped=clamped, escalated=stats.escalated))
    p.tile, p.tiles_cap, p.capacity_stats = t, cap, stats
    return p


# ---------------------------------------------------------------------------
# Decision (re-planned overlay -> disk -> the H100 model or a measured race)
# ---------------------------------------------------------------------------

def _grad_covered(spec: OpSpec, ctx: PlanContext) -> bool:
    """Does this plan race and persist backward verdicts?  Static
    patterns under a differentiable caller."""
    return ctx.differentiable and spec.op == "spmm" and spec.kind == "static"


def _pattern_info(pkey: str, rows, cols, spec: OpSpec
                  ) -> Tuple[Tuple[float, float], dispatch.WalkCounts]:
    """A static pattern's skew (``dispatch.row_balance``) and walk counts
    (``dispatch.static_counts``), memoized per pattern: ``plan`` keys a
    plan by the skew, so a cache hit must not recount."""
    mk = (pkey, spec.m, spec.k, spec.block_size)
    with _LOCK:
        hit = _PATTERN_INFO.get(mk)
    if hit is not None:
        return hit
    info = (dispatch.row_balance(rows, spec.m, spec.k, spec.block_size),
            dispatch.static_counts(rows, cols, spec.m, spec.k,
                                   spec.block_size))
    with _LOCK:
        if len(_PATTERN_INFO) >= _PATTERN_INFO_MAX:
            _PATTERN_INFO.clear()
        _PATTERN_INFO[mk] = info
    return info


def _fingerprint(spec: OpSpec, ctx: PlanContext, dev: torch.device,
                 skew: Tuple[float, float]) -> tuple:
    """The plan's persistent identity: the decision key (shape, ``n``,
    block, density bucket, dtype, mode, measure, device type, the
    pattern's bucketed skew), the capacity sizing of a dynamic problem
    and the backward knobs of a static one, and the TP section (shard
    count, axis, split rule and the mesh's axis names and sizes) where
    the context shards.  The runtime-only knobs join the in-memory key
    only (``_mem_key``)."""
    base = dispatch._cache_key(spec.kind, spec.m, spec.k, spec.n,
                               spec.block_size, spec.density, spec.dtype,
                               ctx.mode, ctx.measure, dev.type, skew)
    q = ctx.resolved_tp_q()
    # a TP verdict belongs to the mesh it was raced on: the axis names
    # and sizes join the key (a 1 x 4 verdict must not answer for 2 x 2,
    # nor for a tp_q-only plan without a mesh)
    tp = (("tp", q, ctx.tp_axis, ctx.tp_balanced)
          + ctx.mesh_fingerprint()) if q else ()
    cap = (("cap", ctx.resolved_headroom(), ctx.capacity_policy, ctx.units)
           if spec.kind == "dynamic" else ())
    grad = (("grad", ctx.grad_mode, ctx.sddmm_mode)
            if _grad_covered(spec, ctx) else ())
    return ("plan", spec.op) + base + tp + cap + grad


def _mem_key(fp: tuple, pkey, dev: torch.device, ctx: PlanContext) -> tuple:
    """In-memory plan identity: the fingerprint, the concrete pattern and
    device, the persistence policy and the runtime-only knobs that change
    what a plan does but not its verdict (and the concrete mesh whose
    group a TP plan reduces over)."""
    persist = ctx.resolved_cache_dir() if ctx.persistence_on() else None
    # a plan on a concrete mesh holds its process group
    mesh = id(ctx.mesh) if is_concrete(ctx.mesh) else None
    return (fp, pkey, str(dev), persist, ctx.overflow_threshold,
            ctx.telemetry, ctx.differentiable, ctx.evolve_drift, mesh)


def _admissible(cands, spec: OpSpec, ctx: PlanContext) -> Tuple[str, ...]:
    """The candidates whose kernels' contracts admit the problem (a
    forced route that does not raises with the contract's reason)."""
    ok, first = [], None
    for r in cands:
        try:
            _check_plan_contracts(r, spec, ctx)
        except ValueError as e:
            first = first or e
            continue
        ok.append(r)
    if not ok:
        raise first
    return tuple(ok)


def _as_rows(x, k: int) -> torch.Tensor:
    """``x [..., k]`` (or ``[n, k]``) as contiguous ``[N, k]`` rows."""
    return x.reshape(-1, k).contiguous()


def _race_runner(spec: OpSpec, operand, x: torch.Tensor,
                 dev: torch.device, ctx: PlanContext, key: str):
    """route -> (the callable the plan would run on it, its arguments):
    a candidate plan built for the race (not cached, no backward),
    packed once as serving packs it.  Dropped after its timing, so a
    route that loses keeps no dense copy or tile stack."""
    race_ctx = dataclasses.replace(ctx, telemetry=False, cache=False)

    def runner(route):
        if spec.kind == "static":
            q = _build_static(operand, int(spec.n), dev, route, race_ctx,
                              with_grad=False)
            vals = operand.values.to(device=dev, dtype=q.dtype)
            packed = q.pack(vals)
            x2 = _as_rows(x, spec.k).to(q.dtype)
            return (lambda xx, pk: q.run_packed(pk, xx)), (x2, packed)
        q = _build_dynamic(spec, dev, route, race_ctx, key)
        op = operand
        x2 = _as_rows(x, spec.k).to(q.dtype)
        return (lambda xx, v: q.run_dynamic(
            dataclasses.replace(op, values=v), xx)), (x2, op.values)
    return runner


def _decide(spec: OpSpec, ctx: PlanContext, operand, x, dev: torch.device,
            key: str, counts: Optional[dispatch.WalkCounts],
            skew: Tuple[float, float]):
    """-> (route, est_seconds, source, from_disk, disk_capacity,
    disk_grad, tp_source), in the reference's order: the re-planner's
    overlay, the disk cache, then ``dispatch.decide`` (analytic, or
    measured with ``ctx.measure``, concrete ``x`` and no capture in
    progress) and, with a mesh, the TP routes beside it.  ``tp_source``
    labels the TP entries of ``est_seconds`` apart from the verdict."""
    dt = route_device(dev)
    if ctx.measure and dev.type == "meta":
        raise ValueError("a measured route race needs a card: a meta "
                         "operand plans on the analytic models "
                         "(PlanContext(measure=False))")
    routes = PLAN_ROUTES[dt] + TP_ROUTES
    rec = _REPLANNED.get(key)
    if rec is None and ctx.cache and ctx.persistence_on():
        rec = cache_lib.load_decision(ctx.resolved_cache_dir(), key)
    if rec is not None and rec.get("route") == "static_tp_shardmap" \
            and not ctx.shardmap_executable():
        rec = None      # raced on a concrete mesh of this shape: not here
    if rec is not None and rec.get("route") in routes:
        return (rec["route"], dict(rec.get("est_seconds", {})),
                rec.get("source", "analytic"), True, rec.get("capacity"),
                rec.get("grad"), rec.get("tp_source", rec.get("source")))
    cache_lib.bump("decisions")
    q = ctx.resolved_tp_q()
    concrete = (operand is not None and x is not None
                and not dispatch.capturing())
    if spec.mode in TP_ROUTES:
        return _decide_forced_tp(spec, ctx, operand, x, dev, q, counts,
                                 skew, concrete)
    cands = _admissible(dispatch._candidates(spec.kind, ctx.mode, dt),
                        spec, ctx)
    measure = ctx.measure and concrete and len(cands) > 1
    runner = _race_runner(spec, operand, x, dev, ctx, key) \
        if measure else None
    dkey = dispatch._cache_key(spec.kind, spec.m, spec.k, spec.n,
                               spec.block_size, spec.density, spec.dtype,
                               spec.mode, measure, dt, skew)
    fresh = dkey not in dispatch._decision_cache
    agree = _mesh_agreement(ctx, dev) if measure else None
    dec = dispatch.decide(spec, dt, counts=counts, skew=skew,
                          candidates=cands, measure=measure, runner=runner,
                          cache=ctx.cache, agree=agree)
    if dec.source == "measured" and (fresh or not ctx.cache):
        cache_lib.bump("measurements")
    route, est, source = dec.route, dict(dec.est_seconds), dec.source
    # the mesh-aware candidates (a static pattern under "auto" with a
    # mesh): timed beside the unsharded routes when those were, else
    # priced; a modelled TP time never overturns a measured verdict
    tp_routes = (_tp_candidates(spec, ctx, q)
                 if spec.mode == "auto" and ctx.mesh is not None else ())
    tp_source = None
    if tp_routes:
        for r in tp_routes:
            est[r] = _tp_estimate(spec, q, r, counts, skew)
        tp_source = "analytic"
        if source == "measured":
            timed = {r: _measure_tp_route(r, spec, ctx, operand, x, dev)
                     for r in tp_routes}
            est.update(timed if agree is None else agree(timed))
            tp_source = "measured"
            cache_lib.bump("measurements")
            route = dispatch.measured_pick(est, route)
        elif est[min(tp_routes, key=est.get)] < est[route]:
            route = min(tp_routes, key=est.get)
    return route, est, source, False, None, None, tp_source


def _mesh_agreement(ctx: PlanContext, dev: torch.device):
    """On a concrete mesh, the measured times every rank decides on: each
    candidate's slowest time over the mesh (one all-reduce), so ranks
    that time the same calls apart still pick one route and run their
    collectives in lockstep; None off a concrete mesh."""
    if not is_concrete(ctx.mesh):
        return None
    from repro_torch.launch import mesh as mesh_lib
    group = mesh_lib.axes_group(ctx.mesh, mesh_lib.mesh_axes(ctx.mesh)[0])
    if group is None:
        return None

    def agree(times: Dict[str, float]) -> Dict[str, float]:
        import torch.distributed as dist
        names = sorted(times)
        t = torch.tensor([times[n] for n in names], dtype=torch.float64,
                         device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        return dict(zip(names, t.tolist()))
    return agree


def _decide_forced_tp(spec: OpSpec, ctx: PlanContext, operand, x,
                      dev: torch.device, q: Optional[int], counts, skew,
                      concrete: bool):
    """A TP mode: "static_tp_shardmap" forces the explicit route (a
    concrete mesh with ``tp_axis`` of size ``q``); "static_tp" is the
    family, racing both routes where both can run (timed with
    ``ctx.measure`` and concrete inputs)."""
    if spec.kind != "static":
        raise ValueError(f"mode {spec.mode!r} cannot execute a "
                         f"{spec.kind} operand")
    if not q:
        raise ValueError(f"mode {spec.mode!r} needs ctx.mesh (with "
                         "ctx.tp_axis) or an explicit ctx.tp_q")
    if spec.mode == "static_tp_shardmap":
        if not ctx.shardmap_executable():
            raise ValueError(
                "mode 'static_tp_shardmap' needs a concrete "
                f"ctx.mesh with axis {ctx.tp_axis!r} of size q={q} "
                "(an abstract mesh or a bare tp_q can only execute "
                "the 'static_tp' route)")
        cands: Tuple[str, ...] = ("static_tp_shardmap",)
    else:
        cands = _tp_candidates(spec, ctx, q) or ("static_tp",)
    est = {r: _tp_estimate(spec, q, r, counts, skew) for r in cands}
    source = "forced"
    if ctx.measure and len(cands) > 1 and concrete:
        est = {r: _measure_tp_route(r, spec, ctx, operand, x, dev)
               for r in cands}
        cache_lib.bump("measurements")
        source = "measured"
    return min(est, key=est.get), est, source, False, None, None, source


def _tp_estimate(spec: OpSpec, q: int, route: str = "static_tp",
                 counts: Optional[dispatch.WalkCounts] = None,
                 skew: Tuple[float, float] = (1.0, 0.0)) -> float:
    """The analytic prior of a TP route (paper Fig. 1a across cards): the
    static route's H100 time over ``q`` (nnz-balanced shards) plus one
    reduction of the ``[n, m]`` output over NVLink
    (``NVLINK_BYTES_PER_S``, the datasheet's rate).  ``static_tp`` is
    priced 5 % above the explicit route, as the reference does, so a tie
    between two unmeasured routes goes to the pinned schedule."""
    t_local = dispatch._estimate(
        "static_cuda", spec.m, spec.k, spec.n, spec.block_size,
        spec.density, spec.dtype, imbalance=skew[0], cv=skew[1],
        counts=counts, kind="static") / max(1, q)
    bytes_el = max(1, getattr(torch, spec.dtype).itemsize)
    t_reduce = (spec.m * spec.n * bytes_el) * max(0, q - 1) / max(1, q) \
        / NVLINK_BYTES_PER_S
    penalty = 1.05 if route == "static_tp" else 1.0
    return (t_local + t_reduce) * penalty


def _tp_candidates(spec: OpSpec, ctx: PlanContext,
                   q: Optional[int]) -> Tuple[str, ...]:
    """The TP routes that can run this plan: ``static_tp`` anywhere (its
    sum is local), the explicit route on a concrete mesh whose
    ``tp_axis`` has size ``q``."""
    if spec.kind != "static" or spec.op != "spmm" or not q or q < 2:
        return ()
    routes = ["static_tp"]
    if ctx.shardmap_executable():
        routes.append("static_tp_shardmap")
    return tuple(routes)


# the k-partition of a pattern, per (pattern, shape, block, q, split
# rule): a race and the plan it builds partition once
_SHARD_META: Dict[Tuple, partitioner.KShardPlan] = {}


def _shard_meta_for(bsr: BlockSparseMatrix, q: int,
                    balanced: bool) -> partitioner.KShardPlan:
    key = (pattern_key(bsr.row_idx, bsr.col_idx), tuple(bsr.shape),
           bsr.block_size, q, balanced)
    with _LOCK:
        meta = _SHARD_META.get(key)
    if meta is None:
        meta = partitioner.plan_k_shards(bsr, q, balanced=balanced)
        with _LOCK:
            if len(_SHARD_META) >= _PATTERN_INFO_MAX:
                _SHARD_META.clear()
            meta = _SHARD_META.setdefault(key, meta)
    return meta


def _build_tp(bsr: BlockSparseMatrix, n: int, dev: torch.device,
              route: str, ctx: PlanContext,
              with_grad: bool = True) -> MatmulPlan:
    """A TP plan on ``route``: the k-partition and a static plan per shard
    this process runs, forced to the device's static route (no nested
    race) with its backward on bsmm and the SDDMM."""
    q = ctx.resolved_tp_q()
    meta = _shard_meta_for(bsr, q, ctx.tp_balanced)
    m, k = bsr.shape
    b = bsr.block_size
    shard_route = ROUTES[("static", route_device(dev))]
    dv_route = SDDMM_ROUTES[route_device(dev)]
    group = None
    if route == "static_tp_shardmap":
        group, r = tp_lib.tp_group(ctx.mesh, ctx.tp_axis)
        shards: Tuple[int, ...] = (r,)
    else:
        shards = tuple(range(q))
    sub_ctx = dataclasses.replace(ctx, mode="static", mesh=None, tp_q=None,
                                  telemetry=False, cache=False, pool=None)
    plans, src, tiles = [], [], []
    for j in shards:
        rows, cols = meta.shard_pattern(j)
        if not len(rows):
            plans.append(None)
            src.append(torch.zeros(0, dtype=torch.long, device=dev))
            tiles.append(0)
            continue
        shard = BlockSparseMatrix(torch.empty((0, b, b), dtype=bsr.dtype),
                                  rows, cols, (m, k), b)
        sp = _build_static(shard, n, dev, shard_route, sub_ctx,
                           with_grad=with_grad)
        sp.spec = OpSpec.from_operand(shard, n, mode="static")
        if with_grad:
            _set_grad_routes(sp, shard_route, dv_route)
        plans.append(sp)
        src.append(torch.as_tensor(meta.shard_source(j), dtype=torch.long,
                                   device=dev))
        tiles.append(sp.packing.num_tiles)
    bal = partitioner.balance_report(meta.real_counts)
    p = MatmulPlan(kind="static", route=route, m=m, k=k, n=n,
                   dtype=bsr.dtype, device=dev, ctx=ctx, block_size=b,
                   pattern=(np.asarray(bsr.row_idx, np.int32),
                            np.asarray(bsr.col_idx, np.int32)))
    p.tp = TPShards(meta, shards, tuple(plans), tuple(src), tuple(tiles),
                    {"dx": shard_route, "dvalues": dv_route}, group)
    p.artifacts = {"nnz_blocks": len(bsr.row_idx), "tp_q": q,
                   "tp_axis": ctx.tp_axis, "tp_route": route,
                   "tp_balanced": ctx.tp_balanced,
                   "tp_imbalance": bal["imbalance"], "tp_slots": meta.slots,
                   "tp_boundaries": [int(v) for v in meta.boundaries]}
    return p


def _measure_tp_route(route: str, spec: OpSpec, ctx: PlanContext, operand,
                      x, dev: torch.device) -> float:
    """Time one TP route on the device as the race times every other
    route (``dispatch.measure_callable``: CUDA events on a card), on a
    candidate plan built for it: its shards' launches and, on the
    explicit route, the all-reduce (every rank of the group plans
    together, so every rank times the same calls)."""
    race_ctx = dataclasses.replace(ctx, telemetry=False, cache=False)
    q = _build_tp(operand, int(spec.n), dev, route, race_ctx,
                  with_grad=False)
    vals = operand.values.to(device=dev, dtype=q.dtype)
    packed = q.pack(vals)
    x2 = _as_rows(x, spec.k).to(q.dtype)
    return dispatch.measure_callable(lambda xx, pk: q.run_packed(pk, xx),
                                     x2, packed)


def _tp_decision(ctx: PlanContext, route: str, est: Dict[str, float],
                 source: str, tp_source: Optional[str]) -> Optional[dict]:
    """The TP section of a plan's report: what the race saw and where the
    crossover sits.  ``tp_speedup_vs_unsharded`` is the best unsharded
    time over the best TP time (> 1: past the crossover on this mesh),
    reported only where both sides carry one unit (both measured or
    both modelled)."""
    tp_est = {r: est[r] for r in TP_ROUTES if r in est}
    if not tp_est:
        return None
    q = ctx.resolved_tp_q()
    best_tp = min(tp_est, key=tp_est.get)
    unsh = {r: v for r, v in est.items() if r not in TP_ROUTES}
    best_un = min(unsh, key=unsh.get) if unsh else None
    tp_source = tp_source or source
    comparable = best_un is None or tp_source == source
    speedup = (est[best_un] / est[best_tp]
               if best_un is not None and comparable else None)
    mesh_fp = ctx.mesh_fingerprint()
    return {
        "q": q, "axis": ctx.tp_axis, "balanced": ctx.tp_balanced,
        "mesh": ({n: v for n, v in zip(*mesh_fp)} if mesh_fp else None),
        "candidates": {r: tp_est[r] for r in
                       sorted(tp_est, key=tp_est.get)},
        "chosen": route if route in TP_ROUTES else None,
        "best_tp_route": best_tp,
        "best_unsharded_route": best_un,
        "source": tp_source,
        "tp_speedup_vs_unsharded": (round(speedup, 4)
                                    if speedup is not None else None),
        "tp_wins": bool(speedup is not None and speedup > 1.0),
    }


def _grad_verdict(est: Dict[str, float], forced: bool,
                  measured: Optional[Dict[str, float]] = None) -> dict:
    """One backward product's verdict: the model's minimum, or what a
    measured race installs over it (``dispatch.measured_pick``).  A
    measured verdict publishes only the measured entries (model seconds
    and device timings are not one unit)."""
    route = min(est, key=est.get)
    source = "forced" if forced else "analytic"
    if measured:
        route = dispatch.measured_pick(measured, route)
        est, source = measured, "measured"
    return {"route": route, "source": source,
            "est_seconds": {r: float(v) for r, v in est.items()}}


def _transposed(p: MatmulPlan):
    """``(W^T's BSR with placeholder values, the value permutation)``:
    the transposed pattern at the logical block, in lexsort order."""
    rows, cols = p.pattern
    tp = partitioner.plan_transpose(rows, cols, (p.m, p.k), p.block_size)
    bsr_t = BlockSparseMatrix(torch.empty(0, dtype=p.dtype), tp.row_idx,
                              tp.col_idx, (p.k, p.m), p.block_size)
    return bsr_t, tp.perm


def _set_grad_routes(p: MatmulPlan, dx_route: str, dv_route: str) -> None:
    """Point ``p``'s backward at its verdicts: a forward-only plan of W^T
    where dL/dx leaves the bsmm walk, the pattern on the device where
    dL/dvalues takes the dense product."""
    g = p.grad
    g.dx_route, g.dv_route = dx_route, dv_route
    g.dx_plan = g.dx_perm = g.dv_pattern = None
    if _family(dx_route) != "static":
        bsr_t, perm = _transposed(p)
        g.dx_plan = _build_static(
            bsr_t, p.n, p.device, dx_route,
            dataclasses.replace(p.ctx, telemetry=False), with_grad=False)
        g.dx_perm = torch.as_tensor(perm, dtype=torch.long, device=p.device)
    if _family(dv_route) == "sddmm_dense":
        rows, cols = p.pattern
        g.dv_pattern = (torch.as_tensor(rows, dtype=torch.long,
                                        device=p.device),
                        torch.as_tensor(cols, dtype=torch.long,
                                        device=p.device))


def _grad_decide(p: MatmulPlan, spec: OpSpec, ctx: PlanContext, x,
                 disk_grad: Optional[dict]) -> dict:
    """The backward verdicts of a static plan (dL/dx: an SpMM on the
    transposed ``[k, m]`` problem; dL/dvalues: the SDDMM or the dense
    product and a gather): a disk replay when the forward record carried
    them, else the model's race over the admissible candidates, timed on
    the device when ``ctx.measure`` and ``x`` is concrete (dy is zeros
    of the output's shape).  Sets ``p``'s backward on the winners."""
    dt = dev_type = route_device(p.device)
    routes = PLAN_ROUTES[dt]
    # dL/dx runs a forward plan of W^T: its kernels' contracts must admit
    # the transposed problem, whether the route is raced, forced or read
    # back from disk
    spec_t = dataclasses.replace(spec, m=spec.k, k=spec.m, mode="auto")
    ctx_t = dataclasses.replace(ctx, differentiable=False)
    if disk_grad is not None \
            and disk_grad.get("dx", {}).get("route") in routes \
            and disk_grad.get("dvalues", {}).get("route") in \
            dispatch.sddmm_candidates(dt):
        _check_plan_contracts(disk_grad["dx"]["route"], spec_t, ctx_t)
        _set_grad_routes(p, disk_grad["dx"]["route"],
                         disk_grad["dvalues"]["route"])
        return dict(disk_grad, from_disk=True)
    cache_lib.bump("decisions")
    rows, cols = p.pattern
    b = spec.block_size
    dx_forced = ctx.grad_mode != "auto"
    dx_cands = _admissible(
        (port_route("static", ctx.grad_mode, dev_type),) if dx_forced
        else dispatch._candidates("static", "auto", dev_type), spec_t, ctx_t)
    dv_forced = ctx.sddmm_mode != "auto"
    dv_cands = ((sddmm_route(ctx.sddmm_mode, dev_type),) if dv_forced
                else dispatch.sddmm_candidates(dev_type))
    counts = dispatch.static_counts(rows, cols, spec.m, spec.k, b)
    counts_t = dispatch.static_counts(cols, rows, spec.k, spec.m, b)
    imb_t, cv_t = dispatch.row_balance(cols, spec.k, spec.m, b)
    dx_est = {r: dispatch._estimate(r, spec.k, spec.m, spec.n, b,
                                    spec.density, spec.dtype,
                                    imbalance=imb_t, cv=cv_t,
                                    counts=counts_t) for r in dx_cands}
    dv_est = {r: dispatch._estimate(r, spec.m, spec.k, spec.n, b,
                                    spec.density, spec.dtype, counts=counts)
              for r in dv_cands}
    dx_meas = dv_meas = None
    if ctx.measure and x is not None and not dispatch.capturing():
        x2 = _as_rows(x, spec.k).to(p.dtype)
        dy = torch.zeros((x2.shape[0], spec.m), dtype=p.dtype,
                         device=p.device)
        v = torch.zeros((len(rows), b, b), dtype=p.dtype, device=p.device)
        dx_meas, dv_meas = {}, {}
        for r in dx_cands:
            _set_grad_routes(p, r, dv_cands[0])
            dx_meas[r] = dispatch.measure_callable(p.grad_dx, v, dy)
        for r in dv_cands:
            _set_grad_routes(p, dx_cands[0], r)
            dv_meas[r] = dispatch.measure_callable(p.grad_dvalues, dy, x2)
        cache_lib.bump("measurements")
    grad = {"dx": _grad_verdict(dx_est, dx_forced, dx_meas),
            "dvalues": _grad_verdict(dv_est, dv_forced, dv_meas),
            "from_disk": False}
    _set_grad_routes(p, grad["dx"]["route"], grad["dvalues"]["route"])
    return grad


def _tp_grad_section(p: MatmulPlan) -> dict:
    """The backward section of a TP plan: its shards' static plans run
    dL/dx (bsmm on each transposed shard) and dL/dvalues (the SDDMM), a
    fixed formulation, not raced."""
    return {"mode": "planned",
            **{side: {"route": route, "source": "forced", "est_seconds": {}}
               for side, route in p.tp.grad_routes.items()},
            "from_disk": False, "sharded": p.artifacts["tp_route"]}


def _record(p: MatmulPlan) -> dict:
    """The verdict ``plan()`` persists: route, source and estimates, the
    planned capacity (without its running ``escalated`` flag), the
    backward verdicts, and the source of the TP routes' estimates (a
    replay reports the crossover in the unit it was raced in)."""
    rec = {"route": p.route, "source": p.source,
           "est_seconds": {r: float(v) for r, v in p.est_seconds.items()}}
    if p.artifacts.get("_tp_source") is not None:
        rec["tp_source"] = p.artifacts["_tp_source"]
    cap = p.artifacts.get("capacity")
    if cap:
        rec["capacity"] = {k2: v for k2, v in cap.items()
                           if k2 != "escalated"}
    grad = p.artifacts.get("grad")
    if grad and grad.get("mode") == "planned" and "dx" in grad \
            and p.tp is None:
        rec["grad"] = {side: {k2: grad[side][k2]
                              for k2 in ("route", "source", "est_seconds")}
                       for side in ("dx", "dvalues")}
    return rec


def plan(operand_or_spec: Union[Operand, OpSpec], n: Optional[int] = None,
         *, x: Optional[torch.Tensor] = None, device: DeviceLike = None,
         ctx: Optional[PlanContext] = None) -> MatmulPlan:
    """Plan ``operand`` for ``n`` activation rows on ``device`` (``cuda``
    unless the caller names another device) under ``ctx``.

    ``operand_or_spec`` is a ``BlockSparseMatrix`` (static kind, ``[m,
    k]``), a ``DynamicOperand`` (dynamic kind), a dense weight tensor
    ``w [k, m]`` (dense kind), or an ``OpSpec`` of the dynamic or dense
    kind (a static plan needs its pattern).  ``x`` (the ``[n, k]``
    activations) is read only by a measured race
    (``PlanContext(measure=True)``).  ``ctx=None`` takes the ambient
    context (``use_ctx``)."""
    ctx = ctx or current_ctx()
    dev = resolve_device(device)
    if isinstance(operand_or_spec, OpSpec):
        spec = operand_or_spec
        if spec.kind == "static":
            raise ValueError("a static plan needs its pattern: plan the "
                             "BlockSparseMatrix, not an OpSpec")
        if ctx.mode != spec.mode:
            ctx = dataclasses.replace(ctx, mode=spec.mode)
        operand = None
        if n is not None:
            spec = dataclasses.replace(spec, n=int(n))
    else:
        operand = operand_or_spec
        if n is None:
            raise ValueError("plan(operand, n): n is required when "
                             "planning from a concrete operand")
        if isinstance(operand, torch.Tensor):
            if operand.dim() != 2:
                raise ValueError(f"dense operand must be [k, m], got "
                                 f"{tuple(operand.shape)}")
            k_, m_ = operand.shape
            spec = OpSpec(kind="dense", m=m_, k=k_, n=int(n),
                          dtype=operand.dtype, op="matmul", mode=ctx.mode)
            operand = None           # one candidate: nothing to race
        else:
            spec = OpSpec.from_operand(operand, n, mode=ctx.mode)
    pkey, skew, counts = None, (1.0, 0.0), None
    if spec.kind == "static":
        pkey = pattern_key(operand.row_idx, operand.col_idx)
        skew, counts = _pattern_info(pkey, operand.row_idx, operand.col_idx,
                                     spec)
    fp = _fingerprint(spec, ctx, dev, skew)
    mem_key = _mem_key(fp, pkey, dev, ctx)
    _register(mem_key, ctx)
    if ctx.cache:
        with _LOCK:
            hit = _cached(mem_key)
        if hit is not None:
            cache_lib.bump("plan_hits")
            capture.hold_plan(hit)
            return hit
    key = cache_lib.key_string(fp)
    if spec.kind == "dynamic":
        counts = dispatch.dynamic_counts(
            spec.m, spec.k, spec.block_size, spec.density,
            headroom=ctx.resolved_headroom(), policy=ctx.capacity_policy)
    route, est, source, from_disk, disk_cap, disk_grad, tp_source = \
        _decide(spec, ctx, operand, x, dev, key, counts, skew)
    _check_plan_contracts(route, spec, ctx)
    if route in TP_ROUTES:
        p = _build_tp(operand, int(spec.n), dev, route, ctx,
                      with_grad=ctx.differentiable)
    elif spec.kind == "static":
        p = _build_static(operand, int(spec.n), dev, route, ctx,
                          with_grad=ctx.differentiable)
    elif spec.kind == "dynamic":
        p = _build_dynamic(spec, dev, route, ctx, key, disk_cap)
    else:
        p = MatmulPlan(kind="dense", route=route, m=spec.m, k=spec.k,
                       n=int(spec.n), dtype=getattr(torch, spec.dtype),
                       device=dev, ctx=ctx)
        if spec.op == "batched_matmul" and route == "dense_cuda":
            p.row_tile = batched_row_tile(
                spec.m, gmm_ops.tma_ok(spec.k, spec.n, p.dtype))
            p.artifacts = {"kernel": "gmm", "row_tile": p.row_tile}
    p.spec = p.spec or spec
    p.key, p.mem_key = key, mem_key
    p.source, p.est_seconds, p.from_disk = source, est, from_disk
    if p.tp is not None and ctx.differentiable:
        p.artifacts["grad"] = _tp_grad_section(p)
    elif _grad_covered(spec, ctx):
        p.artifacts["grad"] = dict(_grad_decide(p, spec, ctx, x, disk_grad),
                                   mode="planned")
    tp_info = _tp_decision(ctx, route, est, source, tp_source)
    if tp_info is not None:
        p.artifacts["tp"] = tp_info
        p.artifacts["_tp_source"] = tp_source
    cache_lib.bump("plans_built")
    # persist the verdict once, with its capacity and backward sections;
    # an identical record (a disk hit rebuilt) writes nothing
    persist = ctx.cache and ctx.persistence_on()
    if persist:
        cache_lib.store_decision(ctx.resolved_cache_dir(), key, _record(p))
    with _LOCK:
        if ctx.cache:
            p = _PLANS.setdefault(mem_key, p)
    capture.hold_plan(p)
    stats = p.capacity_stats
    if ctx.cache and stats is not None:
        esc = None
        if persist and "capacity" in p.artifacts:
            # the escalated verdict is persisted when it trips: a holder
            # that never plans again (the engine) still restarts at worst
            esc = _record(p)
            esc["capacity"] = dict(esc["capacity"], policy="worst",
                                   tiles_cap=esc["capacity"]["worst_tiles"])
        esc_dir = ctx.resolved_cache_dir()

        def _escalate_trip():
            # the next plan() of this problem re-plans at worst case
            with _LOCK:
                if _PLANS.get(mem_key) is p:
                    del _PLANS[mem_key]
            if esc is not None:
                cache_lib.store_decision(esc_dir, key, esc)
        stats._on_escalate = _escalate_trip
    return p


# ---------------------------------------------------------------------------
# Evolution (MatmulPlan.evolve): RigL topology steps on static plans
# ---------------------------------------------------------------------------

# the pattern properties the H100 walk models price (the drift profile)
_PROFILE = ("density", "occupancy", "skew")


def _as_static_bsr(new_pattern, p: MatmulPlan) -> BlockSparseMatrix:
    """``evolve``'s pattern argument as a static BSR of ``p``'s problem
    (zero values on the host: a plan reads the pattern only)."""
    b = p.block_size
    shape = (p.m, p.k)
    grid = (-(-p.m // b), -(-p.k // b))
    if isinstance(new_pattern, BlockSparseMatrix):
        if new_pattern.shape != shape or new_pattern.block_size != b:
            raise ValueError(
                f"evolved pattern {new_pattern.shape} at block "
                f"{new_pattern.block_size} != the plan's {shape} at block "
                f"{b}: evolve changes the pattern, never the problem")
        check_unique_blocks(new_pattern.row_idx, new_pattern.col_idx, grid)
        return new_pattern
    if isinstance(new_pattern, tuple) and len(new_pattern) == 2:
        rows = np.asarray(new_pattern[0], np.int32)
        cols = np.asarray(new_pattern[1], np.int32)
        check_unique_blocks(rows, cols, grid)
        return BlockSparseMatrix(torch.zeros((len(rows), b, b),
                                             dtype=p.dtype),
                                 rows, cols, shape, b)
    mask = np.asarray(new_pattern, bool)
    if mask.shape != grid:
        raise ValueError(f"evolved block mask {mask.shape} != grid {grid}")
    return BlockSparseMatrix.from_mask(mask, b, dtype=p.dtype)


def _pattern_profile(rows, cols, spec: OpSpec) -> Dict[str, float]:
    """The drift metric's inputs: what the H100 walk models price of a
    static pattern.  The block density; the occupancy of the tiles the
    static kernels walk (``kernel_tile``: b in 4..64 walks each block as
    its tile, so this is 1.0 but for the pad tiles of empty tile-rows,
    and the 4 x 4 packing's below 4); the skew factor of its row
    imbalance (``dispatch._skew_factor``, 1.0 below the knee)."""
    b = spec.block_size
    skew, counts = _pattern_info(pattern_key(rows, cols), rows, cols, spec)
    mb, kb = -(-spec.m // b), -(-spec.k // b)
    t = counts.tile
    area = counts.tiles * t * t
    return {"density": len(rows) / max(1, mb * kb),
            "occupancy": len(rows) * b * b / area if area else 0.0,
            "skew": dispatch._skew_factor(*skew)}


def _persist_lineage(p: MatmulPlan, lineage: dict) -> None:
    """Write the evolved verdict and its lineage at the evolved plan's
    key, so a restart replays its forward and backward verdicts with
    zero measurements and the lineage outlives the process."""
    ctx = p.ctx
    if not (ctx.cache and ctx.persistence_on()):
        return
    cdir = ctx.resolved_cache_dir()
    rec = cache_lib.load_decision(cdir, p.key) or _record(p)
    cache_lib.store_decision(cdir, p.key, dict(rec, evolution=lineage))


def _supersede(parent: MatmulPlan) -> None:
    """Mark ``parent`` superseded at a new epoch and move it from the
    plan cache to the weak table (live while something holds it)."""
    global _EPOCH
    with _LOCK:
        _EPOCH += 1
        parent.superseded = _EPOCH
        if parent.ctx.cache and _PLANS.get(parent.mem_key) is parent:
            del _PLANS[parent.mem_key]
            _SUPERSEDED[parent.mem_key] = parent


def _evolve_plan(parent: MatmulPlan, new_bsr: BlockSparseMatrix,
                 rerace: Optional[bool], x) -> MatmulPlan:
    ctx, dev = parent.ctx, parent.device
    new_rows = np.asarray(new_bsr.row_idx, np.int32)
    new_cols = np.asarray(new_bsr.col_idx, np.int32)
    pk_new = pattern_key(new_rows, new_cols)
    children = parent.artifacts.setdefault("_children", {})
    if not rerace:
        # the modules sharing the parent (an LM's layers) evolve onto the
        # same pattern one after the other: one plan for all of them
        ref = children.get(pk_new)
        child = ref() if ref is not None else None
        if child is not None and is_live(child):
            _supersede(parent)
            return child
    old_rows, old_cols = parent.pattern
    spec = OpSpec.from_operand(new_bsr, parent.n, mode=parent.spec.mode)
    eplan = partitioner.plan_evolution(old_rows, old_cols, new_rows,
                                       new_cols, new_bsr.grid)
    prof = _pattern_profile(new_rows, new_cols, spec)
    parent_ev = parent.artifacts.get("evolution")
    if parent_ev:
        # the drift reference is the profile the live verdicts were raced
        # on: inherited down the chain, reset by a re-race
        ref_prof = {q: parent_ev[f"ref_{q}"] for q in _PROFILE}
        gen, root = parent_ev["generation"] + 1, parent_ev["root_key"]
    else:
        ref_prof = _pattern_profile(old_rows, old_cols, parent.spec)
        gen, root = 1, parent.key
    thr = ctx.evolve_drift
    drift = max(abs(prof[q] - ref_prof[q]) / max(ref_prof[q], 1e-12)
                for q in _PROFILE)
    tripped = thr is not None and drift > thr
    do_rerace = tripped if rerace is None else bool(rerace)
    with _LOCK:
        _EVOLUTION["evolves"] += 1
        _EVOLUTION["drift_trips"] += int(tripped)
        _EVOLUTION["reraces"] += int(do_rerace)
    lineage = {"parent_key": parent.key, "root_key": root,
               "generation": gen, "drift": round(float(drift), 6),
               "drift_threshold": thr, "drift_tripped": bool(tripped),
               "reraced": bool(do_rerace), "carried": eplan.carried,
               "dropped": eplan.dropped, "grown": eplan.grown,
               **{q: round(float(prof[q]), 6) for q in _PROFILE}}
    base = prof if do_rerace else ref_prof
    lineage.update({f"ref_{q}": round(float(base[q]), 6) for q in _PROFILE})
    if do_rerace:
        p = plan(new_bsr, spec.n, x=x, device=dev, ctx=ctx)
    else:
        # the verdict-reuse path: the new pattern's walk on the parent's
        # route and backward routes, no decision, no measurement
        _check_plan_contracts(parent.route, spec, ctx)
        if parent.tp is not None:
            p = _build_tp(new_bsr, spec.n, dev, parent.route, ctx,
                          with_grad="grad" in parent.artifacts)
        else:
            p = _build_static(new_bsr, spec.n, dev, parent.route, ctx,
                              with_grad=parent.grad is not None)
        skew, _ = _pattern_info(pk_new, new_rows, new_cols, spec)
        fp = _fingerprint(spec, ctx, dev, skew)
        p.spec, p.key = spec, cache_lib.key_string(fp)
        p.mem_key = _mem_key(fp, pk_new, dev, ctx)
        p.source, p.est_seconds = parent.source, dict(parent.est_seconds)
        p.from_disk = parent.from_disk
        if parent.grad is not None:
            _set_grad_routes(p, parent.grad.dx_route, parent.grad.dv_route)
        if "grad" in parent.artifacts:
            # inherited from the parent in memory: its disk provenance
            p.artifacts["grad"] = dict(parent.artifacts["grad"],
                                       evolved=True)
        for k2 in ("tp", "_tp_source"):
            if k2 in parent.artifacts:
                p.artifacts[k2] = parent.artifacts[k2]
        cache_lib.bump("plans_built")
        if ctx.cache:
            with _LOCK:
                # the evolved plan is this pattern's continuation: a
                # plan() of it must hit with zero decisions
                _PLANS[p.mem_key] = p
                _SUPERSEDED.pop(p.mem_key, None)
    p.artifacts["evolution"] = lineage
    p.artifacts["_evolve"] = eplan
    _persist_lineage(p, lineage)
    children[pk_new] = weakref.ref(p)
    _supersede(parent)
    return p


def evolve(plan_: MatmulPlan, new_pattern, *,
           rerace: Optional[bool] = None,
           x: Optional[torch.Tensor] = None) -> MatmulPlan:
    """Module-level spelling of ``plan_.evolve(new_pattern)``."""
    return plan_.evolve(new_pattern, rerace=rerace, x=x)


def evolve_plans(old_pattern: BlockSparseMatrix,
                 new_pattern: BlockSparseMatrix) -> int:
    """Evolve every cached static spmm plan built on ``old_pattern``
    (any ``n`` or context; superseded ones something still holds
    included) onto ``new_pattern``, each marked superseded.  Returns how
    many were evolved.  ``SparseLinear.evolve`` evolves its own plans
    alone (``evolve``): the other modules on the old pattern keep
    theirs."""
    pk_old = pattern_key(old_pattern.row_idx, old_pattern.col_idx)
    with _LOCK:
        plans = [p for mk, p in list(_PLANS.items())
                 + list(_SUPERSEDED.items()) if mk[1] == pk_old]
    count = 0
    for p in plans:
        if p.kind == "static" and p.spec.op == "spmm":
            p.evolve(new_pattern)
            count += 1
    return count


# ---------------------------------------------------------------------------
# Reports and the re-planner's body
# ---------------------------------------------------------------------------

def _explain(p: MatmulPlan) -> dict:
    s = p.spec
    return {
        "problem": {"kind": s.kind, "m": s.m, "k": s.k, "n": s.n,
                    "block_size": s.block_size,
                    "density": round(s.density, 5),
                    "density_bucket": dispatch._density_bucket(s.density),
                    "dtype": s.dtype},
        "mode": s.mode,
        "op": s.op,
        # the candidates are the card's hand-written kernels on a card,
        # their plain versions on the CPU
        "pallas_admissible": route_device(p.device) == "cuda",
        "candidates": {r: p.est_seconds[r] for r in
                       sorted(p.est_seconds, key=p.est_seconds.get)},
        "chosen": p.route,
        "source": p.source,
        "cached": p.from_disk,
        "from_disk": p.from_disk,
        "cache_key": p.key,
        "tp": p.artifacts.get("tp"),
        "grad": p.artifacts.get("grad") or _batched_grad(p),
        "evolution": p.artifacts.get("evolution"),
        "roofline": p.roofline(),
        "plan": dict({k2: v for k2, v in p.artifacts.items()
                      if not k2.startswith("_")}, executable=True),
        "capacity": p.capacity_report() or p.artifacts.get("capacity"),
    }


def format_plan(p: MatmulPlan) -> str:
    """Human-readable plan report (``explain`` as text)."""
    rep = p.explain()
    pr = rep["problem"]
    lines = [f"plan {pr['kind']} ({pr['m']}x{pr['k']}) @ ({pr['k']}x"
             f"{pr['n']}) b={pr['block_size']} d={pr['density']} "
             f"{pr['dtype']} [mode={rep['mode']}]"]
    for route, sec in rep["candidates"].items():
        mark = "->" if route == rep["chosen"] else "  "
        lines.append(f"  {mark} {route:<30} {sec * 1e6:10.2f} us")
    lines.append(f"   ({rep['source']}"
                 f"{', from disk' if rep['from_disk'] else ''})")
    art = rep["plan"]
    extra = []
    if "packing_tiles" in art:
        extra.append(f"packing: {art['packing_tiles']} tiles of "
                     f"{art['kernel_tile']}, occupancy "
                     f"{art['packing_occupancy']:.3f}")
    if "mma_stages" in art:
        extra.append(f"mma: {art['mma_groups']} groups, "
                     f"{art['mma_stages']} stages")
    if "bucket_blocks" in art:
        extra.append(f"buckets: {art['bucket_blocks']} blocks/bucket over "
                     f"q=({art['q_m']},{art['q_k']},{art['q_n']})")
    if "tp_q" in art:
        extra.append(
            f"tp: {art.get('tp_route', 'static_tp')} q={art['tp_q']} "
            f"{'nnz-balanced' if art.get('tp_balanced', True) else 'even'}"
            f" k-shards over '{art['tp_axis']}'")
    tpd = art.get("tp")
    if tpd and tpd.get("tp_speedup_vs_unsharded") is not None:
        extra.append(
            f"tp race ({tpd['source']}): best {tpd['best_tp_route']} "
            f"{tpd['tp_speedup_vs_unsharded']}x vs "
            f"{tpd['best_unsharded_route']}"
            + (" [past crossover]" if tpd["tp_wins"] else ""))
    g = rep["grad"]
    if g:
        extra.append(f"grad: dx={g['dx']['route']} "
                     f"dvalues={g['dvalues']['route']} "
                     f"({g['dx']['source']}"
                     + (", from disk" if g.get("from_disk") else "") + ")")
    roof = rep.get("roofline")
    if roof and roof.get("chosen"):
        ch = roof["chosen"]
        line = (f"roofline: {ch['efficiency']:.0%} of "
                f"{ch['dominant']}-bound ({ch['headroom']:.1f}x headroom"
                + (", >2x -- kernel work" if ch["flagged"] else "") + ")")
        others = [r for r in roof["kernel_work"] if r != rep["chosen"]]
        if others:
            line += f"; also flagged: {', '.join(others)}"
        extra.append(line)
    ev = rep.get("evolution")
    if ev:
        extra.append(
            f"evolution: gen {ev['generation']} (carried {ev['carried']}, "
            f"dropped {ev['dropped']}, grown {ev['grown']}; drift "
            f"{ev['drift']:.4f} vs {ev['drift_threshold']}; "
            + ("re-raced" if ev["reraced"] else "verdicts inherited") + ")")
    if "grouped_tile" in art:
        t = art["grouped_tile"]
        extra.append(f"grouped: {t}x{t} tile slots (cap "
                     f"{art['grouped_tiles_cap']})")
    capsec = art.get("capacity")
    if capsec:
        extra.append(
            f"capacity: {capsec['policy']} cap {capsec['tiles_cap']} "
            f"(E[tiles] {capsec['expected_tiles']:.0f} x headroom "
            f"{capsec['headroom']:.2f}, worst {capsec['worst_tiles']}, "
            f"P[overflow] {capsec['overflow_p']:.3f})"
            + (" [clamped]" if capsec.get("clamped") else ""))
        st = p.capacity_stats
        if st is not None and st.calls:
            extra.append(f"overflow: {st.overflow_calls}/{st.calls} calls, "
                         f"{st.tiles_dropped_total} tiles dropped"
                         + (" [escalated]" if st.escalated else ""))
    if extra:
        lines.append("   plan: " + "; ".join(extra))
    lines.append(f"   ({'disk-cached' if p.from_disk else 'planned'} "
                 f"executable on {p.device})")
    return "\n".join(lines)


def explain(operand_or_spec: Union[Operand, OpSpec],
            n: Optional[int] = None, *, device: DeviceLike = None,
            ctx: Optional[PlanContext] = None) -> dict:
    """Plan and report in one step."""
    return plan(operand_or_spec, n, device=device, ctx=ctx).explain()


def _remeasurable(p: MatmulPlan) -> bool:
    """Can the re-planner time this plan?  Analytic forward verdicts only
    (a forced one has nothing to race, a measured one is done), and none
    planned for a mesh or ``tp_q``: the TP race belongs to the
    foreground ``measure=True`` path, with every rank of the mesh."""
    return (p.source == "analytic" and p.key not in _REPLANNED
            and (p.kind != "static" or p.pattern is not None)
            and not p.ctx.resolved_tp_q())


def analytic_plans(pool: Optional[str] = None) -> list:
    """The re-planner's worklist: live plans whose forward verdict is
    still analytic (priced by the H100 model, never timed) and that
    ``remeasure_plan`` can upgrade; ``pool`` restricts it to one serving
    engine's plans."""
    if pool is not None:
        plans = pool_plans(pool)
    else:
        with _LOCK:
            plans = list(_PLANS.values())
    return [p for p in plans if _remeasurable(p)]


def _synth_inputs(spec: OpSpec, pattern, seed: int, dev: torch.device):
    """Concrete ``(operand, x [n, k])`` realizing the plan's spec, from
    an explicit ``torch.Generator``: route timing depends on shapes,
    density and the pattern's layout, not on the values."""
    gen = torch.Generator().manual_seed(seed)
    dt = getattr(torch, spec.dtype)
    b = spec.block_size

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(device=dev, dtype=dt)
    x = randn(max(spec.n, 1), spec.k)
    if spec.kind == "static":
        rows, cols = pattern
        return BlockSparseMatrix(randn(len(rows), b, b), rows, cols,
                                 (spec.m, spec.k), b), x
    mask = masks.random_block_mask(spec.m, spec.k, b, spec.density,
                                   seed=seed)
    rows, cols = np.nonzero(mask)
    op = DynamicOperand(randn(max(1, len(rows)), b, b),
                        torch.as_tensor(rows, dtype=torch.int32, device=dev),
                        torch.as_tensor(cols, dtype=torch.int32, device=dev),
                        torch.tensor(len(rows), dtype=torch.int32,
                                     device=dev), (spec.m, spec.k), b)
    return op, x


def remeasure_plan(p: MatmulPlan, *, reps: Optional[int] = None,
                   lock=None, build_lock=None) -> Optional[dict]:
    """Upgrade one plan's analytic forward verdict to a measured one (the
    serving engine's re-planner body): every admissible candidate timed
    on synthesized inputs of the plan's spec by ``measure_callable``, the
    verdict (``dispatch.measured_pick`` over the analytic route: it
    changes only for a winner past the noise) installed in the
    re-planned overlay and on disk (when persistence is on).

    ``reps`` is the reference's repetition count, here the number of
    timing windows whose median is a candidate's time (each window
    launching every input copy, at least ``dispatch.MEASURE_REPS``
    times); None takes ``dispatch.MEASURE_WINDOWS``.  ``lock`` (a
    context manager, the engine's device lock) is held around each
    candidate's warm-up call and each of its timing windows
    (``measure_callable(lock=)``) and while the verdict is installed, so
    a serving thread's calls fall between them.  ``build_lock`` (the
    engine's capture lock; ``lock`` when None) is held while the inputs
    are made, around each candidate's build and pack, its input copies
    and their release: host work and uploads that time nothing, so the
    serving calls go on beside them, but that no CUDA-graph capture may
    see (a capture in global mode fails on another thread's
    allocation).

    The verdict is the key's: every live plan under ``p.key`` adopts it.
    A plan whose route changes is dropped from the in-memory cache so
    its holder's next ``plan()`` adopts the measured route (a CUDA graph
    that holds the old route keeps running it until it is re-captured:
    the engine's re-planner does that).  A plan whose route holds stays
    live and takes the measured verdict in place (``source``
    "measured", its measured times), so a graph holding it holds the
    live plan.  Returns ``{key, route_before, route_after,
    measured, upgraded}``, or None when the plan is not remeasurable."""
    if not _remeasurable(p):
        return None
    guard = lock if lock is not None else contextlib.nullcontext()
    build_guard = build_lock if build_lock is not None else guard
    spec, ctx, dev = p.spec, p.ctx, p.device
    with build_guard:
        operand, x = _synth_inputs(spec, p.pattern, 0, dev)
    cands = _admissible(dispatch._candidates(spec.kind, ctx.mode, dev.type),
                        spec, ctx)
    runner = _race_runner(spec, operand, x, dev, ctx, p.key)
    measured = {}
    for r in cands:
        with build_guard:
            fn, args = runner(r)
        measured[r] = dispatch.measure_callable(
            fn, *args, windows=reps, lock=lock, build_lock=build_lock)
        with build_guard:
            del fn, args
    with build_guard:
        del operand, x
    cache_lib.bump("measurements")
    before = p.route
    route = dispatch.measured_pick(measured, before)
    rec = _record(p)
    rec.update(route=route, source="measured",
               est_seconds={r: float(v) for r, v in measured.items()})
    with guard:
        with _LOCK:
            _REPLANNED[p.key] = rec
            # the verdict is the key's: every live plan under it (another
            # pattern of the same problem) adopts it
            for mk, q in list(_PLANS.items()):
                if q.key != p.key:
                    continue
                if q.route != route:
                    del _PLANS[mk]
                else:
                    q.source, q.from_disk = "measured", True
                    q.est_seconds = dict(rec["est_seconds"])
        if ctx.cache and ctx.persistence_on():
            cache_lib.store_decision(ctx.resolved_cache_dir(), p.key, rec)
    return {"key": p.key, "route_before": before, "route_after": route,
            "measured": dict(rec["est_seconds"]), "upgraded": True}


def batched_row_tile(c: int, tensor_cores: bool = True) -> int:
    """The gmm row tile of a ``[C, D]`` slice.  On the tensor-core walk
    (``tensor_cores``: ``gmm.ops.tma_ok``) C itself where the kernel holds
    it (C <= 128: one row tile per expert, so its weights are read once
    per column tile); on the FMA walk, whose blocks slow past 64 rows, C
    up to 64.  Else the largest multiple of 8 <= that limit dividing C
    (MoE's capacity is a multiple of 8), else C's largest divisor below
    it."""
    limit = gmm_ops.MAX_TM if tensor_cores else gmm_ops.FFMA_TM
    if 1 <= c <= limit:
        return c
    for cands in (range(limit, 0, -8), range(limit, 0, -1)):
        for t in cands:
            if c % t == 0:
                return t
    raise ValueError(f"batched_matmul: empty slice (C = {c})")


def _promote(operand, x: torch.Tensor):
    """``(payload, x)`` in their common dtype."""
    if isinstance(operand, DynamicOperand):
        rt = torch.result_type(operand.values, x)
        if operand.values.dtype != rt:
            operand = dataclasses.replace(operand,
                                          values=operand.values.to(rt))
        return operand, x.to(rt)
    rt = torch.result_type(operand.values, x)
    return operand.values.to(rt), x.to(rt)


def spmm_nt(operand: Union[BlockSparseMatrix, DynamicOperand],
            x: torch.Tensor, *, ctx: Optional[PlanContext] = None
            ) -> torch.Tensor:
    """Activation-major form ``x [..., k] -> x . W^T [..., m]``."""
    if not isinstance(operand, (BlockSparseMatrix, DynamicOperand)):
        raise TypeError(f"spmm_nt takes a sparse operand, got "
                        f"{type(operand).__name__}")
    m, k = operand.shape
    if x.shape[-1] != k:
        raise ValueError(f"x feature dim {x.shape[-1]} != operand k {k}")
    lead = x.shape[:-1]
    payload, x = _promote(operand, x)
    x2 = x.reshape(-1, k)
    p = plan(operand, x2.shape[0], x=x2, device=x.device, ctx=ctx)
    return p.spmm_nt(payload, x2).reshape(*lead, m)


def spmm(operand: Union[BlockSparseMatrix, DynamicOperand],
         x: torch.Tensor, *, ctx: Optional[PlanContext] = None
         ) -> torch.Tensor:
    """``Y = W . X`` with ``x [k, n] -> [m, n]`` (the JAX layout)."""
    if x.dim() != 2:
        raise ValueError(f"x must be [k, n], got shape {tuple(x.shape)}")
    if x.shape[0] != operand.shape[1]:
        raise ValueError(f"X rows {x.shape[0]} != operand k "
                         f"{operand.shape[1]}")
    return spmm_nt(operand, x.t(), ctx=ctx).t()


def matmul(x: torch.Tensor, w: torch.Tensor, *,
           ctx: Optional[PlanContext] = None) -> torch.Tensor:
    """Dense-layer form ``y = x . w`` (``x [..., k]``, ``w [k, m]``)."""
    if isinstance(w, (BlockSparseMatrix, DynamicOperand)):
        raise ValueError("matmul() takes a dense rhs; use spmm_nt for "
                         "sparse operands")
    k, m = w.shape
    if x.shape[-1] != k:
        raise ValueError(f"x feature dim {x.shape[-1]} != w rows {k}")
    rt = torch.result_type(w, x)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).to(rt)
    w = w.to(rt)
    p = plan(w, x2.shape[0], device=x.device, ctx=ctx)
    return p.matmul(x2, w).reshape(*lead, m)



def batched_matmul(a: torch.Tensor, b: torch.Tensor, *,
                   ctx: Optional[PlanContext] = None) -> torch.Tensor:
    """Batched dense ``[..., C, D] @ [..., D, F]`` (MoE expert GEMMs):
    one plan for the per-slice problem, in ``a`` and ``b``'s promoted
    dtype, run over the leading axes (the gmm kernel on a card)."""
    ctx = ctx or current_ctx()
    if a.dim() < 3 or b.dim() != a.dim() or a.shape[-1] != b.shape[-2]:
        raise ValueError(f"batched_matmul takes [..., C, D] @ [..., D, F] "
                         f"with the same leading axes; got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    rt = torch.result_type(a, b)
    c, d = a.shape[-2:]
    spec = OpSpec(kind="dense", m=int(c), k=int(d), n=int(b.shape[-1]),
                  dtype=rt, op="batched_matmul", mode=ctx.mode)
    p = plan(spec, device=a.device, ctx=ctx)
    return p.batched_matmul(a.to(rt), b.to(rt))
