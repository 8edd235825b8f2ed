"""Plan-first sparse matmul API: static, dynamic and dense kinds.

``plan(operand, n, device=..., ctx=...)`` runs every one-time step for a
matmul operand and returns a ``MatmulPlan`` that executes with no
further decisions.  Counterpart of the JAX package's ``sparse/plan.py``
(``_static_executor``/``_dynamic_executor``/``_dense_executor`` at
``plan.py:1051-1275``, ``spmm``/``spmm_nt``/``matmul`` at
``plan.py:1987-2023``), with these cuts:

* no route race: ``PlanContext.mode`` takes the JAX package's modes and
  ``spec.port_route`` maps them onto the port's routes by device (the
  CUDA kernels on a card, their plain PyTorch versions on the CPU);
  "auto" is the static walk (``static_cuda``, the bsmm kernel), the dsmm
  slot walk (``dynamic_cuda``) or the dense GEMM (``dense_cuda``);
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
  ``_planned_vjp`` (``plan.py:1431-1450``) whatever its forward route:
  dL/dx is the bsmm walk on the transposed pattern, dL/dvalues the block
  SDDMM (``sddmm_cuda`` on a card, ``sddmm_torch`` on the CPU).  A
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
  C, else C's largest divisor), forward only.  ``dense_torch`` is
  ``torch.matmul``;
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
  hits and route decisions; ``plan_report`` lists every cached plan's
  forward and backward routes (``:206``).  With no route race, every
  route's ``source`` is ``"fixed"`` (chosen by ``port_route``).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import capture, partitioner
from repro_torch.core import planner as planner_lib
from repro_torch.core.bsr import BlockSparseMatrix, pattern_key
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
from repro_torch.sparse.spec import (SUFFIX, CapacityStats, OpSpec,
                                     PlanContext, port_route)

ROUTES = {("static", "cuda"): "static_cuda",
          ("static", "cpu"): "static_torch",
          ("dense", "cuda"): "dense_cuda",
          ("dense", "cpu"): "dense_torch"}
# route of the static kind's dL/dvalues product, by device type
SDDMM_ROUTES = {"cuda": "sddmm_cuda", "cpu": "sddmm_torch"}
# bins of the balanced walks where the card does not pick (the
# reference's default)
DEFAULT_BINS = 8

Operand = Union[BlockSparseMatrix, DynamicOperand, torch.Tensor]


def _family(route: str) -> str:
    """``static_balanced_cuda`` -> ``static_balanced``."""
    return route.rsplit("_", 1)[0]


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
    ``capacity``)."""

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

    @property
    def grad_routes(self) -> Dict[str, str]:
        """Routes of the backward products: dL/dx and dL/dvalues."""
        if self.kind == "dense":
            return {"dx": "torch_matmul", "dw": "torch_matmul"}
        if self.kind == "dynamic":
            if _family(self.route) == "dynamic" \
                    and self.device.type == "cpu":
                return {"dx": "dynamic_torch", "dvalues": "dynamic_torch"}
            return {"dx": "torch_gather_index_add",
                    "dvalues": "torch_gather_einsum"}
        return {"dx": ROUTES[("static", self.device.type)],
                "dvalues": SDDMM_ROUTES[self.device.type]}

    def capacity_report(self) -> Optional[dict]:
        """Planned capacity + running overflow stats (None for routes
        without a planned bucket)."""
        if self.capacity_stats is None:
            return None
        return dict(self.artifacts.get("capacity", {}),
                    stats=self.capacity_stats.report())

    # -- static kind -------------------------------------------------------

    def pack(self, values: torch.Tensor) -> torch.Tensor:
        """``[nnz, b, b]`` block values -> what the route walks: the
        ``[T, b, b]`` tile stack (``static``; pad tiles for empty rows
        are zero), the stack plus the schedule's zero tile
        (``static_balanced``), the values themselves (the dynamic
        routes) or ``W^T [k, m]`` (``dense``).  Serving packs once per
        weight load."""
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

    def spmm_nt(self, payload, x2: torch.Tensor) -> torch.Tensor:
        """``x2 [N, k] -> x2 . W^T [N, m]``, differentiable in both
        operands through the planned backward.  ``payload`` is the
        ``[nnz, b, b]`` values (static kind) or the ``DynamicOperand``
        (dynamic kind)."""
        if self.kind == "dynamic":
            return self._dynamic_nt(payload, x2)
        if _needs_grad(payload, x2):
            self._check_differentiable()
            return _StaticSpmmFn.apply(payload, x2, self)
        return self.run_packed(self.pack(payload), x2)

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
        the same leading axes, in one gmm launch on a card (forward
        only) or ``torch.matmul`` on the CPU."""
        lead = a.shape[:-2]
        if (tuple(a.shape[-2:]) + (b.shape[-1],) != (self.m, self.k, self.n)
                or b.shape[:-2] != lead or b.shape[-2] != self.k):
            raise ValueError(f"plan expects [..., {self.m}, {self.k}] @ "
                             f"[..., {self.k}, {self.n}] with equal leading "
                             f"axes; got {tuple(a.shape)} @ {tuple(b.shape)}")
        if self.route == "dense_torch":
            return torch.matmul(a, b)
        if _needs_grad(a, b):
            raise NotImplementedError(
                "batched_matmul on the card has no backward (the gmm kernel "
                "is forward only; MoE training waits)")
        e = int(np.prod(lead, dtype=np.int64))
        ids = self.expert_ids.get(e)
        if ids is None:
            ids = self.expert_ids[e] = torch.arange(
                e, dtype=torch.int32, device=self.device).repeat_interleave(
                    self.m // self.row_tile)
        y = gmm_ops.gmm_cuda(a.reshape(e * self.m, self.k).contiguous(),
                             b.reshape(e, self.k, self.n).contiguous(), ids,
                             tm=self.row_tile)
        return y.reshape(*lead, self.m, self.n)

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


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad
                                           for t in tensors)


class _StaticSpmmFn(torch.autograd.Function):
    """``_planned_vjp``: forward runs the plan's route on the packed
    values; backward runs the SDDMM for dvalues and bsmm on the
    transposed pattern for dx, each cast to its operand's dtype."""

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
            dv = p.sddmm(dy2, x2).to(values.dtype)
        if ctx.needs_input_grad[1]:
            dx = p.spmm_t(values, dy2).to(x2.dtype)
        return dv, dx, None


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
_STATS = {"plans_built": 0, "plan_hits": 0, "decisions": 0}
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


def cache_stats() -> Dict[str, int]:
    """Plan-cache counters since ``reset``: plans built, cache hits and
    route decisions (one per plan built: ``port_route``'s fixed choice)."""
    with _LOCK:
        return dict(_STATS, cached=len(_PLANS))


@contextlib.contextmanager
def use_ctx(ctx: PlanContext):
    """Install ``ctx`` as the ambient planning context of this thread:
    every ``plan``/``matmul``/``spmm_nt``/``batched_matmul`` call without
    an explicit ``ctx`` (and ``record_dropped``) picks it up.  The serving
    engine wraps its programs with it, so its pool label and telemetry
    policy never leak into process-global state."""
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
    capture.hold(p)


def pool_plans(pool: str) -> list:
    """Every live plan used under ``ctx.pool == pool``, in first-use
    order.  Plans dropped from the in-memory cache (``reset``, a capacity
    escalation) drop out until their holder plans again."""
    with _LOCK:
        keys = list(_POOLS.get(pool, ()))
        plans = [_PLANS.get(k) for k in keys]
    return [p for p in plans if p is not None]


def plan_report() -> dict:
    """Every plan this process holds with its forward route, the route's
    ``source`` (``"fixed"``: the port has no race yet), kind, op and the
    routes of its backward products (``grad``: ``mode`` "planned" when
    autograd runs them, "unavailable" for a forward-only plan), plus the
    totals."""
    with _LOCK:
        plans = list(_PLANS.values())
    per = {}
    for p in plans:
        # the gmm route of batched_matmul has no backward
        if not p.ctx.differentiable or (p.spec.op == "batched_matmul"
                                        and p.route != "dense_torch"):
            grad = {"mode": "unavailable"}
        else:
            grad = {"mode": "planned",
                    **{name: {"route": route, "source": "fixed"}
                       for name, route in p.grad_routes.items()}}
        per[p.key] = {"route": p.route, "source": "fixed",
                      "from_disk": False, "op": p.spec.op, "kind": p.kind,
                      "grad": grad}
    routes = collections.Counter(r["route"] for r in per.values())
    return {
        "per_plan": per,
        "totals": {
            "plans": len(per),
            "grad_planned": sum(1 for r in per.values()
                                if r["grad"]["mode"] == "planned"),
            "grad_measured": 0,
            "grad_from_disk": 0,
            "by_route": dict(sorted(routes.items())),
        },
    }


def reset() -> None:
    """Forget every cached plan, pool and capacity stat, zero the
    counters."""
    with _LOCK:
        _PLANS.clear()
        _POOLS.clear()
        _CAPACITY.clear()
        _DROPS.clear()
        _DROPS_LOG.clear()
        for key in _STATS:
            _STATS[key] = 0


def reset_telemetry() -> None:
    """Zero the running ``capacity_report()`` counters without
    forgetting plans: stats of cached plans are zeroed in place (their
    plans keep recording), orphaned ones dropped."""
    with _LOCK:
        _DROPS.clear()
        _DROPS_LOG.clear()
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
    recorded."""
    if not current_ctx().telemetry:
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
    if _family(route) in ("dynamic_grouped", "dynamic_grouped_balanced"):
        return gmm_ops.grouped_tile(m, k, b)
    if b in dsmm_ops.BLOCK_SIZES:
        return b
    return max(contract_lib.sub_block(b, dsmm_ops.BLOCK_SIZES),
               dsmm_ops.BLOCK_SIZES[0])


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
    plan is differentiable)."""
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


def _build_static(bsr: BlockSparseMatrix, n: int, dev: torch.device,
                  route: str, ctx: PlanContext) -> MatmulPlan:
    m, k = bsr.shape
    b = bsr.block_size
    rows = np.asarray(bsr.row_idx, np.int32)
    cols = np.asarray(bsr.col_idx, np.int32)
    t, split = kernel_tile(b)
    mp, kp = walk_shape(m, k, t)
    # the pattern the static kernels walk: the operand's, or its split
    er, ec, eb = rows, cols, b
    if split > 1:
        # block z's sub-block (i, j) at z * split^2 + i * split + j, as
        # split_blocks orders the values
        i, j = (a.reshape(1, -1) for a in np.meshgrid(
            np.arange(split), np.arange(split), indexing="ij"))
        er = (rows[:, None] * split + i).reshape(-1).astype(np.int32)
        ec = (cols[:, None] * split + j).reshape(-1).astype(np.int32)
        eb = b // split
    meta = partitioner.plan_packing(er, ec, (m, k), eb, t, t)
    # the bsmm kernels walk "mma" at this tile and dtype (at every n past
    # the decode walk's): record its schedules once, on the device
    mma = dev.type == "cuda" and bal_ops.walk(t, bsr.dtype) == "mma"

    tp = partitioner.plan_transpose(er, ec, (m, k), eb)
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
    grad = GradPlan(
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
    p = MatmulPlan(kind="static", route=route, m=m, k=k, n=n,
                   dtype=bsr.dtype, device=dev, packing=meta,
                   row_ptr=_on_dev(meta.row_ptr(), dev),
                   tile_rows=_on_dev(meta.tile_rows, dev),
                   tile_cols=_on_dev(meta.tile_cols, dev),
                   pack_index=partitioner.pack_index(meta, dev), grad=grad,
                   ctx=ctx, block_size=b, split=split, walk_shape=(mp, kp))
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
        elif dev.type == "cuda":
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
                   ctx: PlanContext, key: str) -> MatmulPlan:
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
    t = gmm_ops.grouped_tile(m, k, b)
    # planned capacity (paper §3.3 bucket sizing): expected distinct
    # tiles at d_max times the headroom, not the safe worst case; where
    # the tile is not a block multiple, of the sub-blocks the pack takes
    slots = planner_lib.nnz_max_blocks(m, k, b, spec.density)
    g = b if t % b == 0 else contract_lib.sub_block(b, dsmm_ops.BLOCK_SIZES)
    mp, kp = walk_shape(m, k, t)
    capplan = planner_lib.plan_grouped_capacity(
        mp, kp, g, spec.density, tile=t, slots=slots * (b // g) ** 2,
        headroom=ctx.resolved_headroom())
    with _LOCK:
        stats = _CAPACITY.get(key)
        if stats is None:
            stats = _CAPACITY[key] = CapacityStats(
                key, tiles_cap=capplan.tiles_cap,
                worst_tiles=capplan.worst_tiles,
                overflow_threshold=ctx.overflow_threshold)
    stats.overflow_threshold = ctx.overflow_threshold
    # guardrail: an escalated problem re-plans at worst-case capacity
    policy = ("worst" if (ctx.capacity_policy == "worst" or stats.escalated)
              else "planned")
    requested = (capplan.tiles_cap if policy == "planned"
                 else capplan.worst_tiles)
    cap, clamped = gmm_ops.clamped_tiles_cap(requested, mp, kp, t,
                                             warn=False)
    stats.tiles_cap = cap
    stats.worst_tiles = capplan.worst_tiles
    stats.clamped = stats.clamped or clamped
    art.update(grouped_tile=t, grouped_tiles_cap=cap,
               capacity=dict(capplan.as_dict(), policy=policy, tiles_cap=cap,
                             clamped=clamped, escalated=stats.escalated))
    p.tile, p.tiles_cap, p.capacity_stats = t, cap, stats
    return p


def plan(operand_or_spec: Union[Operand, OpSpec], n: Optional[int] = None,
         *, device: DeviceLike = None,
         ctx: Optional[PlanContext] = None) -> MatmulPlan:
    """Plan ``operand`` for ``n`` activation rows on ``device`` (``cuda``
    unless the caller names another device) under ``ctx``.

    ``operand_or_spec`` is a ``BlockSparseMatrix`` (static kind, ``[m,
    k]``), a ``DynamicOperand`` (dynamic kind), a dense weight tensor
    ``w [k, m]`` (dense kind), or an ``OpSpec`` of the dynamic or dense
    kind (a static plan needs its pattern).  ``ctx=None`` takes the
    ambient context (``use_ctx``)."""
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
        else:
            spec = OpSpec.from_operand(operand, n, mode=ctx.mode)
    route = port_route(spec.kind, ctx.mode, dev.type)
    _check_plan_contracts(route, spec, ctx)
    if spec.kind == "static":
        fp = ("static", pattern_key(operand.row_idx, operand.col_idx),
              (spec.m, spec.k), spec.block_size, spec.dtype, dev, route)
    elif spec.op == "batched_matmul":
        fp = ("batched_matmul", (spec.m, spec.k, spec.n), spec.dtype, dev,
              route)
    elif spec.kind == "dense":
        fp = ("dense", (spec.k, spec.m), spec.dtype, dev, route)
    else:
        # the problem, never the pattern; capacity sizing is part of it
        fp = ("dynamic", spec.m, spec.k, spec.block_size, spec.density,
              spec.dtype, dev, route,
              ("cap", ctx.resolved_headroom(), ctx.capacity_policy),
              ctx.units)
    key = repr(fp)
    # the runtime-only knobs change what a plan does, not its bucket
    mem_key = fp + (ctx.overflow_threshold, ctx.telemetry,
                    ctx.differentiable)
    _register(mem_key, ctx)
    if ctx.cache:
        with _LOCK:
            hit = _PLANS.get(mem_key)
            if hit is not None:
                _STATS["plan_hits"] += 1
        if hit is not None:
            capture.hold(hit)
            return hit
    if spec.kind == "static":
        p = _build_static(operand, int(spec.n), dev, route, ctx)
    elif spec.kind == "dynamic":
        p = _build_dynamic(spec, dev, route, ctx, key)
    else:
        p = MatmulPlan(kind="dense", route=route, m=spec.m, k=spec.k,
                       n=int(spec.n), dtype=getattr(torch, spec.dtype),
                       device=dev, ctx=ctx)
        if spec.op == "batched_matmul" and route == "dense_cuda":
            p.row_tile = batched_row_tile(
                spec.m, gmm_ops.tma_ok(spec.k, spec.n, p.dtype))
            p.artifacts = {"kernel": "gmm", "row_tile": p.row_tile}
    p.spec = p.spec or spec
    p.key = key
    p.mem_key = mem_key
    with _LOCK:
        _STATS["plans_built"] += 1
        _STATS["decisions"] += 1
        if ctx.cache:
            p = _PLANS.setdefault(mem_key, p)
    capture.hold(p)
    stats = p.capacity_stats
    if ctx.cache and stats is not None:
        def _escalate_trip():
            # the next plan() of this problem re-plans at worst case
            with _LOCK:
                if _PLANS.get(mem_key) is p:
                    del _PLANS[mem_key]
        stats._on_escalate = _escalate_trip
    return p


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
    p = plan(operand, x2.shape[0], device=x.device, ctx=ctx)
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
