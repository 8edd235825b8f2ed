"""Problem and policy descriptions for the plan-first sparse API.

Counterpart of the JAX package's ``sparse/spec.py``, cut to what the
port's plan layer reads.  ``OpSpec`` is the logical problem (operand
kind, shape, block size, density, dtype, mode); ``PlanContext`` the
planning policy (the route race, the disk cache, the backward knobs,
capacity and pools); ``CapacityStats`` the running overflow telemetry
of a planned-capacity route.

``mode`` takes the JAX package's vocabulary ("auto", a family, or a JAX
route id).  "auto" races every admissible route (``core.dispatch``);
``port_route`` maps a family or route id onto the port's one route by
device: its CUDA kernel on a card (``*_cuda``), its plain PyTorch
version on the CPU (``*_torch``).  The two tensor-parallel routes keep
the reference's names on every device (``TP_ROUTES``): ``sparse.plan``
plans them, each shard's partial on the static route of the device.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import planner as planner_lib
from repro_torch.core.bsr import BlockSparseMatrix
from repro_torch.core.dynamic_sparse import DynamicOperand
from repro_torch.kernels.contract import dtype_name
from repro_torch.launch.mesh import mesh_axes

KINDS = ("dense", "static", "dynamic")
OPS = ("spmm", "matmul", "batched_matmul")

# the JAX package's route ids (``core/dispatch.py`` ROUTES) and modes
JAX_ROUTES = ("dense_xla", "dense_pallas", "static_xla", "static_pallas",
              "static_balanced", "dynamic_xla", "dynamic_pallas",
              "dynamic_grouped", "dynamic_grouped_balanced")
# the mesh-aware routes of a static pattern (``core/tp.py``), planned by
# ``sparse.plan``, not by dispatch (they need the pattern's k-shards and
# a mesh axis): "static_tp" computes every shard's partial on this
# device and sums them; "static_tp_shardmap" runs one shard per rank of
# a concrete mesh and all-reduces over its ``tp_axis``.  As a mode,
# "static_tp" is the TP family: it races both where both can run
TP_ROUTES = ("static_tp", "static_tp_shardmap")
MODES = ("auto", "dense", "static", "dynamic") + JAX_ROUTES + TP_ROUTES

# mode -> the port's route family (before the device suffix)
_FAMILY = {"dense": "dense", "dense_xla": "dense", "dense_pallas": "dense",
           "static": "static", "static_xla": "static",
           "static_pallas": "static", "static_balanced": "static_balanced",
           "dynamic": "dynamic", "dynamic_xla": "dynamic",
           "dynamic_pallas": "dynamic", "dynamic_grouped": "dynamic_grouped",
           "dynamic_grouped_balanced": "dynamic_grouped_balanced"}
# which route families each operand kind can execute (a static pattern
# can always run densely or through the dynamic path; a runtime pattern
# cannot recover a plan-time one)
ADMISSIBLE = {"dense": ("dense",),
               "static": ("static", "static_balanced", "dense", "dynamic",
                          "dynamic_grouped", "dynamic_grouped_balanced"),
               "dynamic": ("dynamic", "dynamic_grouped",
                           "dynamic_grouped_balanced", "dense")}
SUFFIX = {"cuda": "_cuda", "cpu": "_torch"}

# backward policies of a static plan (the reference's GRAD_DX_MODES /
# GRAD_SDDMM_MODES): dL/dx is an SpMM on the transposed pattern, any
# static mode but "auto" forcing its route (``port_route``); dL/dvalues a
# block SDDMM ("sddmm_xla" and "sddmm_grouped" force the sddmm route,
# "sddmm_dense" the dense product and a gather)
GRAD_DX_MODES = tuple(m for m in MODES if m not in TP_ROUTES)
GRAD_SDDMM_MODES = ("auto", "sddmm_xla", "sddmm_grouped", "sddmm_dense")
_SDDMM_FAMILY = {"sddmm_xla": "sddmm", "sddmm_grouped": "sddmm",
                 "sddmm_dense": "sddmm_dense"}


def port_route(kind: str, mode: str, device_type: str) -> str:
    """The port route that runs an explicit family or route ``mode`` for
    an operand of ``kind`` on ``device_type``; raises for a mode the kind
    cannot execute.  "auto" is not a route: it races
    (``core.dispatch._candidates``)."""
    if mode == "auto":
        raise ValueError("mode 'auto' races its candidates; port_route maps "
                         "an explicit family or route")
    if mode in TP_ROUTES:
        raise ValueError(f"mode {mode!r} is a tensor-parallel route: "
                         f"sparse.plan plans it from the pattern")
    family = _FAMILY[mode]
    if family not in ADMISSIBLE[kind]:
        raise ValueError(f"mode {mode!r} cannot execute a {kind} operand")
    if device_type not in SUFFIX:
        raise ValueError(f"no route for device type {device_type!r}")
    return family + SUFFIX[device_type]


def sddmm_route(mode: str, device_type: str) -> str:
    """The port route an explicit ``sddmm_mode`` forces."""
    if device_type not in SUFFIX:
        raise ValueError(f"no route for device type {device_type!r}")
    return _SDDMM_FAMILY[mode] + SUFFIX[device_type]


@dataclasses.dataclass(frozen=True)
class OpSpec:
    """Logical matmul problem for ``repro_torch.sparse.plan``.

    kind        "dense" | "static" | "dynamic"
    m, k, n     ``[m, k] . [k, n]`` logical sizes
    block_size  b (1 for dense)
    density     true block density (static) or d_max capacity (dynamic)
    dtype       operand dtype name ("float32", "bfloat16", "float16")
    op          "spmm" (Y = W . X) | "matmul" (x . w, dense) |
                "batched_matmul" ([..., C, D] @ [..., D, F], dense; m, k
                and n are the per-slice C, D and F)
    mode        "auto", a family, or a JAX route id (``MODES``)
    """

    kind: str
    m: int
    k: int
    n: int
    block_size: int = 1
    density: float = 1.0
    dtype: str = "float32"
    op: str = "spmm"
    mode: str = "auto"

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown operand kind {self.kind!r}; "
                             f"expected one of {KINDS}")
        if self.op not in OPS:
            raise ValueError(f"unknown op {self.op!r}; expected one of "
                             f"{OPS}")
        if self.mode not in MODES:
            raise ValueError(f"unknown plan mode {self.mode!r}; expected "
                             f"one of {MODES}")
        if isinstance(self.dtype, torch.dtype):
            object.__setattr__(self, "dtype", dtype_name(self.dtype))

    @classmethod
    def from_operand(cls, operand, n: int, *, op: str = "spmm",
                     mode: str = "auto") -> "OpSpec":
        """Describe ``operand . [k, n]`` for a ``BlockSparseMatrix``, a
        ``DynamicOperand`` or a dense ``[m, k]`` tensor."""
        if isinstance(operand, BlockSparseMatrix):
            m, k = operand.shape
            b = operand.block_size
            mb, kb = operand.grid
            return cls(kind="static", m=m, k=k, n=int(n), block_size=b,
                       density=len(operand.row_idx) / max(1, mb * kb),
                       dtype=dtype_name(operand.dtype), op=op, mode=mode)
        if isinstance(operand, DynamicOperand):
            m, k = operand.shape
            b = operand.block_size
            return cls(kind="dynamic", m=m, k=k, n=int(n), block_size=b,
                       density=operand.capacity / max(1, (m // b) * (k // b)),
                       dtype=dtype_name(operand.dtype), op=op, mode=mode)
        if isinstance(operand, torch.Tensor):
            if operand.dim() != 2:
                raise ValueError(f"dense operand must be 2-D, got shape "
                                 f"{tuple(operand.shape)}")
            m, k = operand.shape
            return cls(kind="dense", m=m, k=k, n=int(n),
                       dtype=dtype_name(operand.dtype), op=op, mode=mode)
        raise TypeError(f"cannot plan a {type(operand).__name__}")

    def roofline_cost(self, route: str) -> dict:
        """The work ``route`` executes on this problem, for pricing it
        against the card's roofline (``analysis.route_efficiency``):
        the routes that execute densely (``dense_*`` and
        ``sddmm_dense_*``, and every route of a dense operand) pay the
        full product, the sparse SpMM and SDDMM routes only the
        pattern's share, so a flag reads "this kernel is slow for what
        it does", not "a sparser algorithm exists".  Derived from the
        spec's fields alone: it joins no fingerprint."""
        from repro_torch.analysis import cost
        fam = route.rsplit("_", 1)[0]
        bytes_el = max(1, getattr(torch, self.dtype).itemsize)
        d = (1.0 if self.kind == "dense" or fam in ("dense", "sddmm_dense")
             else self.density)
        build = (cost.sddmm_cost_dict if fam in ("sddmm", "sddmm_dense")
                 else cost.spmm_cost_dict)
        return build(self.m, self.k, self.n, density=d, bytes_el=bytes_el)


# ---------------------------------------------------------------------------
# Capacity: planned bucket sizing + running overflow telemetry
# ---------------------------------------------------------------------------

CAPACITY_POLICIES = ("planned", "worst")

# the guardrail needs a frequency estimate, not a single sample: never
# escalate before this many observed calls
ESCALATION_MIN_CALLS = 4


class CapacityStats:
    """Running overflow telemetry for one planned-capacity problem.

    Every execution of a planned-capacity route with telemetry on
    records its exact pack overflow here.  The stats outlive plan
    objects (they are registered per plan key), so the escalation
    guardrail survives the eviction of the plan it trips."""

    def __init__(self, key: str = "", *, tiles_cap: int = 0,
                 worst_tiles: int = 0, overflow_threshold: float = 0.0):
        self.key = key
        self.tiles_cap = tiles_cap
        self.worst_tiles = worst_tiles
        self.overflow_threshold = overflow_threshold
        self.calls = 0
        self.overflow_calls = 0
        self.tiles_dropped_total = 0
        self.blocks_dropped_total = 0
        self.dropped_frac_sum = 0.0
        self.max_dropped_frac = 0.0
        self.last_tiles_total = 0
        self.last_tiles_dropped = 0
        self.clamped = False          # requested cap was reduced to fit
        self.escalated = False        # guardrail tripped -> worst case
        self._lock = threading.Lock()
        self._on_escalate = None      # set by the plan layer

    def record(self, tiles_total, tiles_dropped, blocks_dropped,
               dropped_frac) -> None:
        """Fold one execution's exact pack accounting into the running
        stats; trips the escalation guardrail when the observed overflow
        frequency exceeds ``overflow_threshold``."""
        tiles_total = int(np.asarray(tiles_total).sum())
        tiles_dropped = int(np.asarray(tiles_dropped).sum())
        blocks_dropped = int(np.asarray(blocks_dropped).sum())
        dropped_frac = float(np.asarray(dropped_frac).max())
        trip = None
        with self._lock:
            self.calls += 1
            self.last_tiles_total = tiles_total
            self.last_tiles_dropped = tiles_dropped
            if tiles_dropped > 0 or dropped_frac > 0:
                self.overflow_calls += 1
            self.tiles_dropped_total += tiles_dropped
            self.blocks_dropped_total += blocks_dropped
            self.dropped_frac_sum += dropped_frac
            self.max_dropped_frac = max(self.max_dropped_frac,
                                        dropped_frac)
            if (not self.escalated
                    and self.overflow_threshold > 0.0
                    and self.calls >= ESCALATION_MIN_CALLS
                    and self.overflow_frequency > self.overflow_threshold):
                self.escalated = True
                trip = self._on_escalate
        if trip is not None:
            trip()

    def reset_counts(self) -> None:
        """Zero the running counters (the plan keeps recording)."""
        with self._lock:
            self.calls = 0
            self.overflow_calls = 0
            self.tiles_dropped_total = 0
            self.blocks_dropped_total = 0
            self.dropped_frac_sum = 0.0
            self.max_dropped_frac = 0.0
            self.last_tiles_total = 0
            self.last_tiles_dropped = 0

    @property
    def overflow_frequency(self) -> float:
        return self.overflow_calls / self.calls if self.calls else 0.0

    @property
    def mean_dropped_frac(self) -> float:
        return self.dropped_frac_sum / self.calls if self.calls else 0.0

    def report(self) -> dict:
        with self._lock:
            return {"tiles_cap": self.tiles_cap,
                    "worst_tiles": self.worst_tiles,
                    "calls": self.calls,
                    "overflow_calls": self.overflow_calls,
                    "overflow_frequency": round(self.overflow_frequency, 6),
                    "tiles_dropped_total": self.tiles_dropped_total,
                    "blocks_dropped_total": self.blocks_dropped_total,
                    "mean_dropped_frac": round(self.mean_dropped_frac, 6),
                    "max_dropped_frac": round(self.max_dropped_frac, 6),
                    "last_tiles_total": self.last_tiles_total,
                    "last_tiles_dropped": self.last_tiles_dropped,
                    "clamped": self.clamped,
                    "escalated": self.escalated,
                    "overflow_threshold": self.overflow_threshold}


def _default_cache_dir() -> Optional[str]:
    return os.environ.get("REPRO_CACHE_DIR") or None


@dataclasses.dataclass(frozen=True)
class PlanContext:
    """Planning policy for ``repro_torch.sparse.plan``.

    mode            "auto" (race every admissible route), a family or a
                    JAX route id (``MODES``; one route, ``port_route``)
    measure         time the candidates on the device (``plan(..., x=)``
                    with concrete inputs, never under a CUDA-graph
                    capture) instead of trusting the H100 model
    differentiable  the caller may take gradients through the result
                    (the planned backward runs when autograd asks)
    cache           keep and reuse plans and decisions in memory
    persist         read and write verdicts on disk.  None (the default)
                    persists iff a cache directory is configured
                    (``cache_dir`` here, ``sparse.configure``, or
                    $REPRO_CACHE_DIR); True with no directory raises
    cache_dir       directory of the persistent verdict cache
    units           parallel-unit budget for ``planner.plan_dynamic``

    Capacity policy of the grouped dynamic routes (paper §3.3):

    headroom            slack over the expected tile count (None: the
                        planner's 1.25)
    capacity_policy     "planned" (expected * headroom, overflow counted
                        exactly) or "worst" (never overflows)
    overflow_threshold  observed overflow frequency above which the
                        guardrail re-plans at worst-case capacity; 0
                        disables
    telemetry           record each call's pack overflow (one host read
                        of four device counters per call; off for loops
                        that must not wait for the device) and the MoE
                        routing drops (``record_dropped``)

    Backward policy of a static plan (part of its fingerprint):

    grad_mode       dL/dx, an SpMM on the transposed pattern: "auto"
                    races the static candidates on the transposed ``[k,
                    m]`` problem; a family or route id forces one
    sddmm_mode      dL/dvalues: "auto" races the block SDDMM against the
                    dense product and a gather; a route id forces one
                    (``GRAD_SDDMM_MODES``)

    Evolution policy (``MatmulPlan.evolve``: RigL topology updates on
    static plans):

    evolve_drift    relative drift of the pattern's profile (block
                    density, kernel-tile occupancy and the walk model's
                    skew factor, against the profile the verdicts were
                    raced on) above which ``evolve`` races the routes
                    again instead of inheriting them.  Constant-nnz RigL
                    steps drift ~0; a pruning schedule that halves the
                    density trips it.  0.0 re-races on any change, None
                    never.  Joins the in-memory key only; the value and
                    the drift are recorded in the evolution lineage

    Tensor parallelism (the k-sharded routes, ``TP_ROUTES``):

    mesh            an ``launch.mesh.AbstractMesh`` (names and sizes: a
                    plan prices ``q`` cards and runs every shard here,
                    ``static_tp``) or a ``DeviceMesh`` over a process
                    group (``static_tp_shardmap`` runs one shard per rank
                    too).  Under "auto" a static plan races the TP routes
                    against the unsharded ones; its verdict is keyed on
                    the mesh's axis names and sizes
    tp_axis         the mesh axis the blocks' k range shards over
    tp_q            shard count without a mesh (``static_tp`` only), or
                    one that overrides the axis size
    tp_balanced     nnz-balanced uneven k-splits (the static mode's),
                    else fixed equal ones

    Plan pool (the serving engine's plan enumeration):

    pool            label grouping every plan used under this context
                    into a named pool (``sparse.pool_plans(name)``).
                    Runtime-only: a label, not an identity -- it joins
                    neither the plan's ``key`` nor the in-memory cache
                    key, so pooled and unpooled callers share one plan
                    per problem
    """

    mode: str = "auto"
    measure: bool = False
    differentiable: bool = True
    cache: bool = True
    persist: Optional[bool] = None
    cache_dir: Optional[str] = None
    units: int = 16
    headroom: Optional[float] = None
    capacity_policy: str = "planned"
    overflow_threshold: float = 0.25
    telemetry: bool = True
    grad_mode: str = "auto"
    sddmm_mode: str = "auto"
    evolve_drift: Optional[float] = 0.25
    pool: Optional[str] = None
    mesh: Any = None
    tp_axis: str = "model"
    tp_q: Optional[int] = None
    tp_balanced: bool = True

    def __post_init__(self):
        if self.evolve_drift is not None and self.evolve_drift < 0:
            raise ValueError(f"evolve_drift must be >= 0 or None, got "
                             f"{self.evolve_drift}")
        if self.mode not in MODES:
            raise ValueError(f"unknown plan mode {self.mode!r}; expected "
                             f"one of {MODES}")
        if self.grad_mode not in GRAD_DX_MODES:
            raise ValueError(f"unknown grad_mode {self.grad_mode!r}; "
                             f"expected one of {GRAD_DX_MODES}")
        if self.sddmm_mode not in GRAD_SDDMM_MODES:
            raise ValueError(f"unknown sddmm_mode {self.sddmm_mode!r}; "
                             f"expected one of {GRAD_SDDMM_MODES}")
        if self.capacity_policy not in CAPACITY_POLICIES:
            raise ValueError(
                f"unknown capacity_policy {self.capacity_policy!r}; "
                f"expected one of {CAPACITY_POLICIES}")
        if self.headroom is not None and self.headroom <= 0:
            raise ValueError(f"headroom must be positive, got "
                             f"{self.headroom}")

    def resolved_headroom(self) -> float:
        return float(self.headroom if self.headroom is not None
                     else planner_lib.HEADROOM)

    def resolved_cache_dir(self) -> Optional[str]:
        from repro_torch.sparse import cache as cache_lib
        return (self.cache_dir or cache_lib.configured_cache_dir()
                or _default_cache_dir())

    def resolved_tp_q(self) -> Optional[int]:
        """The shard count of the TP routes: ``tp_q``, else the size of
        the mesh's ``tp_axis``, else None (no TP).  A mesh without
        ``tp_axis`` raises: planning unsharded would hide the mistake."""
        if self.tp_q is not None:
            return int(self.tp_q)
        if self.mesh is not None:
            names, sizes = mesh_axes(self.mesh)
            if self.tp_axis not in names:
                raise ValueError(
                    f"PlanContext.mesh axes {names} do not include "
                    f"tp_axis {self.tp_axis!r}; pass "
                    f"PlanContext(tp_axis=...) naming the mesh axis to "
                    f"shard k over, or set tp_q explicitly to plan "
                    f"without a mesh")
            return sizes[names.index(self.tp_axis)]
        return None

    def mesh_fingerprint(self) -> tuple:
        """The mesh's identity in a plan key: axis names and sizes (not
        its devices or ranks: a verdict holds for any mesh of the same
        shape on this card type)."""
        if self.mesh is None:
            return ()
        return mesh_axes(self.mesh)

    def shardmap_executable(self) -> bool:
        """Can the ``static_tp_shardmap`` route run under this context?"""
        from repro_torch.core import tp as tp_lib
        q = self.resolved_tp_q()
        return bool(q) and tp_lib.shard_map_executable(
            self.mesh, self.tp_axis, q)

    def persistence_on(self) -> bool:
        if self.persist is None:
            return self.resolved_cache_dir() is not None
        if self.persist and self.resolved_cache_dir() is None:
            raise ValueError(
                "PlanContext(persist=True) but no cache directory is "
                "configured; set PlanContext(cache_dir=...), call "
                "sparse.configure(cache_dir=...), or export "
                "REPRO_CACHE_DIR")
        return bool(self.persist)
