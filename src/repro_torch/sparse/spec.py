"""Problem and policy descriptions for the plan-first sparse API.

Counterpart of the JAX package's ``sparse/spec.py``, cut to what the
port's plan layer reads.  ``OpSpec`` is the logical problem (operand
kind, shape, block size, density, dtype, mode); ``PlanContext`` the
planning policy; ``CapacityStats`` the running overflow telemetry of a
planned-capacity route.

``mode`` takes the JAX package's vocabulary ("auto", a family, or a JAX
route id) and ``port_route`` maps it onto the port's routes by device:
a route's CUDA kernel on a card (``*_cuda``), its plain PyTorch version
on the CPU (``*_torch``).  "auto" keeps the device-fixed choice: the
static walk for static operands, the dsmm slot walk for dynamic ones,
the dense GEMM for dense ones.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.core import planner as planner_lib
from repro_torch.core.bsr import BlockSparseMatrix
from repro_torch.core.dynamic_sparse import DynamicOperand

KINDS = ("dense", "static", "dynamic")
OPS = ("spmm", "matmul", "batched_matmul")

# the JAX package's route ids (``core/dispatch.py`` ROUTES) and modes
JAX_ROUTES = ("dense_xla", "dense_pallas", "static_xla", "static_pallas",
              "static_balanced", "dynamic_xla", "dynamic_pallas",
              "dynamic_grouped", "dynamic_grouped_balanced")
MODES = ("auto", "dense", "static", "dynamic") + JAX_ROUTES

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
_ADMISSIBLE = {"dense": ("dense",),
               "static": ("static", "static_balanced", "dense", "dynamic",
                          "dynamic_grouped", "dynamic_grouped_balanced"),
               "dynamic": ("dynamic", "dynamic_grouped",
                           "dynamic_grouped_balanced", "dense")}
_AUTO = {"dense": "dense", "static": "static", "dynamic": "dynamic"}
SUFFIX = {"cuda": "_cuda", "cpu": "_torch"}


def port_route(kind: str, mode: str, device_type: str) -> str:
    """The port route that runs ``mode`` for an operand of ``kind`` on
    ``device_type``; raises for a mode the kind cannot execute."""
    family = _AUTO[kind] if mode == "auto" else _FAMILY[mode]
    if family not in _ADMISSIBLE[kind]:
        raise ValueError(f"mode {mode!r} cannot execute a {kind} operand")
    if device_type not in SUFFIX:
        raise ValueError(f"no route for device type {device_type!r}")
    return family + SUFFIX[device_type]


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


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


@dataclasses.dataclass(frozen=True)
class PlanContext:
    """Planning policy for ``repro_torch.sparse.plan``.

    mode            "auto", a family or a JAX route id (``MODES``),
                    mapped to the port's routes by ``port_route``
    differentiable  the caller may take gradients through the result
                    (the planned backward runs when autograd asks)
    cache           keep and reuse plans in memory
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
                        that must not wait for the device)
    """

    mode: str = "auto"
    differentiable: bool = True
    cache: bool = True
    units: int = 16
    headroom: Optional[float] = None
    capacity_policy: str = "planned"
    overflow_threshold: float = 0.25
    telemetry: bool = True

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown plan mode {self.mode!r}; expected "
                             f"one of {MODES}")
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
