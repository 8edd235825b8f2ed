"""Plan-first sparse matmul API, static and dense kinds.

``plan(operand, n, device=...)`` runs every one-time step for a matmul
operand and returns a ``MatmulPlan`` that executes with no further
decisions.  Counterpart of the JAX package's ``sparse/plan.py``
(``_static_executor``/``_dense_executor`` at ``plan.py:1042-1077``,
``spmm_nt``/``matmul`` at ``plan.py:2001-2023``), cut to what serving
needs:

* the route is fixed by the device, with no race: on a CUDA device the
  static kind runs ``static_cuda`` (the bsmm kernel) and the dense kind
  ``dense_cuda`` (the dense_mm kernel); on the CPU they run the kernels'
  plain PyTorch versions (``static_torch``, ``dense_torch``);
* a static plan runs ``partitioner.plan_packing`` once with
  ``tm = tk = b`` and keeps the CSR row pointer and tile columns on the
  device;
* plans are cached in memory per (pattern, shape, dtype, device) and
  serve any number of activation rows ``n``.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import partitioner
from repro_torch.core.bsr import BlockSparseMatrix, pattern_key
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.kernels.bsmm import ops as bsmm_ops
from repro_torch.kernels.dense_mm import ops as dmm_ops

ROUTES = {("static", "cuda"): "static_cuda",
          ("static", "cpu"): "static_torch",
          ("dense", "cuda"): "dense_cuda",
          ("dense", "cpu"): "dense_torch"}

Operand = Union[BlockSparseMatrix, torch.Tensor]


@dataclasses.dataclass
class MatmulPlan:
    """One operand's executable plan.

    ``kind`` is ``"static"`` (block-sparse ``W [m, k]``, applied as
    ``y = x . W^T``) or ``"dense"`` (``w [k, m]``, applied as
    ``y = x . w``).  ``n`` is the activation row count the plan was
    built for; it runs at any other ``n`` as well."""

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

    def pack(self, values: torch.Tensor) -> torch.Tensor:
        """``[nnz, b, b]`` block values -> the ``[T, b, b]`` tile stack
        the kernel walks (pad tiles for empty rows are zero).  Serving
        packs once per weight load."""
        return partitioner.pack_values(self.packing, values).contiguous()

    def run_packed(self, tiles: torch.Tensor, x2: torch.Tensor
                   ) -> torch.Tensor:
        """Static kind on a packed stack: ``x2 [N, k] -> [N, m]``."""
        return bsmm_ops.bsmm_nt(x2.contiguous(), tiles, self.row_ptr,
                                self.tile_cols, self.tile_rows, self.m)

    def spmm_nt(self, values: torch.Tensor, x2: torch.Tensor
                ) -> torch.Tensor:
        """Static kind: ``x2 [N, k] -> x2 . W^T [N, m]``."""
        return self.run_packed(self.pack(values), x2)

    def matmul(self, x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Dense kind: ``x2 [N, k] . w [k, m]``."""
        return dmm_ops.dense_mm(x2.contiguous(), w.contiguous())


_LOCK = threading.Lock()
_PLANS: Dict[Tuple, MatmulPlan] = {}
_STATS = {"plans_built": 0, "plan_hits": 0}


def cache_stats() -> Dict[str, int]:
    """Plan-cache counters: plans built and cache hits since ``reset``."""
    with _LOCK:
        return dict(_STATS, cached=len(_PLANS))


def reset() -> None:
    """Forget every cached plan and zero the counters."""
    with _LOCK:
        _PLANS.clear()
        for key in _STATS:
            _STATS[key] = 0


def _build_static(bsr: BlockSparseMatrix, n: int, dev: torch.device,
                  dtype: torch.dtype) -> MatmulPlan:
    m, k = bsr.shape
    b = bsr.block_size
    rows = np.asarray(bsr.row_idx, np.int32)
    cols = np.asarray(bsr.col_idx, np.int32)
    meta = partitioner.plan_packing(rows, cols, (m, k), b, b, b)

    def on_dev(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int32),
                               device=dev)

    return MatmulPlan(kind="static", route=ROUTES[("static", dev.type)],
                      m=m, k=k, n=n, dtype=dtype, device=dev,
                      packing=meta, row_ptr=on_dev(meta.row_ptr()),
                      tile_rows=on_dev(meta.tile_rows),
                      tile_cols=on_dev(meta.tile_cols))


def plan(operand: Operand, n: int, *, device: DeviceLike = None
         ) -> MatmulPlan:
    """Plan ``operand`` for ``n`` activation rows on ``device``
    (``cuda`` unless the caller names another device).

    ``operand`` is a ``BlockSparseMatrix`` (static kind, ``[m, k]``) or
    a dense weight tensor ``w [k, m]`` (dense kind)."""
    dev = resolve_device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no route for device {dev}")
    if isinstance(operand, BlockSparseMatrix):
        key = ("static", pattern_key(operand.row_idx, operand.col_idx),
               tuple(operand.shape), operand.block_size, operand.dtype,
               dev)
    elif isinstance(operand, torch.Tensor):
        if operand.dim() != 2:
            raise ValueError(f"dense operand must be [k, m], got "
                             f"{tuple(operand.shape)}")
        key = ("dense", tuple(operand.shape), operand.dtype, dev)
    else:
        raise TypeError(f"cannot plan a {type(operand).__name__}")
    with _LOCK:
        hit = _PLANS.get(key)
        if hit is not None:
            _STATS["plan_hits"] += 1
            return hit
    if key[0] == "static":
        p = _build_static(operand, int(n), dev, operand.dtype)
    else:
        k, m = operand.shape
        p = MatmulPlan(kind="dense", route=ROUTES[("dense", dev.type)],
                       m=m, k=k, n=int(n), dtype=operand.dtype, device=dev)
    with _LOCK:
        p = _PLANS.setdefault(key, p)
        _STATS["plans_built"] += 1
    return p


def spmm_nt(operand: BlockSparseMatrix, x: torch.Tensor) -> torch.Tensor:
    """Activation-major form ``x [..., k] -> x . W^T [..., m]``."""
    m, k = operand.shape
    if x.shape[-1] != k:
        raise ValueError(f"x feature dim {x.shape[-1]} != operand k {k}")
    rt = torch.result_type(operand.values, x)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).to(rt)
    p = plan(operand, x2.shape[0], device=x.device)
    y = p.spmm_nt(operand.values.to(rt), x2)
    return y.reshape(*lead, m)


def spmm(operand: BlockSparseMatrix, x: torch.Tensor) -> torch.Tensor:
    """``Y = W . X`` with ``x [k, n] -> [m, n]`` (the JAX layout)."""
    if x.dim() != 2:
        raise ValueError(f"x must be [k, n], got shape {tuple(x.shape)}")
    return spmm_nt(operand, x.t()).t()


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Dense-layer form ``y = x . w`` (``x [..., k]``, ``w [k, m]``)."""
    if isinstance(w, BlockSparseMatrix):
        raise ValueError("matmul() takes a dense rhs; use spmm_nt for "
                         "sparse operands")
    k, m = w.shape
    if x.shape[-1] != k:
        raise ValueError(f"x feature dim {x.shape[-1]} != w rows {k}")
    rt = torch.result_type(w, x)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).to(rt)
    w = w.to(rt)
    p = plan(w, x2.shape[0], device=x.device)
    return p.matmul(x2, w).reshape(*lead, m)
