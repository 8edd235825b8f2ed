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
  serve any number of activation rows ``n``;
* under autograd a static plan runs the planned backward of
  ``_planned_vjp`` (``plan.py:1431-1450``): dL/dx is the bsmm walk on the
  transposed pattern (``partitioner.plan_transpose``, packed once at plan
  time) and dL/dvalues the block SDDMM (route ``sddmm_cuda``, the sddmm
  kernel, on a card; ``sddmm_torch``, its plain version, on the CPU).  A
  dense plan mirrors ``_dense_planned_vjp`` (``plan.py:1488-1510``): the
  dense_mm kernel forward, two ``torch.matmul`` products backward, as the
  JAX package leaves them to XLA.
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
from repro_torch.kernels.sddmm import ops as sddmm_ops

ROUTES = {("static", "cuda"): "static_cuda",
          ("static", "cpu"): "static_torch",
          ("dense", "cuda"): "dense_cuda",
          ("dense", "cpu"): "dense_torch"}
# route of the static kind's dL/dvalues product, by device type
SDDMM_ROUTES = {"cuda": "sddmm_cuda", "cpu": "sddmm_torch"}

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
    pack_index: Optional[torch.Tensor] = None   # [nnz] long
    grad: Optional["GradPlan"] = None           # static kind only

    @property
    def grad_routes(self) -> Dict[str, str]:
        """Routes of the backward products: dL/dx and dL/dvalues."""
        if self.kind == "dense":
            return {"dx": "torch_matmul", "dw": "torch_matmul"}
        return {"dx": self.route,
                "dvalues": SDDMM_ROUTES[self.device.type]}

    def pack(self, values: torch.Tensor) -> torch.Tensor:
        """``[nnz, b, b]`` block values -> the ``[T, b, b]`` tile stack
        the kernel walks (pad tiles for empty rows are zero).  Serving
        packs once per weight load."""
        return partitioner.pack_values(self.packing, values,
                                       self.pack_index).contiguous()

    def run_packed(self, tiles: torch.Tensor, x2: torch.Tensor
                   ) -> torch.Tensor:
        """Static kind on a packed stack: ``x2 [N, k] -> [N, m]``."""
        return bsmm_ops.bsmm_nt(x2.contiguous(), tiles, self.row_ptr,
                                self.tile_cols, self.tile_rows, self.m)

    def spmm_nt(self, values: torch.Tensor, x2: torch.Tensor
                ) -> torch.Tensor:
        """Static kind: ``x2 [N, k] -> x2 . W^T [N, m]``, differentiable
        in both operands through the planned backward."""
        if _needs_grad(values, x2):
            return _StaticSpmmFn.apply(values, x2, self)
        return self.run_packed(self.pack(values), x2)

    def spmm_t(self, values: torch.Tensor, dy2: torch.Tensor
               ) -> torch.Tensor:
        """dL/dx of the static kind: ``dy2 [N, m] -> dy2 . W [N, k]``,
        the bsmm walk over the transposed pattern's tile stack."""
        g = self.grad
        return bsmm_ops.bsmm_nt(dy2.contiguous(), self.pack_t(values),
                                g.row_ptr, g.tile_cols, g.tile_rows, self.k)

    def pack_t(self, values: torch.Tensor) -> torch.Tensor:
        """``W^T``'s ``[T', b, b]`` tile stack: the values permuted into
        the transposed pattern's order, each block transposed, packed
        for the bsmm walk (a device gather per call while training)."""
        g = self.grad
        return partitioner.pack_values(
            g.packing, partitioner.apply_transpose(g.transpose, values,
                                                   g.perm),
            g.pack_index).contiguous()

    def sddmm(self, dy2: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        """dL/dvalues of the static kind: ``[nnz, b, b]`` block-sampled
        ``dy2^T . x2`` in the pattern's lexsort order."""
        g = self.grad
        dv = sddmm_ops.sddmm(dy2.contiguous(), x2.contiguous(),
                             g.block_row_ptr, g.col_idx, g.row_idx,
                             self.packing.block_size)
        return dv if g.unsort is None else dv[g.unsort]

    def matmul(self, x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Dense kind: ``x2 [N, k] . w [k, m]``, differentiable in both
        operands."""
        if _needs_grad(x2, w):
            return _DenseMatmulFn.apply(x2, w)
        return dmm_ops.dense_mm(x2.contiguous(), w.contiguous())


@dataclasses.dataclass
class GradPlan:
    """A static plan's backward metadata, built once with the plan.

    ``transpose``/``packing`` are ``W^T``'s pattern and its
    ``plan_packing(tm = tk = b)``; ``row_ptr``/``tile_rows``/
    ``tile_cols`` its walk on the device, ``perm`` the value permutation.
    ``block_row_ptr``/``row_idx``/``col_idx`` are the forward pattern's
    CSR runs in lexsort order, which the SDDMM walks; ``unsort`` maps
    them back to the operand's block order where that differs."""

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
    unsort: Optional[torch.Tensor] = None  # [nnz] long


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad
                                           for t in tensors)


class _StaticSpmmFn(torch.autograd.Function):
    """``_planned_vjp``: forward packs the values and runs bsmm;
    backward runs the SDDMM for dvalues and bsmm on the transposed
    pattern for dx, each cast to its operand's dtype."""

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

    order = np.lexsort((cols, rows))
    unsort = None
    if not np.array_equal(order, np.arange(order.size)):
        unsort = torch.as_tensor(np.argsort(order), device=dev)
    tp = partitioner.plan_transpose(rows, cols, (m, k), b)
    tmeta = partitioner.plan_packing(tp.row_idx, tp.col_idx, tp.shape,
                                     b, b, b)
    grad = GradPlan(
        transpose=tp, packing=tmeta,
        perm=torch.as_tensor(tp.perm, dtype=torch.long, device=dev),
        pack_index=partitioner.pack_index(tmeta, dev),
        row_ptr=on_dev(tmeta.row_ptr()), tile_rows=on_dev(tmeta.tile_rows),
        tile_cols=on_dev(tmeta.tile_cols),
        block_row_ptr=on_dev(sddmm_ops.block_row_ptr(rows[order], m // b)),
        row_idx=on_dev(rows[order]), col_idx=on_dev(cols[order]),
        unsort=unsort)
    return MatmulPlan(kind="static", route=ROUTES[("static", dev.type)],
                      m=m, k=k, n=n, dtype=dtype, device=dev,
                      packing=meta, row_ptr=on_dev(meta.row_ptr()),
                      tile_rows=on_dev(meta.tile_rows),
                      tile_cols=on_dev(meta.tile_cols),
                      pack_index=partitioner.pack_index(meta, dev), grad=grad)


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
