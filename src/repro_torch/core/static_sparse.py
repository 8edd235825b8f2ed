"""Static block-sparse matmul in plain PyTorch: the gather / einsum /
index_add formulation.

Counterpart of the JAX package's ``core/static_sparse.py``
(``make_spmm``, ``make_spmm_t``, ``make_sddmm``), in its layout: ``x``
is ``[k, n]`` and ``Y = (M * W) . X`` is ``[m, n]``.  Each ``make_*``
closes over a fixed pattern (host index arrays, moved to a device once
per device) and takes the values per call.  These are the plain
versions of the static plan's three products -- forward, dL/dx (the
transposed SpMM) and dL/dvalues (the block SDDMM) -- and hold the CUDA
kernels' backward to account on the card.  Products are summed in fp32
and cast to the inputs' dtype once.

The reference's deprecated convenience API (``spmm``, ``spmm_nt``,
``spmm_t``, ``sddmm``, ``spmm_cached``) is kept as thin shims over
``repro_torch.sparse.plan``: each plans the ``BlockSparseMatrix`` on
its tensors' device and runs the plan, so a card launches the
hand-written kernels (bsmm forward and on the transposed pattern,
sddmm) and the CPU their plain versions.  ``backend="xla"`` and
``"pallas"`` both name the static family (``sparse.spec.port_route``):
the device, not the backend, picks the kernel or its plain version.
``interpret`` is kept for the reference's signature and selects
nothing (the port has no interpreter).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch


class _Pattern:
    """A fixed block pattern with its index tensors cached per device."""

    def __init__(self, row_idx, col_idx, grid: Tuple[int, int],
                 block_size: int):
        self.rows = np.asarray(row_idx, np.int64)
        self.cols = np.asarray(col_idx, np.int64)
        self.grid = tuple(grid)
        self.b = int(block_size)
        self._dev: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    def on(self, device: torch.device):
        hit = self._dev.get(device)
        if hit is None:
            hit = (torch.as_tensor(self.rows, device=device),
                   torch.as_tensor(self.cols, device=device))
            self._dev[device] = hit
        return hit


def _spmm_fwd_impl(pat: _Pattern, values: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """``Y[m, n] = sum_z values[z] . X_block[col[z]]`` scattered to rows."""
    mb, kb = pat.grid
    b, n = pat.b, x.shape[-1]
    rows, cols = pat.on(x.device)
    gathered = x.float().reshape(kb, b, n)[cols]                # [z, b, n]
    part = torch.einsum("zab,zbn->zan", values.float(), gathered)
    y = torch.zeros((mb, b, n), dtype=torch.float32, device=x.device)
    y.index_add_(0, rows, part)
    return y.reshape(mb * b, n).to(torch.result_type(values, x))


def _spmm_t_impl(pat: _Pattern, values: torch.Tensor,
                 dy: torch.Tensor) -> torch.Tensor:
    """dL/dx: ``(M * W)^T . dY`` -- gather rows, scatter columns."""
    mb, kb = pat.grid
    b, n = pat.b, dy.shape[-1]
    rows, cols = pat.on(dy.device)
    gathered = dy.float().reshape(mb, b, n)[rows]               # [z, b, n]
    part = torch.einsum("zab,zan->zbn", values.float(), gathered)
    dx = torch.zeros((kb, b, n), dtype=torch.float32, device=dy.device)
    dx.index_add_(0, cols, part)
    return dx.reshape(kb * b, n).to(torch.result_type(values, dy))


def _sddmm_impl(pat: _Pattern, dy: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """dL/dvalues: block-sampled ``dY . X^T``, only the pattern's blocks
    (``[nnz, b, b]`` in the pattern's order)."""
    mb, kb = pat.grid
    b, n = pat.b, x.shape[-1]
    rows, cols = pat.on(x.device)
    dyg = dy.float().reshape(mb, b, n)[rows]                    # [z, b, n]
    xg = x.float().reshape(kb, b, n)[cols]                      # [z, b, n]
    out = torch.einsum("zan,zbn->zab", dyg, xg)
    return out.to(torch.result_type(dy, x))


class _SpmmFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, x, pat):
        ctx.pat = pat
        ctx.save_for_backward(values, x)
        return _spmm_fwd_impl(pat, values, x)

    @staticmethod
    def backward(ctx, dy):
        values, x = ctx.saved_tensors
        dv = dx = None
        if ctx.needs_input_grad[0]:
            dv = _sddmm_impl(ctx.pat, dy, x).to(values.dtype)
        if ctx.needs_input_grad[1]:
            dx = _spmm_t_impl(ctx.pat, values, dy).to(x.dtype)
        return dv, dx, None


def make_spmm(row_idx: np.ndarray, col_idx: np.ndarray,
              grid: Tuple[int, int], block_size: int
              ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Differentiable ``(values, x [k, n]) -> y [m, n]`` for a fixed
    pattern; its backward runs ``make_sddmm``'s and ``make_spmm_t``'s
    products."""
    pat = _Pattern(row_idx, col_idx, grid, block_size)
    return lambda values, x: _SpmmFn.apply(values, x, pat)


def make_spmm_t(row_idx: np.ndarray, col_idx: np.ndarray,
                grid: Tuple[int, int], block_size: int
                ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """``(values, dy [m, n]) -> (M * W)^T . dY [k, n]``: the dL/dx
    product for a fixed pattern."""
    pat = _Pattern(row_idx, col_idx, grid, block_size)
    return lambda values, dy: _spmm_t_impl(pat, values, dy)


def make_sddmm(row_idx: np.ndarray, col_idx: np.ndarray,
               grid: Tuple[int, int], block_size: int
               ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """``(dy [m, n], x [k, n]) -> [nnz, b, b]`` block-sampled
    ``dY . X^T``: the dL/dvalues product for a fixed pattern."""
    pat = _Pattern(row_idx, col_idx, grid, block_size)
    return lambda dy, x: _sddmm_impl(pat, dy, x)


# ---------------------------------------------------------------------------
# The reference's convenience API: shims over the plan
# ---------------------------------------------------------------------------

_BACKENDS = {"xla": "static_xla", "pallas": "static_pallas"}


def _static_ctx(mode: str):
    """A plan context forcing the static family forward (``mode``) and
    the static walks backward (the bsmm walk on ``W^T``, the sddmm)."""
    from repro_torch import sparse as sparse_api
    return sparse_api.PlanContext(mode=mode, grad_mode="static",
                                  sddmm_mode="sddmm_grouped")


def _backend_ctx(backend: str):
    route = _BACKENDS.get(backend)
    if route is None:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{sorted(_BACKENDS)}")
    return _static_ctx(route)


def _static_plan(bsr, n: int, device: torch.device):
    from repro_torch import sparse as sparse_api
    return sparse_api.plan(bsr, int(n), device=device,
                           ctx=_static_ctx("static"))


def spmm(bsr, x: torch.Tensor, *, backend: str = "xla",
         interpret: bool = False) -> torch.Tensor:
    """``Y = (M * W) . X`` with ``x [k, n]`` -> ``[m, n]``, through the
    static plan of ``bsr`` for ``n`` columns (differentiable in
    ``bsr.values`` and ``x``).  Deprecated in the reference: prefer
    ``repro_torch.sparse.plan(bsr, n)``."""
    from repro_torch import sparse as sparse_api
    if x.shape[0] != bsr.shape[1]:
        raise ValueError(f"X rows {x.shape[0]} != k {bsr.shape[1]}")
    return sparse_api.spmm(bsr, x, ctx=_backend_ctx(backend))


def spmm_nt(bsr, x: torch.Tensor, *, backend: str = "xla",
            interpret: bool = False) -> torch.Tensor:
    """Activation-major form: ``x [..., k] -> [..., m]`` (``y = x .
    W^T``)."""
    from repro_torch import sparse as sparse_api
    return sparse_api.spmm_nt(bsr, x, ctx=_backend_ctx(backend))


def spmm_t(bsr, dy: torch.Tensor) -> torch.Tensor:
    """Transpose product ``(M * W)^T . dY``: ``dy [m, n] -> [k, n]``, the
    plan's dL/dx walk (bsmm over ``W^T``'s tiles on a card)."""
    if dy.shape[0] != bsr.shape[0]:
        raise ValueError(f"dY rows {dy.shape[0]} != m {bsr.shape[0]}")
    values = bsr.values
    rt = torch.result_type(values, dy)
    p = _static_plan(bsr, dy.shape[1], dy.device)
    return p.spmm_t(values.to(rt), dy.to(rt).t().contiguous()).t()


def sddmm(bsr, dy: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Block-sampled ``dY . X^T`` on the pattern of ``bsr``: ``dy [m, n]``,
    ``x [k, n]`` -> ``[nnz, b, b]`` in ``bsr``'s block order, the plan's
    dL/dvalues walk (the sddmm kernel on a card)."""
    if dy.shape[0] != bsr.shape[0] or x.shape[0] != bsr.shape[1] \
            or dy.shape[1] != x.shape[1]:
        raise ValueError(f"dY {tuple(dy.shape)} and X {tuple(x.shape)} do "
                         f"not fit {tuple(bsr.shape)}")
    rt = torch.result_type(dy, x)
    p = _static_plan(bsr, x.shape[1], x.device)
    return p.sddmm(dy.to(rt).t().contiguous(), x.to(rt).t().contiguous())


def spmm_cached(bsr, x: torch.Tensor) -> torch.Tensor:
    """``spmm`` with the pattern's work done once: the reference caches a
    function per pattern; here the plan cache holds the plan per
    pattern and ``n``, so this is ``spmm``."""
    return spmm(bsr, x)
