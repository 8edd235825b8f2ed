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
