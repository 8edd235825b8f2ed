"""Balanced-walk grouped SpMM (the ``dynamic_grouped_balanced`` route).

Counterpart of the JAX package's ``kernels/gmm/balanced.py``.
``grouped_spmm`` hands the packed tile slots to the dsmm walk in
row-major tile order; this variant re-orders the slots by a device-side
row swizzle (the runtime analogue of ``partitioner.plan_swizzle``):
row-tiles are snake-binned by their runtime tile counts and the slots
ordered by ``(bin, row)``.  Each row's slots stay contiguous, which is
all the dsmm kernel needs; the rows are no longer ascending (each row's
columns still are).  Plain PyTorch on device tensors; the balance
analysis costs device work per call, as everything else in dynamic mode
does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.dynamic_sparse import DynamicOperand
from repro_torch.kernels.dsmm import ops as dsmm_ops
from repro_torch.kernels.gmm.ops import (fit_tile, pack_tiles_device,
                                         resolve_tiles)


def _encode_slots_balanced(op: DynamicOperand, num_bins: int
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Row-swizzled slot order (device-side):

    1. snake-bin row-tiles by their valid slot counts (descending,
       stable);
    2. stable-sort the slots by ``(bin, row)``, the padding slots (index
       ``>= op.nnz``) last and off the grid at row-tile ``grid_m``, where
       the walks skip them.

    Each row's slots stay contiguous and in the pack's ascending column
    order.  The reference prepends a zero coverage slot to every row-tile
    as ``encode_slots`` does; the port's walks write every output tile
    without one.  Returns ``(rows, cols, values)`` of the ``S`` slots."""
    mt, _ = op.grid
    dev = op.values.device
    nb = max(1, min(int(num_bins), mt))
    valid = torch.arange(op.capacity, device=dev) < op.nnz
    counts = torch.zeros(mt, dtype=torch.int32, device=dev)
    counts.index_add_(0, op.row_idx.long(), valid.to(torch.int32))
    order_desc = torch.argsort(-counts, stable=True)
    i = torch.arange(mt, device=dev)
    pos, rnd = i % nb, i // nb
    dealt = torch.where(rnd % 2 == 0, pos, nb - 1 - pos).to(torch.int32)
    bin_of_row = torch.zeros(mt, dtype=torch.int32, device=dev)
    bin_of_row[order_desc] = dealt

    rows = op.row_idx.long()
    key = torch.where(valid, bin_of_row[rows].long() * (mt + 1) + rows,
                      nb * (mt + 1))
    order = torch.argsort(key, stable=True)
    rows = torch.where(valid, rows, mt).to(torch.int32)
    return rows[order], op.col_idx.to(torch.int32)[order], op.values[order]


def balanced_spmm(op: DynamicOperand, x2: torch.Tensor, *,
                  tile: Optional[int] = None,
                  tiles_cap: Optional[int] = None, num_bins: int = 8,
                  return_stats: bool = False):
    """``y[N, m] = x2[N, k] . decode(op)^T`` through the device-side
    tile pack and the row-swizzled dsmm walk.  Capacity semantics are
    those of ``grouped_spmm``; only the slot visit order differs."""
    t, cap = resolve_tiles(op, tile, tiles_cap)
    packed, stats = pack_tiles_device(fit_tile(op, t), tile=t, tiles_cap=cap,
                                      with_stats=return_stats)
    rows, cols, vals = _encode_slots_balanced(packed, num_bins)
    y = dsmm_ops.dsmm_slots(dsmm_ops.pad_cols(x2, packed.shape[1]), vals,
                            rows, cols, packed.shape[0])
    y = y[:, :op.shape[0]] if packed.shape[0] != op.shape[0] else y
    return (y, stats) if return_stats else y
