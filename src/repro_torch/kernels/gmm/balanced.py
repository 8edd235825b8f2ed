"""Balanced-walk grouped SpMM (the ``dynamic_grouped_balanced`` route).

Counterpart of the JAX package's ``kernels/gmm/balanced.py``.
``grouped_spmm`` hands the packed tile slots to the dsmm walk in
row-major tile order; this variant re-orders the slots by a device-side
row swizzle (the runtime analogue of ``partitioner.plan_swizzle``):
row-tiles are snake-binned by their runtime tile counts and the slots
ordered by ``(bin, row)``.  Each row's slots stay contiguous, which is
all the dsmm kernel needs; the rows are no longer ascending.  Plain
PyTorch on device tensors; the balance analysis costs device work per
call, as everything else in dynamic mode does.
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
    """Coverage slots + row-swizzled slot order (device-side):

    1. prepend one zero coverage slot per output row-tile (as
       ``encode_slots``), so every output tile is written;
    2. snake-bin row-tiles by their valid slot counts (descending,
       stable), then stable-sort all slots by ``(bin, row)``.

    Returns ``(rows, cols, values)`` of ``grid_m + S`` slots."""
    mt, _ = op.grid
    b = op.block_size
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

    rows = torch.cat([torch.arange(mt, dtype=torch.int32, device=dev),
                      op.row_idx.to(torch.int32)])
    cols = torch.cat([torch.zeros(mt, dtype=torch.int32, device=dev),
                      op.col_idx.to(torch.int32)])
    vals = torch.cat([op.values.new_zeros((mt, b, b)), op.values])
    key = bin_of_row[rows.long()].long() * (mt + 1) + rows
    order = torch.argsort(key, stable=True)
    return rows[order], cols[order], vals[order]


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
