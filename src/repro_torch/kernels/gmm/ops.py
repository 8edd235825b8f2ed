"""Device-side tile packer behind the ``dynamic_grouped`` routes.

Counterpart of the JAX package's ``kernels/gmm/ops.py``, without the
``gmm`` kernel itself.  Instead of walking ``b x b`` logical blocks, the
runtime pattern is packed on the device into ``t x t`` tile slots and
the dsmm slot walk runs on those tiles.  The tile capacity is planned
(expected tiles x headroom, ``planner.plan_grouped_capacity``), so
overflow is possible by design: tiles beyond ``tiles_cap`` are dropped
from the product and counted exactly in ``GroupedPackStats``, never
silently.  Every step is plain PyTorch on device tensors.
"""
from __future__ import annotations

import warnings
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.dynamic_sparse import DynamicOperand
from repro_torch.kernels.dsmm import ops as dsmm_ops


class GroupedPackStats(NamedTuple):
    """Exact overflow accounting for one device-side pack (device
    scalars).  ``tiles_total`` counts the distinct non-empty tiles the
    pattern occupies; ``tiles_dropped``/``blocks_dropped`` the tiles and
    logical blocks beyond ``tiles_cap``; ``dropped_value_frac`` the
    share of L1 value mass the dropped blocks carried."""

    tiles_total: torch.Tensor         # [] int32
    tiles_dropped: torch.Tensor       # [] int32
    blocks_dropped: torch.Tensor      # [] int32
    dropped_value_frac: torch.Tensor  # [] float32


def grouped_tile_size(m: int, k: int, b: int, limit: int = 128) -> int:
    """Largest square tile ``t <= limit`` that is a multiple of the
    logical block ``b`` and divides both ``m`` and ``k``.  Worst case
    ``t == b`` (the pack degenerates to the plain block walk)."""
    t = b * max(1, limit // b)
    while t > b and (m % t or k % t):
        t -= b
    if m % t or k % t:
        raise ValueError(f"no tile size <= {limit} divides both m={m} and "
                         f"k={k} at block {b}")
    return t


def pack_tiles_device(op: DynamicOperand, *, tile: int, tiles_cap: int,
                      with_stats: bool = True
                      ) -> Tuple[DynamicOperand,
                                 Optional[GroupedPackStats]]:
    """Pack a runtime block pattern into ``tiles_cap`` dense ``tile x
    tile`` slots on the device.

    Blocks are sorted (stably) by their covering tile, each distinct
    tile gets one slot in tile order, and the blocks of a tile add into
    it.  Tiles beyond ``tiles_cap`` overflow: dropped from the product,
    counted in the returned stats.  Padded tile slots carry zeros at
    (0, 0).  ``with_stats=False`` skips the accounting reductions."""
    m, k = op.shape
    b = op.block_size
    t = tile
    if t % b or m % t or k % t:
        raise ValueError(f"tile {t} must be a block-multiple divisor of "
                         f"shape {op.shape} (block {b})")
    rpb = cpb = t // b
    mt, kt = m // t, k // t
    s = op.capacity
    tiles_cap = max(1, tiles_cap)
    dev = op.values.device
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    if s == 0:
        packed = DynamicOperand(
            op.values.new_zeros((tiles_cap, t, t)),
            torch.zeros(tiles_cap, dtype=torch.int32, device=dev),
            torch.zeros(tiles_cap, dtype=torch.int32, device=dev),
            zero_i, (m, k), t)
        return packed, (GroupedPackStats(
            zero_i, zero_i, zero_i,
            torch.zeros((), dtype=torch.float32, device=dev))
            if with_stats else None)

    # padding slots (beyond op.nnz) must not claim a tile slot: a
    # sentinel past every real tile sends them to the cropped scratch slot
    sentinel = mt * kt
    valid = torch.arange(s, device=dev) < op.nnz
    rows, cols = op.row_idx.long(), op.col_idx.long()
    lin = torch.where(valid, (rows // rpb) * kt + cols // cpb, sentinel)
    order = torch.argsort(lin, stable=True)
    sl = lin[order]
    vmask = sl < sentinel
    new_tile = vmask & torch.cat([torch.ones(1, dtype=torch.bool,
                                             device=dev),
                                  sl[1:] != sl[:-1]])
    rank = torch.cumsum(new_tile.to(torch.int32), 0) - 1
    tiles_total = new_tile.sum(dtype=torch.int32)
    num_tiles = torch.clamp(tiles_total, max=tiles_cap)
    kept = vmask & (rank < tiles_cap)
    dst = torch.where(kept, rank, tiles_cap).long()

    vals = op.values[order]
    in_r = rows[order] % rpb
    in_c = cols[order] % cpb
    tiles = op.values.new_zeros((tiles_cap + 1, rpb, cpb, b, b))
    tiles.index_put_((dst, in_r, in_c), vals, accumulate=True)
    tiles = tiles.permute(0, 1, 3, 2, 4).reshape(tiles_cap + 1, t, t)
    tiles = tiles[:tiles_cap].contiguous()

    safe_sl = torch.where(vmask, sl, 0)
    tile_rows = torch.zeros(tiles_cap + 1, dtype=torch.int32, device=dev)
    tile_rows[dst] = (safe_sl // kt).to(torch.int32)
    tile_cols = torch.zeros(tiles_cap + 1, dtype=torch.int32, device=dev)
    tile_cols[dst] = (safe_sl % kt).to(torch.int32)

    packed = DynamicOperand(tiles, tile_rows[:tiles_cap].contiguous(),
                            tile_cols[:tiles_cap].contiguous(), num_tiles,
                            (m, k), t)
    if not with_stats:
        return packed, None

    dropped = vmask & ~kept
    blocks_dropped = dropped.sum(dtype=torch.int32)
    mass = vals.float().abs().sum(dim=(1, 2))
    total_mass = torch.where(vmask, mass, 0.0).sum()
    dropped_mass = torch.where(dropped, mass, 0.0).sum()
    dropped_frac = torch.where(total_mass > 0.0,
                               dropped_mass / total_mass.clamp_min(1e-30),
                               0.0).to(torch.float32)
    stats = GroupedPackStats(tiles_total, (tiles_total - num_tiles).to(
        torch.int32), blocks_dropped, dropped_frac)
    return packed, stats


_clamp_warned: set = set()


def clamped_tiles_cap(requested: int, m: int, k: int, tile: int,
                      *, warn: bool = True) -> Tuple[int, bool]:
    """Clamp a requested tile capacity into ``[1, (m/t)*(k/t)]``.

    Returns ``(effective_cap, was_clamped)``; a reduced capacity is
    warned once per (requested, grid) and reported to the caller."""
    mt, kt = m // tile, k // tile
    eff = max(1, min(int(requested), mt * kt))
    clamped = eff != int(requested)
    if clamped and warn:
        sig = (int(requested), mt * kt)
        if sig not in _clamp_warned:
            _clamp_warned.add(sig)
            warnings.warn(
                f"grouped_spmm: requested tiles_cap={requested} clamped "
                f"to {eff} (tile grid {mt}x{kt} = {mt * kt} slots); the "
                f"clamp is recorded in the plan report", stacklevel=3)
    return eff, clamped


def resolve_tiles(op: DynamicOperand, tile: Optional[int],
                  tiles_cap: Optional[int]) -> Tuple[int, int]:
    """``(t, tiles_cap)`` of a grouped call: the tile defaults to
    ``grouped_tile_size``, the capacity to the safe worst case (every
    slot in a distinct tile, capped at the tile grid)."""
    m, k = op.shape
    t = tile or grouped_tile_size(m, k, op.block_size)
    mt, kt = m // t, k // t
    if tiles_cap is None:
        tiles_cap = min(op.capacity, mt * kt)
    else:
        tiles_cap, _ = clamped_tiles_cap(tiles_cap, m, k, t)
    return t, max(1, tiles_cap)


def grouped_spmm(op: DynamicOperand, x2: torch.Tensor, *,
                 tile: Optional[int] = None, tiles_cap: Optional[int] = None,
                 return_stats: bool = False):
    """``y[N, m] = x2[N, k] . decode(op)^T`` through the device-side
    tile pack and the dsmm slot walk on ``t x t`` tiles (the
    ``dynamic_grouped`` route).  With ``return_stats=True`` the pack's
    exact overflow accounting is returned beside ``y``."""
    t, cap = resolve_tiles(op, tile, tiles_cap)
    packed, stats = pack_tiles_device(op, tile=t, tiles_cap=cap,
                                      with_stats=return_stats)
    y = dsmm_ops.dsmm(packed, x2)
    return (y, stats) if return_stats else y
