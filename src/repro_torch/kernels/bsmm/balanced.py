"""Balanced-walk static block-sparse matmul: CUDA kernel wrapper and
plain version.

``bsmm_balanced(x2, tiles, visit_rows, visit_cols, visit_slot, m)``
computes ``y[N, m] = x2[N, k] . W^T`` for the block-sparse ``W`` held as
a packed ``[T + 1, b, b]`` tile stack (``plan_packing`` with ``tm = tk
= b`` plus one trailing zero tile), walked over the ``[bins, steps]``
visit schedule of ``partitioner.plan_packing_balanced``.  For a CUDA
tensor it launches ``csrc/bsmm_balanced.cu`` (the port of
``src/repro/kernels/bsmm/balanced.py`` ``bsmm_balanced_call``) or
raises; for a CPU tensor it runs ``bsmm_balanced_plain``.  ``walk(b,
dtype)`` names the kernel's walk: "mma" (bf16/fp16 at b in
``ops.MMA_BLOCKS``: bsmm's tensor-core walk with the bins as its groups,
on the ``ops.MmaSchedule`` the plan records beside the visit schedule)
or "ffma" (the visit schedule on the CUDA cores).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import partitioner
from repro_torch.analysis import cost as cost_lib
from repro_torch.kernels import _build, meta
from repro_torch.kernels.bsmm import ops

TILE_SIZES = (4, 8, 16, 32, 64)
DTYPES = _build.DTYPES
COUNTER = _build.LaunchCounter()
WALKS = ("mma", "ffma")                  # the C entry's walk codes, in order
# launches per walk, beside the total COUNTER
WALK_COUNTERS = {name: _build.LaunchCounter() for name in WALKS}
# thread blocks the balanced walk aims for: two per SM of an H100
TARGET_BLOCKS = 2 * 132


def tokens_per_block(b: int) -> int:
    """Tokens one thread block of the kernel covers at tile size ``b``."""
    return 256 if b <= 4 else (128 if b == 8 else 64)


def card_bins(row_tiles: int, n: int, b: int) -> int:
    """Bin count the plan picks for the card: enough (bin, token tile)
    blocks to fill it (``TARGET_BLOCKS``), at least the reference's
    default of 8, at most one bin per row-tile."""
    n_tiles = max(1, -(-n // tokens_per_block(b)))
    want = max(8, -(-TARGET_BLOCKS // n_tiles))
    return max(1, min(want, row_tiles))


def walk(b: int, dtype) -> str:
    """The walk ``bsmm_balanced_cuda`` launches at tile ``b`` in ``dtype``
    (pure Python): "mma" for bf16/fp16 at b in ``ops.MMA_BLOCKS``,
    "ffma" elsewhere."""
    if b not in TILE_SIZES:
        raise ValueError(f"bsmm_balanced kernel takes tiles of "
                         f"{TILE_SIZES}; got {b}")
    return ("mma" if dtype in (torch.bfloat16, torch.float16)
            and b in ops.MMA_BLOCKS else "ffma")


# The balanced walk's time over the uniform walk's (``ops.walk_seconds``)
# on the same tiles, by walk: the skew-grid and Table 3 rows of
# chip_smoke.py (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md) put it at 1.00
# to 1.11 on the mma walk and 1.47 to 2.24 on the ffma walk, on uniform,
# DLMC-like and power-law patterns alike: binning does not pay on the
# card, where both walks slow down on hot rows.
OVERHEAD = {"mma": 1.05, "ffma": 1.6}


def walk_seconds(name: str, n: int, m: int, k: int, tile: int, tiles: int,
                 stages: int, dtype) -> float:
    """Modelled device seconds of walk ``name`` on the packing of
    ``tiles`` tiles (pure Python): the uniform walk's model
    (``ops.walk_seconds``, on its mma or ffma walk) times ``OVERHEAD``."""
    return OVERHEAD[name] * ops.walk_seconds(name, n, m, k, tile, tiles,
                                             stages, dtype)


def mma_bins(row_tiles: int, b: int) -> int:
    """Bins of the row swizzle where the walk is "mma": ``ceil(mb / R)``,
    so that every bin is one group of the walk (``ops.bin_groups``)."""
    return max(1, -(-row_tiles // ops.MMA_ROWS[b]))


def bsmm_balanced_plain(x2: torch.Tensor, tiles: torch.Tensor,
                        visit_rows: torch.Tensor, visit_cols: torch.Tensor,
                        visit_slot: torch.Tensor, m: int) -> torch.Tensor:
    """Plain PyTorch version: every step of every lane (pads included)
    multiplies its tile with its x slice in fp32 and adds into its
    row-tile.  Same inputs and result as the kernel."""
    n, k = x2.shape
    b = tiles.shape[-1]
    rows, cols = visit_rows.reshape(-1).long(), visit_cols.reshape(-1).long()
    xs = x2.float().reshape(n, k // b, b)[:, cols]              # [N, V, b]
    w = tiles.float()[visit_slot.reshape(-1).long()]            # [V, b, b]
    part = torch.einsum("nvj,vij->nvi", xs, w)
    y = torch.zeros((n, m // b, b), dtype=torch.float32, device=x2.device)
    y.index_add_(1, rows, part)
    return y.reshape(n, m).to(x2.dtype)


def _check(x2, tiles, visit_rows, visit_cols, visit_slot, m):
    if x2.dim() != 2 or tiles.dim() != 3:
        raise ValueError(f"x2 must be [N, K] and tiles [T + 1, b, b]; got "
                         f"{tuple(x2.shape)} and {tuple(tiles.shape)}")
    n, k = x2.shape
    _, tm, tk = tiles.shape
    if tm != tk or tm not in TILE_SIZES:
        raise ValueError(f"bsmm_balanced kernel takes square tiles of "
                         f"{TILE_SIZES}; got {tm}x{tk}")
    if k % tk or m % tm:
        raise ValueError(f"k={k}, m={m} must be multiples of the tile {tm}")
    if x2.dtype not in DTYPES or tiles.dtype != x2.dtype:
        raise ValueError(f"dtypes x2={x2.dtype}, tiles={tiles.dtype}: "
                         f"both one of {DTYPES}")
    shape = tuple(visit_rows.shape)
    for name, a in (("visit_rows", visit_rows), ("visit_cols", visit_cols),
                    ("visit_slot", visit_slot)):
        if a.dtype != torch.int32 or a.dim() != 2 or tuple(a.shape) != shape:
            raise ValueError(f"{name} must be int32 [bins, steps] like "
                             f"visit_rows {shape}")
    for name, a in (("x2", x2), ("tiles", tiles), ("visit_rows", visit_rows),
                    ("visit_cols", visit_cols), ("visit_slot", visit_slot)):
        if a.device != x2.device:
            raise ValueError(f"{name} on {a.device}, x2 on {x2.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def bsmm_balanced_cuda(x2: torch.Tensor, tiles: torch.Tensor,
                       visit_rows: torch.Tensor, visit_cols: torch.Tensor,
                       visit_slot: torch.Tensor, m: int,
                       schedule: Optional[ops.MmaSchedule] = None,
                       plan: Optional[str] = None) -> torch.Tensor:
    """Launch the CUDA kernel (CUDA tensors; meta tensors take the meta
    branch, ``kernels/meta.py``) on ``walk(...)``'s walk, or on ``plan``
    where the caller names one; the "mma" walk reads ``schedule`` (its
    groups the bins), the "ffma" walk the visit schedule.  A walk that
    does not apply raises."""
    _check(x2, tiles, visit_rows, visit_cols, visit_slot, m)
    n, k = x2.shape
    b = tiles.shape[1]
    wk = plan or walk(b, x2.dtype)
    if wk not in WALKS or (wk == "mma" and walk(b, x2.dtype) != "mma"):
        raise ValueError(f"bsmm_balanced walk {wk!r} does not take b={b} "
                         f"in {x2.dtype}")
    if x2.device.type not in ("cuda", "meta"):
        raise ValueError(f"bsmm_balanced_cuda needs CUDA tensors, got "
                         f"{x2.device}")
    bins, steps = visit_rows.shape
    y = torch.empty((n, m), dtype=x2.dtype, device=x2.device)
    if n == 0 or bins == 0:
        return y
    if wk == "mma":
        ops.check_schedule(schedule, b, m, x2.device)
        x2, tiles = ops.aligned(x2), ops.aligned(tiles)
    if x2.device.type == "meta":
        # the K slices' fp32 scratch, as a launch allocates it
        ops.mma_args(schedule if wk == "mma" else None, n, m, x2.device)
        return meta.account(
            "bsmm_balanced", wk, y, cost_lib.bsmm_balanced_cost(
                n, k, m, tiles.shape[0] - 1, b, x2.element_size(),
                visit_rows.numel()))
    fn = _build.entry("bsmm_balanced", "bsmm_balanced_nt",
                      [ctypes.c_void_p] * 11 + [ctypes.c_int] * 13
                      + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    sargs, part = ops.mma_args(schedule if wk == "mma" else None, n, m,
                               x2.device)
    with torch.cuda.device(x2.device):
        code = fn(x2.data_ptr(), tiles.data_ptr(), visit_rows.data_ptr(),
                  visit_cols.data_ptr(), visit_slot.data_ptr(), *sargs[:4],
                  y.data_ptr(), None if part is None else part.data_ptr(),
                  n, k, m, b, bins, steps, tiles.shape[0] - 1, *sargs[4:],
                  _build.DTYPE_CODES[x2.dtype], WALKS.index(wk), stream)
    _build.check(code, "bsmm_balanced_nt")
    COUNTER.launches += 1
    WALK_COUNTERS[wk].launches += 1
    return y


def bsmm_balanced(x2: torch.Tensor, tiles: torch.Tensor,
                  visit_rows: torch.Tensor, visit_cols: torch.Tensor,
                  visit_slot: torch.Tensor, m: int,
                  schedule: Optional[ops.MmaSchedule] = None
                  ) -> torch.Tensor:
    """``y[N, m] = x2 . W^T`` over the balanced visit schedule.  CUDA
    tensors launch the kernel (or raise; the "mma" walk reads
    ``schedule``); CPU tensors run the plain version; meta tensors take
    the meta branch."""
    if x2.device.type in ("cuda", "meta"):
        return bsmm_balanced_cuda(x2.contiguous(), tiles, visit_rows,
                                  visit_cols, visit_slot, m, schedule)
    if x2.device.type != "cpu":
        raise ValueError(f"bsmm_balanced: unsupported device {x2.device}")
    return bsmm_balanced_plain(x2, tiles, visit_rows, visit_cols,
                               visit_slot, m)


def balanced_schedule(meta: partitioner.BalancedPacking,
                      device=None) -> ops.MmaSchedule:
    """The "mma" walk's schedule of a balanced packing: its bins as the
    groups (``ops.bin_groups``), the pad tiles left out."""
    base = meta.base
    b = base.tm
    real = ops.real_tiles(base.num_tiles, base.block_slot)
    return ops.mma_schedule(base.row_ptr(), base.tile_cols, b,
                            ops.bin_groups(meta.swizzle.bin_of, b), real,
                            device)


def pad_tiles(tiles: torch.Tensor) -> torch.Tensor:
    """The tile stack with the schedule's trailing zero tile."""
    return torch.cat([tiles, tiles.new_zeros((1,) + tuple(tiles.shape[1:]))])


def bsmm_balanced_from_plan(meta: partitioner.BalancedPacking,
                            values: torch.Tensor,
                            x2: torch.Tensor) -> torch.Tensor:
    """SpMM from a one-time ``plan_packing_balanced`` analysis: pack the
    ``[nnz, b, b]`` values (as the uniform walk does), append the zero
    pad tile, walk the schedule.  Builds the schedules and copies them to
    the device on every call; ``sparse.plan`` keeps them there
    instead."""
    base = meta.base
    dev = x2.device
    tiles = pad_tiles(partitioner.pack_values(base, values)).contiguous()

    def on_dev(a):
        return torch.as_tensor(a, dtype=torch.int32, device=dev).contiguous()
    sched = (balanced_schedule(meta, dev) if dev.type == "cuda"
             and walk(base.tm, x2.dtype) == "mma" else None)
    return bsmm_balanced(x2, tiles, on_dev(meta.visit_rows),
                         on_dev(meta.visit_cols), on_dev(meta.visit_slot),
                         base.shape[0], sched)
