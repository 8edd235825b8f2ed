"""Expert-grouped GEMM (the gmm kernel) and the device-side tile packer
behind the ``dynamic_grouped`` routes.

Counterpart of the JAX package's ``kernels/gmm/ops.py``:

* ``gmm(x, w, expert_ids, tm=, tf=, td=)`` computes ``out[t] = x[t] @
  w[expert_ids[t // tm]]`` with fp32 accumulation.  For a CUDA tensor it
  launches ``csrc/gmm.cu`` (the port of ``src/repro/kernels/gmm/gmm.py``
  ``gmm_call``) or raises; for a CPU tensor it runs ``ref.gmm_ref``.
  MoE's expert GEMMs reach it through ``sparse.batched_matmul``.
  ``walk(tm, d, f, dtype)`` is the pure-Python choice of the kernel's
  walk: "wgmma" (16-bit, D and F multiples of 8: TMA + tensor cores) or
  "ffma" (the rest: fp32 FMA on the CUDA cores).
* ``grouped_spmm``: instead of walking ``b x b`` logical blocks, the
  runtime pattern is packed on the device into ``t x t`` tile slots and
  the dsmm slot walk runs on those tiles.  The tile capacity is planned
  (expected tiles x headroom, ``planner.plan_grouped_capacity``), so
  overflow is possible by design: tiles beyond ``tiles_cap`` are dropped
  from the product and counted exactly in ``GroupedPackStats``, never
  silently.  Every step is plain PyTorch on device tensors.
"""
from __future__ import annotations

import ctypes
import dataclasses
import warnings
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.dynamic_sparse import DynamicOperand
from repro_torch.analysis import cost as cost_lib
from repro_torch.kernels import _build, meta
from repro_torch.kernels.contract import elem_bytes, sub_block
from repro_torch.kernels.dsmm import ops as dsmm_ops
from repro_torch.kernels.gmm.ref import gmm_ref

DTYPES = _build.DTYPES
COUNTER = _build.LaunchCounter()
WALKS = ("wgmma", "ffma")
# launches per walk, beside the total COUNTER
WALK_COUNTERS = {name: _build.LaunchCounter() for name in WALKS}
MAX_TM = 128            # rows of a row tile the kernel holds
FFMA_TM = 64            # rows past which the FMA walk's blocks slow down
# Time of each gmm walk: (seconds a launch, FLOP/s, bytes/s), fitted by
# hand to chip_smoke.py's [kernel] gmm rows (qwen3's expert GEMMs at C 8
# and 80; device time, L2 cold; PERF.md lists them) on an NVIDIA H100
# 80GB HBM3 at a 700.00 W power limit.
WALK_MODEL = {"wgmma": (12e-6, 572e12, 3.35e12),
              "ffma": (12e-6, 9e12, 3.35e12)}
# the grouped routes' device tile pack (``pack_tiles_device``: plain
# PyTorch sorts and scatters), fitted to the same run's pack_ms
PACK_SECONDS = 0.35e-3


def walk_seconds(name: str, rows: int, d: int, f: int, experts: int,
                 dtype) -> float:
    """Modelled device seconds of gmm walk ``name`` for ``rows`` rows of
    ``x [rows, d]`` against ``experts`` expert matrices ``[d, f]`` (pure
    Python): its launch term plus the larger of its operations over its
    rate and its bytes (x, the experts' weights and the output once) over
    its bandwidth."""
    es = elem_bytes(dtype)
    launch, rate, bw = WALK_MODEL[name]
    return launch + max(2.0 * rows * d * f / rate,
                        (rows * d + experts * d * f + rows * f) * es / bw)


def grouped_seconds(n: int, m: int, k: int, tile: int, tiles: int,
                    dtype) -> float:
    """Modelled device seconds of ``grouped_spmm`` at ``tiles`` tile slots
    of ``tile`` (pure Python): the device pack, the slot encode and the
    dsmm walk over the packed tiles (their fullest tile-row taken as
    the mean: a pack's row profile is data)."""
    mt = max(1, -(-m // tile))
    name = dsmm_ops.walk(tile, dtype)
    return (PACK_SECONDS + dsmm_ops.encode_seconds(tiles)
            + dsmm_ops.walk_seconds(name, n, m, k, tile, tiles,
                                    -(-tiles // mt), dtype))


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


def grouped_tile(m: int, k: int, b: int) -> int:
    """The tile the grouped routes pack into on the port: the
    reference's ``grouped_tile_size`` where the dsmm kernel walks it;
    else the largest of the kernel's blocks that is a multiple of the
    block the operand is split into (``contract.sub_block``, at least 4)
    and divides ``m`` and ``k`` padded to that block (blocks that are not
    powers of two, grids that no kernel block divides)."""
    try:
        t = grouped_tile_size(m, k, b)
    except ValueError:
        t = 0
    if t in dsmm_ops.BLOCK_SIZES:
        return t
    wb = max(sub_block(b, dsmm_ops.BLOCK_SIZES), dsmm_ops.BLOCK_SIZES[0])
    mp, kp = dsmm_ops.padded(m, wb), dsmm_ops.padded(k, wb)
    return max(s for s in dsmm_ops.BLOCK_SIZES
               if s % wb == 0 and mp % s == 0 and kp % s == 0)


def fit_tile(op: DynamicOperand, tile: int) -> DynamicOperand:
    """``op`` as the ``tile`` pack takes it: each slot split into
    sub-blocks the tile is a multiple of (``dsmm.ops.split_slots``, on
    the device) and the shape padded to a tile multiple.  The operand
    itself where both already hold."""
    b = op.block_size
    if tile % b:
        op = dsmm_ops.split_slots(op, sub_block(b, dsmm_ops.BLOCK_SIZES))
    m, k = op.shape
    mp, kp = dsmm_ops.padded(m, tile), dsmm_ops.padded(k, tile)
    if (mp, kp) != (m, k):
        op = dataclasses.replace(op, shape=(mp, kp))
    return op


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
    mt, kt = -(-m // tile), -(-k // tile)
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
    t = tile or grouped_tile(m, k, op.block_size)
    mt, kt = -(-m // t), -(-k // t)
    if tiles_cap is None:
        # one tile a slot at worst, once split into blocks the tile takes
        split = (op.block_size // sub_block(op.block_size,
                                            dsmm_ops.BLOCK_SIZES)
                 if t % op.block_size else 1)
        tiles_cap = min(op.capacity * split * split, mt * kt)
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
    packed, stats = pack_tiles_device(fit_tile(op, t), tile=t, tiles_cap=cap,
                                      with_stats=return_stats)
    y = dsmm_ops.dsmm(packed, dsmm_ops.pad_cols(x2, packed.shape[1]))
    y = y[:, :op.shape[0]] if packed.shape[0] != op.shape[0] else y
    return (y, stats) if return_stats else y


# --- the gmm kernel ----------------------------------------------------------

def _fit(t: int, pref: int) -> int:
    """``pref`` halved until it divides ``t`` (the reference's tile fit)."""
    v = pref
    while t % v:
        v //= 2
    return max(v, 1)


def _check_gmm(x, w, expert_ids, tm: int, tf: int, td: int):
    if x.dim() != 2 or w.dim() != 3 or x.shape[1] != w.shape[1]:
        raise ValueError(f"gmm takes x [T, D] and w [E, D, F]; got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype not in DTYPES or w.dtype != x.dtype:
        raise ValueError(f"dtypes x={x.dtype}, w={w.dtype}: both one of "
                         f"{DTYPES}")
    if w.device != x.device or expert_ids.device != x.device:
        raise ValueError(f"x on {x.device}, w on {w.device}, expert_ids "
                         f"on {expert_ids.device}")
    t_rows, d = x.shape
    f = w.shape[2]
    if tm < 1 or t_rows % tm:
        raise ValueError(f"rows {t_rows} not divisible by tile {tm}")
    if expert_ids.dim() != 1 or expert_ids.shape[0] != t_rows // tm:
        raise ValueError("expert_ids must have one entry per row tile")
    if tf < 1 or f % tf or td < 1 or d % td:
        raise ValueError(f"tiles tf={tf}, td={td} must divide F={f}, "
                         f"D={d}")


@dataclasses.dataclass(frozen=True)
class Walk:
    """The kernel's walk for one problem: ``name`` "wgmma" | "ffma" and,
    for wgmma, ``bn`` the columns of F a block owns (64 or 128)."""

    name: str
    bn: int = 64


def tma_ok(d: int, f: int, dtype) -> bool:
    """Whether TMA can load x [T, D] and w [E, D, F]: 16-bit values and
    16-byte row strides (D and F multiples of 8)."""
    return (dtype in (torch.bfloat16, torch.float16) and d > 0
            and d % 8 == 0 and f % 8 == 0)


def walk(tm: int, d: int, f: int, dtype) -> Walk:
    """The walk ``gmm_cuda`` launches for row tiles of ``tm`` rows, x [.,
    D] and w [E, D, F] in ``dtype`` (pure Python; the CPU tests reach
    it): wgmma wherever TMA can load the operands, with 128-column
    blocks unless F fits 64; ffma elsewhere."""
    if not 1 <= tm <= MAX_TM:
        raise ValueError(f"gmm: row tile tm={tm} outside the kernel's "
                         f"1..{MAX_TM}")
    if tma_ok(d, f, dtype):
        return Walk("wgmma", bn=64 if f <= 64 else 128)
    return Walk("ffma")


def gmm_cuda(x: torch.Tensor, w: torch.Tensor, expert_ids: torch.Tensor, *,
             tm: int, plan: Optional[Walk] = None) -> torch.Tensor:
    """Launch the CUDA kernel (CUDA tensors; meta tensors take the meta
    branch, ``kernels/meta.py``; ``tm <= 128``) on ``walk(...)``'s walk,
    or on ``plan`` where the caller names one."""
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"gmm_cuda needs CUDA tensors, got {x.device}")
    if not 1 <= tm <= MAX_TM:
        raise ValueError(f"gmm_cuda: row tile tm={tm} outside the "
                         f"kernel's 1..{MAX_TM}")
    if expert_ids.dtype != torch.int32:
        raise ValueError(f"expert_ids must be int32, got {expert_ids.dtype}")
    # shapes and dtypes (the kernel reads expert_ids[T // tm - 1] and
    # takes w in x's dtype); any tf, td is fine here
    _check_gmm(x, w, expert_ids, tm, 1, 1)
    if not (x.is_contiguous() and w.is_contiguous()
            and expert_ids.is_contiguous()):
        raise ValueError("x, w and expert_ids must be contiguous")
    t_rows, d = x.shape
    e, _, f = w.shape
    out = torch.empty((t_rows, f), dtype=x.dtype, device=x.device)
    if t_rows == 0 or f == 0:
        return out
    wk = plan or walk(tm, d, f, x.dtype)
    if wk.name == "wgmma":
        if not tma_ok(d, f, x.dtype):
            raise ValueError(f"the wgmma walk needs 16-bit x, w with D and "
                             f"F multiples of 8; got {x.dtype}, D={d}, F={f}")
        # TMA reads from 16-byte-aligned bases: a view at an unaligned
        # offset is copied (fresh allocations are aligned)
        x, w = (a if a.data_ptr() % 16 == 0 else a.clone() for a in (x, w))
    # 16-byte loads of w (ffma) need F in whole vectors and an aligned base
    vec = int(f % (16 // w.element_size()) == 0 and w.data_ptr() % 16 == 0)
    if x.device.type == "meta":
        # the ids are data: every expert counted (as batched_matmul's
        # ids name each one)
        return meta.account("gmm", wk.name, out, cost_lib.gmm_cost(
            t_rows, d, f, e, x.element_size(), expert_ids.numel()))
    fn = _build.entry("gmm", "gmm", [ctypes.c_void_p] * 4
                      + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), w.data_ptr(), expert_ids.data_ptr(),
                  out.data_ptr(), t_rows // tm, tm, d, f, e,
                  WALKS.index(wk.name), wk.bn, vec,
                  _build.DTYPE_CODES[x.dtype], stream)
    _build.check(code, "gmm")
    COUNTER.launches += 1
    WALK_COUNTERS[wk.name].launches += 1
    return out


def gmm(x: torch.Tensor, w: torch.Tensor, expert_ids: torch.Tensor, *,
        tm: Optional[int] = None, tf: Optional[int] = None,
        td: Optional[int] = None) -> torch.Tensor:
    """Grouped GEMM.  ``x: [T, D]`` rows grouped by expert, ``w: [E, D,
    F]``, ``expert_ids: [T // tm]`` one expert per row tile -> ``[T, F]``
    in x's dtype.  ``tf``/``td`` are checked as the reference checks them
    (each must divide F / D); the kernel tiles F and D its own way
    whatever they say, and holds at most 128 rows a tile (``tm <= 128``,
    narrower than the reference).  CUDA tensors launch the kernel (or
    raise); CPU tensors run ``gmm_ref``; meta tensors take the meta
    branch."""
    t_rows, d = x.shape[0], x.shape[-1]
    f = w.shape[-1]
    tm = tm or (t_rows // max(int(expert_ids.shape[0]), 1))
    tf = tf or _fit(f, 128)
    td = td or _fit(d, 128)
    _check_gmm(x, w, expert_ids, tm, tf, td)
    if x.device.type in ("cuda", "meta"):
        return gmm_cuda(x.contiguous(), w.contiguous(),
                        expert_ids.to(torch.int32).contiguous(), tm=tm)
    if x.device.type != "cpu":
        raise ValueError(f"gmm: unsupported device {x.device}")
    return gmm_ref(x, w, expert_ids, tm=tm)
