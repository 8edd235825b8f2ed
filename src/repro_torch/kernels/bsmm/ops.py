"""Static block-sparse matmul: CUDA kernel wrapper, the tensor-core
walk's host schedule, and plain versions.

``bsmm_nt(x, tiles, row_ptr, tile_cols, tile_rows, m, schedule)``
computes ``y[N, M] = x[N, K] . W^T`` for the block-sparse ``W`` held as a
packed ``[T, tb, tb]`` tile stack (``partitioner.plan_packing`` with
``tm = tk = tb``).  For a CUDA tensor it launches ``csrc/bsmm.cu`` (the
port of ``src/repro/kernels/bsmm/bsmm.py`` ``bsmm_call``) or raises; for
a CPU tensor it runs ``bsmm_nt_plain``, the gather + einsum version.
``walk(b, dtype, n)`` is the pure-Python choice of the kernel's walk:
"decode" for the fewest tokens, "mma" (bf16/fp16 at b in
``MMA_BLOCKS``: tensor cores over groups of block-rows sharing x) or
"ffma" (fp32 FMA on the CUDA cores).  The "mma" walk reads an
``MmaSchedule`` that ``mma_schedule`` builds once per pattern on the
host (``sparse.plan`` keeps it on the device); ``bsmm_schedule_plain``
walks a schedule in plain PyTorch, as the kernel reads it.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.analysis import cost as cost_lib
from repro_torch.kernels import _build, meta
from repro_torch.kernels.contract import elem_bytes

TILE_SIZES = (4, 8, 16, 32, 64)
DTYPES = _build.DTYPES
COUNTER = _build.LaunchCounter()
WALKS = ("decode", "mma", "ffma")        # the C entry's walk codes, in order
# launches per walk, beside the total COUNTER
WALK_COUNTERS = {name: _build.LaunchCounter() for name in WALKS}
MMA_BLOCKS = (16, 32, 64)                # tiles the tensor-core walk takes
# tokens the decode kernel holds at each tile (4 a lane, 32 / b lanes a
# row of the tile)
DECODE_CAPACITY = {4: 32, 8: 16, 16: 8, 32: 4}
# the most tokens the decode walk takes where the mma walk would run
# (16-bit, b in MMA_BLOCKS), from chip_smoke.py's bsmm rows at N 4, 8,
# 16, 64 (b = 16): summed over llama's up, gate and down projections the
# decode walk is faster at N 4, the mma walk from N 8 on (alone, up/gate
# favours decode to N 8 and down mma from N 4); b = 32 keeps the decode
# kernel's capacity (not measured); elsewhere the decode walk takes all
# it holds
DECODE_MAX_N_MMA = {16: 4, 32: 4}
# the mma walk (csrc/bsmm_mma.cuh): x's chunks of MMA_CHUNK columns; a
# group of MMA_ROWS[b] block-rows; at most MMA_STAGE_BLOCKS[b] blocks a
# stage (the kernel checks both against its build)
MMA_CHUNK = 64
MMA_ROWS = {16: 16, 32: 16, 64: 8}
MMA_STAGE_BLOCKS = {16: 16, 32: 8, 64: 2}
MMA_TOKENS = {16: 128, 32: 64, 64: 64}   # tokens a thread block owns
SMS = 132                                # the H100's SMs
# K slices: a slice walks at least this many stages
MMA_MIN_SLICE_STAGES = 8
_MMA_DTYPES = (torch.bfloat16, torch.float16)
# Time of each walk: (seconds a launch, FLOP/s, bytes/s) by (walk, bytes
# per value), fitted by hand to chip_smoke.py's [kernel] bsmm rows and
# [table3] static_cuda rows (device time, L2 cold; PERF.md lists them) on
# an NVIDIA H100 80GB HBM3 at a 700.00 W power limit.  The mma walk reads
# x once per stage (a group's chunk of MMA_CHUNK columns) from L2; the
# ffma walk computes whole 64-token tiles at FFMA_RATE[tile]; the decode
# walk streams the tiles with one block per tile-row, at full rate from
# DECODE_FULL_ROWS tile-rows up (fitted to llama's down projection, 128
# tile-rows: 0.0133 to 0.0155 ms at N 4 in bf16).
WALK_MODEL = {
    ("decode", 2): (4.0e-6, 10e12, 0.72e12),
    ("decode", 4): (4.0e-6, 10e12, 1.0e12),
    ("mma", 2): (13e-6, 572e12, 4.1e12),
    ("ffma", 2): (8.0e-6, 0.0, 3.0e12),
    ("ffma", 4): (8.0e-6, 0.0, 3.0e12),
}
# FLOP/s of the ffma walk by tile (4 and 16 fitted; 8 interpolated, 32
# and 64 taken as 16's: not measured)
FFMA_RATE = {4: 2.95e12, 8: 5.9e12, 16: 9.9e12, 32: 9.9e12, 64: 9.9e12}
DECODE_FULL_ROWS = 200


def walk_seconds(name: str, n: int, m: int, k: int, tile: int, tiles: int,
                 stages: int, dtype) -> float:
    """Modelled device seconds of walk ``name`` for ``x [n, k] . W^T``
    with ``W [m, k]`` packed into ``tiles`` tiles of ``tile`` (pad tiles
    of empty rows included) and, on the mma walk, ``stages`` stages (a
    group's chunk of x, or a share of one: ``mma_stage_count``): its
    launch term plus the larger of its operations over its rate and its
    bytes over its bandwidth."""
    es = elem_bytes(dtype)
    launch, rate, bw = WALK_MODEL[(name, es)]
    area = float(tiles) * tile * tile
    if name == "mma":
        nbytes = (area + n * m + stages * MMA_CHUNK * n) * es
        return launch + max(2.0 * n * area / rate, nbytes / bw)
    nbytes = (area + n * k + n * m) * es
    if name == "ffma":
        rows = -(-n // 64) * 64
        return launch + max(2.0 * rows * area / FFMA_RATE[tile],
                            nbytes / bw)
    bw *= min(1.0, (m // tile) / DECODE_FULL_ROWS)
    return launch + max(2.0 * n * area / rate, nbytes / bw)


def mma_stage_count(tile_rows, tile_cols, b: int, group_rows=None) -> int:
    """Stages of the mma walk over the (unique) tiles at ``tile_rows``,
    ``tile_cols`` (numpy, pure Python): per group and chunk of x, its
    tiles in stages of at most ``MMA_STAGE_BLOCKS[b]``.  Groups are
    ``MMA_ROWS[b]`` consecutive tile-rows, or ``group_rows[r]`` where
    given (a bin of the balanced walk)."""
    rows = np.asarray(tile_rows, np.int64)
    cols = np.asarray(tile_cols, np.int64)
    if rows.size == 0:
        return 0
    grp = (rows // MMA_ROWS[b] if group_rows is None
           else np.asarray(group_rows, np.int64)[rows])
    key = grp * (int(cols.max()) // (MMA_CHUNK // b) + 1) \
        + cols // (MMA_CHUNK // b)
    _, cnt = np.unique(key, return_counts=True)
    return int(np.sum(-(-cnt // MMA_STAGE_BLOCKS[b])))


def walk(b: int, dtype, n: int) -> str:
    """The walk ``bsmm_nt_cuda`` launches for ``n`` tokens at tile ``b``
    in ``dtype`` (pure Python; the CPU tests reach it): "decode" up to
    the crossover (``DECODE_MAX_N_MMA`` where "mma" applies, else the
    decode kernel's capacity), "mma" for bf16/fp16 at b in
    ``MMA_BLOCKS``, "ffma" elsewhere."""
    if b not in TILE_SIZES:
        raise ValueError(f"bsmm kernel takes tiles of {TILE_SIZES}; got {b}")
    mma = dtype in _MMA_DTYPES and b in MMA_BLOCKS
    cap = DECODE_MAX_N_MMA.get(b, 0) if mma else DECODE_CAPACITY.get(b, 0)
    if n <= cap:
        return "decode"
    return "mma" if mma else "ffma"


@dataclasses.dataclass(frozen=True)
class MmaSchedule:
    """The "mma" walk's schedule of one pattern (``mma_schedule``), in
    the layout ``csrc/bsmm_mma.cuh`` reads.  Group ``g`` owns the
    block-rows ``group_rows[g]`` (-1: none) and walks stages
    ``stage_ptr[g] .. stage_ptr[g + 1] - 1``; stage ``s`` reads x's
    chunk ``stage_chunk[s]`` (``MMA_CHUNK`` columns) and, for each row
    slot ``r``, ``stage_runs[s, r] = (first tile, bits | place << 8)``:
    the row's tiles in the chunk are ``first, first + 1, ...``, one per
    set bit (their block columns within the chunk), packed from
    ``place`` among the stage's blocks."""

    b: int
    group_rows: torch.Tensor     # [G, R] int32
    stage_ptr: torch.Tensor      # [G + 1] int32
    stage_chunk: torch.Tensor    # [S] int32
    stage_runs: torch.Tensor     # [S, R, 2] int32

    @property
    def groups(self) -> int:
        return int(self.group_rows.shape[0])

    @property
    def rows(self) -> int:
        return int(self.group_rows.shape[1])

    @property
    def stages(self) -> int:
        return int(self.stage_chunk.shape[0])


def uniform_groups(row_tiles: int, b: int) -> np.ndarray:
    """bsmm's groups: consecutive block-rows, ``MMA_ROWS[b]`` a group
    (the last one short, padded with -1)."""
    r = MMA_ROWS[b]
    g = -(-row_tiles // r)
    out = np.full(g * r, -1, np.int32)
    out[:row_tiles] = np.arange(row_tiles, dtype=np.int32)
    return out.reshape(g, r)


def bin_groups(bin_of: np.ndarray, b: int) -> np.ndarray:
    """bsmm_balanced's groups: the block-rows of each bin of a row swizzle
    (``partitioner.plan_swizzle``'s ``bin_of``), ascending, a bin of more
    than ``MMA_ROWS[b]`` rows cut into several groups (at ``ceil(mb /
    R)`` bins none is: sorted-snake dealing gives every bin
    ``floor(mb / bins)`` or ``ceil(mb / bins)`` rows)."""
    r = MMA_ROWS[b]
    bin_of = np.asarray(bin_of, np.int64)
    groups = []
    for g in range(int(bin_of.max()) + 1 if bin_of.size else 0):
        rows = np.flatnonzero(bin_of == g).astype(np.int32)
        for i in range(0, rows.size, r):
            part = np.full(r, -1, np.int32)
            part[:rows[i:i + r].size] = rows[i:i + r]
            groups.append(part)
    return (np.stack(groups) if groups
            else np.zeros((0, r), np.int32))


def real_tiles(num_tiles: int, block_slot) -> np.ndarray:
    """``[T]`` bool: the tiles a block lands in (a packing's
    ``block_slot``); the rest are the pad tiles of empty rows."""
    real = np.zeros(num_tiles, bool)
    real[np.asarray(block_slot, np.int64)] = True
    return real


def packing_schedule(packing, device=None) -> MmaSchedule:
    """The "mma" walk's schedule of a ``plan_packing`` at a tile of
    ``MMA_BLOCKS``: consecutive block-rows as groups
    (``uniform_groups``), the pad tiles left out."""
    b = packing.tm
    return mma_schedule(packing.row_ptr(), packing.tile_cols, b,
                        uniform_groups(packing.grid[0], b),
                        real_tiles(packing.num_tiles, packing.block_slot),
                        device)


def mma_schedule(row_ptr, tile_cols, b: int, group_rows,
                 real: Optional[np.ndarray] = None,
                 device=None) -> MmaSchedule:
    """The "mma" walk's schedule of a CSR tile order (numpy, once per
    pattern): for each group of ``group_rows``, the ascending chunks of x
    its rows' tiles touch, a stage per chunk (several where the chunk
    holds more than ``MMA_STAGE_BLOCKS[b]`` of the group's blocks), and
    per stage and row slot the run's first tile, block columns and place.
    ``real`` marks the tiles to walk (default all): the plan leaves out
    the pad tiles of empty rows, whose rows are written as zeros.  Each
    row's tiles must be consecutive and in ascending columns (the order
    of ``plan_packing``)."""
    if b not in MMA_BLOCKS:
        raise ValueError(f"the mma walk takes tiles of {MMA_BLOCKS}; got {b}")
    row_ptr = np.asarray(row_ptr, np.int64)
    cols = np.asarray(tile_cols, np.int64)
    mb, t = row_ptr.size - 1, cols.size
    r_slots, e_cols, cap = MMA_ROWS[b], MMA_CHUNK // b, MMA_STAGE_BLOCKS[b]
    group_rows = np.asarray(group_rows, np.int32).reshape(-1, r_slots)
    n_groups = group_rows.shape[0]
    grp_of = np.full(mb, -1, np.int64)
    slot_of = np.full(mb, -1, np.int64)
    gg, ll = np.nonzero(group_rows >= 0)
    rr = group_rows[gg, ll].astype(np.int64)
    if rr.size and (rr.max() >= mb or np.unique(rr).size != rr.size):
        raise ValueError("group_rows must name each block-row below "
                         f"{mb} at most once")
    grp_of[rr], slot_of[rr] = gg, ll
    tile_rows = np.repeat(np.arange(mb), np.diff(row_ptr))
    keep = grp_of[tile_rows] >= 0
    if real is not None:
        keep &= np.asarray(real, bool)
    tix = np.flatnonzero(keep)
    g, lr = grp_of[tile_rows[tix]], slot_of[tile_rows[tix]]
    q, cb = cols[tix] // e_cols, cols[tix] % e_cols
    order = np.lexsort((cb, lr, q, g))
    tix, g, lr, q, cb = (a[order] for a in (tix, g, lr, q, cb))
    new_gq = np.ones(tix.size, bool)
    new_gq[1:] = (g[1:] != g[:-1]) | (q[1:] != q[:-1])
    starts = np.flatnonzero(new_gq)
    rank = np.arange(tix.size) - starts[np.cumsum(new_gq) - 1]
    sub = rank // cap
    new_st = new_gq.copy()
    new_st[1:] |= sub[1:] != sub[:-1]
    st = np.cumsum(new_st) - 1
    new_run = new_st.copy()
    new_run[1:] |= lr[1:] != lr[:-1]
    run_start = np.flatnonzero(new_run)
    run_of = np.cumsum(new_run) - 1
    # the e-th block of a run is tile first + e
    if not np.array_equal(tix - tix[run_start][run_of],
                          np.arange(tix.size) - run_start[run_of]):
        raise ValueError("a row's tiles in a chunk must be consecutive in "
                         "the tile stack (CSR order, columns ascending)")
    n_st = int(st[-1]) + 1 if st.size else 0
    runs = np.zeros((n_st, r_slots, 2), np.int64)
    runs[st[run_start], lr[run_start], 0] = tix[run_start]
    runs[st[run_start], lr[run_start], 1] = (rank[run_start] % cap) << 8
    np.bitwise_or.at(runs[..., 1], (st, lr), np.int64(1) << cb)
    stage_ptr = np.searchsorted(g[new_st], np.arange(n_groups + 1))
    if t >= 1 << 31:
        raise ValueError(f"{t} tiles do not fit the schedule's int32")

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int32),
                               device=device)
    return MmaSchedule(b, dev(group_rows), dev(stage_ptr), dev(q[new_st]),
                       dev(runs))


def bsmm_schedule_plain(x: torch.Tensor, tiles: torch.Tensor,
                        sched: MmaSchedule, m: int) -> torch.Tensor:
    """Plain PyTorch walker of an ``MmaSchedule``: every stage's runs read
    as the kernel reads them (the e-th set bit of a row's run is tile
    ``first + e`` at block column ``chunk * (MMA_CHUNK / b) + bit``), each
    tile multiplied with its x slice in fp32 and added into its row; a
    row slot without runs gives zeros.  Same inputs and result as the
    kernel's "mma" walk."""
    n, k = x.shape
    b = sched.b
    e_cols = MMA_CHUNK // b
    runs = sched.stage_runs.long()
    first, word = runs[..., 0], runs[..., 1]
    group = torch.repeat_interleave(
        torch.arange(sched.groups, device=runs.device),
        torch.diff(sched.stage_ptr.long()), output_size=sched.stages)
    rows = sched.group_rows.long()[group]                       # [S, R]
    chunk = sched.stage_chunk.long()[:, None].expand_as(rows)
    t_idx, r_idx, c_idx = [], [], []
    for c in range(e_cols):
        on = (word >> c) & 1 == 1
        before = sum(((word >> j) & 1) for j in range(c))      # e of bit c
        t_idx.append((first + before)[on])
        r_idx.append(rows[on])
        c_idx.append((chunk * e_cols + c)[on])
    t_idx, r_idx, c_idx = (torch.cat(a) for a in (t_idx, r_idx, c_idx))
    xs = x.float().reshape(n, k // b, b)[:, c_idx]              # [N, V, b]
    part = torch.einsum("nvj,vij->nvi", xs, tiles.float()[t_idx])
    y = torch.zeros((n, m // b, b), dtype=torch.float32, device=x.device)
    y.index_add_(1, r_idx, part)
    return y.reshape(n, m).to(x.dtype)


def bsmm_nt_plain(x: torch.Tensor, tiles: torch.Tensor,
                  tile_rows: torch.Tensor, tile_cols: torch.Tensor,
                  m: int) -> torch.Tensor:
    """Plain PyTorch version: gather each tile's x slice, multiply in
    fp32, scatter-add into the tile's output rows.  Same inputs and
    result as the kernel (``tile_rows``/``tile_cols`` as long tensors)."""
    n, k = x.shape
    t, tm, tk = tiles.shape
    xs = x.float().reshape(n, k // tk, tk)[:, tile_cols]        # [N, T, tk]
    part = torch.einsum("ntk,tmk->ntm", xs, tiles.float())      # [N, T, tm]
    y = torch.zeros((n, m // tm, tm), dtype=torch.float32, device=x.device)
    y.index_add_(1, tile_rows, part)
    return y.reshape(n, m).to(x.dtype)


def _check(x, tiles, row_ptr, tile_cols, m):
    if x.dim() != 2 or tiles.dim() != 3:
        raise ValueError(f"x must be [N, K] and tiles [T, tb, tb]; got "
                         f"{tuple(x.shape)} and {tuple(tiles.shape)}")
    n, k = x.shape
    t, tm, tk = tiles.shape
    if tm != tk or tm not in TILE_SIZES:
        raise ValueError(f"bsmm kernel takes square tiles of {TILE_SIZES}; "
                         f"got {tm}x{tk}")
    if k % tk or m % tm:
        raise ValueError(f"k={k}, m={m} must be multiples of the tile {tm}")
    if x.dtype not in DTYPES or tiles.dtype != x.dtype:
        raise ValueError(f"dtypes x={x.dtype}, tiles={tiles.dtype}: both "
                         f"one of {DTYPES}")
    if row_ptr.dtype != torch.int32 or tile_cols.dtype != torch.int32:
        raise ValueError("row_ptr and tile_cols must be int32")
    if row_ptr.numel() != m // tm + 1 or tile_cols.numel() != t:
        raise ValueError(f"row_ptr has {row_ptr.numel()} entries (want "
                         f"{m // tm + 1}), tile_cols {tile_cols.numel()} "
                         f"(want {t})")
    for name, a in (("x", x), ("tiles", tiles), ("row_ptr", row_ptr),
                    ("tile_cols", tile_cols)):
        if a.device != x.device:
            raise ValueError(f"{name} on {a.device}, x on {x.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check_schedule(sched, b, m, dev):
    if not isinstance(sched, MmaSchedule) or sched.b != b:
        raise ValueError(f"the mma walk needs the pattern's MmaSchedule at "
                         f"tile {b} (mma_schedule; sparse.plan keeps one)")
    if sched.rows != MMA_ROWS[b] or sched.groups < -(-(m // b) //
                                                     sched.rows):
        raise ValueError(f"schedule of {sched.groups} groups of "
                         f"{sched.rows} rows does not cover {m // b} "
                         f"block-rows")
    for name in ("group_rows", "stage_ptr", "stage_chunk", "stage_runs"):
        a = getattr(sched, name)
        if a.dtype != torch.int32 or a.device != dev \
                or not a.is_contiguous():
            raise ValueError(f"schedule {name} must be contiguous int32 on "
                             f"{dev}")


def mma_slices(sched: MmaSchedule, n: int) -> int:
    """K slices of the mma walk for ``n`` tokens: 1 where the groups and
    token tiles fill half the card; else as many as keep the blocks in
    one wave of its SMs, each slice walking at least
    ``MMA_MIN_SLICE_STAGES`` of its group's stages on average (pure
    Python)."""
    blocks = sched.groups * -(-n // MMA_TOKENS[sched.b])
    if blocks == 0 or 2 * blocks > SMS:
        return 1
    deep = sched.stages // max(1, sched.groups * MMA_MIN_SLICE_STAGES)
    return max(1, min(SMS // blocks, deep))


def aligned(a: torch.Tensor) -> torch.Tensor:
    """``a``, or a copy where its base is not 16-byte aligned (TMA and
    cp.async read from 16-byte-aligned bases; fresh allocations are)."""
    return a if a.data_ptr() % 16 == 0 else a.clone()


def mma_args(sched: Optional[MmaSchedule], n: int, m: int, dev):
    """The C entry's schedule arguments: four pointers, then groups, rows,
    the stage capacity and the K slices (nulls and zeros without a
    schedule), and the slices' fp32 scratch (None for one slice)."""
    if sched is None:
        return [None] * 4 + [0, 0, 0, 1], None
    slices = mma_slices(sched, n)
    part = (torch.empty(slices * n * m, dtype=torch.float32, device=dev)
            if slices > 1 else None)
    return [sched.group_rows.data_ptr(), sched.stage_ptr.data_ptr(),
            sched.stage_chunk.data_ptr(), sched.stage_runs.data_ptr(),
            sched.groups, sched.rows, MMA_STAGE_BLOCKS[sched.b],
            slices], part


def bsmm_nt_cuda(x: torch.Tensor, tiles: torch.Tensor,
                 row_ptr: torch.Tensor, tile_cols: torch.Tensor,
                 m: int, schedule: Optional[MmaSchedule] = None,
                 plan: Optional[str] = None) -> torch.Tensor:
    """Launch the CUDA kernel (CUDA tensors; meta tensors take the meta
    branch, ``kernels/meta.py``) on ``walk(...)``'s walk, or on ``plan``
    where the caller names one; the "mma" walk reads ``schedule``.  A
    walk that does not apply raises."""
    _check(x, tiles, row_ptr, tile_cols, m)
    n, k = x.shape
    b = tiles.shape[1]
    wk = plan or walk(b, x.dtype, n)
    if wk not in WALKS or (wk == "mma" and not (
            x.dtype in _MMA_DTYPES and b in MMA_BLOCKS)) or (
            wk == "decode" and n > DECODE_CAPACITY.get(b, 0)):
        raise ValueError(f"bsmm walk {wk!r} does not take b={b}, n={n} in "
                         f"{x.dtype}")
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"bsmm_nt_cuda needs CUDA tensors, got {x.device}")
    y = torch.empty((n, m), dtype=x.dtype, device=x.device)
    if n == 0:
        return y
    if wk == "mma":
        check_schedule(schedule, b, m, x.device)
        x, tiles = aligned(x), aligned(tiles)
    if x.device.type == "meta":
        # the K slices' fp32 scratch, as a launch allocates it
        mma_args(schedule if wk == "mma" else None, n, m, x.device)
        return meta.account("bsmm", wk, y, cost_lib.bsmm_cost(
            n, k, m, tiles.shape[0], b, x.element_size(),
            row_ptr.numel() + tile_cols.numel()))
    fn = _build.entry("bsmm", "bsmm_nt",
                      [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10
                      + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    sargs, part = mma_args(schedule if wk == "mma" else None, n, m,
                           x.device)
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), tiles.data_ptr(), row_ptr.data_ptr(),
                  tile_cols.data_ptr(), *sargs[:4], y.data_ptr(),
                  None if part is None else part.data_ptr(), n, k, m, b,
                  *sargs[4:], _build.DTYPE_CODES[x.dtype], WALKS.index(wk),
                  stream)
    _build.check(code, "bsmm_nt")
    COUNTER.launches += 1
    WALK_COUNTERS[wk].launches += 1
    return y


def bsmm_nt(x: torch.Tensor, tiles: torch.Tensor, row_ptr: torch.Tensor,
            tile_cols: torch.Tensor, tile_rows: torch.Tensor,
            m: int, schedule: Optional[MmaSchedule] = None) -> torch.Tensor:
    """``y[N, M] = x[N, K] . W^T`` over the packed tile stack.  CUDA
    tensors launch the kernel (or raise; the "mma" walk reads
    ``schedule``); CPU tensors run the plain version; meta tensors take
    the meta branch."""
    if x.device.type in ("cuda", "meta"):
        return bsmm_nt_cuda(x, tiles, row_ptr, tile_cols, m, schedule)
    if x.device.type != "cpu":
        raise ValueError(f"bsmm_nt: unsupported device {x.device}")
    return bsmm_nt_plain(x, tiles, tile_rows.long(), tile_cols.long(), m)
