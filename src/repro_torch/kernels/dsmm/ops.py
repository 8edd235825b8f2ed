"""Dynamic block-sparse matmul: runtime slot encoder, CUDA kernel
wrapper and plain version.

``dsmm_slots(x2, values, rows, cols, m)`` computes ``y[N, m] = x2[N, k]
. W^T`` for ``W`` held as runtime slots (``values[s]`` is the ``b x b``
block at block-row ``rows[s]``, block-col ``cols[s]``; each block-row's
slots contiguous).  For a CUDA tensor it launches ``csrc/dsmm.cu`` (the
port of ``src/repro/kernels/dsmm/dsmm.py`` ``dsmm_call``) or raises; for
a CPU tensor it runs ``dsmm_plain``, the gather + einsum + ``index_add_``
version.  ``dsmm(op, x2)`` encodes a ``DynamicOperand`` with
``encode_slots`` first (the ``dynamic_pallas`` route), after
``kernel_operand`` has brought a block the kernel does not take onto one
it does (``split_slots`` into sub-blocks, ``reblock`` below 4, the shape
padded to the walked block).  ``walk(b, dtype)`` is the pure-Python
choice of the kernel's walk: "mma" (bf16/fp16 at b in {16, 32, 64, 128}:
tensor cores over groups of block-rows, x shared through TMA) or "ffma"
(the rest: fp32 FMA on the CUDA cores).  Nothing here reads a device
value on the host.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.dynamic_sparse import DynamicOperand
from repro_torch.analysis import cost as cost_lib
from repro_torch.kernels import _build, meta
from repro_torch.kernels.contract import elem_bytes, sub_block

BLOCK_SIZES = (4, 8, 16, 32, 64, 128)
DTYPES = _build.DTYPES
COUNTER = _build.LaunchCounter()
WALKS = ("mma", "ffma")
# launches per walk, beside the total COUNTER
WALK_COUNTERS = {name: _build.LaunchCounter() for name in WALKS}
MMA_BLOCKS = (16, 32, 64, 128)   # blocks the tensor-core walk takes
# Time of each walk: (seconds a launch, seconds a slot of a block-row's
# chain at b = 16, bytes/s) by walk, and its FLOP/s by block, fitted by
# hand to chip_smoke.py's [kernel] dsmm rows (FFN up/gate and down at N
# 4, 256, 2048; Table 3 at b 4 and 16; the t = 128 grouped tiles; device
# time, L2 cold; PERF.md lists them) on an NVIDIA H100 80GB HBM3 at a
# 700.00 W power limit.  A block-row's slots run one after another, so
# the row with the most slots bounds the walk at few tokens; the rates of
# blocks 8, 32 and 64 are interpolated (not measured).
WALK_MODEL = {"mma": (14e-6, 1.8e-6, 3.35e12),
              "ffma": (10e-6, 1.6e-6, 3.35e12)}
WALK_RATE = {"mma": {16: 55e12, 32: 80e12, 64: 120e12, 128: 158e12},
             "ffma": {4: 3.66e12, 8: 6.4e12, 16: 9.1e12, 32: 9.1e12,
                      64: 9.1e12, 128: 9.1e12}}
# the device encode (``encode_slots``: a stable sort of the slots),
# fitted to the same rows' encode_ms
ENCODE_MODEL = (60e-6, 1.6e-9)           # seconds a call, seconds a slot


def walk_seconds(name: str, n: int, m: int, k: int, b: int, slots: int,
                 row_slots: int, dtype) -> float:
    """Modelled device seconds of walk ``name`` over ``slots`` slots of
    ``b x b`` (``row_slots`` of them in the fullest block-row) for ``x [n,
    k] . W^T``, ``W [m, k]`` (pure Python): its launch term plus the
    largest of the fullest row's chain, its operations over its rate and
    its bytes (values, x and y once) over its bandwidth.  The ffma walk
    computes whole 64-token tiles.  The encode is ``encode_seconds``."""
    es = elem_bytes(dtype)
    launch, per_slot, bw = WALK_MODEL[name]
    rows = n if name == "mma" else -(-n // 64) * 64
    area = float(slots) * b * b
    return launch + max(row_slots * per_slot * b / 16,
                        2.0 * rows * area / WALK_RATE[name][b],
                        (area + n * k + n * m) * es / bw)


def encode_seconds(slots: int) -> float:
    """Modelled device seconds of ``encode_slots`` over ``slots`` slots."""
    return ENCODE_MODEL[0] + ENCODE_MODEL[1] * slots


def walk(b: int, dtype) -> str:
    """The walk ``dsmm_cuda`` launches at block ``b`` in ``dtype`` (pure
    Python; the CPU tests reach it): "mma" for bf16/fp16 at b in
    ``MMA_BLOCKS``, "ffma" elsewhere."""
    if b not in BLOCK_SIZES:
        raise ValueError(f"dsmm kernel takes blocks of {BLOCK_SIZES}; "
                         f"got {b}")
    if dtype in (torch.bfloat16, torch.float16) and b in MMA_BLOCKS:
        return "mma"
    return "ffma"


def encode_slots(op: DynamicOperand
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Runtime re-partitioning on the device (the reference's
    ``dsmm/ops.py:10-26``, in the order the port's walks want):

    1. send the padding slots (index ``>= op.nnz``, zeros at (0, 0)) to
       block-row ``grid_m``, off the grid, where the walks skip them;
    2. stable-sort the slots by ``row * grid_k + col``, so each row's
       slots are contiguous and in ascending column order for any
       runtime pattern (the padding last).

    The reference also prepends a zero 'coverage' slot to every block-row
    so that its walk writes rows without a block; the port's walks write
    every output row whatever the slots, so it has none (a coverage slot
    beside a block in the same column would cost the tensor-core walk an
    extra sweep).  Returns ``(rows, cols, values)`` of the ``S`` slots.
    Reads nothing on the host."""
    mb, kb = op.grid
    dev = op.values.device
    pad = torch.arange(op.capacity, device=dev) >= op.nnz
    rows = torch.where(pad, mb, op.row_idx.to(torch.int32))
    cols = op.col_idx.to(torch.int32)
    order = torch.argsort(rows.long() * kb + cols.long(), stable=True)
    return rows[order], cols[order], op.values[order]


def reblock(op: DynamicOperand, t: int = BLOCK_SIZES[0]) -> DynamicOperand:
    """Blocks below the kernel's, on the device: each ``b x b`` slot
    (``b`` dividing ``t``) embedded at its offset in the ``t x t`` block
    that covers it, zeros elsewhere; slots that share a ``t``-block add
    in the walk.  Padding slots stay zero.  Reads nothing on the host."""
    b = op.block_size
    r = t // b
    rows, cols = op.row_idx.long(), op.col_idx.long()
    s = op.capacity
    vals = op.values.new_zeros((s, r, b, r, b))
    vals[torch.arange(s, device=vals.device), rows % r, :, cols % r, :] = \
        op.values
    return DynamicOperand(vals.reshape(s, t, t), (rows // r).to(torch.int32),
                          (cols // r).to(torch.int32), op.nnz, op.shape, t)


def split_slots(op: DynamicOperand, g: int) -> DynamicOperand:
    """Each ``b x b`` slot as ``(b / g)^2`` slots of ``g x g`` (``g``
    dividing ``b``), on the device: slot z's sub-block (i, j) at ``(z r +
    i) r + j`` with ``r = b / g``, so the valid slots stay first (``nnz``
    scaled by ``r^2``).  The same matrix; reads nothing on the host."""
    b = op.block_size
    if g == b:
        return op
    r = b // g
    s = op.capacity
    vals = op.values.reshape(s, r, g, r, g).permute(0, 1, 3, 2, 4).reshape(
        s * r * r, g, g)
    i = torch.arange(r, device=op.values.device)
    rows = (op.row_idx.long()[:, None, None] * r + i[None, :, None]).expand(
        s, r, r).reshape(-1)
    cols = (op.col_idx.long()[:, None, None] * r + i[None, None, :]).expand(
        s, r, r).reshape(-1)
    return DynamicOperand(vals, rows.to(torch.int32), cols.to(torch.int32),
                          op.nnz * (r * r), op.shape, g)


def padded(n: int, t: int) -> int:
    """``n`` rounded up to a multiple of ``t``."""
    return -(-n // t) * t


def pad_cols(x2: torch.Tensor, k: int) -> torch.Tensor:
    """``x2 [N, k0]`` contiguous, with zero columns up to ``k`` (the
    activations of a product walked on a padded shape)."""
    if x2.shape[1] == k:
        return x2.contiguous()
    return torch.nn.functional.pad(x2, (0, k - x2.shape[1]))


def kernel_operand(op: DynamicOperand) -> DynamicOperand:
    """``op`` at a block the kernel walks: each slot split into the
    largest of ``BLOCK_SIZES`` that divides ``b`` (``split_slots``; 2 or
    1 where none does), then ``reblock``ed into 4 x 4 blocks below 4,
    the shape padded to a multiple of the walked block (where ``m`` or
    ``k`` is a multiple of ``b`` and not of it).  The operand itself
    where the kernel takes ``b``."""
    b = op.block_size
    if b in BLOCK_SIZES:
        return op
    g = sub_block(b, BLOCK_SIZES)
    op = split_slots(op, g)
    t = max(g, BLOCK_SIZES[0])
    m, k = op.shape
    if (padded(m, t), padded(k, t)) != (m, k):
        op = dataclasses.replace(op, shape=(padded(m, t), padded(k, t)))
    return reblock(op, t) if g < t else op


def dsmm_plain(x2: torch.Tensor, values: torch.Tensor, rows: torch.Tensor,
               cols: torch.Tensor, m: int,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain PyTorch version: gather each slot's x slice, multiply in
    fp32, add into the slot's output rows.  Same inputs and result as
    the kernel: a slot whose row or col lies outside the grid adds
    nothing."""
    n, k = x2.shape
    b = values.shape[-1]
    mb, kb = m // b, k // b
    r, c = rows.long(), cols.long()
    keep = ((r >= 0) & (r < mb) & (c >= 0) & (c < kb)).float()
    xs = x2.float().reshape(n, kb, b)[:, c.clamp(0, max(kb - 1, 0))]
    part = torch.einsum("nsj,sij->nsi", xs, values.float()
                        * keep[:, None, None])                 # [N, S, b]
    y = torch.zeros((n, mb, b), dtype=torch.float32, device=x2.device)
    y.index_add_(1, r.clamp(0, max(mb - 1, 0)), part)
    return y.reshape(n, m).to(out_dtype or x2.dtype)


def _check(x2, values, rows, cols, m):
    if x2.dim() != 2 or values.dim() != 3:
        raise ValueError(f"x2 must be [N, K] and values [S, b, b]; got "
                         f"{tuple(x2.shape)} and {tuple(values.shape)}")
    n, k = x2.shape
    s, b, b2 = values.shape
    if b != b2 or b not in BLOCK_SIZES:
        raise ValueError(f"dsmm kernel takes square blocks of "
                         f"{BLOCK_SIZES}; got {b}x{b2}")
    if k % b or m % b:
        raise ValueError(f"k={k}, m={m} must be multiples of the block {b}")
    if x2.dtype not in DTYPES or values.dtype != x2.dtype:
        raise ValueError(f"dtypes x2={x2.dtype}, values={values.dtype}: "
                         f"both one of {DTYPES}")
    if rows.dtype != torch.int32 or cols.dtype != torch.int32:
        raise ValueError("rows and cols must be int32")
    if rows.numel() != s or cols.numel() != s:
        raise ValueError(f"rows has {rows.numel()} entries, cols "
                         f"{cols.numel()} (want {s})")
    for name, a in (("x2", x2), ("values", values), ("rows", rows),
                    ("cols", cols)):
        if a.device != x2.device:
            raise ValueError(f"{name} on {a.device}, x2 on {x2.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def dsmm_cuda(x2: torch.Tensor, values: torch.Tensor, rows: torch.Tensor,
              cols: torch.Tensor, m: int,
              out_dtype: Optional[torch.dtype] = None,
              plan: Optional[str] = None) -> torch.Tensor:
    """Launch the CUDA kernel (CUDA tensors; meta tensors take the meta
    branch, ``kernels/meta.py``) on ``walk(...)``'s walk, or on ``plan``
    where the caller names one."""
    _check(x2, values, rows, cols, m)
    n, k = x2.shape
    b = values.shape[-1]
    wk = plan or walk(b, x2.dtype)
    if wk not in WALKS or (wk == "mma" and walk(b, x2.dtype) != "mma"):
        raise ValueError(f"dsmm walk {wk!r} does not take b={b} in "
                         f"{x2.dtype}")
    if x2.device.type not in ("cuda", "meta"):
        raise ValueError(f"dsmm_cuda needs CUDA tensors, got {x2.device}")
    if out_dtype not in (None, x2.dtype):
        raise ValueError(f"the dsmm kernel writes its input dtype "
                         f"{x2.dtype}, not {out_dtype}")
    y = torch.empty((n, m), dtype=x2.dtype, device=x2.device)
    if n == 0 or m == 0:
        return y
    if wk == "mma":
        # TMA and cp.async read from 16-byte-aligned bases: a view at an
        # unaligned offset is copied (fresh allocations are aligned)
        x2, values = (a if a.data_ptr() % 16 == 0 else a.clone()
                      for a in (x2, values))
    bounds = torch.zeros(2 * (m // b), dtype=torch.int32, device=x2.device)
    if x2.device.type == "meta":
        return meta.account("dsmm", wk, y, cost_lib.dsmm_cost(
            n, k, m, values.shape[0], b, x2.element_size()))
    fn = _build.entry("dsmm", "dsmm_nt",
                      [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                      + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    with torch.cuda.device(x2.device):
        code = fn(x2.data_ptr(), values.data_ptr(), rows.data_ptr(),
                  cols.data_ptr(), bounds.data_ptr(), y.data_ptr(), n, k, m,
                  b, values.shape[0], _build.DTYPE_CODES[x2.dtype],
                  WALKS.index(wk), stream)
    _build.check(code, "dsmm_nt")
    COUNTER.launches += 1
    WALK_COUNTERS[wk].launches += 1
    return y


def dsmm_slots(x2: torch.Tensor, values: torch.Tensor, rows: torch.Tensor,
               cols: torch.Tensor, m: int,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``y[N, m] = x2 . W^T`` over runtime slots whose block-rows are
    contiguous (fastest on the tensor-core walk where each row's columns
    ascend, as ``encode_slots`` orders them).  CUDA tensors launch the
    kernel (or raise); CPU tensors run the plain version; meta tensors
    take the meta branch."""
    if x2.device.type in ("cuda", "meta"):
        return dsmm_cuda(x2.contiguous(), values.contiguous(), rows, cols,
                         m, out_dtype)
    if x2.device.type != "cpu":
        raise ValueError(f"dsmm: unsupported device {x2.device}")
    return dsmm_plain(x2, values, rows, cols, m, out_dtype)


def dsmm(op: DynamicOperand, x2: torch.Tensor,
         out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Dynamic SpMM ``y[N, m] = x2[N, k] . decode(op)^T``: encode the
    slots on the device, then the slot walk."""
    m, k = op.shape
    if x2.dim() != 2 or x2.shape[1] != k:
        raise ValueError(f"x2 must be [N, {k}], got {tuple(x2.shape)}")
    op = kernel_operand(op)
    mp, kp = op.shape
    rows, cols, vals = encode_slots(op)
    y = dsmm_slots(pad_cols(x2, kp), vals, rows, cols, mp, out_dtype)
    return y[:, :m] if mp != m else y
