"""Dynamic block-sparse matmul: runtime slot encoder, CUDA kernel
wrapper and plain version.

``dsmm_slots(x2, values, rows, cols, m)`` computes ``y[N, m] = x2[N, k]
. W^T`` for ``W`` held as runtime slots (``values[s]`` is the ``b x b``
block at block-row ``rows[s]``, block-col ``cols[s]``; each block-row's
slots contiguous).  For a CUDA tensor it launches ``csrc/dsmm.cu`` (the
port of ``src/repro/kernels/dsmm/dsmm.py`` ``dsmm_call``) or raises; for
a CPU tensor it runs ``dsmm_plain``, the gather + einsum + ``index_add_``
version.  ``dsmm(op, x2)`` encodes a ``DynamicOperand`` with
``encode_slots`` first (the ``dynamic_pallas`` route), after ``reblock``
where its blocks are below the kernel's.  Nothing here
reads a device value on the host.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.dynamic_sparse import DynamicOperand
from repro_torch.kernels import _build

BLOCK_SIZES = (4, 8, 16, 32, 64, 128)
DTYPES = _build.DTYPES
COUNTER = _build.LaunchCounter()


def encode_slots(op: DynamicOperand
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Runtime re-partitioning on the device (``dsmm/ops.py:10-26``):

    1. prepend one zero 'coverage' slot per output block-row, so every
       row has a run even when it holds no block this step;
    2. stable-sort all slots by row, so each row's slots are contiguous
       for any runtime pattern.

    Returns ``(rows, cols, values)`` of ``grid_m + S`` slots."""
    mb, _ = op.grid
    b = op.block_size
    dev = op.values.device
    rows = torch.cat([torch.arange(mb, dtype=torch.int32, device=dev),
                      op.row_idx.to(torch.int32)])
    cols = torch.cat([torch.zeros(mb, dtype=torch.int32, device=dev),
                      op.col_idx.to(torch.int32)])
    vals = torch.cat([op.values.new_zeros((mb, b, b)), op.values])
    order = torch.argsort(rows, stable=True)
    return rows[order], cols[order], vals[order]


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


def dsmm_plain(x2: torch.Tensor, values: torch.Tensor, rows: torch.Tensor,
               cols: torch.Tensor, m: int,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain PyTorch version: gather each slot's x slice, multiply in
    fp32, add into the slot's output rows.  Same inputs and result as
    the kernel."""
    n, k = x2.shape
    b = values.shape[-1]
    xs = x2.float().reshape(n, k // b, b)[:, cols.long()]     # [N, S, b]
    part = torch.einsum("nsj,sij->nsi", xs, values.float())    # [N, S, b]
    y = torch.zeros((n, m // b, b), dtype=torch.float32, device=x2.device)
    y.index_add_(1, rows.long(), part)
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
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Launch the CUDA kernel (CUDA tensors only)."""
    _check(x2, values, rows, cols, m)
    if x2.device.type != "cuda":
        raise ValueError(f"dsmm_cuda needs CUDA tensors, got {x2.device}")
    if out_dtype not in (None, x2.dtype):
        raise ValueError(f"the dsmm kernel writes its input dtype "
                         f"{x2.dtype}, not {out_dtype}")
    n, k = x2.shape
    b = values.shape[-1]
    y = torch.empty((n, m), dtype=x2.dtype, device=x2.device)
    if n == 0 or m == 0:
        return y
    bounds = torch.zeros(2 * (m // b), dtype=torch.int32, device=x2.device)
    fn = _build.entry("dsmm", "dsmm_nt",
                      [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                      + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    with torch.cuda.device(x2.device):
        code = fn(x2.data_ptr(), values.data_ptr(), rows.data_ptr(),
                  cols.data_ptr(), bounds.data_ptr(), y.data_ptr(), n, k, m,
                  b, values.shape[0], _build.DTYPE_CODES[x2.dtype], stream)
    _build.check(code, "dsmm_nt")
    COUNTER.launches += 1
    return y


def dsmm_slots(x2: torch.Tensor, values: torch.Tensor, rows: torch.Tensor,
               cols: torch.Tensor, m: int,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``y[N, m] = x2 . W^T`` over runtime slots whose block-rows are
    contiguous.  CUDA tensors launch the kernel (or raise); CPU tensors
    run the plain version."""
    if x2.device.type == "cuda":
        return dsmm_cuda(x2.contiguous(), values.contiguous(), rows, cols,
                         m, out_dtype)
    if x2.device.type != "cpu":
        raise ValueError(f"dsmm: unsupported device {x2.device}")
    return dsmm_plain(x2, values, rows, cols, m, out_dtype)


def dsmm(op: DynamicOperand, x2: torch.Tensor,
         out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Dynamic SpMM ``y[N, m] = x2[N, k] . decode(op)^T``: encode the
    slots on the device, then the slot walk."""
    if x2.dim() != 2 or x2.shape[1] != op.shape[1]:
        raise ValueError(f"x2 must be [N, {op.shape[1]}], got "
                         f"{tuple(x2.shape)}")
    if op.block_size < BLOCK_SIZES[0] and BLOCK_SIZES[0] % op.block_size == 0:
        op = reblock(op)
    rows, cols, vals = encode_slots(op)
    return dsmm_slots(x2, vals, rows, cols, op.shape[0], out_dtype)
