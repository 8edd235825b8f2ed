"""Static block-sparse matmul: CUDA kernel wrapper and plain version.

``bsmm_nt(x, tiles, row_ptr, tile_cols, tile_rows, m)`` computes
``y[N, M] = x[N, K] . W^T`` for the block-sparse ``W`` held as a packed
``[T, tb, tb]`` tile stack (``partitioner.plan_packing`` with
``tm = tk = tb``).  For a CUDA tensor it launches ``csrc/bsmm.cu`` (the
port of ``src/repro/kernels/bsmm/bsmm.py`` ``bsmm_call``) or raises; for
a CPU tensor it runs ``bsmm_nt_plain``, the gather + einsum version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

TILE_SIZES = (4, 8, 16, 32, 64)
DTYPES = _build.DTYPES
COUNTER = _build.LaunchCounter()


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


def bsmm_nt_cuda(x: torch.Tensor, tiles: torch.Tensor,
                 row_ptr: torch.Tensor, tile_cols: torch.Tensor,
                 m: int) -> torch.Tensor:
    """Launch the CUDA kernel (CUDA tensors only)."""
    _check(x, tiles, row_ptr, tile_cols, m)
    if x.device.type != "cuda":
        raise ValueError(f"bsmm_nt_cuda needs CUDA tensors, got {x.device}")
    n, k = x.shape
    y = torch.empty((n, m), dtype=x.dtype, device=x.device)
    if n == 0:
        return y
    fn = _build.entry("bsmm", "bsmm_nt",
                      [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                      + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), tiles.data_ptr(), row_ptr.data_ptr(),
                  tile_cols.data_ptr(), y.data_ptr(), n, k, m,
                  tiles.shape[1], _build.DTYPE_CODES[x.dtype],
                  stream)
    _build.check(code, "bsmm_nt")
    COUNTER.launches += 1
    return y


def bsmm_nt(x: torch.Tensor, tiles: torch.Tensor, row_ptr: torch.Tensor,
            tile_cols: torch.Tensor, tile_rows: torch.Tensor,
            m: int) -> torch.Tensor:
    """``y[N, M] = x[N, K] . W^T`` over the packed tile stack.  CUDA
    tensors launch the kernel (or raise); CPU tensors run the plain
    version."""
    if x.device.type == "cuda":
        return bsmm_nt_cuda(x, tiles, row_ptr, tile_cols, m)
    if x.device.type != "cpu":
        raise ValueError(f"bsmm_nt: unsupported device {x.device}")
    return bsmm_nt_plain(x, tiles, tile_rows.long(), tile_cols.long(), m)
