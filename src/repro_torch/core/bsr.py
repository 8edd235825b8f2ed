"""Block-sparse (BSR-like) matrix container.

Same layout as the JAX package's ``core/bsr.py``:

* ``values``  -- ``[nnz, b, b]`` tensor of non-zero blocks, blocks in
  lexsort (row, col) order
* ``row_idx`` -- ``[nnz]`` host numpy block-row index of each block
* ``col_idx`` -- ``[nnz]`` host numpy block-col index of each block

The pattern is a host constant (static sparsity, PopSparse §3.2); only
the values live on the device.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Tuple

import numpy as np
import torch


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def check_unique_blocks(row_idx, col_idx, grid: Tuple[int, int]) -> None:
    """Reject out-of-range or duplicate ``(row, col)`` block coordinates.
    ``pack_values`` scatters by copy, so a duplicate block would
    silently overwrite another."""
    rows = np.asarray(row_idx, np.int64)
    cols = np.asarray(col_idx, np.int64)
    mb, kb = grid
    if rows.size and (rows.min() < 0 or rows.max() >= mb
                      or cols.min() < 0 or cols.max() >= kb):
        raise ValueError(
            f"block indices out of range for grid {grid}: rows in "
            f"[{rows.min()}, {rows.max()}], cols in "
            f"[{cols.min()}, {cols.max()}]")
    lin = rows * kb + cols
    uniq, counts = np.unique(lin, return_counts=True)
    if uniq.size != lin.size:
        dup = uniq[counts > 1][0]
        raise ValueError(
            f"duplicate block coordinates in static pattern: block "
            f"(row={int(dup // kb)}, col={int(dup % kb)}) appears "
            f"{int(counts.max())} times ({lin.size - uniq.size} "
            f"duplicate entries total); deduplicate the pattern")


def pattern_key(row_idx, col_idx) -> str:
    """Content hash of a static pattern (plan-cache key component)."""
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(row_idx, np.int32).tobytes())
    h.update(b"|")
    h.update(np.ascontiguousarray(col_idx, np.int32).tobytes())
    return h.hexdigest()


@dataclasses.dataclass
class BlockSparseMatrix:
    """A block-sparse matrix of logical shape ``(m, k)`` with ``b x b``
    blocks; ``values[z]`` is block ``(row_idx[z], col_idx[z])``."""

    values: torch.Tensor       # [nnz, b, b]
    row_idx: np.ndarray        # [nnz] int32 (block row)
    col_idx: np.ndarray        # [nnz] int32 (block col)
    shape: Tuple[int, int]     # (m, k)
    block_size: int            # b

    @property
    def grid(self) -> Tuple[int, int]:
        m, k = self.shape
        b = self.block_size
        return (_ceil_div(m, b), _ceil_div(k, b))

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @classmethod
    def from_mask(cls, mask: np.ndarray, block_size: int, *,
                  values: Optional[torch.Tensor] = None,
                  dtype: torch.dtype = torch.float32,
                  device="cpu") -> "BlockSparseMatrix":
        """BSR matrix for a host block mask; ``values`` defaults to
        zeros."""
        mask = np.asarray(mask, bool)
        mb, kb = mask.shape
        b = block_size
        rows, cols = np.nonzero(mask)
        order = np.lexsort((cols, rows))
        rows = rows[order].astype(np.int32)
        cols = cols[order].astype(np.int32)
        check_unique_blocks(rows, cols, (mb, kb))
        if values is None:
            values = torch.zeros((len(rows), b, b), dtype=dtype,
                                 device=device)
        elif tuple(values.shape) != (len(rows), b, b):
            raise ValueError(f"values {tuple(values.shape)} != "
                             f"{(len(rows), b, b)}")
        return cls(values, rows, cols, (mb * b, kb * b), b)

    def to_dense(self) -> torch.Tensor:
        m, k = self.shape
        b = self.block_size
        mb, kb = self.grid
        out = torch.zeros((mb, kb, b, b), dtype=self.values.dtype,
                          device=self.values.device)
        rows = torch.as_tensor(self.row_idx, dtype=torch.long,
                               device=self.values.device)
        cols = torch.as_tensor(self.col_idx, dtype=torch.long,
                               device=self.values.device)
        out.index_put_((rows, cols), self.values, accumulate=True)
        return out.permute(0, 2, 1, 3).reshape(m, k)
