"""Dynamic block-sparse matmul (PopSparse §3.3, Appendix A.2).

Counterpart of the JAX package's ``core/dynamic_sparse.py``.  Only the
maximum density ``d_max`` is fixed when a plan is built; the pattern is
data.  The runtime encoder packs the pattern into fixed-size slot
tensors on the device:

    values  [S, b, b]   non-zero blocks (zero-padded)
    row_idx [S]         block-row per slot (int32)
    col_idx [S]         block-col per slot (int32)
    nnz     []          true block count (a device scalar)

Padded slots carry zero values at (row 0, col 0) and contribute exactly
zero.  Nothing here reads a device value on the host, so encoding and
multiplying a new pattern every step never waits for the device.

``_dspmm`` is the plain gather / einsum / ``index_add_`` formulation
(the JAX ``dynamic_xla`` route, ``dynamic_torch`` in the port), an
``autograd.Function`` with the JAX backward.  ``dspmm``/``dspmm_nt`` go
through ``repro_torch.sparse.plan``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core.bsr import BlockSparseMatrix


@dataclasses.dataclass
class DynamicOperand:
    """Fixed-capacity encoded sparse operand (runtime pattern)."""

    values: torch.Tensor     # [S, b, b]
    row_idx: torch.Tensor    # [S] int32
    col_idx: torch.Tensor    # [S] int32
    nnz: torch.Tensor        # [] int32, true block count
    shape: Tuple[int, int]
    block_size: int

    def __post_init__(self):
        m, k = self.shape
        b = self.block_size
        if b <= 0:
            raise ValueError(f"block_size must be positive, got {b}")
        if m % b or k % b:
            raise ValueError(
                f"DynamicOperand shape {self.shape} is not divisible by "
                f"block_size {b}; pad the operand to block multiples "
                f"(ceil-div grids would leave partial blocks the encoded "
                f"slot arrays cannot address)")

    @property
    def capacity(self) -> int:
        return int(self.values.shape[0])

    @property
    def grid(self) -> Tuple[int, int]:
        b = self.block_size
        return (-(-self.shape[0] // b), -(-self.shape[1] // b))

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.values.device

    def to_dense(self) -> torch.Tensor:
        """The dense ``[m, k]`` matrix; duplicate slots add."""
        mb, kb = self.grid
        b = self.block_size
        out = torch.zeros((mb, kb, b, b), dtype=self.values.dtype,
                          device=self.values.device)
        out.index_put_((self.row_idx.long(), self.col_idx.long()),
                       self.values, accumulate=True)
        return out.permute(0, 2, 1, 3).reshape(self.shape)


def encode(dense_w: torch.Tensor, block_mask: torch.Tensor, *,
           block_size: int, nnz_max: int) -> DynamicOperand:
    """Runtime encoder: pack the masked blocks of ``dense_w`` into
    ``nnz_max`` slots, active blocks first in row-major order; blocks
    beyond capacity are dropped, row-major last (bucket overflow).
    Differentiable in ``dense_w`` through the gather.

    ``block_mask``: ``[m / b, k / b]`` bool, on ``dense_w``'s device."""
    m, k = dense_w.shape
    b = block_size
    if m % b or k % b:
        raise ValueError(f"shape {tuple(dense_w.shape)} not divisible by "
                         f"block {b}")
    mb, kb = m // b, k // b
    if tuple(block_mask.shape) != (mb, kb):
        raise ValueError(f"mask shape {tuple(block_mask.shape)} != grid "
                         f"{(mb, kb)}")
    if not 0 < nnz_max <= mb * kb:
        raise ValueError(f"nnz_max {nnz_max} outside [1, {mb * kb}]")
    flat = block_mask.reshape(-1).to(torch.bool)
    # stable order: active blocks first, in row-major order (the integer
    # key 0 = active, 1 = inactive, sorted stably)
    order = torch.argsort((~flat).to(torch.int8), stable=True)
    sel = order[:nnz_max]
    count = torch.clamp(flat.sum(dtype=torch.int32), max=nnz_max)
    valid = torch.arange(sel.numel(), device=flat.device) < count
    rows = torch.where(valid, sel // kb, 0).to(torch.int32)
    cols = torch.where(valid, sel % kb, 0).to(torch.int32)
    blocked = dense_w.reshape(mb, b, kb, b).permute(0, 2, 1, 3)
    vals = blocked[rows.long(), cols.long()] * valid[:, None, None].to(
        dense_w.dtype)
    return DynamicOperand(vals, rows, cols, count, (m, k), b)


def encode_from_bsr(bsr: BlockSparseMatrix, *,
                    nnz_max: int) -> DynamicOperand:
    """Encode an existing (static) BSR into ``nnz_max`` slots."""
    m, k = bsr.shape
    b = bsr.block_size
    if m % b or k % b:
        raise ValueError(
            f"BSR shape {bsr.shape} is not divisible by block_size {b}; "
            f"cannot encode partial blocks into fixed slots -- pad the "
            f"matrix to block multiples first")
    nnz = int(len(bsr.row_idx))
    if nnz > nnz_max:
        raise ValueError(
            f"pattern nnz {nnz} exceeds capacity nnz_max={nnz_max}; raise "
            f"nnz_max (or d_max upstream) to at least {nnz}, or prune the "
            f"pattern before encoding")
    dev = bsr.values.device
    pad = nnz_max - nnz
    vals = torch.cat([bsr.values,
                      bsr.values.new_zeros((pad, b, b))])
    rows = torch.zeros(nnz_max, dtype=torch.int32, device=dev)
    cols = torch.zeros(nnz_max, dtype=torch.int32, device=dev)
    rows[:nnz] = torch.as_tensor(bsr.row_idx, dtype=torch.int32,
                                 device=dev)
    cols[:nnz] = torch.as_tensor(bsr.col_idx, dtype=torch.int32,
                                 device=dev)
    return DynamicOperand(vals, rows, cols,
                          torch.tensor(nnz, dtype=torch.int32, device=dev),
                          (m, k), b)


# ---------------------------------------------------------------------------
# Matmul: the same contraction as the static one, with runtime indices.
# ``x`` is ``[k, n]`` (the JAX layout); products are summed in fp32.
# ---------------------------------------------------------------------------

def dspmm_forward(values, row_idx, col_idx, x, mb: int, b: int):
    """``Y[mb * b, n] = sum_z values[z] . X_block[col[z]]`` added into
    block-row ``row[z]``."""
    n = x.shape[-1]
    kb = x.shape[0] // b
    gathered = x.float().reshape(kb, b, n)[col_idx.long()]     # [z, b, n]
    part = torch.einsum("zab,zbn->zan", values.float(), gathered)
    y = torch.zeros((mb, b, n), dtype=torch.float32, device=x.device)
    y.index_add_(0, row_idx.long(), part)
    return y.reshape(mb * b, n)


def dspmm_backward(values, row_idx, col_idx, x, dy, mb: int, b: int):
    """``(dvalues, dx)`` of ``dspmm_forward`` for the cotangent ``dy``
    (``dynamic_sparse.py:164-178``), in fp32."""
    n = x.shape[-1]
    kb = x.shape[0] // b
    rows, cols = row_idx.long(), col_idx.long()
    dyg = dy.float().reshape(mb, b, n)[rows]                   # [z, b, n]
    xg = x.float().reshape(kb, b, n)[cols]                     # [z, b, n]
    dvalues = torch.einsum("zan,zbn->zab", dyg, xg)
    part = torch.einsum("zab,zan->zbn", values.float(), dyg)
    dx = torch.zeros((kb, b, n), dtype=torch.float32, device=x.device)
    dx.index_add_(0, cols, part)
    return dvalues, dx.reshape(kb * b, n)


class _DSpmmFn(torch.autograd.Function):
    """``_dspmm`` with its custom backward; indices get no gradient."""

    @staticmethod
    def forward(ctx, values, row_idx, col_idx, x, mb, b):
        ctx.save_for_backward(values, row_idx, col_idx, x)
        ctx.mb, ctx.b = mb, b
        return dspmm_forward(values, row_idx, col_idx, x, mb, b).to(
            torch.result_type(values, x))

    @staticmethod
    def backward(ctx, dy):
        values, row_idx, col_idx, x = ctx.saved_tensors
        dv, dx = dspmm_backward(values, row_idx, col_idx, x, dy, ctx.mb,
                                ctx.b)
        return (dv.to(values.dtype), None, None, dx.to(x.dtype), None,
                None)


def _dspmm(values, row_idx, col_idx, x, mb: int, b: int) -> torch.Tensor:
    """Plain dynamic SpMM ``[k, n] -> [mb * b, n]``, differentiable in
    ``values`` and ``x``."""
    return _DSpmmFn.apply(values, row_idx, col_idx, x, mb, b)


_BACKEND_MODES = {"auto": "auto", "xla": "dynamic_xla",
                  "pallas": "dynamic_pallas", "grouped": "dynamic_grouped"}


def dspmm(op: DynamicOperand, x: torch.Tensor, *,
          backend: str = "auto") -> torch.Tensor:
    """``Y = decode(op) . X`` with ``X: [k, n]`` -> ``Y: [m, n]``, through
    ``repro_torch.sparse.plan``.  ``backend`` maps onto the plan modes
    as in the JAX shim: "auto", "xla", "pallas", "grouped"."""
    if x.shape[0] != op.shape[1]:
        raise ValueError(f"X rows {x.shape[0]} != k {op.shape[1]}")
    mode = _BACKEND_MODES.get(backend)
    if mode is None:
        raise ValueError(f"unknown backend {backend!r}")
    from repro_torch import sparse  # local: the plan layer imports us
    return sparse.spmm(op, x, ctx=sparse.PlanContext(mode=mode))


def dspmm_nt(op: DynamicOperand, x: torch.Tensor, *,
             backend: str = "auto") -> torch.Tensor:
    """Activation-major form ``x: [..., k] -> [..., m]``."""
    mode = _BACKEND_MODES.get(backend)
    if mode is None:
        raise ValueError(f"unknown backend {backend!r}")
    from repro_torch import sparse
    return sparse.spmm_nt(op, x, ctx=sparse.PlanContext(mode=mode))
