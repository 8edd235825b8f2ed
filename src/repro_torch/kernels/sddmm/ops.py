"""Block-sampled dense-dense matmul (SDDMM): CUDA kernel wrapper and
plain version.

``sddmm(dy2, x2, row_ptr, col_idx, row_idx, b)`` computes the value
gradient of a static block-sparse ``y = x . W^T``:

    dvalues[z] = dy2[:, r_z*b:(r_z+1)*b]^T . x2[:, c_z*b:(c_z+1)*b]

for every pattern block ``z`` in lexsort (row, col) order, with
``dy2 [N, m]`` and ``x2 [N, k]`` activation-major.  The result is
``[nnz, b, b]`` in ``dy2``'s dtype, summed over ``N`` in fp32 and rounded
once.  For a CUDA tensor it launches ``csrc/sddmm.cu`` (the port of
``src/repro/kernels/sddmm/sddmm.py`` ``sddmm_tiles_call``) or raises; for
a CPU tensor it runs ``sddmm_plain``, the gather + einsum version.
``walk(b, dtype)`` is the pure-Python choice of the kernel's walk: "mma"
(bf16/fp16 at b in {16, 32, 64}: TMA + warp-level tensor-core products)
or "ffma" (the rest: fp32 FMA on the CUDA cores).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.analysis import cost as cost_lib
from repro_torch.kernels import _build, meta
from repro_torch.kernels.contract import elem_bytes

BLOCK_SIZES = (4, 8, 16, 32, 64)
DTYPES = _build.DTYPES
COUNTER = _build.LaunchCounter()
WALKS = ("mma", "ffma")
# launches per walk, beside the total COUNTER
WALK_COUNTERS = {name: _build.LaunchCounter() for name in WALKS}
MMA_BLOCKS = (16, 32, 64)   # blocks the tensor-core walk takes
_FFMA_BLOCKS = 1024     # the FMA walk's 256-thread blocks: ~8 an SM of an H100
_MMA_WAVE = 2 * 132     # the mma walk's 544-thread blocks: one wave, 2 an SM
_MIN_SPLIT_ROWS = 256   # least rows of N one split walks
# Time of each walk: (seconds a launch, FLOP/s, bytes/s) by walk, fitted
# by hand to chip_smoke.py's [kernel] sddmm rows (FFN up/gate and down at
# N 256 and 2048; device time, L2 cold; PERF.md lists them) on an NVIDIA
# H100 80GB HBM3 at a 700.00 W power limit.  Each block reads its slice
# of x (N rows of b columns), from L2 on the mma walk; dy is read once.
WALK_MODEL = {"mma": (8e-6, 572e12, 5.8e12),
              "ffma": (8e-6, 15e12, 3.35e12)}


def walk_seconds(name: str, n: int, m: int, k: int, b: int, blocks: int,
                 dtype) -> float:
    """Modelled device seconds of walk ``name`` sampling ``blocks`` blocks
    of ``b x b`` from ``dy [n, m]^T . x [n, k]`` (pure Python): its
    launch term plus the larger of its operations over its rate and its
    bytes over its bandwidth."""
    es = elem_bytes(dtype)
    launch, rate, bw = WALK_MODEL[name]
    return launch + max(2.0 * n * blocks * b * b / rate,
                        (blocks * b * (n + b) + n * m) * es / bw)


def block_row_ptr(row_idx: np.ndarray, grid_rows: int) -> np.ndarray:
    """CSR pointer ``[grid_rows + 1]`` over lexsort-ordered blocks: the
    blocks of block-row ``r`` are ``ptr[r]:ptr[r + 1]`` (the runs of
    ``plan_packing(tm = tk = b)`` without its pad tiles)."""
    rows = np.asarray(row_idx, np.int64)
    return np.searchsorted(rows, np.arange(grid_rows + 1)).astype(np.int32)


def walk(b: int, dtype) -> str:
    """The walk ``sddmm_cuda`` launches at block ``b`` in ``dtype`` (pure
    Python; the CPU tests reach it): "mma" for bf16/fp16 at b in
    ``MMA_BLOCKS``, "ffma" elsewhere."""
    if b not in BLOCK_SIZES:
        raise ValueError(f"sddmm kernel takes blocks of {BLOCK_SIZES}; "
                         f"got {b}")
    if dtype in (torch.bfloat16, torch.float16) and b in MMA_BLOCKS:
        return "mma"
    return "ffma"


def n_splits(n: int, grid_rows: int, walk_name: str = "ffma") -> int:
    """Slices of ``N`` the kernel sums separately (1 = one pass writing
    the result), each at least 256 rows of ``N``.  The FMA walk aims at
    ~1024 (block-row, slice) thread blocks; the mma walk splits only
    where the rows leave most of one wave of its blocks empty, and then
    into as many slices as still fit in that wave (the partial sums'
    extra pass costs more than a second wave)."""
    rows = max(grid_rows, 1)
    if walk_name == "mma":
        want = max(1, _MMA_WAVE // rows)
    else:
        want = -(-_FFMA_BLOCKS // rows)
    return max(1, min(want, n // _MIN_SPLIT_ROWS))


def sddmm_plain(dy2: torch.Tensor, x2: torch.Tensor,
                row_idx: torch.Tensor, col_idx: torch.Tensor,
                b: int) -> torch.Tensor:
    """Plain PyTorch version: gather each block's ``dy`` and ``x``
    column slices, contract ``N`` in fp32, cast to ``dy2``'s dtype
    (``row_idx``/``col_idx`` as long tensors)."""
    n, m = dy2.shape
    k = x2.shape[1]
    dyg = dy2.float().reshape(n, m // b, b)[:, row_idx]          # [N, z, b]
    xg = x2.float().reshape(n, k // b, b)[:, col_idx]            # [N, z, b]
    return torch.einsum("nza,nzc->zac", dyg, xg).to(dy2.dtype)


def _check(dy2, x2, row_ptr, col_idx, b):
    if dy2.dim() != 2 or x2.dim() != 2 or dy2.shape[0] != x2.shape[0]:
        raise ValueError(f"sddmm takes dy2 [N, m] and x2 [N, k]; got "
                         f"{tuple(dy2.shape)} and {tuple(x2.shape)}")
    m, k = dy2.shape[1], x2.shape[1]
    if b not in BLOCK_SIZES:
        raise ValueError(f"sddmm kernel takes blocks of {BLOCK_SIZES}; "
                         f"got {b}")
    if m % b or k % b:
        raise ValueError(f"m={m}, k={k} must be multiples of the block {b}")
    if dy2.dtype not in DTYPES or x2.dtype != dy2.dtype:
        raise ValueError(f"dtypes dy2={dy2.dtype}, x2={x2.dtype}: both "
                         f"one of {DTYPES}")
    if row_ptr.dtype != torch.int32 or col_idx.dtype != torch.int32:
        raise ValueError("row_ptr and col_idx must be int32")
    if row_ptr.numel() != m // b + 1:
        raise ValueError(f"row_ptr has {row_ptr.numel()} entries (want "
                         f"{m // b + 1})")
    for name, a in (("dy2", dy2), ("x2", x2), ("row_ptr", row_ptr),
                    ("col_idx", col_idx)):
        if a.device != dy2.device:
            raise ValueError(f"{name} on {a.device}, dy2 on {dy2.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def sddmm_cuda(dy2: torch.Tensor, x2: torch.Tensor, row_ptr: torch.Tensor,
               col_idx: torch.Tensor, b: int,
               plan: Optional[str] = None) -> torch.Tensor:
    """Launch the CUDA kernel (CUDA tensors; meta tensors take the meta
    branch, ``kernels/meta.py``) on ``walk(...)``'s walk, or on ``plan``
    where the caller names one."""
    _check(dy2, x2, row_ptr, col_idx, b)
    wk = plan or walk(b, dy2.dtype)
    if wk not in WALKS or (wk == "mma" and walk(b, dy2.dtype) != "mma"):
        raise ValueError(f"sddmm walk {wk!r} does not take b={b} in "
                         f"{dy2.dtype}")
    if dy2.device.type not in ("cuda", "meta"):
        raise ValueError(f"sddmm_cuda needs CUDA tensors, got {dy2.device}")
    n, m = dy2.shape
    k = x2.shape[1]
    nnz = col_idx.numel()
    out = torch.empty((nnz, b, b), dtype=dy2.dtype, device=dy2.device)
    if nnz == 0:
        return out
    if n == 0:
        return out.zero_()
    # the kernel stages rows with 16-byte loads (ffma) or TMA (mma): an
    # operand that is a view at an unaligned offset is copied (fresh
    # allocations are)
    dy2, x2 = (a if a.data_ptr() % 16 == 0 else a.clone()
               for a in (dy2, x2))
    # the mma walk's scratch for x^T [k, N'], N' = N rounded up to 8
    # (TMA's 16-byte row stride)
    ldx = -(-n // 8) * 8 if wk == "mma" else 0
    xt = (torch.empty((k, ldx), dtype=x2.dtype, device=x2.device)
          if wk == "mma" else None)
    mb = m // b
    splits = n_splits(n, mb, wk)
    partial = (torch.empty(splits * nnz * b * b, dtype=torch.float32,
                           device=dy2.device) if splits > 1 else None)
    if dy2.device.type == "meta":
        return meta.account("sddmm", wk, out, cost_lib.sddmm_cost(
            n, m, k, nnz, b, dy2.element_size(), row_ptr.numel() + nnz))
    fn = _build.entry("sddmm", "sddmm",
                      [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                      + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(dy2.device).cuda_stream
    with torch.cuda.device(dy2.device):
        code = fn(dy2.data_ptr(), x2.data_ptr(), row_ptr.data_ptr(),
                  col_idx.data_ptr(), out.data_ptr(),
                  partial.data_ptr() if partial is not None else None,
                  xt.data_ptr() if xt is not None else None,
                  n, m, k, ldx, nnz, splits, b,
                  _build.DTYPE_CODES[dy2.dtype], WALKS.index(wk), stream)
    _build.check(code, "sddmm")
    COUNTER.launches += 1
    WALK_COUNTERS[wk].launches += 1
    return out


def sddmm(dy2: torch.Tensor, x2: torch.Tensor, row_ptr: torch.Tensor,
          col_idx: torch.Tensor, row_idx: torch.Tensor,
          b: int) -> torch.Tensor:
    """``[nnz, b, b]`` block-sampled ``dy2^T . x2``.  CUDA tensors
    launch the kernel (or raise); CPU tensors run the plain version; meta
    tensors take the meta branch."""
    if dy2.device.type in ("cuda", "meta"):
        return sddmm_cuda(dy2, x2, row_ptr, col_idx, b)
    if dy2.device.type != "cpu":
        raise ValueError(f"sddmm: unsupported device {dy2.device}")
    _check(dy2, x2, row_ptr, col_idx, b)
    return sddmm_plain(dy2, x2, row_idx.long(), col_idx.long(), b)
