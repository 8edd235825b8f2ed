"""Block-sparse flash attention: host pair lists, CUDA kernel wrapper and
the plain version.

``bs_attn(q, k, v, block_mask, ...)`` is the JAX package's
``kernels/bs_attn/ops.py`` ``bs_attn`` (q ``[H, Sq, dh]``, k/v ``[H,
Skv, dh]``).  For CUDA tensors it launches ``csrc/bs_attn.cu`` (the
port of ``src/repro/kernels/bs_attn/bs_attn.py`` ``bs_attn_call``) or
raises; for CPU tensors it runs ``ref.bs_attn_ref``.  ``bs_attn_cuda``
is the lower-level launcher on a prepared ``Walk`` in the models'
``[B, S, H, dh]`` layout (strided, GQA read in place), with the element
window of the JAX tile walk; ``models/attention.attend_train`` calls it.
``kernel_walk(dtype)`` is the kernel's walk: "wgmma" (bf16/fp16: TMA + tensor
cores) or "cuda_core" (fp32: FMA on the CUDA cores).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.analysis import cost as cost_lib
from repro_torch.kernels import _build, meta
from repro_torch.kernels.bs_attn.ref import bs_attn_ref

Q_ROWS = 64                     # query rows per thread block (QT in the .cu)
# 192: MLA's q.k head (qk_nope 128 + qk_rope 64), v padded to it
HEAD_DIMS = (32, 64, 128, 192, 256)
DTYPES = _build.DTYPES
COUNTER = _build.LaunchCounter()
WALKS = ("cuda_core", "wgmma")
# launches per walk, beside the total COUNTER
WALK_COUNTERS = {name: _build.LaunchCounter() for name in WALKS}
# launches per head dim, beside the total COUNTER
HEAD_DIM_COUNTERS = {dh: _build.LaunchCounter() for dh in HEAD_DIMS}


def kernel_walk(dtype) -> str:
    """The walk ``bs_attn_cuda`` launches for ``dtype``: the tensor cores
    for 16-bit types; fp32 stays on the CUDA cores (TF32 would miss the
    fp32 budget)."""
    if dtype not in DTYPES:
        raise ValueError(f"bs_attn takes {DTYPES}; got {dtype}")
    return "wgmma" if dtype in (torch.bfloat16, torch.float16) else \
        "cuda_core"


def mask_to_pairs(block_mask: np.ndarray):
    """Host: flatten a block mask into row-sorted (q_tile, kv_tile) pairs.

    Raises if any q tile row is empty (an uncovered output tile would
    never be written) -- causal masks including the diagonal always pass.
    """
    mask = np.asarray(block_mask, bool)
    if not mask.any(axis=1).all():
        raise ValueError("every q block-row needs >=1 visible kv block")
    rows, cols = np.nonzero(mask)
    order = np.lexsort((cols, rows))
    return rows[order].astype(np.int32), cols[order].astype(np.int32)


def walk_group(nq: int, bq: int) -> int:
    """q tiles one thread block walks together: ``Q_ROWS // bq`` when the
    tiles are smaller than a block and there are several, else 1."""
    return Q_ROWS // bq if (bq < Q_ROWS and nq > 1) else 1


def walk_csr(block_mask: np.ndarray, group: int = 1):
    """``(row_ptr, cols)`` int32: a CSR over ``mask_to_pairs``'s pairs
    with ``group`` consecutive q tiles merged into one walk row (the
    union of their kv tiles); ``group = 1`` gives the pairs themselves."""
    mask = np.asarray(block_mask, bool)
    if group > 1:
        nq, nkv = mask.shape
        ng = -(-nq // group)
        pad = np.zeros((ng * group, nkv), bool)
        pad[:nq] = mask
        if not mask.any(axis=1).all():
            raise ValueError("every q block-row needs >=1 visible kv block")
        mask = pad.reshape(ng, group, nkv).any(axis=1)
    rows, cols = mask_to_pairs(mask)
    row_ptr = np.zeros(mask.shape[0] + 1, np.int32)
    np.cumsum(np.bincount(rows, minlength=mask.shape[0]), out=row_ptr[1:])
    return row_ptr, cols


def tile_mask_implied(block_mask: np.ndarray, bq: int, bkv: int, *,
                      causal: bool, window: int = 0,
                      global_prefix: int = 0) -> bool:
    """Whether the element mask (causal ``r >= c``; with ``window > 0``
    also ``r - c < window or c < global_prefix``) already hides every
    element of every tile outside ``block_mask``, so a per-element
    lookup of the tile mask cannot change what a group walk sees."""
    mask = np.asarray(block_mask, bool)
    nq, nkv = mask.shape
    r_lo = np.arange(nq)[:, None] * bq
    r_hi = r_lo + bq - 1
    c_lo = np.arange(nkv)[None, :] * bkv
    c_hi = c_lo + bkv - 1
    # does the tile hold a visible pair: the smallest r - c among its
    # pairs (with r >= c under the causal mask) against the window
    seen = (r_hi >= c_lo) if causal else np.ones((nq, nkv), bool)
    d_min = np.maximum(r_lo - c_hi, 0) if causal else r_lo - c_hi
    if window > 0:
        seen = seen & ((d_min < window) | (c_lo < global_prefix))
    return not (seen & ~mask).any()


class Walk(NamedTuple):
    """Device metadata of one block mask: the walk CSR, the dense tile
    mask (``group > 1`` only, and only where the element mask does not
    already imply it: ``tile_mask_implied``) and the tiling."""

    row_ptr: torch.Tensor       # [n_walk + 1] int32
    cols: torch.Tensor          # [pairs] int32
    tile_mask: Optional[torch.Tensor]   # [nq, nkv] uint8 or None
    nq: int
    nkv: int
    bq: int
    bkv: int
    group: int

    @property
    def n_blocks(self) -> int:
        """Thread blocks per (batch, head)."""
        if self.group > 1:
            return int(self.row_ptr.numel()) - 1
        return self.nq * (-(-self.bq // Q_ROWS))


def make_walk(block_mask: np.ndarray, bq: int, bkv: int, device, *,
              causal: Optional[bool] = None, window: int = 0,
              global_prefix: int = 0) -> Walk:
    """The walk of ``block_mask``.  Given the element mask's parameters
    (``causal`` not None) a group walk drops the tile mask where they
    imply it (the kernel then reads no tile mask per element)."""
    mask = np.asarray(block_mask, bool)
    nq, nkv = mask.shape
    group = walk_group(nq, bq)
    row_ptr, cols = walk_csr(mask, group)
    implied = causal is not None and tile_mask_implied(
        mask, bq, bkv, causal=causal, window=window,
        global_prefix=global_prefix)
    tile_mask = (torch.as_tensor(mask.astype(np.uint8), device=device)
                 if group > 1 and not implied else None)
    return Walk(torch.as_tensor(row_ptr, device=device),
                torch.as_tensor(cols, device=device), tile_mask, nq, nkv,
                bq, bkv, group)


def _check(q, k, v, walk: Walk):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be [B, S, heads, dh]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b_, sq, h, dh = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    if tuple(v.shape) != tuple(k.shape) or k.shape[0] != b_ \
            or k.shape[3] != dh:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"bs_attn kernel takes head dims {HEAD_DIMS}; "
                         f"got {dh}")
    if kvh < 1 or h % kvh:
        raise ValueError(f"{h} heads are not a multiple of {kvh} kv heads")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes q={q.dtype}, k={k.dtype}, v={v.dtype}: "
                         f"all one of {DTYPES}")
    if (walk.nq * walk.bq != sq or walk.nkv * walk.bkv != skv
            or walk.group != walk_group(walk.nq, walk.bq)):
        raise ValueError(f"walk of {walk.nq}x{walk.nkv} tiles of "
                         f"{walk.bq}x{walk.bkv} does not tile Sq={sq}, "
                         f"Skv={skv}")
    vec = 16 // q.element_size()
    for name, a in (("q", q), ("k", k), ("v", v)):
        if a.device != q.device:
            raise ValueError(f"{name} on {a.device}, q on {q.device}")
        if a.stride(3) != 1 or any(s % vec for s in a.stride()[:3]) \
                or a.data_ptr() % 16:
            raise ValueError(f"{name}: the head dim must be contiguous and "
                             f"the other strides multiples of {vec} "
                             f"elements, 16-byte aligned; got strides "
                             f"{a.stride()}")


def bs_attn_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 walk: Walk, *, scale: float, causal: bool = True,
                 softcap: Optional[float] = None, window: int = 0,
                 global_prefix: int = 0,
                 out: Optional[torch.Tensor] = None,
                 plan: Optional[str] = None) -> torch.Tensor:
    """Launch the kernel (CUDA tensors; meta tensors take the meta branch,
    ``kernels/meta.py``): q ``[B, Sq, H, dh]``, k/v
    ``[B, Skv, KV, dh]`` -> ``[B, Sq, H, dh]`` (into ``out`` when given,
    any strides with a contiguous head dim), on ``kernel_walk(q.dtype)`` or on
    the walk ``plan`` names."""
    _check(q, k, v, walk)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"bs_attn_cuda needs CUDA tensors, got {q.device}")
    b_, sq, h, dh = q.shape
    if out is None:
        out = torch.empty((b_, sq, h, dh), dtype=q.dtype, device=q.device)
    elif (tuple(out.shape) != tuple(q.shape) or out.dtype != q.dtype
          or out.device != q.device or out.stride(3) != 1):
        raise ValueError(f"out {tuple(out.shape)} {out.dtype} does not "
                         f"match q")
    if b_ == 0 or sq == 0:
        return out
    for t in (walk.row_ptr, walk.cols):
        if t.device != q.device or t.dtype != torch.int32:
            raise ValueError("walk metadata must be int32 on q's device")
    name = plan or kernel_walk(q.dtype)
    if name not in WALKS or (name == "wgmma" and q.dtype == torch.float32):
        raise ValueError(f"bs_attn: walk {name!r} does not take {q.dtype}")
    if q.device.type == "meta":
        pairs = cost_lib.attn_pairs(sq, k.shape[1], causal=causal,
                                    window=window,
                                    global_prefix=global_prefix)
        return meta.account("bs_attn", name, out, cost_lib.bs_attn_cost(
            b_, sq, h, k.shape[1], k.shape[2], dh, q.element_size(), pairs))
    fn = _build.entry("bs_attn", "bs_attn_fwd",
                      [ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 12
                      + [ctypes.c_int] * 11 + [ctypes.c_float] * 2
                      + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    strides = [s for a in (q, k, v, out) for s in a.stride()[:3]]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tile_mask = 0 if walk.tile_mask is None else walk.tile_mask.data_ptr()
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  walk.row_ptr.data_ptr(), walk.cols.data_ptr(), tile_mask,
                  *strides, b_, h, k.shape[2], sq, k.shape[1], dh, walk.nkv,
                  walk.bq, walk.bkv, walk.group, walk.n_blocks, float(scale),
                  float(softcap) if softcap is not None else 0.0,
                  int(bool(causal)), int(window), int(global_prefix),
                  WALKS.index(name), _build.DTYPE_CODES[q.dtype], stream)
    _build.check(code, "bs_attn_fwd")
    COUNTER.launches += 1
    WALK_COUNTERS[name].launches += 1
    HEAD_DIM_COUNTERS[dh].launches += 1
    return out


def check_rows_covered(block_mask: np.ndarray, bq: int, bkv: int,
                       causal: bool) -> None:
    """Under the causal mask each q tile's first row must see a key: its
    first visible kv tile may not start after that row.  (A row that
    sees none is undefined: the JAX kernel and its oracle disagree.)"""
    mask = np.asarray(block_mask, bool)
    if not mask.any(axis=1).all():
        raise ValueError("every q block-row needs >=1 visible kv block")
    if causal:
        first = mask.argmax(axis=1) * bkv
        bad = np.flatnonzero(first > np.arange(mask.shape[0]) * bq)
        if bad.size:
            raise ValueError(f"q tiles {bad[:8].tolist()} have rows that "
                             f"see no key under the causal mask")


def bs_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            block_mask: np.ndarray, *, bq: int = 128, bkv: int = 128,
            scale: Optional[float] = None, causal: bool = True,
            softcap: Optional[float] = None) -> torch.Tensor:
    """Block-sparse attention.  ``q: [H, Sq, dh]``, ``k/v: [H, Skv,
    dh]``, ``block_mask: [Sq/bq, Skv/bkv]`` host bool.  CUDA tensors
    launch the kernel (or raise); CPU tensors run the plain version; meta
    tensors take the meta branch."""
    h, sq, dh = q.shape
    skv = k.shape[1]
    block_mask = np.asarray(block_mask, bool)
    if sq % bq or skv % bkv or block_mask.shape != (sq // bq, skv // bkv):
        raise ValueError(f"mask {block_mask.shape} != grid "
                         f"{(sq // bq, skv // bkv)} of tiles {bq}x{bkv}")
    check_rows_covered(block_mask, bq, bkv, causal)
    scale = scale if scale is not None else 1.0 / np.sqrt(dh)
    if q.device.type in ("cuda", "meta"):
        walk = make_walk(block_mask, bq, bkv, q.device, causal=causal)
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        bs_attn_cuda(q.transpose(0, 1)[None], k.transpose(0, 1)[None],
                     v.transpose(0, 1)[None], walk, scale=float(scale),
                     causal=causal, softcap=softcap,
                     out=out.transpose(0, 1)[None])
        return out
    if q.device.type != "cpu":
        raise ValueError(f"bs_attn: unsupported device {q.device}")
    return bs_attn_ref(q, k, v, block_mask, bq=bq, bkv=bkv, scale=scale,
                       causal=causal, softcap=softcap)
