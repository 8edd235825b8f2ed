"""Dense tiled matmul: CUDA kernel wrapper and plain version.

``dense_mm(x, w)`` computes ``y[N, D] = x[N, K] . w[K, D]`` with fp32
accumulation.  For a CUDA tensor it launches ``csrc/dense_mm.cu`` (the
port of ``src/repro/kernels/dense_mm/dense_mm.py`` ``dense_mm_call``) or
raises; for a CPU tensor it runs ``dense_mm_plain``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

DTYPES = _build.DTYPES
COUNTER = _build.LaunchCounter()
SPLITK_MAX_N = 16       # rows the kernel's split-K walk takes
_TARGET_BLOCKS = 264    # two thread blocks per SM of an H100


def splitk_slices(n: int, k: int, d: int) -> int:
    """K slices of the kernel's split-K walk for ``n <= 16`` rows (0 =
    the tiled walk): enough (64-column tile, K slice) blocks to fill the
    card, each slice at least 64 rows deep."""
    if n > SPLITK_MAX_N:
        return 0
    col_tiles = -(-d // 64)
    return max(1, min(-(-_TARGET_BLOCKS // col_tiles), k // 64))


def dense_mm_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: fp32 matmul, cast to the input dtype."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def _check(x, w):
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"dense_mm takes x [N, K] and w [K, D]; got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype not in DTYPES or w.dtype != x.dtype:
        raise ValueError(f"dtypes x={x.dtype}, w={w.dtype}: both one of "
                         f"{DTYPES}")
    if w.device != x.device:
        raise ValueError(f"w on {w.device}, x on {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")


def dense_mm_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel (CUDA tensors only)."""
    _check(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"dense_mm_cuda needs CUDA tensors, got {x.device}")
    n, k = x.shape
    d = w.shape[1]
    y = torch.empty((n, d), dtype=x.dtype, device=x.device)
    if n == 0 or d == 0:
        return y
    slices = splitk_slices(n, k, d)
    scratch = (torch.empty(slices * n * d, dtype=torch.float32,
                           device=x.device) if slices else None)
    fn = _build.entry("dense_mm", "dense_mm",
                      [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                      + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                  scratch.data_ptr() if slices else None, n, k, d, slices,
                  _build.DTYPE_CODES[x.dtype], stream)
    _build.check(code, "dense_mm")
    COUNTER.launches += 1
    return y


def dense_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``y = x @ w`` with fp32 accumulation.  CUDA tensors launch the
    kernel (or raise); CPU tensors run the plain version."""
    if x.device.type == "cuda":
        return dense_mm_cuda(x, w)
    if x.device.type != "cpu":
        raise ValueError(f"dense_mm: unsupported device {x.device}")
    _check(x, w)
    return dense_mm_plain(x, w)
