"""Dense matmul: CUDA kernel wrapper, walk selection and plain version.

``dense_mm(x, w)`` computes ``y[N, D] = x[N, K] . w[K, D]`` with fp32
accumulation.  For a CUDA tensor it launches ``csrc/dense_mm.cu`` (the
port of ``src/repro/kernels/dense_mm/dense_mm.py`` ``dense_mm_call``) or
raises; for a CPU tensor it runs ``dense_mm_plain``.  ``walk(n, k, d,
dtype)`` is the pure-Python choice of the kernel's walk, tile and K
split for a shape: "decode" (N <= 16 where x's K slice fits shared
memory: w streamed once, K slices joined in a thread-block cluster),
"wgmma" (16-bit, K and D multiples of 8: TMA
+ wgmma tensor-core tiles; above N = 16 always, at N <= 16 where
``walk_seconds`` prices it below the decode walk) or "ffma" (the rest:
fp32 FMA tiles).  ``walk_seconds`` is the walks' time model on the H100,
which ``core.dispatch`` prices the serving engine's buckets with.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.analysis import cost as cost_lib
from repro_torch.kernels import _build, meta
from repro_torch.kernels.contract import dtype_name, elem_bytes

DTYPES = _build.DTYPES
COUNTER = _build.LaunchCounter()
WALKS = ("decode", "wgmma", "ffma")
# launches per walk, beside the total COUNTER
WALK_COUNTERS = {name: _build.LaunchCounter() for name in WALKS}
DECODE_MAX_N = 16       # rows the decode walk takes
SMS = 132               # streaming multiprocessors of an H100 SXM
_DECODE_SLICE_ROWS = 256  # least K rows of a decode slice
_DECODE_MAX_SLICES = 8    # portable cluster size
_DECODE_SMEM = 96 * 1024  # shared memory a decode block takes by choice
_SMEM_MAX = 227 * 1024    # the most a block can take (the kernel checks it)
_TC_BK = 64             # K rows of one wgmma stage
_MIN_SLICE_ROWS = 256   # least K rows of a split-K slice (wgmma, ffma)
# Time of each walk: (seconds a launch, FLOP/s, bytes/s) by (walk, bytes
# per value), fitted to chip_smoke.py's [kernel] dense_mm rows (device
# time, L2 cold; PERF.md lists them) on an NVIDIA H100 80GB HBM3 at a
# 700.00 W power limit; ``launch.bench_dense_mm`` times every walk forced
# at N <= 64, the race this model decides, to refit it.  The launch term holds what does not scale with
# the shape: launch, pipeline fill, epilogue, the cluster or split-K
# reduction.
WALK_MODEL = {
    ("decode", 2): (6.4e-6, 10e12, 1.96e12),
    ("decode", 4): (5.5e-6, 10e12, 2.4e12),
    ("wgmma", 2): (8.7e-6, 572e12, 3.35e12),
    ("ffma", 2): (6.0e-6, 22e12, 3.0e12),
    ("ffma", 4): (6.0e-6, 22e12, 3.0e12),
}


@dataclasses.dataclass(frozen=True)
class Walk:
    """The kernel's walk for one shape.

    name    "decode" | "wgmma" | "ffma"
    bm, bn  output tile (wgmma: 64 or 128 each; ffma: 64 x 64)
    cl      decode: column lanes of a block (16 bytes of w each)
    slices  K slices (decode: the cluster size; wgmma / ffma: > 1 adds
            the fp32 partials in a second launch)
    blocks  thread blocks of the main launch
    """

    name: str
    bm: int = 0
    bn: int = 0
    cl: int = 0
    slices: int = 1
    blocks: int = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tma_ok(k: int, d: int, dtype) -> bool:
    """Whether TMA can load x [N, K] and w [K, D]: 16-bit values and
    16-byte row strides (K and D multiples of 8)."""
    return (dtype_name(dtype) in ("bfloat16", "float16") and k > 0
            and k % 8 == 0 and d % 8 == 0)


def _decode_walk(n: int, k: int, d: int, es: int) -> Walk | None:
    """The decode walk's column lanes and cluster size, or None where
    even its narrowest block cannot hold x's K slice in shared memory
    (fp32 [NT, K / slices] beside the sums [9, NT, 8 columns of 16
    bytes]: K past about 24k in 16-bit types, 27k in fp32, at N 9..16)."""
    vec = 16 // es
    nt = 1 << max(0, (n - 1).bit_length())       # rows the kernel holds
    slices = max(1, min(_DECODE_MAX_SLICES, k // _DECODE_SLICE_ROWS))
    kc = _cdiv(k, slices)
    # the widest column slabs that still give half the card a block
    for cl in (32, 16, 8):
        slabs = _cdiv(d, cl * vec)
        smem = 4 * (nt * kc + 9 * nt * cl * vec)
        if cl == 8 or (slabs * slices >= SMS // 2 and smem <= _DECODE_SMEM):
            break
    if smem > _SMEM_MAX:
        return None
    return Walk("decode", cl=cl, slices=slices, blocks=slabs * slices)


def _split(tiles: int, k_units: int, unit_rows: int) -> int:
    """K slices that bring ``tiles`` blocks up to the card's SMs, each
    slice at least ``_MIN_SLICE_ROWS`` deep (``k_units`` units of
    ``unit_rows`` rows), normalised to the count the kernel launches."""
    if tiles >= SMS:
        return 1
    want = min(_cdiv(SMS, tiles),
               max(1, k_units * unit_rows // _MIN_SLICE_ROWS))
    per = _cdiv(k_units, max(1, want))
    return _cdiv(k_units, per)


def walk_seconds(name: str, n: int, k: int, d: int, dtype) -> float:
    """Modelled device seconds of walk ``name`` for ``x [n, k] . w [k,
    d]``: its launch term plus the larger of its operations over its rate
    and its bytes (each operand once) over its bandwidth.  The ffma walk
    computes whole 64-row tiles."""
    es = elem_bytes(dtype)
    launch, rate, bw = WALK_MODEL[(name, es)]
    rows = _cdiv(n, 64) * 64 if name == "ffma" else n
    return launch + max(2.0 * rows * k * d / rate,
                        float(n * k + k * d + n * d) * es / bw)


def _tc_walk(n: int, k: int, d: int) -> Walk:
    # 128 x 128 tiles while they fill half the card; below that 64 x 64,
    # and K split only where even those leave most SMs idle
    bm = bn = 128
    if _cdiv(n, bm) * _cdiv(d, bn) < SMS // 2:
        bm = bn = 64
    tiles = _cdiv(n, bm) * _cdiv(d, bn)
    slices = (_split(tiles, _cdiv(k, _TC_BK), _TC_BK)
              if tiles < SMS // 4 else 1)
    return Walk("wgmma", bm=bm, bn=bn, slices=slices, blocks=tiles * slices)


@functools.lru_cache(maxsize=4096)
def walk(n: int, k: int, d: int, dtype) -> Walk:
    """The walk, tile and K split ``dense_mm_cuda`` launches for ``x [n,
    k] . w [k, d]`` in ``dtype`` (pure Python; the CPU tests reach it;
    memoized, as decode calls it per projection per step).  At N <= 16
    in 16-bit types the decode and wgmma walks race on ``walk_seconds``:
    the wgmma walk streams a wide w faster, the decode walk starts
    sooner.  A shape the decode walk cannot hold takes the walk of N >
    16."""
    es = elem_bytes(dtype)
    if n <= DECODE_MAX_N:
        dec = _decode_walk(n, k, d, es)
        if dec is not None and not (
                tma_ok(k, d, dtype)
                and walk_seconds("wgmma", n, k, d, dtype)
                < walk_seconds("decode", n, k, d, dtype)):
            return dec
    if tma_ok(k, d, dtype):
        return _tc_walk(n, k, d)
    tiles = _cdiv(n, 64) * _cdiv(d, 64)
    slices = _split(tiles, _cdiv(max(k, 1), 16), 16)
    return Walk("ffma", bm=64, bn=64, slices=slices, blocks=tiles * slices)


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


def dense_mm_cuda(x: torch.Tensor, w: torch.Tensor,
                  plan: Walk | None = None) -> torch.Tensor:
    """Launch the CUDA kernel (CUDA tensors; meta tensors take the meta
    branch, ``kernels/meta.py``) on ``walk(...)``'s walk, or on ``plan``
    where the caller names one."""
    _check(x, w)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"dense_mm_cuda needs CUDA tensors, got {x.device}")
    n, k = x.shape
    d = w.shape[1]
    y = torch.empty((n, d), dtype=x.dtype, device=x.device)
    if n == 0 or d == 0:
        return y
    wk = plan or walk(n, k, d, x.dtype)
    if wk.name == "wgmma":
        if not tma_ok(k, d, x.dtype):
            raise ValueError(f"the wgmma walk needs 16-bit x, w with K and "
                             f"D multiples of 8; got {x.dtype}, K={k}, D={d}")
        # TMA reads from 16-byte-aligned bases: a view at an unaligned
        # offset is copied (fresh allocations are aligned)
        x, w = (a if a.data_ptr() % 16 == 0 else a.clone() for a in (x, w))
    elif wk.name == "decode" and n > DECODE_MAX_N:
        raise ValueError(f"the decode walk takes N <= {DECODE_MAX_N}, got "
                         f"{n}")
    scratch = (torch.empty(wk.slices * n * d, dtype=torch.float32,
                           device=x.device)
               if wk.slices > 1 and wk.name != "decode" else None)
    if x.device.type == "meta":
        return meta.account("dense_mm", wk.name, y, cost_lib.dense_mm_cost(
            n, k, d, x.element_size()))
    fn = _build.entry("dense_mm", "dense_mm",
                      [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                      + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                  scratch.data_ptr() if scratch is not None else None,
                  n, k, d, WALKS.index(wk.name), wk.bm, wk.bn, wk.cl,
                  wk.slices, _build.DTYPE_CODES[x.dtype], stream)
    _build.check(code, "dense_mm")
    COUNTER.launches += 1
    WALK_COUNTERS[wk.name].launches += 1
    return y


def dense_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``y = x @ w`` with fp32 accumulation.  CUDA tensors launch the
    kernel (or raise); CPU tensors run the plain version; meta tensors
    take the meta branch."""
    if x.device.type in ("cuda", "meta"):
        return dense_mm_cuda(x, w)
    if x.device.type != "cpu":
        raise ValueError(f"dense_mm: unsupported device {x.device}")
    _check(x, w)
    return dense_mm_plain(x, w)
