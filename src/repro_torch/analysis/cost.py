"""Analytic work counts of the sparse products: the roofline inputs of
every route the plan layer races.

Counterpart of the analytic half of the JAX package's
``analysis/hlo_cost.py`` (``spmm_cost_dict``, ``sddmm_cost_dict``).  The
reference also reads FLOPs and bytes out of compiled HLO text; the port
compiles no HLO (its routes are hand-written kernels), so the counts are
the analytic ones only.  Below them, the work of one launch of each of
the seven kernels.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def spmm_cost_dict(m: int, k: int, n: int, *, density: float = 1.0,
                   bytes_el: int = 2) -> dict:
    """Useful work of ``sparse[m, k] @ dense[k, n]`` at block density
    ``density``: the lower bound a perfect kernel would hit -- zero
    blocks never touched, the dense operand and the output streamed
    once.  Shaped for ``roofline.roofline_terms`` / ``route_efficiency``
    (``collective_bytes`` 0: one card)."""
    d = min(max(float(density), 0.0), 1.0)
    return dict(
        flops=2.0 * m * k * n * d,
        bytes=(m * k * d + k * n + m * n) * float(bytes_el),
        collective_bytes=0.0,
        collectives={}, warnings=[])


def sddmm_cost_dict(m: int, k: int, n: int, *, density: float = 1.0,
                    bytes_el: int = 2) -> dict:
    """Useful work of the block-sampled ``dY[m, n] @ X[k, n]^T``
    (backward dL/dvalues): only the sampled ``[m, k]`` pattern blocks
    are computed and written, both dense factors are read once."""
    d = min(max(float(density), 0.0), 1.0)
    return dict(
        flops=2.0 * m * k * n * d,
        bytes=(m * n + k * n + m * k * d) * float(bytes_el),
        collective_bytes=0.0,
        collectives={}, warnings=[])


# -- one kernel launch: (FLOPs, bytes moved) ---------------------------------
# Each input read once, each output written once, the int32 walk metadata
# counted; the work ``chip_smoke.py``'s ``[kernel]`` rows bound, and what
# each kernel's meta branch (``kernels/meta.py``) accounts for a launch.

def dense_mm_cost(n: int, k: int, d: int, es: int) -> Tuple[float, float]:
    """``x [n, k] @ w [k, d]``."""
    return 2.0 * n * k * d, float((n * k + k * d + n * d) * es)


def bsmm_cost(n: int, k: int, m: int, tiles: int, b: int, es: int,
              meta_ints: int) -> Tuple[float, float]:
    """``x [n, k] . W^T [k, m]`` over ``tiles`` b x b tiles (the blocks
    the walk reads; ``chip_smoke.py`` counts the non-zero blocks where it
    knows them, a meta launch the tile stack it is handed)."""
    el = tiles * b * b
    return 2.0 * n * el, float((n * k + el + n * m) * es + meta_ints * 4)


def bsmm_balanced_cost(n: int, k: int, m: int, tiles: int, b: int, es: int,
                       visit: int) -> Tuple[float, float]:
    """The balanced walk: ``bsmm_cost`` with the three ``[bins, steps]``
    visit tables as its metadata."""
    return bsmm_cost(n, k, m, tiles, b, es, 3 * visit)


def sddmm_cost(n: int, m: int, k: int, nnz: int, b: int, es: int,
               meta_ints: int) -> Tuple[float, float]:
    """``[nnz, b, b]`` block-sampled ``dy [n, m]^T . x [n, k]``."""
    el = nnz * b * b
    return 2.0 * n * el, float((n * m + n * k + el) * es + meta_ints * 4)


def dsmm_cost(n: int, k: int, m: int, slots: int, b: int,
              es: int) -> Tuple[float, float]:
    """``x [n, k] . W^T`` over ``slots`` runtime blocks (their row and
    column ids read)."""
    el = slots * b * b
    return 2.0 * n * el, float((n * k + el + n * m) * es + 2 * 4 * slots)


def gmm_cost(rows: int, d: int, f: int, experts: int, es: int,
             tiles: int) -> Tuple[float, float]:
    """``rows`` of ``x [., d]`` each through its tile's expert of ``w [E,
    d, f]``; ``experts``: the experts the ids name (every one of a
    batched_matmul's)."""
    return (2.0 * rows * d * f,
            float((rows * d + experts * d * f + rows * f) * es + tiles * 4))


def attn_pairs(sq: int, skv: int, *, causal: bool, window: int = 0,
               global_prefix: int = 0) -> int:
    """Visible (query, key) pairs of one head and row: the causal ``r >=
    c`` and the window ``r - c < window or c < global_prefix`` that the
    kernel's element mask applies (``kernels/bs_attn/ref.py``)."""
    r = np.arange(sq, dtype=np.int64)
    hi = np.minimum(r + 1, skv) if causal else np.full(sq, skv, np.int64)
    if window <= 0:
        return int(hi.sum())
    lo = np.clip(r - window + 1, 0, hi)
    return int((hi - lo + np.minimum(global_prefix, lo)).sum())


def bs_attn_cost(b_: int, sq: int, h: int, skv: int, kvh: int, dh: int,
                 es: int, pairs: int) -> Tuple[float, float]:
    """q ``[B, Sq, H, dh]`` over k/v ``[B, Skv, KV, dh]`` with ``pairs``
    visible pairs a head and row: q.k and p.v, 2 FLOPs a multiply-add."""
    q = b_ * sq * h * dh
    kv = b_ * skv * kvh * dh
    return 4.0 * b_ * pairs * dh * h, float((2 * q + 2 * kv) * es)
