"""Analytic H100 time model of the dense route, and the serving price on it.

Counterpart of the JAX package's ``core/dispatch.py`` ``_estimate`` and
``price_tokens`` (``dispatch.py:438-468``), cut to the route the serving
engine prices, ``dense_cuda``.  The reference prices with its calibrated
TPU model; no TPU figure carries over.  Here ``_estimate`` models the
dense_mm kernel as it runs on the card: ``dense_mm.ops.walk`` names the
walk a shape takes, and ``dense_mm.ops.walk_seconds`` gives the walk's
time, a per-launch constant plus the larger of its operations over the
walk's rate and its bytes (each operand once) over the walk's bandwidth.
Pricing never measures, as the reference's never does.  Each walk's
time grows with the token count and the walk taken at N <= 16 is the
cheaper one, so a price never falls as the tokens grow.

The constants (``dense_mm.ops.WALK_MODEL``) are fitted to the ``[kernel]
dense_mm`` rows that ``chip_smoke.py`` measures (device time per call,
L2 cold), on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit;
``PERF.md`` lists the rows. The price is this card's on whatever device
the engine runs, as the reference prices with its TPU model on the CPU.
"""
from __future__ import annotations

import functools
from typing import Iterable, Tuple

from repro_torch.kernels.dense_mm import ops as dmm_ops

ROUTE = "dense_cuda"


def _estimate(route: str, m: int, k: int, n: int, *,
              dtype="float32") -> float:
    """Seconds of one ``route`` call for ``[m, k] . [k, n]`` (``y[n, m] =
    x[n, k] . w[k, m]``) on the H100: the time model of the walk the
    dense_mm kernel takes for the shape.  The reference's block size and
    density arguments are left out: the dense route reads neither."""
    if route != ROUTE:
        raise ValueError(f"no H100 model for route {route!r}; priced "
                         f"route: {ROUTE!r}")
    if n <= 0 or m <= 0:
        return 0.0
    return dmm_ops.walk_seconds(dmm_ops.walk(n, k, m, dtype).name, n, k, m,
                                dtype)


@functools.lru_cache(maxsize=65536)
def _price(shapes: Tuple[Tuple[int, int], ...], n_tokens: int,
           dtype: str) -> float:
    return sum(_estimate(ROUTE, m, k, n_tokens, dtype=dtype)
               for m, k in shapes)


def price_tokens(shapes: Iterable[Tuple[int, int]], n_tokens: int, *,
                 dtype="float32", route: str = ROUTE) -> float:
    """Model-seconds on the H100 for pushing ``n_tokens`` tokens through a
    stack of ``[m, k]`` matmuls: the serving engine's admission and
    padding price (the reference's ``price_tokens``, priced by the card's
    model; memoized, as the ladder and every admission ask for it).
    ``shapes`` holds one ``(m, k)`` pair per matmul the tokens flow
    through."""
    if route != ROUTE:
        raise ValueError(f"no H100 model for route {route!r}; priced "
                         f"route: {ROUTE!r}")
    n_tokens = int(n_tokens)
    if n_tokens <= 0:
        return 0.0
    return _price(tuple((int(m), int(k)) for m, k in shapes), n_tokens,
                  dmm_ops._dtype_name(dtype))
