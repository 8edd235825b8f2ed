"""Analytic work counts of the sparse products: the roofline inputs of
every route the plan layer races.

Counterpart of the analytic half of the JAX package's
``analysis/hlo_cost.py`` (``spmm_cost_dict``, ``sddmm_cost_dict``).  The
reference also reads FLOPs and bytes out of compiled HLO text; the port
compiles no HLO (its routes are hand-written kernels), so the counts are
the analytic ones only.
"""
from __future__ import annotations


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
