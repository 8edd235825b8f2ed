"""The seven kernels on the meta device: what a launch would do, without
one.

Each kernel's launching wrapper (``*_cuda``) has three branches: a CUDA
tensor launches the kernel (or raises), a CPU tensor runs the plain
version through the public wrapper, and a meta tensor -- and only a meta
tensor -- takes the meta branch: it allocates exactly the outputs and
workspaces the CUDA branch allocates (the same code, so the same shapes,
dtypes and strides: a dry-run that tracks live storages sees the card's
bytes), adds the launch's FLOPs and bytes to ``WORK[kernel]`` (the
formulas of ``analysis/cost.py``, the work ``chip_smoke.py``'s kernel
bounds count) and launches nothing.  It bumps no launch counter.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

KERNELS = ("bs_attn", "bsmm", "bsmm_balanced", "dense_mm", "dsmm", "gmm",
           "sddmm")


@dataclasses.dataclass
class Work:
    """Launches a card would make, and their FLOPs and bytes moved."""

    calls: int = 0
    flops: float = 0.0
    bytes: float = 0.0
    walks: Dict[str, int] = dataclasses.field(default_factory=dict)


WORK: Dict[str, Work] = {k: Work() for k in KERNELS}


def account(kernel: str, walk: str, out, cost: Tuple[float, float]):
    """Add one launch of ``kernel`` on ``walk`` with ``cost`` = (flops,
    bytes) and return ``out`` (the meta branch's result)."""
    w = WORK[kernel]
    w.calls += 1
    w.walks[walk] = w.walks.get(walk, 0) + 1
    w.flops += float(cost[0])
    w.bytes += float(cost[1])
    return out


def reset() -> None:
    for k in KERNELS:
        WORK[k] = Work()


def totals() -> Dict[str, dict]:
    """``{kernel: {"calls", "flops", "bytes", "walks"}}`` since the last
    reset."""
    return {k: dataclasses.asdict(w) for k, w in WORK.items()}
