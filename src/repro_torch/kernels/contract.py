"""Static kernel contracts: what each CUDA kernel of the port accepts.

Mirror of the JAX package's ``repro/kernels/contract.py``
``KernelContract``, for the port's hand-written kernels.  A contract
names the plan route it serves, its dtypes, its block range and its
divisibility rules over ``m, k, n, b`` (Python expressions), and the
reference kernel it replaces.  Where a contract is narrower than the
reference kernel's, the kernel package's ``__init__`` says so beside it.
The ``pallas`` field of the reference has no counterpart: every contract
here is a CUDA kernel for ``sm_90a``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

CAPACITY_KINDS = ("exact", "planned_bucket", "slot_capacity", "dense")

_EVAL_GLOBALS = {"__builtins__": {}, "any": any, "all": all,
                 "min": min, "max": max, "range": range}


@dataclasses.dataclass(frozen=True)
class KernelContract:
    """Declared admissibility of one kernel.

    kernel        kernel name ("bs_attn", "bsmm", "bsmm_balanced",
                  "dense_mm", "dsmm", "gmm", "sddmm")
    routes        plan routes the kernel serves
    dtypes        supported operand dtypes, by name
    min_block /   inclusive block-size range
    max_block
    divisibility  eval-able constraints over {m, k, n, b}; all must hold
    grid          the launch grid, in words
    capacity      one of CAPACITY_KINDS
    replaces      file:line and name of the TPU kernel it ports
    """

    kernel: str
    routes: Tuple[str, ...]
    dtypes: Tuple[str, ...]
    min_block: int
    max_block: int
    divisibility: Tuple[str, ...]
    grid: str
    capacity: str
    replaces: str

    def __post_init__(self):
        if self.capacity not in CAPACITY_KINDS:
            raise ValueError(f"contract {self.kernel!r}: capacity "
                             f"{self.capacity!r} not in {CAPACITY_KINDS}")
        if not (1 <= self.min_block <= self.max_block):
            raise ValueError(f"contract {self.kernel!r}: bad block range "
                             f"[{self.min_block}, {self.max_block}]")

    def admits(self, m: int, k: int, n: int, b: int,
               dtype: str = "float32") -> Optional[str]:
        """``None`` if the kernel accepts ``(m, k)`` times ``(k, n)`` at
        block size ``b`` in ``dtype``; otherwise the reason it rejects."""
        if dtype not in self.dtypes:
            return f"dtype {dtype} not in supported {self.dtypes}"
        if not (self.min_block <= b <= self.max_block):
            return (f"block {b} outside [{self.min_block}, "
                    f"{self.max_block}]")
        for expr in self.divisibility:
            env = dict(_EVAL_GLOBALS, m=m, k=k, n=n, b=b)
            if not eval(expr, env):  # noqa: S307 (sandboxed)
                return f"constraint {expr!r} fails for m={m} k={k} n={n} b={b}"
        return None


def dtype_name(dtype) -> str:
    """``torch.bfloat16`` (or "bfloat16") -> "bfloat16"."""
    return str(dtype).replace("torch.", "")


def elem_bytes(dtype) -> int:
    """Bytes a value of ``dtype`` takes in the kernels' walks (4 for
    float32, 2 for the 16-bit types), for their time models."""
    return 4 if dtype_name(dtype) == "float32" else 2


def sub_block(b: int, sizes: Sequence[int]) -> int:
    """The block at which a ``b x b`` block is re-expressed for a kernel
    that walks square blocks of ``sizes`` (ascending): the largest of
    them that divides ``b``; else 2 where ``b`` is even, else 1 (blocks
    the caller then packs or re-blocks into the smallest of ``sizes``).
    Splitting each block into ``(b / g)^2`` blocks of ``g`` is exact."""
    for t in reversed(tuple(sizes)):
        if b % t == 0:
            return t
    return 2 if b % 2 == 0 else 1


_REGISTRY: Dict[str, KernelContract] = {}


def register(contract: KernelContract) -> KernelContract:
    """Register ``contract`` under its kernel name (idempotent)."""
    prev = _REGISTRY.get(contract.kernel)
    if prev is not None and prev != contract:
        raise ValueError(f"conflicting contract registration for "
                         f"{contract.kernel!r}")
    _REGISTRY[contract.kernel] = contract
    return contract


def contract_for_route(route: str) -> Optional[KernelContract]:
    for c in _REGISTRY.values():
        if route in c.routes:
            return c
    return None


def load_all() -> Dict[str, KernelContract]:
    """Import every kernel package and return the full registry."""
    import repro_torch.kernels.bs_attn   # noqa: F401
    import repro_torch.kernels.bsmm      # noqa: F401
    import repro_torch.kernels.dense_mm  # noqa: F401
    import repro_torch.kernels.dsmm      # noqa: F401
    import repro_torch.kernels.gmm       # noqa: F401
    import repro_torch.kernels.sddmm     # noqa: F401
    return dict(_REGISTRY)
