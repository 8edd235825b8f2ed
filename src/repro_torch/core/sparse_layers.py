"""Neural-network layers backed by block-sparse matmul (``nn.Module``s).

Counterparts of the JAX package's ``core/sparse_layers.py``
``SparseLinear``, ``SparseFFN`` and ``DynamicSparseLinear``.  The block pattern is a host
constant on the module, not a parameter; the values are a
``[nnz, b, b]`` parameter in lexsort (row, col) order, the JAX layout,
so weights carry across one to one.

Parameters are created with ``requires_grad=False`` (serving) and
train once switched on (``module.requires_grad_(True)``): with grad
enabled the forward runs the plan's autograd Function (bsmm forward;
SDDMM and bsmm on the transposed pattern backward); under ``no_grad`` it
runs the cached packed tile stack.  ``SparseLinear.evolve`` moves a
layer onto a new pattern (a RigL topology step: ``core/pruning.py``),
its values and plans with it.  ``DynamicSparseLinear`` keeps a
dense master weight and a runtime block mask (the paper's dynamic mode):
each forward encodes the masked blocks on the device and multiplies
through the dynamic plan, so the mask may change every step.

On a model-parallel mesh (``mesh=``, a concrete mesh whose ``"model"``
axis has m > 1 ranks) a ``SparseLinear`` holds only its rank's k-shard
of the blocks (the paper's nnz-balanced k-split,
``partitioner.plan_k_shards``; ``held``) and runs the
``static_tp_shardmap`` route: one bsmm on its shard and one all-reduce a
product, dL/dvalues for its own blocks only.  The reference's rule puts
a contiguous range of ``values`` on each rank instead; the k-shard is
the set whose product needs no other rank's blocks.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import sparse as sparse_api
from repro_torch.core import capture
from repro_torch.core import dynamic_sparse as dsp
from repro_torch.core import masks as masks_lib
from repro_torch.core import partitioner
from repro_torch.core.bsr import BlockSparseMatrix
from repro_torch.core import tp as tp_lib
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.launch.mesh import Block, Held, fill_normal, owns_block
from repro_torch.sharding import rules


class SparseLinear(nn.Module):
    """``y = x . (M * W)^T (+ bias)`` with a static block pattern ``M``.

    ``pattern`` is a host block mask ``[out/b, in/b]``.  A route verdict
    depends on the token count, so the module keeps one plan per count it
    sees (``sparse.plan``, shared by every layer with the same pattern;
    the decode batch and each prefill bucket of a serving engine), and
    one packed operand per route it runs (the kernel's tile stack, or
    W^T for the dense route), rebuilt only when ``values`` changes: its
    memory does not grow with the bucket ladder."""

    def __init__(self, in_features: int, out_features: int,
                 block_size: int, pattern: np.ndarray, *,
                 use_bias: bool = False, dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None, mesh=None):
        super().__init__()
        pattern = np.asarray(pattern, bool)
        b = block_size
        if pattern.shape != (out_features // b, in_features // b):
            raise ValueError(f"pattern {pattern.shape} != grid "
                             f"{(out_features // b, in_features // b)}")
        dev = resolve_device(device)
        self.in_features = in_features
        self.out_features = out_features
        self.block_size = b
        self.pattern = pattern
        rows, cols = np.nonzero(pattern)
        order = np.lexsort((cols, rows))
        self.row_idx = rows[order].astype(np.int32)
        self.col_idx = cols[order].astype(np.int32)
        # name -> Held of the values as this rank's k-shard (a
        # model-parallel mesh); empty: held whole
        self.held: Dict[str, Held] = {}
        self.mesh = None
        m = rules.model_split(mesh)
        nnz = len(self.row_idx)
        if m > 1:
            self.mesh = mesh
            _, r = tp_lib.tp_group(mesh, "model")
            meta = partitioner.plan_k_shards(self.as_bsr(torch.empty(
                (0, b, b), dtype=dtype)), m, balanced=True)
            self.held["values"] = Held.whole(Block(
                (nnz, b, b),
                (meta.shard_source(r).astype(np.int64), slice(None),
                 slice(None)),
                owns_block(mesh, rules.P("model")), ("model",)))
            nnz = self.held["values"].block.block_shape[0]
        self.values = nn.Parameter(
            torch.zeros((nnz, b, b), dtype=dtype, device=dev),
            requires_grad=False)
        self.bias = (nn.Parameter(torch.zeros(out_features, dtype=dtype,
                                              device=dev),
                                  requires_grad=False)
                     if use_bias else None)
        # (tokens, ambient PlanContext without its pool label) -> plan
        self._plans: Dict[tuple, sparse_api.MatmulPlan] = {}
        # route -> (values version, packed operand), for the routes of
        # the live plans in ``_plans``
        self._packed: Dict[str, tuple] = {}

    @classmethod
    def random_pattern(cls, in_features: int, out_features: int,
                       block_size: int, density: float, *, seed: int = 0,
                       **kw) -> "SparseLinear":
        pattern = masks_lib.random_block_mask(
            out_features, in_features, block_size, density, seed=seed)
        return cls(in_features, out_features, block_size, pattern, **kw)

    @property
    def nnz_blocks(self) -> int:
        return int(self.row_idx.size)

    @property
    def density(self) -> float:
        return self.nnz_blocks / self.pattern.size

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Normal values scaled by the expected fan-in ``in * density``
        (the JAX layer's rule; the numbers differ, the scale does not)."""
        fan_in = self.in_features * self.density
        scale = 1.0 / np.sqrt(max(1.0, fan_in))
        fill_normal(self.values, generator, lambda v: v * scale,
                    self.held.get("values"))
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def as_bsr(self, values: Optional[torch.Tensor] = None
               ) -> BlockSparseMatrix:
        """The pattern with ``values`` (the module's own by default; a
        k-shard's module plans on an empty stack: a plan reads only the
        pattern)."""
        if values is None:
            values = (self.values if not self.held else
                      self.values.new_empty((0,) + self.values.shape[1:]))
        return BlockSparseMatrix(values, self.row_idx, self.col_idx,
                                 (self.out_features, self.in_features),
                                 self.block_size)

    def evolve(self, new_pattern: np.ndarray) -> partitioner.EvolvePlan:
        """Topology update (RigL drop and grow) onto ``new_pattern``
        ``[out / b, in / b]``, in place.

        The values of carried blocks move to their new slots bit for bit
        and grown blocks start at zero (RigL's convention): in place when
        the block count holds, else into a new ``values`` parameter (its
        ``grad``, if any, is carried the same way).  Each plan of this
        module is evolved onto the new pattern (``sparse.evolve``: no
        route decision unless the pattern drifted past the context's
        ``evolve_drift``), and the packed operands are dropped (their
        pack index changed even where the values' version did not).
        Modules that shared the old plans (an LM's layers, built on one
        seed) keep them, live.

        The reference returns ``(layer, params)``; this module is
        mutable, so it returns the ``EvolvePlan`` instead: the caller
        carries other per-slot state with it (the optimizer's master
        copy and moments: ``optim.adamw.carry_slots``)."""
        if self.held:
            raise NotImplementedError("a topology step on a k-shard (its "
                                      "blocks move between ranks)")
        new_pattern = np.asarray(new_pattern, bool)
        b = self.block_size
        grid = (self.out_features // b, self.in_features // b)
        if new_pattern.shape != grid:
            raise ValueError(f"pattern {new_pattern.shape} != grid {grid}")
        rows, cols = np.nonzero(new_pattern)
        order = np.lexsort((cols, rows))
        rows = rows[order].astype(np.int32)
        cols = cols[order].astype(np.int32)
        eplan = partitioner.plan_evolution(self.row_idx, self.col_idx,
                                           rows, cols, grid)
        v = self.values
        with torch.no_grad():
            carried = partitioner.apply_evolution(eplan, v.detach())
            grad = (None if v.grad is None
                    else partitioner.apply_evolution(eplan, v.grad))
            if carried.shape == v.shape:
                v.copy_(carried)
                v.grad = grad
            else:
                self.values = nn.Parameter(carried,
                                           requires_grad=v.requires_grad)
                self.values.grad = grad
        new_bsr = BlockSparseMatrix(
            torch.empty((0, b, b), dtype=v.dtype), rows, cols,
            (self.out_features, self.in_features), b)
        self._plans = {k: sparse_api.evolve(p, new_bsr)
                       for k, p in self._plans.items()
                       if p.device == v.device and sparse_api.is_live(p)}
        self._packed = {}
        self.pattern = new_pattern
        self.row_idx, self.col_idx = rows, cols
        return eplan

    def plan(self, n: int, x: Optional[torch.Tensor] = None
             ) -> sparse_api.MatmulPlan:
        """The module's plan for ``n`` tokens under the ambient context,
        built once (``x``, the ``[n, in]`` activations, feeds a measured
        race) and planned again only when the plan cache dropped it
        (``sparse.reset``, a re-planned verdict); each later use registers
        it in the ambient plan pool (as a cache hit of ``sparse.plan``
        would) and keeps it alive through a capture.  The pool label is
        runtime-only, so engines that share the module share its plans.
        Building a plan drops the plans the cache no longer holds, and
        the packed operands of routes no kept plan runs."""
        ctx = sparse_api.current_ctx()
        if self.held:
            # the rank holds one k-shard: the explicit route over "model"
            ctx = dataclasses.replace(
                ctx, mode="static_tp_shardmap", mesh=self.mesh,
                tp_axis="model", tp_q=None, tp_balanced=True, measure=False)
        key = (n, _poolless(ctx))
        p = self._plans.get(key)
        if p is not None and p.device == self.values.device \
                and sparse_api.is_live(p):
            sparse_api.note_use(p)
            return p
        p = self._plans[key] = sparse_api.plan(
            self.as_bsr(), n, x=x, device=self.values.device, ctx=ctx)
        self._plans = {k: q for k, q in self._plans.items()
                       if q.device == self.values.device
                       and sparse_api.is_live(q)}
        routes = {q.route for q in self._plans.values()}
        self._packed = {r: v for r, v in self._packed.items()
                        if r in routes}
        return p

    def packed(self, p: sparse_api.MatmulPlan) -> torch.Tensor:
        """``p``'s packed operand for the current values (cached per
        route; a capture in progress keeps the stack it reads alive)."""
        v = self.values
        key = (v.data_ptr(), v._version, v.dtype, v.device)
        hit = self._packed.get(p.route)
        if hit is None or hit[0] != key:
            with torch.no_grad():
                hit = self._packed[p.route] = (
                    key, p.pack(v, held=bool(self.held)))
        capture.hold(hit[1])
        return hit[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        x2 = x.reshape(-1, self.in_features).to(self.values.dtype)
        p = self.plan(x2.shape[0], x2)
        if torch.is_grad_enabled() and (self.values.requires_grad
                                        or x2.requires_grad):
            y = p.spmm_nt(self.values, x2, held=bool(self.held))
        else:
            y = p.run_packed(self.packed(p), x2)
        y = y.reshape(*lead, self.out_features)
        if self.bias is not None:
            y = y + self.bias
        return y


@functools.lru_cache(maxsize=64)
def _poolless(ctx: sparse_api.PlanContext) -> sparse_api.PlanContext:
    """``ctx`` without its pool label (a runtime-only knob of no plan's
    identity)."""
    return ctx if ctx.pool is None else dataclasses.replace(ctx, pool=None)


class DynamicSparseLinear(nn.Module):
    """Dense master weight + runtime block mask (dynamic sparse
    training).

    Matches PopSparse's dynamic mode: the slot capacity is fixed by
    ``d_max``; the mask is data (a buffer) and may change every step.
    ``forward`` encodes ``weight`` under ``mask`` into ``nnz_max`` slots
    and runs ``dspmm_nt`` through the dynamic plan (``backend`` as in the
    JAX layer: "auto", "xla", "pallas", "grouped").  Gradients reach the
    dense weight through the encoder's gather."""

    def __init__(self, in_features: int, out_features: int,
                 block_size: int, d_max: float, *, use_bias: bool = False,
                 dtype: torch.dtype = torch.float32, backend: str = "auto",
                 device: DeviceLike = None):
        super().__init__()
        b = block_size
        if in_features % b or out_features % b:
            raise ValueError(f"features ({out_features}, {in_features}) "
                             f"not divisible by block {b}")
        dev = resolve_device(device)
        self.in_features = in_features
        self.out_features = out_features
        self.block_size = b
        self.d_max = float(d_max)
        self.backend = backend
        self.weight = nn.Parameter(torch.zeros(
            (out_features, in_features), dtype=dtype, device=dev))
        self.register_buffer("mask", torch.zeros(
            (out_features // b, in_features // b), dtype=torch.bool,
            device=dev))
        self.bias = (nn.Parameter(torch.zeros(out_features, dtype=dtype,
                                              device=dev))
                     if use_bias else None)

    @property
    def nnz_max(self) -> int:
        grid = (self.out_features // self.block_size) * \
            (self.in_features // self.block_size)
        return max(1, int(np.ceil(grid * self.d_max)))

    def reset_parameters(self, generator: torch.Generator, *,
                         mask_seed: int = 0) -> None:
        """Normal weight scaled by ``1 / sqrt(in * d_max)`` (the JAX
        layer's rule) and a random block mask at ``d_max``."""
        scale = 1.0 / np.sqrt(self.in_features * self.d_max)
        with torch.no_grad():
            w = torch.randn(self.weight.shape, generator=generator,
                            device=self.weight.device)
            self.weight.copy_(w * scale)
            if self.bias is not None:
                self.bias.zero_()
        self.set_mask(masks_lib.random_block_mask(
            self.out_features, self.in_features, self.block_size,
            self.d_max, seed=mask_seed))

    def set_mask(self, mask) -> None:
        """Install a new block mask ``[out / b, in / b]`` (a host array
        or a tensor; copied into the buffer)."""
        if not isinstance(mask, torch.Tensor):
            mask = torch.from_numpy(np.array(mask, bool))
        if tuple(mask.shape) != tuple(self.mask.shape):
            raise ValueError(f"mask {tuple(mask.shape)} != grid "
                             f"{tuple(self.mask.shape)}")
        self.mask.copy_(mask)

    def load_jax_params(self, params) -> "DynamicSparseLinear":
        """Copy the JAX layer's params (``{"w", "mask", "bias"}`` as
        numpy) into this module."""
        with torch.no_grad():
            self.weight.copy_(torch.from_numpy(np.array(params["w"],
                                                        np.float32)))
            if self.bias is not None:
                self.bias.copy_(torch.from_numpy(np.array(
                    params["bias"], np.float32)))
        self.set_mask(np.asarray(params["mask"], bool))
        return self

    def encode(self) -> dsp.DynamicOperand:
        return dsp.encode(self.weight, self.mask,
                          block_size=self.block_size, nnz_max=self.nnz_max)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = dsp.dspmm_nt(self.encode(), x.to(self.weight.dtype),
                         backend=self.backend)
        if self.bias is not None:
            y = y + self.bias
        return y


class SparseFFN(nn.Module):
    """Transformer FFN with block-sparse weights (gated or plain).

    Patterns come from ``random_block_mask`` with seeds ``seed + 1``
    (up), ``seed + 2`` (down) and ``seed + 3`` (gate), as in the JAX
    layer, so the two packages hold the same blocks."""

    def __init__(self, d_model: int, d_ff: int, block_size: int,
                 density: float, *, gated: bool = True, seed: int = 0,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None, mesh=None):
        super().__init__()
        dev = resolve_device(device)

        def mk(i, o, s):
            return SparseLinear.random_pattern(
                i, o, block_size, density, seed=seed + s, dtype=dtype,
                device=dev, mesh=mesh)

        self.up = mk(d_model, d_ff, 1)
        self.down = mk(d_ff, d_model, 2)
        self.gate = mk(d_model, d_ff, 3) if gated else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.up(x)
        if self.gate is not None:
            h = F.silu(self.gate(x)) * h
        else:
            h = F.gelu(h, approximate="tanh")
        return self.down(h)
