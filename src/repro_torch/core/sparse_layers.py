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
runs the cached packed tile stack.  ``DynamicSparseLinear`` keeps a
dense master weight and a runtime block mask (the paper's dynamic mode):
each forward encodes the masked blocks on the device and multiplies
through the dynamic plan, so the mask may change every step.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import sparse as sparse_api
from repro_torch.core import capture
from repro_torch.core import dynamic_sparse as dsp
from repro_torch.core import masks as masks_lib
from repro_torch.core.bsr import BlockSparseMatrix
from repro_torch.core.device import DeviceLike, resolve_device


class SparseLinear(nn.Module):
    """``y = x . (M * W)^T (+ bias)`` with a static block pattern ``M``.

    ``pattern`` is a host block mask ``[out/b, in/b]``.  The module plans
    its matmul once (``sparse.plan``, shared by every layer with the same
    pattern) and packs its values into the kernel's tile stack once per
    weight load: the stack is rebuilt only when ``values`` changes."""

    def __init__(self, in_features: int, out_features: int,
                 block_size: int, pattern: np.ndarray, *,
                 use_bias: bool = False, dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None):
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
        self.values = nn.Parameter(
            torch.zeros((len(self.row_idx), b, b), dtype=dtype, device=dev),
            requires_grad=False)
        self.bias = (nn.Parameter(torch.zeros(out_features, dtype=dtype,
                                              device=dev),
                                  requires_grad=False)
                     if use_bias else None)
        self._plan: Optional[sparse_api.MatmulPlan] = None
        self._packed: Optional[torch.Tensor] = None
        self._packed_key = None

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
        with torch.no_grad():
            v = torch.randn(self.values.shape, generator=generator,
                            device=self.values.device)
            self.values.copy_(v * scale)
            if self.bias is not None:
                self.bias.zero_()

    def as_bsr(self) -> BlockSparseMatrix:
        return BlockSparseMatrix(self.values, self.row_idx, self.col_idx,
                                 (self.out_features, self.in_features),
                                 self.block_size)

    def plan(self) -> sparse_api.MatmulPlan:
        """The module's plan, built once under the ambient context; each
        later use registers it in the ambient plan pool (as a cache hit
        of ``sparse.plan`` would) and keeps it alive through a capture."""
        if self._plan is None or self._plan.device != self.values.device:
            self._plan = sparse_api.plan(self.as_bsr(), 0,
                                         device=self.values.device)
        else:
            sparse_api.note_use(self._plan)
        return self._plan

    def packed(self) -> torch.Tensor:
        """The kernel's tile stack for the current values (cached; a
        capture in progress keeps the stack it reads alive)."""
        v = self.values
        key = (v.data_ptr(), v._version, v.dtype, v.device)
        if self._packed is None or self._packed_key != key:
            with torch.no_grad():
                self._packed = self.plan().pack(v)
            self._packed_key = key
        capture.hold(self._packed)
        return self._packed

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        x2 = x.reshape(-1, self.in_features).to(self.values.dtype)
        if torch.is_grad_enabled() and (self.values.requires_grad
                                        or x2.requires_grad):
            y = self.plan().spmm_nt(self.values, x2)
        else:
            y = self.plan().run_packed(self.packed(), x2)
        y = y.reshape(*lead, self.out_features)
        if self.bias is not None:
            y = y + self.bias
        return y


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
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)

        def mk(i, o, s):
            return SparseLinear.random_pattern(
                i, o, block_size, density, seed=seed + s, dtype=dtype,
                device=dev)

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
