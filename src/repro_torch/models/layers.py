"""Base layers: norms, dense projections, embeddings, rotary, MLP.

Counterparts of the JAX package's ``models/layers.py``.  Parameter names
match the JAX params pytree (``scale``, ``w``, ``b``, ``table``) so that
``LM.load_jax_params`` maps leaves one to one.  Dense projections go
through ``sparse.matmul`` (the dense_mm kernel on a card, with the
planned dense backward under autograd); the unembed stays a plain
``torch.matmul``, as the JAX package leaves it to XLA.  Parameters are
created frozen and train after ``requires_grad_(True)``; a tied
embedding collects its gradient from both the gather and the unembed.

Model parallelism (``mesh=`` a concrete mesh whose ``"model"`` axis has
m > 1 ranks) and FSDP (its ``"data"`` axis past 1): a ``Dense`` or an
``Embedding`` holds only its rank's block of the weight under the
reference's rules (``held``: ``launch.mesh.Held`` by leaf name), its
own contiguous tensor (the dense_mm kernel's TMA needs 16-byte strides;
a strided view would be copied on every call).  A block split over
``"data"`` is gathered inside the forward, just before the kernel
(``weight()``: ``core.tp.gather_held``, its gradient reduce-scattered),
so it is whole over ``"data"`` only while its layer runs.  ``MLP`` splits as
Megatron does under the reference's rules: ``up``/``gate``
column-parallel (d_ff over ``"model"``, the input through
``core.tp.copy_to_group``), ``down`` row-parallel (its output
all-reduced through ``reduce_from_group``).  Every random draw is the
whole tensor's, in pieces (``launch.mesh.fill_normal``): a held block
keeps its part of each piece, so it holds what the whole module would
there, and no card ever holds a whole split weight.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import sparse as sparse_api
from repro_torch.core import tp as tp_lib
from repro_torch.launch.mesh import Held, fill_normal
from repro_torch.sharding import rules

def rms_norm(x: torch.Tensor, scale: torch.Tensor, *,
             eps: float = 1e-6, plus_one: bool = False) -> torch.Tensor:
    """RMS norm computed in fp32, returned in ``x``'s dtype;
    ``plus_one`` scales by ``1 + scale`` (Gemma's pre+post norms)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    if plus_one:
        scale = scale + 1.0
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


class RMSNorm(nn.Module):
    """RMS norm with an fp32 ``scale`` initialised to ones (also with
    ``plus_one``, as in the JAX package)."""

    def __init__(self, d: int, *, plus_one: bool = False, device=None):
        super().__init__()
        self.plus_one = plus_one
        self.scale = nn.Parameter(torch.ones(d, dtype=torch.float32,
                                             device=device),
                                  requires_grad=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)

    def forward(self, x, *, eps: float = 1e-6):
        return rms_norm(x, self.scale, eps=eps, plus_one=self.plus_one)


def dense(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x [..., d_in] . w [d_in, d_out] (+ b)`` through the plan API."""
    y = sparse_api.matmul(x, w)
    if b is not None:
        y = y + b
    return y


def _param(shape, held: Optional[Held], dtype, device) -> nn.Parameter:
    """A frozen zero parameter of ``shape``, or of ``held``'s block."""
    if held is not None:
        shape = held.block.block_shape
    return nn.Parameter(torch.zeros(tuple(shape), dtype=dtype,
                                    device=device), requires_grad=False)


class Dense(nn.Module):
    """Dense projection with ``w [d_in, d_out]`` (the JAX layout).
    ``held`` (``{"w": Held, "b": Held}``, from the caller on a mesh; a
    None entry is held whole) makes it hold its rank's blocks of the
    whole weight and bias."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = False,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 held: Optional[Dict[str, Held]] = None):
        super().__init__()
        self.held = {k: h for k, h in (held or {}).items() if h is not None}
        self.d_in = d_in
        self.w = _param((d_in, d_out), self.held.get("w"), dtype, device)
        self.b = (_param((d_out,), self.held.get("b"), dtype, device)
                  if bias else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        fill_normal(self.w, generator, lambda v: v / np.sqrt(self.d_in),
                    self.held.get("w"))
        if self.b is not None:
            with torch.no_grad():
                self.b.zero_()

    def weight(self) -> torch.Tensor:
        """``w`` as the product reads it: its ``"data"`` split gathered."""
        return tp_lib.gather_held(self.w, self.held.get("w"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.weight(), self.b)


class Embedding(nn.Module):
    """Token table ``[vocab, d]``; ``embed`` gathers rows, ``unembed``
    projects back with a plain ``torch.matmul``.  On a model-parallel
    ``mesh`` whose rule splits the vocabulary (``"model"`` on its rows)
    it holds rows ``[v0, v0 + vocab / m)`` (``v0``; ``group`` is the
    ``"model"`` axis's process group, None when held whole); with a
    ``"data"`` axis past 1 it holds its columns' share too, gathered by
    ``weight()``."""

    def __init__(self, vocab: int, d: int, *,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 mesh=None):
        super().__init__()
        self.vocab = vocab
        self.held: Dict[str, Held] = {}
        self.group, self.v0 = None, 0
        split = rules.model_split(mesh) > 1 and rules.held_spec(
            "table", (vocab, d), mesh)[0] == "model"
        h = rules.hold("table", (vocab, d), mesh, model=split)
        if h is not None:
            self.held["table"] = h
        if split:
            self.group, _ = tp_lib.tp_group(mesh, "model")
            self.v0 = h.block.index[0].start
        self.table = _param((vocab, d), self.held.get("table"), dtype,
                            device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        fill_normal(self.table, generator, lambda v: v * 0.02,
                    self.held.get("table"))

    def weight(self) -> torch.Tensor:
        """The rows this rank holds, their ``"data"`` split gathered."""
        return tp_lib.gather_held(self.table, self.held.get("table"))


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def unembed(table: torch.Tensor, x: torch.Tensor, *,
            softcap: Optional[float] = None) -> torch.Tensor:
    logits = torch.matmul(x, table.t())
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


# --- rotary ----------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 10000.0,
               freqs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: ``[..., S, H, dh]``, positions: ``[..., S]``; rotation in fp32.
    ``freqs`` is ``rope_freqs(dh, theta)`` as an fp32 tensor on x's
    device, passed by callers that keep it (building it here copies from
    the host, which waits for the device)."""
    if freqs is None:
        freqs = torch.as_tensor(rope_freqs(x.shape[-1], theta),
                                dtype=torch.float32, device=x.device)
    ang = positions[..., None].float() * freqs          # [..., S, dh/2]
    cos = torch.cos(ang)[..., None, :]                  # over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --- FFN (dense path) --------------------------------------------------------

class MLP(nn.Module):
    """Dense FFN: gated (``silu``/``gelu``) or plain ``gelu_plain``.  On
    a model-parallel ``mesh`` whose rule splits d_ff, ``up``/``gate``
    are column-parallel and ``down`` row-parallel (``group`` the
    ``"model"`` axis's process group; None: whole)."""

    def __init__(self, d_model: int, d_ff: int, *, act: str = "silu",
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 mesh=None):
        super().__init__()
        self.act = act
        self.group = None
        split = rules.model_split(mesh) > 1 and rules.held_spec(
            "up.w", (d_model, d_ff), mesh)[1] == "model"
        if split:
            self.group, _ = tp_lib.tp_group(mesh, "model")
        held = {n: {"w": rules.hold(f"{n}.w", shape, mesh, model=split)}
                for n, shape in (("up", (d_model, d_ff)),
                                 ("gate", (d_model, d_ff)),
                                 ("down", (d_ff, d_model)))}
        self.up = Dense(d_model, d_ff, dtype=dtype, device=device,
                        held=held.get("up"))
        self.down = Dense(d_ff, d_model, dtype=dtype, device=device,
                          held=held.get("down"))
        self.gate = (Dense(d_model, d_ff, dtype=dtype, device=device,
                           held=held.get("gate"))
                     if act in ("silu", "gelu") else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.group is not None:
            x = tp_lib.copy_to_group(x, self.group)
        h = self.up(x)
        if self.gate is not None:
            g = self.gate(x)
            g = F.silu(g) if self.act == "silu" else F.gelu(
                g, approximate="tanh")
            h = g * h
        else:
            h = F.gelu(h, approximate="tanh")
        y = self.down(h)
        if self.group is not None:
            y = tp_lib.reduce_from_group(y, self.group)
        return y
