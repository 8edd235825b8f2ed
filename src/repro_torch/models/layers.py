"""Base layers: norms, dense projections, embeddings, rotary, MLP.

Counterparts of the JAX package's ``models/layers.py``.  Parameter names
match the JAX params pytree (``scale``, ``w``, ``b``, ``table``) so that
``LM.load_jax_params`` maps leaves one to one.  Dense projections go
through ``sparse.matmul`` (the dense_mm kernel on a card, with the
planned dense backward under autograd); the unembed stays a plain
``torch.matmul``, as the JAX package leaves it to XLA.  Parameters are
created frozen and train after ``requires_grad_(True)``; a tied
embedding collects its gradient from both the gather and the unembed.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import sparse as sparse_api


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


class Dense(nn.Module):
    """Dense projection with ``w [d_in, d_out]`` (the JAX layout)."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = False,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.w = nn.Parameter(torch.zeros((d_in, d_out), dtype=dtype,
                                          device=device),
                              requires_grad=False)
        self.b = (nn.Parameter(torch.zeros(d_out, dtype=dtype, device=device),
                               requires_grad=False) if bias else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            v = torch.randn(self.w.shape, generator=generator,
                            device=self.w.device)
            self.w.copy_(v / np.sqrt(self.w.shape[0]))
            if self.b is not None:
                self.b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.w, self.b)


class Embedding(nn.Module):
    """Token table ``[vocab, d]``; ``embed`` gathers rows, ``unembed``
    projects back with a plain ``torch.matmul``."""

    def __init__(self, vocab: int, d: int, *,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.table = nn.Parameter(torch.zeros((vocab, d), dtype=dtype,
                                              device=device),
                                  requires_grad=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            v = torch.randn(self.table.shape, generator=generator,
                            device=self.table.device)
            self.table.copy_(v * 0.02)


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
    """Dense FFN: gated (``silu``/``gelu``) or plain ``gelu_plain``."""

    def __init__(self, d_model: int, d_ff: int, *, act: str = "silu",
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.act = act
        self.up = Dense(d_model, d_ff, dtype=dtype, device=device)
        self.down = Dense(d_ff, d_model, dtype=dtype, device=device)
        self.gate = (Dense(d_model, d_ff, dtype=dtype, device=device)
                     if act in ("silu", "gelu") else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.up(x)
        if self.gate is not None:
            g = self.gate(x)
            g = F.silu(g) if self.act == "silu" else F.gelu(
                g, approximate="tanh")
            h = g * h
        else:
            h = F.gelu(h, approximate="tanh")
        return self.down(h)
