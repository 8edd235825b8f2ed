"""Error-feedback int8 gradient compression.

Counterpart of the JAX package's ``optim/compress.py``: each gradient
tensor plus its carried residual is quantised to int8 with one fp32
scale per tensor (``abs().max() / 127``, taken on the device), then
dequantised; what the quantisation lost is carried to the next step in
an fp32 residual (error feedback, Seide et al. 2014 / Karimireddy et al.
2019), which preserves convergence.

The reference quantises and dequantises the gradient after GSPMD's
all-reduce and models the wire volume analytically; it never sends
int8.  The port keeps that arithmetic: the data-parallel step
(``train/step.py`` over a mesh) reduces the gradient first, then
compresses its blocks, each rank the blocks of its residuals, with one
scale per group taken as the max over every rank's blocks (one small
all-reduce, ``amax_reduce``).  Sending the int8 codes instead would
quantise each rank's partial gradient rather than the reduced one: other
numerics, and a feature the reference lacks.  So ``wire_bytes`` stays
analytic: what an int8 all-reduce would move.

Everything runs on the gradients' device with no host read, so a
captured train step (``train/program.py``) carries the residuals as
state, updated in place.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass
class EFState:
    residual: Tensors    # fp32, one per gradient, keyed as the params


def ef_init(params: Tensors) -> EFState:
    """Zero fp32 residuals shaped like ``params``, on their devices."""
    return EFState({n: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
                    for n, p in params.items()})


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(amax, 1e-12) / 127.0


def _quantize(x: torch.Tensor, scale: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    if scale is None:
        scale = _scale(x.abs().max())
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


@torch.no_grad()
def compress_grads(grads: Tensors, ef: EFState,
                   groups: Optional[Sequence[Sequence[str]]] = None,
                   amax_reduce: Optional[Callable[[torch.Tensor], None]]
                   = None) -> Tuple[Tensors, EFState]:
    """``(grads as seen after the all-reduce, ef)``: each gradient
    quantised with its residual and dequantised (fp32); the residuals
    are overwritten in place with what the quantisation lost, and the
    same ``EFState`` is returned.

    ``groups`` names gradients that share one scale (the max of their
    ``abs().max()``): the reference takes one scale per leaf of its
    parameter tree, where a leaf stacks the layers at one position of a
    period (``LM.leaf_groups``).  A gradient in no group has its own.
    ``amax_reduce`` turns the ``[groups]`` vector of local maxima into
    the maxima over every rank's blocks, in place."""
    xs = {n: g.to(torch.float32) + ef.residual[n] for n, g in grads.items()}
    grouped = [tuple(n for n in grp if n in xs) for grp in groups or ()]
    seen = {n for grp in grouped for n in grp}
    grouped += [(n,) for n in xs if n not in seen]
    grouped = [grp for grp in grouped if grp]
    amax = torch.stack([xs[grp[0]].abs().max() if len(grp) == 1 else
                        torch.stack([xs[n].abs().max() for n in grp]).max()
                        for grp in grouped])
    if amax_reduce is not None:
        amax_reduce(amax)
    out: Tensors = {}
    for grp, scale in zip(grouped, _scale(amax)):
        for n in grp:
            d = _dequantize(*_quantize(xs[n], scale))
            ef.residual[n].copy_(xs[n] - d)
            out[n] = d
    return {n: out[n] for n in grads}, ef


def wire_bytes(grads: Tensors) -> Dict[str, int]:
    """All-reduce volume of ``grads`` without and with compression: fp32
    elements, against int8 elements plus one fp32 scale per tensor."""
    n = sum(int(g.numel()) for g in grads.values())
    return {"fp32": 4 * n, "int8": n + 4 * len(grads)}
