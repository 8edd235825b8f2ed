"""AdamW with fp32 master weights.

Counterpart of the JAX package's ``optim/adamw.py``.  Parameters stay in
their compute dtype (bf16); the optimizer carries an fp32 master copy
and fp32 moments, keyed by parameter name.  Unlike the JAX version,
``adamw_update`` works in place: it overwrites the master weights and
moments, and writes the rounded master back into the parameters with
``copy_`` (the returned params are the same tensors), so a step holds no
second copy of the model or of its optimizer state.

A topology update (``SparseLinear.evolve``) moves a sparse layer's
values to new slots; ``carry_slots`` moves that parameter's master copy
and moments the same way.  Without it the next step would write the
master, in the old slot order, back over the evolved values.  The
reference leaves this to its caller (its ``rigl_evolve`` carries the
values only).

The update count lives on the parameters' device as a 0-dim int32 tensor
(as the reference's ``AdamState.count``), advanced in place, and the
bias corrections and the learning rate are device values too: a captured
train step (``train/program.py``) holds their addresses and reads
nothing back to the host.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.core import partitioner

Tensors = Dict[str, torch.Tensor]


def counter(value, like: Tensors) -> torch.Tensor:
    """A step or update count as a 0-dim int32 tensor on the device of
    ``like``'s tensors (the CPU if it has none); a tensor is returned as
    it is."""
    if isinstance(value, torch.Tensor):
        return value
    dev = next((t.device for t in like.values()), torch.device("cpu"))
    return torch.tensor(int(value), dtype=torch.int32, device=dev)


@dataclasses.dataclass
class AdamState:
    count: torch.Tensor  # [] int32: updates applied so far (an int is taken)
    master: Tensors      # fp32 copy of the params
    mu: Tensors          # first moment (fp32)
    nu: Tensors          # second moment (fp32)

    def __post_init__(self):
        self.count = counter(self.count, self.master)


def adamw_init(params: Tensors) -> AdamState:
    """Zero moments and an fp32 master copy (never aliasing a param)."""
    with torch.no_grad():
        master = {n: p.detach().to(torch.float32, copy=True)
                  for n, p in params.items()}
        zeros = {n: torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for n, p in params.items()}
        zeros2 = {n: torch.zeros_like(z) for n, z in zeros.items()}
    return AdamState(0, master, zeros, zeros2)


def global_norm(tensors: Tensors) -> torch.Tensor:
    """fp32 L2 norm over every tensor of the dict."""
    sq = [torch.sum(g.float() ** 2) for g in tensors.values()]
    return torch.sqrt(torch.stack(sq).sum())


def clip_by_global_norm(grads: Tensors, max_norm: float,
                        norm: Optional[torch.Tensor] = None
                        ) -> Tuple[Tensors, torch.Tensor]:
    """Scale ``grads`` so their global norm is at most ``max_norm``;
    returns ``(grads, norm before clipping)``.  ``norm`` is that norm
    where the caller took it (over blocks held by several ranks)."""
    if norm is None:
        norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {n: g * scale.to(g.dtype) for n, g in grads.items()}, norm


# elements of the parameters one ``_foreach`` pass of ``adamw_update``
# covers: its fp32 temporaries (the cast gradients, the denominators, the
# steps) then hold about 3 x 4 B of them, or of the largest parameter
# where that is bigger (a MoE layer's [E, D, F] expert stack: 201 M
# elements at qwen3-moe-30b-a3b's width), not 12 B of the whole model
UPDATE_GROUP_ELEMS = 1 << 28


def _groups(names, sizes, limit: int):
    """``names`` cut, in order, into runs of at most ``limit`` elements
    (a larger tensor alone)."""
    run, total = [], 0
    for n in names:
        if run and total + sizes[n] > limit:
            yield run
            run, total = [], 0
        run.append(n)
        total += sizes[n]
    if run:
        yield run


@torch.no_grad()
def adamw_update(grads: Tensors, state: AdamState, params: Optional[Tensors],
                 *, lr: Union[float, torch.Tensor], b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1) -> Tuple[Tensors, AdamState]:
    """One AdamW step (decoupled weight decay on every parameter, as the
    reference).  Updates ``state``'s tensors and ``params`` in place
    (the count too: ``state.count`` stays the same tensor) and returns
    ``(params, state)``; ``params=None`` leaves the parameters to the
    caller (a sharded step gathers them from the ranks' masters).  ``lr`` is a float or a 0-dim fp32 tensor on the
    parameters' device; the bias corrections are computed from the count
    on its device, so the step reads nothing on the host.  The arithmetic
    is the reference's, op for op, over many tensors at once
    (``_foreach`` kernels over groups of ``UPDATE_GROUP_ELEMS`` elements:
    a few launches per group instead of a dozen per tensor, and fp32
    temporaries of one group at a time)."""
    state.count = counter(state.count, state.master)
    state.count.add_(1)
    c = state.count.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, c)
    bc2 = 1.0 - torch.pow(b2, c)
    sizes = {n: g.numel() for n, g in grads.items()}
    for names in _groups(list(grads), sizes, UPDATE_GROUP_ELEMS):
        gs = [grads[n].float() for n in names]
        ms = [state.mu[n] for n in names]
        vs = [state.nu[n] for n in names]
        ws = [state.master[n] for n in names]
        torch._foreach_mul_(ms, b1)                   # m = b1 m + (1-b1) g
        torch._foreach_add_(ms, gs, alpha=1 - b1)
        torch._foreach_mul_(vs, b2)                   # v = b2 v + (1-b2) g g
        torch._foreach_addcmul_(vs, gs, gs, value=1 - b2)
        del gs
        denom = torch._foreach_div(vs, bc2)           # sqrt(v / bc2) + eps
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        step = torch._foreach_div(ms, bc1)            # (m / bc1) / denom
        torch._foreach_div_(step, denom)
        del denom
        torch._foreach_add_(step, ws, alpha=weight_decay)  # w -= lr (...)
        torch._foreach_mul_(step, lr)
        torch._foreach_sub_(ws, step)
        del step
        if params is not None:
            for n, w in zip(names, ws):
                params[n].copy_(w)
    return params, state


@torch.no_grad()
def carry_slots(state: AdamState, name: str,
                eplan: partitioner.EvolvePlan) -> None:
    """Carry the fp32 master copy and both moments of the per-slot
    parameter ``name`` (a ``[nnz, b, b]`` values stack) through a
    topology update: carried slots keep theirs bit for bit, grown slots
    start at zero in all three (RigL's convention: a grown block starts
    at zero with fresh moments).  In place when the slot count holds."""
    for table in (state.master, state.mu, state.nu):
        old = table[name]
        new = partitioner.apply_evolution(eplan, old)
        if new.shape == old.shape:
            old.copy_(new)
        else:
            table[name] = new
