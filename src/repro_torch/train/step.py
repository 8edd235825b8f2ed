"""Train step: loss -> grad -> clip -> AdamW, with optional microbatch
gradient accumulation.

Counterpart of the JAX package's ``train/step.py``.  The model holds
its parameters (an ``nn.Module``), so the state's ``params`` are the
model's own tensors, keyed by name, and a step updates them in place.
Gradients come from ``torch.autograd.grad`` of ``LM.loss``: through the
sparse FFN that runs the static plan's planned backward (bsmm on the
transposed pattern for dL/dx, the SDDMM for dL/dvalues), and through an
MoE FFN's routing and expert GEMMs (gmm on W^T for dL/da).  With
``grad_compress`` the gradients go through error-feedback int8
compression (``optim/compress.py``) before the clip, as the reference's
do; its residuals are part of the state.

RigL topology steps: ``rigl_evolve`` is the reference's step on a plan
(the new mask, the evolved plan, the carried values);
``evolve_sparse_layer`` applies one to a ``SparseLinear`` of a training
state, its optimizer slots (``carry_slots``) with it.

The step and AdamW's update count are 0-dim int32 tensors on the
parameters' device, advanced in place, and the learning rate, the bias
corrections and every metric are device values: a step reads nothing
back to the host, so ``train/program.py`` can capture it as one CUDA
graph (the counterpart of the reference's ``jax.jit`` of this step).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import partitioner, pruning
from repro_torch.core.bsr import BlockSparseMatrix
from repro_torch.optim.adamw import (AdamState, adamw_init, adamw_update,
                                     carry_slots, clip_by_global_norm,
                                     counter)
from repro_torch.optim.compress import EFState, compress_grads, ef_init
from repro_torch.optim.schedule import warmup_cosine

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    step: torch.Tensor       # [] int32 on the params' device (an int is taken)
    params: Tensors          # the model's parameters, by name
    opt: AdamState
    ef: Optional[EFState] = None   # None unless gradient compression

    def __post_init__(self):
        self.step = counter(self.step, self.params)


class TrainHParams(NamedTuple):
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    clip_norm: float = 1.0
    weight_decay: float = 0.1
    accum: int = 1                 # microbatch accumulation factor
    grad_compress: bool = False


def init_train_state(lm, *, hp: TrainHParams = TrainHParams()
                     ) -> TrainState:
    """Make ``lm``'s parameters (as initialised or loaded) trainable and
    start AdamW on them (and the compression residuals with
    ``grad_compress``)."""
    lm.requires_grad_(True)
    params = dict(lm.named_parameters())
    return TrainState(0, params, adamw_init(params),
                      ef_init(params) if hp.grad_compress else None)


def microbatch_grads(grad_fn: Callable, params: Tensors, batch: dict,
                     accum: int):
    """Gradient accumulation over ``accum`` microbatches.

    ``grad_fn(params, microbatch) -> ((loss, metrics), grads)``.  The
    batch is split on axis 0 into ``accum`` consecutive pieces, run one
    after the other (peak activation memory drops to 1/accum); grads
    accumulate in fp32.  Loss, metrics and grads come back
    microbatch-averaged."""
    if accum == 1:
        (loss, metrics), grads = grad_fn(params, batch)
        return loss, metrics, grads
    size = {v.shape[0] for v in batch.values()}
    if len(size) != 1 or next(iter(size)) % accum:
        raise ValueError(f"batch sizes {sorted(size)} do not split into "
                         f"{accum} microbatches")
    step = next(iter(size)) // accum
    tot_loss = None
    tot_metrics: Dict[str, torch.Tensor] = {}
    acc: Tensors = {}
    for i in range(accum):
        mb = {k: v[i * step:(i + 1) * step] for k, v in batch.items()}
        (loss, metrics), grads = grad_fn(params, mb)
        with torch.no_grad():
            for n, g in grads.items():
                if n in acc:
                    acc[n] += g.float()
                else:
                    acc[n] = g.float()
            tot_loss = loss.float() if tot_loss is None else tot_loss + loss
            for k, v in metrics.items():
                tot_metrics[k] = tot_metrics.get(k, 0) + v
    inv = 1.0 / accum
    return (tot_loss * inv, {k: v * inv for k, v in tot_metrics.items()},
            {n: g * inv for n, g in acc.items()})


@torch.no_grad()
def rigl_evolve(plan_, values: torch.Tensor, dense_grad: torch.Tensor, *,
                fraction: float, generator: torch.Generator):
    """One RigL topology step on a static sparse plan: drop the
    ``fraction`` lowest-|W| active blocks, regrow as many by the largest
    |dense gradient| (``pruning.rigl_update``, on the values' device),
    ``plan_.evolve`` onto the new pattern and carry the surviving values
    (grown blocks start at zero).  Returns ``(new_plan, new_values)``.

    ``dense_grad`` is the dense-position ``dL/dW = dy^T . x`` of shape
    ``[m, k]`` at every block, active or not.  The reference computes it
    outside any Pallas kernel (XLA's dot); its counterpart here is
    ``torch.matmul`` in the caller.  The one host read of the step is
    the new mask going to ``evolve``, as in the reference; the carry
    stays on the device.  Constant nnz, so the evolved plan keeps the
    parent's verdicts unless the drift guardrail trips."""
    rows, cols = plan_.pattern
    bsr = BlockSparseMatrix(values, rows, cols, (plan_.m, plan_.k),
                            plan_.block_size)
    mask = torch.zeros(bsr.grid, dtype=torch.bool)
    mask[torch.as_tensor(rows, dtype=torch.long),
         torch.as_tensor(cols, dtype=torch.long)] = True
    new_mask = pruning.rigl_update(
        bsr.to_dense(), dense_grad, mask.to(values.device),
        block_size=plan_.block_size, fraction=fraction, generator=generator)
    new_plan = plan_.evolve(new_mask.cpu().numpy())
    return new_plan, new_plan.carry_values(values)


def evolve_sparse_layer(state: TrainState, name: str, layer,
                        new_pattern) -> partitioner.EvolvePlan:
    """Move the ``SparseLinear`` ``layer``, whose values are
    ``state.params[name]``, onto ``new_pattern`` (``layer.evolve``) and
    carry the optimizer's master copy and moments of those values with
    it (``carry_slots``), and its compression residual where the state
    has one (a grown block starts with none).  Returns the
    ``EvolvePlan``."""
    eplan = layer.evolve(new_pattern)
    carry_slots(state.opt, name, eplan)
    if state.ef is not None:
        with torch.no_grad():
            old = state.ef.residual[name]
            new = partitioner.apply_evolution(eplan, old)
            if new.shape == old.shape:
                old.copy_(new)
            else:
                state.ef.residual[name] = new
    state.params[name] = layer.values
    return eplan


def lm_grad_fn(lm) -> Callable:
    """``grad_fn`` for ``microbatch_grads``: value and gradient of
    ``lm.loss`` with respect to every trainable parameter; a batch's
    ``frontend`` or ``enc_frames`` go to ``lm.loss`` with its tokens."""
    def grad_fn(params: Tensors, batch: dict):
        names = [n for n, p in params.items() if p.requires_grad]
        loss, metrics = lm.loss(batch["tokens"], batch["targets"],
                                frontend=batch.get("frontend"),
                                enc_frames=batch.get("enc_frames"))
        gs = torch.autograd.grad(loss, [params[n] for n in names],
                                 allow_unused=True)
        grads = {n: (torch.zeros_like(params[n]) if g is None else g)
                 for n, g in zip(names, gs)}
        return (loss.detach(), metrics), grads
    return grad_fn


def make_train_step(lm, hp: TrainHParams = TrainHParams()):
    """``train_step(state, batch) -> (state, metrics)``; ``batch`` is
    ``{"tokens", "targets"}`` ``[B, S]`` arrays, with a VLM's
    ``frontend`` or an encoder-decoder's ``enc_frames`` where the model
    takes them.  The state is updated in
    place (its step, parameters and optimizer tensors) and returned.
    Metrics, each a device tensor: the loss's own (``xent``; an MoE
    model's ``aux_loss``, ``z_loss`` and ``dropped_frac`` too),
    microbatch-averaged, ``loss``, ``grad_norm`` (before clipping) and
    ``lr`` (from the step on its device).  With ``grad_compress`` the
    gradients are compressed before the clip, one scale per leaf of the
    reference's parameter tree (``LM.leaf_groups``; ``state.ef``
    carries the residuals, in place).  Nothing is read back to the host once the
    plans are built."""
    grad_fn = lm_grad_fn(lm)
    groups = lm.leaf_groups() if hp.grad_compress else None

    def train_step(state: TrainState, batch: dict
                   ) -> Tuple[TrainState, Dict[str, Any]]:
        loss, metrics, grads = microbatch_grads(grad_fn, state.params,
                                                batch, hp.accum)
        if hp.grad_compress:
            if state.ef is None:
                raise ValueError("grad_compress=True needs the state's "
                                 "residuals: init_train_state(lm, hp=hp)")
            grads, state.ef = compress_grads(grads, state.ef, groups)
        grads, gnorm = clip_by_global_norm(grads, hp.clip_norm)
        lr = warmup_cosine(state.step, peak_lr=hp.peak_lr,
                           warmup_steps=hp.warmup_steps,
                           total_steps=hp.total_steps)
        adamw_update(grads, state.opt, state.params, lr=lr,
                     weight_decay=hp.weight_decay)
        state.step.add_(1)
        return state, dict(metrics, loss=loss, grad_norm=gnorm, lr=lr)

    return train_step


# -- checkpoint trees -----------------------------------------------------------

def state_tree(state: TrainState) -> dict:
    """The state as a nested dict of tensors, the step and the count
    among them (what the checkpointer stores), with the compression
    residuals under ``ef`` where the state has them."""
    tree = {"step": state.step, "params": dict(state.params),
            "opt": {"count": state.opt.count,
                    "master": dict(state.opt.master),
                    "mu": dict(state.opt.mu), "nu": dict(state.opt.nu)}}
    if state.ef is not None:
        tree["ef"] = {"residual": dict(state.ef.residual)}
    return tree


@torch.no_grad()
def load_state_tree(state: TrainState, tree: dict) -> TrainState:
    """Copy a restored ``state_tree`` into ``state``'s tensors in place
    (the model's parameters, the step, the count and the compression
    residuals included: a captured train step reads the restored
    values); returns ``state``."""
    pairs = [(tree["params"], state.params),
             (tree["opt"]["master"], state.opt.master),
             (tree["opt"]["mu"], state.opt.mu),
             (tree["opt"]["nu"], state.opt.nu)]
    if (state.ef is None) != ("ef" not in tree):
        raise ValueError("the checkpoint and the state disagree on "
                         "gradient compression (residuals in one only)")
    if state.ef is not None:
        pairs.append((tree["ef"]["residual"], state.ef.residual))
    for src, dst in pairs:
        for n, t in dst.items():
            t.copy_(src[n])
    state.step.copy_(torch.as_tensor(tree["step"]))
    state.opt.count.copy_(torch.as_tensor(tree["opt"]["count"]))
    return state
