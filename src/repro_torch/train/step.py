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

Data parallelism with the state sharded (``init_train_state(mesh=)`` on
a concrete ``DeviceMesh``; the reference gets it from GSPMD under
``train_state_specs``, "Adam moments spread over data*model chips").
Every rank runs the same program on its shard of the batch
(``ShardLayout``):

* the gradients are summed over the batch axes' group and averaged, in
  their own dtype (bf16 parameters give bf16 gradients, as the
  reference's all-reduce carries);
* each rank keeps its block of every fp32 master, mu, nu and residual,
  the block that the parameter's spec over the whole mesh gives it
  (``sharding.rules.param_spec``; a replicated spec keeps the whole);
* compression (``grad_compress``) runs on the blocks of the reduced
  gradient, one scale per group as the max over every rank's blocks;
* the clip's norm is the whole reduced gradient's: the blocks' squares
  summed over the mesh, each block counted once (by one of its
  replicas);
* AdamW updates the blocks; a parameter held whole (a norm, a bias,
  the router: no rule splits it; every parameter of an LM built without
  the mesh) is gathered back whole on every rank (an all-reduce of
  zeros beside its one writer, in buckets).

A parameter a rank holds as its block (``LM.held_blocks``) is updated
in place, its state that block.  Every weight is held as its rule's
whole block (FSDP: the ``"data"`` split beside the ``"model"`` one),
gathered over ``"data"`` inside the forward, so its gradient arrives
already summed over ``"data"`` (the gather's backward reduce-scatters
it) and is all-reduced over the batch axes its block does not split
(``"pod"``); each rank writes its own block.  A model-parallel LM's own
blocks (a sparse FFN's k-shard, whole over ``"data"``) are all-reduced
over the batch axes.  A mixer whose heads do not split over ``"model"``
holds its weights' ``"data"`` blocks only: their state is the rule's
block inside, and the updated block is gathered over ``"model"``.  A
partial gradient (KV heads several ranks' query heads read, ``q_norm``
/ ``k_norm`` inside split heads, the columns and conv channels of a
Mamba-2 in projection every head reads) is summed over every rank that
holds it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import partitioner, pruning
from repro_torch.core.bsr import BlockSparseMatrix
from repro_torch.launch import mesh as mesh_lib
from repro_torch.optim.adamw import (UPDATE_GROUP_ELEMS, AdamState,
                                     _groups, adamw_init, adamw_update,
                                     carry_slots, clip_by_global_norm,
                                     counter)
from repro_torch.optim.compress import EFState, compress_grads, ef_init
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.sharding import rules

Tensors = Dict[str, torch.Tensor]


class ShardLayout:
    """Where a data-parallel step keeps each parameter's state on a
    concrete mesh, and the collectives that move it (module docstring).

    ``specs``: every parameter's spec under the rules (of its whole
    shape, ``shapes``); ``held``: the parameters the model holds as this
    rank's block, or whose gradient is partial over the ranks
    (``LM.held_blocks``: ``launch.mesh.Held``).  ``place[name]`` is a
    ``Held`` for every parameter: a whole parameter's state is its
    rule's block.  ``comm_ms``, when a dict, collects each collective's
    host time (after a device synchronise) by kind, one entry a step:
    a measurement aid that adds syncs, off by default."""

    def __init__(self, lm, mesh):
        self.mesh = mesh
        held = lm.held_blocks()
        self.shapes = {n: tuple(held[n].block.shape) if n in held
                       else tuple(p.shape)
                       for n, p in lm.named_parameters()}
        self.specs = {n: rules.param_spec(n, shp, mesh)
                      for n, shp in self.shapes.items()}
        self.place: Dict[str, mesh_lib.Held] = {}
        for n, shp in self.shapes.items():
            if n not in held:
                state = mesh_lib.Block.of(shp, self.specs[n], mesh)
                self.place[n] = mesh_lib.Held(
                    mesh_lib.Block.whole(shp, mesh), state, state.index)
                continue
            h = self.place[n] = held[n]
            # a held block's state lies inside it: the rule's block of
            # its tensor, or the whole held block (a k-shard, KV heads
            # several ranks hold, a partial norm, an expert stack)
            if not (set(h.block.axes) <= set(h.state.axes) and (
                    h.state is h.block
                    or h.state.index == mesh_lib.block_slices(
                        shp, self.specs[n], mesh))):
                raise ValueError(f"{n}: its state block {h.state.index} "
                                 f"lies outside its held block "
                                 f"{h.block.index}")
        self.held = set(held)
        self.partial = {n for n, h in held.items() if h.partial}
        names = mesh_lib.mesh_axes(mesh)[0]
        self.batch_axes = rules.batch_axes(mesh)
        self.batch_group = mesh_lib.axes_group(mesh, self.batch_axes)
        self.dp = mesh_lib.axis_index(mesh, self.batch_axes)[1]
        self.mesh_group = mesh_lib.axes_group(mesh, names)
        # the batch axes a held block's gradient is not yet summed over
        # (an expert stack's arrives summed over those its block splits)
        self.held_groups = {
            n: mesh_lib.axes_group(mesh, [
                a for a in self.batch_axes if a not in held[n].block.axes])
            for n in self.held}
        # the axes a held block's state splits it over: gathered back
        # into the block after the update (on the one dim ``local``
        # cuts: ``(dim, index, parts)``)
        self.state_groups, self.state_split = {}, {}
        for n in self.held:
            axes = [a for a in held[n].state.axes
                    if a not in held[n].block.axes]
            self.state_groups[n] = mesh_lib.axes_group(mesh, axes)
            if self.state_groups[n] is not None:
                dims = [d for d, s in enumerate(held[n].local)
                        if s != slice(None)]
                if len(dims) != 1:
                    raise ValueError(f"{n}: its state splits its block on "
                                     f"{len(dims)} dims, not one")
                self.state_split[n] = (dims[0],) + mesh_lib.axis_index(
                    mesh, axes)
        self.owner = {n: h.state.owner for n, h in self.place.items()}
        self.comm_ms: Optional[Dict[str, List[float]]] = None

    def backend(self) -> str:
        import torch.distributed as dist
        return dist.get_backend(self.mesh_group)

    def block(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's state block of the parameter ``name`` as it holds
        it (``t``: the whole tensor, or the held block)."""
        return t[self.place[name].local]

    def _buckets(self, tensors: Tensors, names: List[str]):
        """``names`` cut into runs of one dtype and at most
        ``UPDATE_GROUP_ELEMS`` elements (one flat buffer each)."""
        by_dtype: Dict[torch.dtype, List[str]] = {}
        for n in names:
            by_dtype.setdefault(tensors[n].dtype, []).append(n)
        sizes = {n: tensors[n].numel() for n in names}
        for run in by_dtype.values():
            yield from _groups(run, sizes, UPDATE_GROUP_ELEMS)

    def storage_specs(self, tree: dict) -> dict:
        """How a ``state_tree`` of this layout's state is held, leaf by
        leaf: a ``launch.mesh.Block`` for every parameter and every
        optimizer and residual table entry, ``P()`` for the step and the
        count (the checkpoint gathers and re-slices by them)."""
        out = {}
        for key, node in tree.items():
            if key == "params":
                out[key] = {n: (self.place[n].block if n in self.held
                                else rules.P()) for n in node}
            elif isinstance(node, dict):
                out[key] = {k: ({n: self.place[n].state for n in v}
                                if isinstance(v, dict) else rules.P())
                            for k, v in node.items()}
            else:
                out[key] = rules.P()
        return out

    @contextlib.contextmanager
    def _timed(self, kind: str, device: torch.device):
        if self.comm_ms is None:
            yield
            return
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.comm_ms.setdefault(kind, []).append(
            (time.perf_counter() - t0) * 1e3)

    def _all_reduce(self, t: torch.Tensor, group, op=None) -> None:
        import torch.distributed as dist
        if group is not None:
            dist.all_reduce(t, op=op or dist.ReduceOp.SUM, group=group)

    def reduce_grads(self, grads: Tensors) -> Tensors:
        """The fp32 state blocks of the gradients averaged over the batch
        axes (the whole gradients are dropped as they are reduced); a
        partial gradient is summed over every rank that holds its block
        as well (in its place in a whole buffer, over the mesh)."""
        out: Tensors = {}
        inv = 1.0 / self.dp
        dev = next(iter(grads.values())).device
        with self._timed("grad_all_reduce", dev):
            for n in [n for n in grads if n in self.held]:
                g = grads.pop(n)
                if n in self.partial:
                    blk = self.place[n].block
                    whole = g.new_zeros(blk.shape)
                    blk.put(whole, g)
                    self._all_reduce(whole, self.mesh_group)
                    g = blk.take(whole)
                    del whole
                else:
                    self._all_reduce(g, self.held_groups[n])
                out[n] = self.block(n, g).float() * inv
            for names in list(self._buckets(grads, list(grads))):
                flat = torch.cat([grads[n].reshape(-1) for n in names])
                self._all_reduce(flat, self.batch_group)
                off = 0
                for n in names:
                    g = grads.pop(n)
                    g = flat[off:off + g.numel()].view(g.shape)
                    off += g.numel()
                    out[n] = self.block(n, g).float() * inv
                del flat
        return out

    def mean_metrics(self, metrics: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """Each metric averaged over the batch axes (one all-reduce)."""
        if self.batch_group is None:
            return metrics
        keys = list(metrics)
        vals = torch.stack([metrics[k].float() for k in keys])
        with self._timed("metrics_all_reduce", vals.device):
            self._all_reduce(vals, self.batch_group)
        vals = vals / self.dp
        return {k: vals[i] for i, k in enumerate(keys)}

    def global_norm(self, blocks: Tensors) -> torch.Tensor:
        """The fp32 L2 norm of the whole gradient from its blocks: each
        state block's squares counted by its one owner (a block several
        ranks hold counted once; of blocks that overlap in part, each
        owner's ``written`` part), summed over the mesh."""
        dev = next(iter(blocks.values())).device
        own = [torch.sum(self.place[n].state.written(g).float() ** 2)
               for n, g in blocks.items() if self.owner[n]]
        sq = (torch.stack(own).sum() if own else
              torch.zeros((), dtype=torch.float32, device=dev))
        with self._timed("norm_all_reduce", dev):
            self._all_reduce(sq, self.mesh_group)
        return torch.sqrt(sq)

    def amax_reduce(self, amax: torch.Tensor) -> None:
        import torch.distributed as dist
        with self._timed("amax_all_reduce", amax.device):
            self._all_reduce(amax, self.mesh_group, dist.ReduceOp.MAX)

    @torch.no_grad()
    def write_params(self, master: Tensors, params: Tensors) -> None:
        """Every parameter from the ranks' fp32 master blocks: a held
        block from this rank's own (where its state splits it, gathered
        over the axes that split it: ``core.tp.all_gather_dim``), the
        rest gathered whole."""
        from repro_torch.core.tp import all_gather_dim
        for n in [n for n in params if n in self.held]:   # rank order
            group = self.state_groups[n]
            if group is None:
                params[n].copy_(master[n])
                continue
            dim, idx, parts = self.state_split[n]
            params[n].copy_(all_gather_dim(master[n].to(params[n].dtype),
                                           group, dim, idx, parts))
        rest = [n for n in params if n not in self.held]
        if not rest:
            return
        with self._timed("param_all_gather", params[rest[0]].device):
            for names in self._buckets(params, rest):
                p0 = params[names[0]]
                flat = torch.zeros(sum(params[n].numel() for n in names),
                                   dtype=p0.dtype, device=p0.device)
                off, views = 0, []
                for n in names:
                    v = flat[off:off + params[n].numel()].view(self.shapes[n])
                    off += params[n].numel()
                    if self.owner[n]:
                        self.place[n].state.put(v, master[n])
                    views.append((n, v))
                self._all_reduce(flat, self.mesh_group)
                for n, v in views:
                    params[n].copy_(v)


@dataclasses.dataclass
class TrainState:
    step: torch.Tensor       # [] int32 on the params' device (an int is taken)
    params: Tensors          # the model's parameters, by name
    opt: AdamState           # whole, or this rank's blocks under ``layout``
    ef: Optional[EFState] = None   # None unless gradient compression
    layout: Optional[ShardLayout] = None   # None unless sharded on a mesh

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


def init_train_state(lm, *, hp: TrainHParams = TrainHParams(),
                     mesh=None) -> TrainState:
    """Make ``lm``'s parameters (as initialised or loaded) trainable and
    start AdamW on them (and the compression residuals with
    ``grad_compress``).  On a concrete ``mesh`` the state is this rank's
    blocks (``ShardLayout``); every rank calls it with the same model."""
    lm.requires_grad_(True)
    params = dict(lm.named_parameters())
    layout = ShardLayout(lm, mesh) if mesh_lib.is_concrete(mesh) else None
    held = (params if layout is None else
            {n: layout.block(n, p).contiguous() for n, p in params.items()})
    return TrainState(0, params, adamw_init(held),
                      ef_init(held) if hp.grad_compress else None,
                      layout=layout)


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
    ``EvolvePlan``.  A state sharded on a mesh is refused: its slots are
    blocks of the whole tables."""
    if state.layout is not None:
        raise NotImplementedError("a topology step on a state sharded over "
                                  "a mesh (its optimizer slots are blocks)")
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
        lay = state.layout
        if lay is not None:
            grads = lay.reduce_grads(grads)
            metrics = lay.mean_metrics(dict(metrics, loss=loss))
            loss = metrics.pop("loss")
        if hp.grad_compress:
            if state.ef is None:
                raise ValueError("grad_compress=True needs the state's "
                                 "residuals: init_train_state(lm, hp=hp)")
            grads, state.ef = compress_grads(
                grads, state.ef, groups,
                amax_reduce=None if lay is None else lay.amax_reduce)
        grads, gnorm = clip_by_global_norm(
            grads, hp.clip_norm,
            norm=None if lay is None else lay.global_norm(grads))
        lr = warmup_cosine(state.step, peak_lr=hp.peak_lr,
                           warmup_steps=hp.warmup_steps,
                           total_steps=hp.total_steps)
        adamw_update(grads, state.opt, state.params if lay is None else None,
                     lr=lr, weight_decay=hp.weight_decay)
        if lay is not None:
            lay.write_params(state.opt.master, state.params)
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
