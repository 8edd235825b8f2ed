"""Mixture-of-Experts FFN: the paper's dynamic block sparsity at layer
scale.

Counterpart of the JAX package's ``models/moe.py`` (``MoEMetrics``,
``moe_init``, ``_capacity``, ``moe_apply``, ``_moe_gspmd``,
``_route_and_rank``, ``moe_flops_per_token``).  Dispatch is the
reference's sort-free "capacity gather": top-k routing in fp32, each
expert takes the first C tokens routed to it (priority by the flattened
token-major assignment order), the expert GEMMs run on the ``[E, C,
D]`` buckets, and a weighted scatter-add combines, token by token in
the reference's order (``combine``).  Overflow goes to a
scratch column that is cropped, and is counted in ``dropped_frac``;
empty slots gather token 0 with combine weight 0.  The expert GEMMs go
through ``sparse.batched_matmul``: the gmm kernel on a card (one launch
per product for all experts), ``torch.matmul`` on the CPU.  Training
differentiates through all of it, as ``jax.grad`` does the reference:
the fp32 router, top-k, the row gathers (``embedding``), the combine
and the expert GEMMs (on a card the plan's backward: gmm on each
expert's W^T for dL/da); empty slots and dropped assignments get
exactly zero gradient.

Built on a concrete mesh (``MoE(mesh=)``, ``LM(mesh=)``), a module
holds only its rank's block of ``w_gate`` / ``w_up`` / ``w_down`` under
the sharding rules, whatever its ``impl``: its ``E / m`` experts where
the ``"model"`` axis's size m divides E (else every expert, as the
reference's divisibility fallback leaves them), and where ``"data"``
splits the second dim, that shard, all-gathered in the forward and
reduce-scattered in the backward (the reference's FSDP gather).  Its
shared experts are an ``MLP`` split over ``"model"`` by their rules
(column-parallel up / gate, row-parallel down).  Such a module runs
under its mesh only (``sharding.activation_mesh``).  The tokens a rank
holds there are its shard of the batch over the batch axes (as the
data-parallel step gives each rank; the serving engine's ranks hold the
whole batch: ``activation_mesh(batch_split=False)``), replicated over
``"model"``.

``impl="shard_map"`` is the reference's expert parallelism
(``_moe_shard_map``), taken under the reference's rule (``ep_route``: a
``"model"`` axis whose size divides E, and batch axes): each rank routes
its tokens with the capacity of its own token count and the metrics
are averaged over the batch axes.  ``impl="gspmd"`` (and a shard_map
config outside ``ep_route``) on a concrete mesh is ``_moe_global``: the
reference's ``_moe_gspmd`` on the global batch, its capacity, kept set
and metrics those of every rank's tokens together (``global_route``).
Both compute a rank's experts on its own tokens' buckets, combine them
in the reference's slot order and all-reduce the partial output once
over ``"model"`` in ``combine_dtype`` (``_moe_experts``).  The backward
is Megatron's pair, as ``core/tp.py``'s: the expert inputs (the token
rows and the combine weights) are an identity forward with an
all-reduce backward, the combine an all-reduce forward with an identity
backward.  Off a concrete mesh the gspmd formulation runs on the tokens
given.  The module holds its parameters under the reference's names
(``router.w``, ``w_gate``, ``w_up``, ``w_down``, ``shared.*``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import sparse as sparse_api
from repro_torch.core.tp import (copy_to_group, gather_held,
                                 reduce_from_group, sum_over_group)
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.layers import MLP
from repro_torch.sharding import rules


class MoEMetrics(NamedTuple):
    aux_loss: torch.Tensor       # load-balance loss (switch-style)
    z_loss: torch.Tensor         # router logit magnitude penalty
    dropped_frac: torch.Tensor   # fraction of assignments over capacity


class _Router(nn.Module):
    """The router's fp32 ``w [d_model, E]``."""

    def __init__(self, d: int, e: int, *, device=None):
        super().__init__()
        self.w = nn.Parameter(torch.zeros((d, e), dtype=torch.float32,
                                          device=device),
                              requires_grad=False)


class MoE(nn.Module):
    """Stacked expert weights ``w_gate``/``w_up [E, D, F]``, ``w_down [E,
    F, D]``, the router, and the shared experts' ``MLP`` when the config
    has them.  ``forward(x)`` is ``moe_apply``."""

    def __init__(self, cfg, *, dtype: torch.dtype = torch.bfloat16,
                 device=None, mesh=None):
        super().__init__()
        m = cfg.moe
        d = cfg.d_model
        self.cfg = cfg
        self.router = _Router(d, m.num_experts, device=device)
        # name -> ``launch.mesh.Held`` of the expert stacks held as this
        # rank's block under their rule (on a concrete ``mesh``); empty:
        # held whole
        self.held = {}
        self.mesh = mesh if mesh_lib.is_concrete(mesh) else None

        def param(name, shape):
            if self.mesh is not None:
                h = self.held[name] = rules.held_block(name, shape, mesh)
                shape = h.block.block_shape
            return nn.Parameter(torch.zeros(shape, dtype=dtype,
                                            device=device),
                                requires_grad=False)

        self.w_gate = param("w_gate", (m.num_experts, d, m.d_ff_expert))
        self.w_up = param("w_up", (m.num_experts, d, m.d_ff_expert))
        self.w_down = param("w_down", (m.num_experts, m.d_ff_expert, d))
        self.shared = (MLP(d, m.num_shared * m.d_ff_shared, act=cfg.act,
                           dtype=dtype, device=device, mesh=self.mesh)
                       if m.num_shared else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's scales: N(0, 1/d) router and gate/up, N(0,
        1/d_ff_expert) down, drawn on the parameters' device (the shared
        MLP fills its own).  One expert at a time, so the fp32 draw
        never holds a whole stack; a held block keeps its part of every
        draw, so it holds what the whole module would there."""
        d = self.cfg.d_model
        with torch.no_grad():
            for name, p, scale in (
                    ("router", self.router.w, 1.0 / np.sqrt(d)),
                    ("w_gate", self.w_gate, 1.0 / np.sqrt(d)),
                    ("w_up", self.w_up, 1.0 / np.sqrt(d)),
                    ("w_down", self.w_down,
                     1.0 / np.sqrt(self.cfg.moe.d_ff_expert))):
                if name in self.held:
                    blk = self.held[name].block
                    shape, sl = blk.shape, blk.index
                    lo = sl[0].start
                    for e in range(shape[0]):
                        x = torch.randn(shape[1:], generator=generator,
                                        device=p.device) * scale
                        if lo <= e < lo + p.shape[0]:
                            p[e - lo].copy_(x[sl[1:]])
                    continue
                rows = p.unsqueeze(0) if p.dim() == 2 else p
                for sl in rows:
                    sl.copy_(torch.randn(sl.shape, generator=generator,
                                         device=sl.device) * scale)

    def forward(self, x: torch.Tensor):
        return moe_apply(self, self.cfg, x)


def moe_init(cfg, *, dtype: torch.dtype = torch.bfloat16, device=None,
             seed: int = 0, mesh=None) -> MoE:
    """An ``MoE`` on ``device`` filled from a seeded ``torch.Generator``
    on that device (the JAX key's numbers are not reproduced; tests carry
    JAX weights over with ``LM.load_jax_params``)."""
    mod = MoE(cfg, dtype=dtype, device=device, mesh=mesh)
    dev = mod.w_gate.device
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    for sub in mod.modules():
        if hasattr(sub, "reset_parameters"):
            sub.reset_parameters(gen)
    return mod


def _capacity(tokens: int, cfg) -> int:
    m = cfg.moe
    c = int(np.ceil(tokens * m.top_k / m.num_experts * m.capacity_factor))
    # a nonzero multiple of 8 (the gather shape the reference keeps)
    return max(8, -(-c // 8) * 8)


def ep_route(cfg, mesh) -> bool:
    """The reference's rule for ``impl="shard_map"``: a concrete mesh
    (an abstract one has no ranks to hold the experts) with a
    ``"model"`` axis whose size divides E, and batch axes."""
    m = cfg.moe
    if m is None or m.impl != "shard_map" or not mesh_lib.is_concrete(mesh):
        return False
    names, sizes = mesh_lib.mesh_axes(mesh)
    return ("model" in names
            and m.num_experts % sizes[names.index("model")] == 0
            and bool(rules.batch_axes(mesh)))


def moe_apply(moe: MoE, cfg, x: torch.Tensor):
    """x ``[B, S, D]`` -> ``(y, MoEMetrics)``.  Capacity-bounded top-k
    routing: through ``_moe_shard_map`` where ``ep_route`` holds for the
    installed mesh (``sharding.current_mesh``), through
    ``_moe_global`` on any other concrete mesh, else through the gspmd
    formulation.  The routing drop is folded into the ``"moe_dispatch"``
    capacity stream (``sparse.record_dropped``: kept on the card until
    ``capacity_report()``, so no layer waits for it)."""
    mesh = rules.current_mesh()
    if ep_route(cfg, mesh):
        y, metrics = _moe_shard_map(moe, cfg, x, mesh)
    elif mesh_lib.is_concrete(mesh):
        y, metrics = _moe_global(moe, cfg, x, mesh)
    elif moe.held:
        raise ValueError("this MoE holds one rank's experts: run it under "
                         "its mesh (sharding.activation_mesh)")
    else:
        y, metrics = _moe_gspmd(moe, cfg, x)
    sparse_api.record_dropped("moe_dispatch", metrics.dropped_frac)
    return y, metrics


def _route(xf: torch.Tensor, router_w: torch.Tensor, cfg, ranking: str):
    """Top-k routing of a token set ``xf [T, D]``: ``(logits [T, E] fp32,
    top_p [T, k], flat_e [T k], slot [T k], counts [E])``, ``slot`` each
    assignment's rank in its expert's queue over the flattened (T * k)
    token-major priority order; ``ranking`` "sort" (the reference's
    ``_route_and_rank``) or "cumsum" (its gspmd default) rank alike."""
    m = cfg.moe
    e_n, k = m.num_experts, m.top_k
    dev = xf.device
    logits = torch.matmul(xf.float(), router_w)                   # [T, E]
    if m.router_score == "sigmoid":
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(scores, k, dim=-1)                  # [T, k]
    if m.norm_topk_prob:
        top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    flat_e = top_e.reshape(-1)
    if ranking == "sort":
        order = torch.argsort(flat_e, stable=True)
        sorted_e = flat_e[order]
        first = torch.searchsorted(sorted_e,
                                   torch.arange(e_n, device=dev))
        rank_sorted = torch.arange(flat_e.shape[0], device=dev) \
            - first[sorted_e]
        slot = torch.empty_like(flat_e)
        slot[order] = rank_sorted
        counts = expert_counts(flat_e, e_n)
    else:
        # the reference's cumsum over the [T k, E] one-hot, laid out [E,
        # T k] so the scan runs along the contiguous axis (a scan down
        # the outer axis took 1.5 ms a layer at a 1008-token prefill on
        # an H100, launch.profile_serve); the same slots
        onehot = (flat_e[None, :] == torch.arange(
            e_n, device=dev)[:, None]).to(torch.int32)            # [E, T k]
        slot = (torch.cumsum(onehot, dim=1) * onehot).sum(0) - 1
        counts = onehot.sum(1)
    return logits, top_p, flat_e, slot, counts


def _assign(flat_e: torch.Tensor, slot: torch.Tensor, top_p: torch.Tensor,
            keep: torch.Tensor, e_n: int, bucket: int):
    """The buckets' index map and combine weights for the kept
    assignments (each kept ``slot`` below ``bucket``):
    ``(token_for_slot [E, bucket] long, w_slot [E, bucket] fp32,
    flat_slot [T, k])``, the last each assignment's flat slot (``E *
    bucket`` where it was dropped, for ``combine``).  Empty slots gather
    token 0 at weight 0."""
    t, k = top_p.shape
    dev = flat_e.device
    # overflow goes to the scratch column ``bucket`` (duplicate writes
    # there only), which is cropped
    e_idx = torch.where(keep, flat_e, e_n - 1)
    c_idx = torch.where(keep, slot, bucket)
    # each token id k times (an expand: no output size to compute on the
    # device, as a repeat_interleave may)
    tok_idx = torch.arange(t, device=dev)[:, None].expand(t, k).reshape(-1)
    token_for_slot = torch.zeros((e_n, bucket + 1), dtype=torch.long,
                                 device=dev)
    token_for_slot[e_idx, c_idx] = tok_idx
    w_slot = torch.zeros((e_n, bucket + 1), dtype=torch.float32, device=dev)
    w_slot[e_idx, c_idx] = top_p.reshape(-1)
    flat_slot = torch.where(keep, flat_e * bucket + slot, e_n * bucket)
    return (token_for_slot[:, :bucket], w_slot[:, :bucket],
            flat_slot.reshape(t, k))


def _route_and_rank(xf: torch.Tensor, router_w: torch.Tensor, cfg,
                    cap: int, *, ranking: str = "sort"):
    """Routing core on a token set ``xf [T, D]``: fp32 router, top-k,
    capacity slot assignment.  Returns ``(token_for_slot [E, C] long,
    w_slot [E, C] fp32, counts [E], dropped, probs_mean [E], z, aux,
    flat_slot [T, k])`` (``_assign``'s maps at ``C = cap``)."""
    m = cfg.moe
    e_n, k = m.num_experts, m.top_k
    logits, top_p, flat_e, slot, counts = _route(xf, router_w, cfg, ranking)
    keep = slot < cap
    # the kept count (exact) times the fp32 reciprocal of T * k, as
    # jnp.mean computes it
    dropped = 1.0 - keep.sum(dtype=torch.float32) * float(
        np.float32(1.0 / keep.numel()))
    token_for_slot, w_slot, flat_slot = _assign(flat_e, slot, top_p, keep,
                                                e_n, cap)
    probs_mean = torch.softmax(logits, dim=-1).mean(0)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    frac = counts.float() / (xf.shape[0] * k)
    aux = e_n * torch.sum(frac * probs_mean)
    return (token_for_slot, w_slot, counts, dropped, probs_mean, z, aux,
            flat_slot)


def expert_counts(flat_e: torch.Tensor, e_n: int) -> torch.Tensor:
    """Assignments per expert, ``[E]`` int64: ``bincount`` with a fixed
    output size, as an exact integer ``scatter_add_`` (``torch.bincount``
    reads its input's maximum on the host to size its output, a device
    sync that a CUDA-graph capture refuses)."""
    counts = torch.zeros(e_n, dtype=torch.long, device=flat_e.device)
    return counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))


def combine(out_e: torch.Tensor, w_slot: torch.Tensor,
            flat_slot: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The weighted scatter-add of the expert outputs ``out_e [E, C, D]``
    back to the tokens, in ``dtype``.  ``flat_slot [T, k]`` is each
    assignment's flat ``[E, C]`` slot (``E * C`` where it was dropped).
    Each token's contributions are added one at a time in ascending slot
    order, the order the reference's (and the CPU's) sequential
    scatter-add over the flat slots takes, so the sum is the same bit for
    bit on every device and every run (``index_add_`` on a card adds
    with atomics, in an order that changes from run to run).  The slots
    no token filled (token 0 at weight 0) add zeros there and are left
    out here."""
    e_n, cap, d = out_e.shape
    contrib = (out_e.to(dtype) * w_slot[..., None].to(dtype)).reshape(-1, d)
    # a zero row for the dropped assignments, which sort last
    contrib = torch.cat([contrib, contrib.new_zeros((1, d))])
    slots = torch.sort(flat_slot, dim=1).values
    y = torch.zeros((flat_slot.shape[0], d), dtype=dtype,
                    device=out_e.device)
    for j in range(slots.shape[1]):
        # a row gather (``embedding``: its backward sums the dropped
        # assignments' duplicates of the zero row as one segment)
        y = y + F.embedding(slots[:, j], contrib)
    return y


def _expert_ffn(cfg, buckets: torch.Tensor, w_gate: torch.Tensor,
                w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """The three batched expert products on ``buckets [E, C, D]`` (gmm on
    a card) -> ``[E, C, D]``."""
    bmm = sparse_api.batched_matmul
    h_g = bmm(buckets, w_gate)
    h_u = bmm(buckets, w_up)
    act = (F.silu(h_g) if cfg.act == "silu"
           else F.gelu(h_g, approximate="tanh"))
    return bmm(act * h_u, w_down)


def _combine_dtype(cfg) -> torch.dtype:
    return (torch.bfloat16 if cfg.moe.combine_dtype == "bfloat16"
            else torch.float32)


def _moe_gspmd(moe: MoE, cfg, x: torch.Tensor):
    """Capacity gather + batched expert GEMMs + weighted scatter-add."""
    m = cfg.moe
    b_, s, d = x.shape
    t = b_ * s
    xf = x.reshape(t, d)
    cap = _capacity(t, cfg)
    token_for_slot, w_slot, _, dropped, _, z, aux, flat_slot = \
        _route_and_rank(xf, moe.router.w, cfg, cap, ranking=m.ranking)

    # a row gather whose backward adds duplicate rows as segments
    # (``embedding``): every empty slot gathers token 0, and an index
    # backward serialises the thousands of duplicates of one row
    buckets = F.embedding(token_for_slot, xf)                     # [E, C, D]
    out_e = _expert_ffn(cfg, buckets, moe.w_gate, moe.w_up, moe.w_down)
    y = combine(out_e, w_slot, flat_slot, _combine_dtype(cfg)).float()
    if moe.shared is not None:
        y = y + moe.shared(xf).float()
    return (y.reshape(b_, s, d).to(x.dtype),
            MoEMetrics(aux, z, dropped))


def _local_experts(moe: MoE, name: str, mesh, e0: int, e_loc: int):
    """This rank's ``[E / ep, ...]`` experts of the stack ``name``: a held
    block with its ``"data"`` shard gathered (``core.tp.gather_held``, as
    every FSDP-held weight), or the slice of a whole stack."""
    w = getattr(moe, name)
    if name not in moe.held:
        return w[e0:e0 + e_loc]
    return gather_held(w, moe.held[name])


def _moe_experts(moe: MoE, cfg, xf: torch.Tensor, mesh, token_for_slot,
                 w_slot, flat_slot, *, split: bool) -> torch.Tensor:
    """The routed experts' output ``[T, D]`` fp32 on this rank's tokens
    ``xf`` from their buckets' maps (``_assign``): with ``split``, this
    rank computes its ``E / ep`` experts of the ``"model"`` axis and one
    all-reduce over it (in ``combine_dtype``) combines the ranks'
    partials; else every expert here."""
    e_n, bucket = token_for_slot.shape
    group = mesh_lib.axes_group(mesh, ("model",)) if split else None
    ep_idx, ep = (mesh_lib.axis_index(mesh, ("model",)) if split
                  else (0, 1))
    e_loc = e_n // ep
    e0 = ep_idx * e_loc
    x_in = xf
    if group is not None:
        # each rank's gradient reaches only its experts' slots and rows:
        # summed over the group, every rank holds the whole of both
        w_slot = copy_to_group(w_slot, group)
        x_in = copy_to_group(xf, group)
    w_g, w_u, w_d = (_local_experts(moe, n, mesh, e0, e_loc)
                     for n in ("w_gate", "w_up", "w_down"))
    buckets = F.embedding(token_for_slot[e0:e0 + e_loc], x_in)
    out_e = _expert_ffn(cfg, buckets, w_g, w_u, w_d)       # [E_loc, C, D]
    # this rank's slots, renumbered from its first expert; the rest go to
    # the zero row
    lo, hi = e0 * bucket, (e0 + e_loc) * bucket
    local = torch.where((flat_slot >= lo) & (flat_slot < hi),
                        flat_slot - lo, e_loc * bucket)
    y = combine(out_e, w_slot[e0:e0 + e_loc], local, _combine_dtype(cfg))
    if group is not None:
        y = reduce_from_group(y, group)                        # THE combine
    return y.float()


def _moe_shard_map(moe: MoE, cfg, x: torch.Tensor, mesh):
    """Explicit local EP dispatch (the reference's ``_moe_shard_map``):

    * tokens: this rank's shard over the batch axes, replicated over
      ``"model"``;
    * expert weights: E over ``"model"`` (the ``"data"`` shard of a held
      block all-gathered locally, reduce-scattered in the backward);
    * each rank routes its local tokens with the capacity of its own
      token count, computes only its E / ep experts, and contributes a
      partial ``[T_loc, D]``;
    * one all-reduce over ``"model"`` (in ``combine_dtype``) combines;
    * the metrics are averaged over the batch axes.
    """
    m = cfg.moe
    b_, s, d = x.shape
    xf = x.reshape(b_ * s, d)
    cap = _capacity(b_ * s, cfg)
    tfs, w_slot, _, dropped, _, z, aux, flat_slot = _route_and_rank(
        xf, moe.router.w, cfg, cap, ranking=m.ranking)
    y = _moe_experts(moe, cfg, xf, mesh, tfs, w_slot, flat_slot, split=True)
    metrics = torch.stack([aux, z, dropped])
    bgroup = mesh_lib.axes_group(mesh, rules.token_axes(mesh))
    if bgroup is not None:
        metrics = sum_over_group(metrics, bgroup) \
            / mesh_lib.group_size(bgroup)
    if moe.shared is not None:
        y = y + moe.shared(xf).float()
    return (y.reshape(b_, s, d).to(x.dtype),
            MoEMetrics(metrics[0], metrics[1], metrics[2]))


def global_route(moe: MoE, cfg, xf: torch.Tensor, mesh):
    """The reference's gspmd routing of the global batch, from this rank's
    tokens ``xf [T, D]`` (its shard over the installed mesh's token axes,
    ``rules.token_axes``; the global batch is the ranks' shards in the
    order of their index over those axes).  Each rank ranks its own
    assignments; one all-reduce of the ``[ranks, E]`` count table gives
    each assignment its global queue position (its local rank plus the
    counts of the ranks before it), kept iff below the capacity of the
    global token count: the reference's kept set, bit for bit.  Returns
    ``(token_for_slot [E, C], w_slot, flat_slot [T, k], logits, counts
    [E] global, cap)``, at buckets of ``C = min(cap, T)`` (no expert keeps
    more of one rank's tokens: a token routes to an expert once)."""
    m = cfg.moe
    e_n = m.num_experts
    t = xf.shape[0]
    axes = rules.token_axes(mesh)
    group = mesh_lib.axes_group(mesh, axes)
    idx, n = mesh_lib.axis_index(mesh, axes)
    cap = _capacity(t * n, cfg)
    logits, top_p, flat_e, slot, counts = _route(xf, moe.router.w, cfg,
                                                 m.ranking)
    if group is None:
        keep = slot < cap
    else:
        import torch.distributed as dist
        table = counts.new_zeros((n, e_n))
        table[idx] = counts
        dist.all_reduce(table, group=group)
        keep = slot + table[:idx].sum(0)[flat_e] < cap
        counts = table.sum(0)
    tfs, w_slot, flat_slot = _assign(flat_e, slot, top_p, keep, e_n,
                                     min(cap, t))
    return tfs, w_slot, flat_slot, logits, counts, cap


def _moe_global(moe: MoE, cfg, x: torch.Tensor, mesh):
    """The gspmd formulation on a concrete mesh, as the reference's
    ``_moe_gspmd`` computes it on the global batch:

    * routing: ``global_route`` (the global capacity and kept set);
    * expert weights: the rules' blocks the module holds (E over
      ``"model"`` where it divides, the ``"data"`` shard gathered); each
      rank computes its experts on its own tokens' buckets, one
      all-reduce over ``"model"`` combines (``_moe_experts``);
    * metrics: ``aux`` from the global counts and router probabilities'
      sums, ``z`` and ``dropped_frac`` global means (the probabilities'
      and logsumexps' sums all-reduced over the token axes by
      ``core.tp.sum_over_group``, so the data-parallel step's averaged
      gradient is the reference's);
    * the shared experts: the module's ``MLP``, split over ``"model"``
      as its rules say.
    """
    m = cfg.moe
    e_n, k = m.num_experts, m.top_k
    b_, s, d = x.shape
    xf = x.reshape(b_ * s, d)
    tfs, w_slot, flat_slot, logits, counts, cap = global_route(
        moe, cfg, xf, mesh)
    split = "w_gate" in moe.held and rules.param_spec(
        "w_gate", moe.held["w_gate"].block.shape, mesh)[0] == "model"
    y = _moe_experts(moe, cfg, xf, mesh, tfs, w_slot, flat_slot,
                     split=split)
    sums = torch.cat([torch.softmax(logits, dim=-1).sum(0),
                      (torch.logsumexp(logits, dim=-1) ** 2).sum()[None]])
    group = mesh_lib.axes_group(mesh, rules.token_axes(mesh))
    if group is not None:
        sums = sum_over_group(sums, group)
    t_g = b_ * s * mesh_lib.axis_index(mesh, rules.token_axes(mesh))[1]
    probs_mean, z = sums[:e_n] / t_g, sums[e_n] / t_g
    aux = e_n * torch.sum(counts.float() / (t_g * k) * probs_mean)
    # the kept count (an expert keeps the first cap of its queue) times
    # the fp32 reciprocal of T * k, as jnp.mean computes it
    dropped = 1.0 - torch.clamp(counts, max=cap).sum().float() * float(
        np.float32(1.0 / (t_g * k)))
    if moe.shared is not None:
        y = y + moe.shared(xf).float()
    return (y.reshape(b_, s, d).to(x.dtype),
            MoEMetrics(aux, z, dropped))


def moe_flops_per_token(cfg) -> float:
    """Active-path FLOPs (the 6·N_active·D numerator's layer share)."""
    m = cfg.moe
    d = cfg.d_model
    f = 2.0 * d * m.d_ff_expert * 3 * m.top_k
    f += 2.0 * d * m.num_experts                 # router
    if m.num_shared:
        f += 2.0 * d * m.num_shared * m.d_ff_shared * 3
    return f
