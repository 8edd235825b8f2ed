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
per product for all experts), ``torch.matmul`` on the CPU.

``impl="shard_map"`` needs a device mesh; the port has none yet, so
every call takes the gspmd formulation, as the reference does without a
mesh.  The module holds its parameters under the reference's names
(``router.w``, ``w_gate``, ``w_up``, ``w_down``, ``shared.*``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import sparse as sparse_api
from repro_torch.models.layers import MLP


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
                 device=None):
        super().__init__()
        m = cfg.moe
        d = cfg.d_model
        self.cfg = cfg
        self.router = _Router(d, m.num_experts, device=device)

        def param(shape):
            return nn.Parameter(torch.zeros(shape, dtype=dtype,
                                            device=device),
                                requires_grad=False)

        self.w_gate = param((m.num_experts, d, m.d_ff_expert))
        self.w_up = param((m.num_experts, d, m.d_ff_expert))
        self.w_down = param((m.num_experts, m.d_ff_expert, d))
        self.shared = (MLP(d, m.num_shared * m.d_ff_shared, act=cfg.act,
                           dtype=dtype, device=device)
                       if m.num_shared else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's scales: N(0, 1/d) router and gate/up, N(0,
        1/d_ff_expert) down, drawn on the parameters' device (the shared
        MLP fills its own).  One expert at a time, so the fp32 draw
        never holds a whole stack."""
        d = self.cfg.d_model
        with torch.no_grad():
            for p, scale in ((self.router.w, 1.0 / np.sqrt(d)),
                             (self.w_gate, 1.0 / np.sqrt(d)),
                             (self.w_up, 1.0 / np.sqrt(d)),
                             (self.w_down,
                              1.0 / np.sqrt(self.cfg.moe.d_ff_expert))):
                rows = p.unsqueeze(0) if p.dim() == 2 else p
                for sl in rows:
                    sl.copy_(torch.randn(sl.shape, generator=generator,
                                         device=sl.device) * scale)

    def forward(self, x: torch.Tensor):
        return moe_apply(self, self.cfg, x)


def moe_init(cfg, *, dtype: torch.dtype = torch.bfloat16, device=None,
             seed: int = 0) -> MoE:
    """An ``MoE`` on ``device`` filled from a seeded ``torch.Generator``
    on that device (the JAX key's numbers are not reproduced; tests carry
    JAX weights over with ``LM.load_jax_params``)."""
    mod = MoE(cfg, dtype=dtype, device=device)
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


def moe_apply(moe: MoE, cfg, x: torch.Tensor):
    """x ``[B, S, D]`` -> ``(y, MoEMetrics)``.  Capacity-bounded top-k
    routing through the gspmd formulation (the port has no mesh for
    ``impl="shard_map"``).  The routing drop is folded into the
    ``"moe_dispatch"`` capacity stream (``sparse.record_dropped``: kept on
    the card until ``capacity_report()``, so no layer waits for it)."""
    y, metrics = _moe_gspmd(moe, cfg, x)
    sparse_api.record_dropped("moe_dispatch", metrics.dropped_frac)
    return y, metrics


def _route_and_rank(xf: torch.Tensor, router_w: torch.Tensor, cfg,
                    cap: int, *, ranking: str = "sort"):
    """Routing core on a token set ``xf [T, D]``: fp32 router, top-k,
    capacity slot assignment.  Returns ``(token_for_slot [E, C] long,
    w_slot [E, C] fp32, counts [E], dropped, probs_mean [E], z, aux,
    flat_slot [T, k])``, the last each assignment's flat ``[E, C]`` slot
    (``E * C`` where it was dropped, for ``combine``);
    ``ranking`` "sort" (the reference's ``_route_and_rank``) or "cumsum"
    (its gspmd default) assign the same slots."""
    m = cfg.moe
    e_n, k = m.num_experts, m.top_k
    t = xf.shape[0]
    dev = xf.device
    logits = torch.matmul(xf.float(), router_w)                   # [T, E]
    if m.router_score == "sigmoid":
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(scores, k, dim=-1)                  # [T, k]
    if m.norm_topk_prob:
        top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # position within each expert's queue over the flattened (T * k)
    # assignment priority order
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
    keep = slot < cap
    # the kept count (exact) times the fp32 reciprocal of T * k, as
    # jnp.mean computes it
    dropped = 1.0 - keep.sum(dtype=torch.float32) * float(
        np.float32(1.0 / keep.numel()))

    # index map + combine weights: overflow goes to the scratch column
    # cap (duplicate writes there only), which is cropped
    e_idx = torch.where(keep, flat_e, e_n - 1)
    c_idx = torch.where(keep, slot, cap)
    # each token id k times (an expand: no output size to compute on the
    # device, as a repeat_interleave may)
    tok_idx = torch.arange(t, device=dev)[:, None].expand(t, k).reshape(-1)
    token_for_slot = torch.zeros((e_n, cap + 1), dtype=torch.long,
                                 device=dev)
    token_for_slot[e_idx, c_idx] = tok_idx
    w_slot = torch.zeros((e_n, cap + 1), dtype=torch.float32, device=dev)
    w_slot[e_idx, c_idx] = top_p.reshape(-1)

    probs_mean = torch.softmax(logits, dim=-1).mean(0)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    frac = counts.float() / (t * k)
    aux = e_n * torch.sum(frac * probs_mean)
    flat_slot = torch.where(keep, flat_e * cap + slot, e_n * cap)
    return (token_for_slot[:, :cap], w_slot[:, :cap], counts, dropped,
            probs_mean, z, aux, flat_slot.reshape(t, k))


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
        y = y + contrib[slots[:, j]]
    return y


def _moe_gspmd(moe: MoE, cfg, x: torch.Tensor):
    """Capacity gather + batched expert GEMMs + weighted scatter-add."""
    bmm = sparse_api.batched_matmul
    m = cfg.moe
    b_, s, d = x.shape
    t = b_ * s
    xf = x.reshape(t, d)
    cap = _capacity(t, cfg)
    token_for_slot, w_slot, _, dropped, _, z, aux, flat_slot = \
        _route_and_rank(xf, moe.router.w, cfg, cap, ranking=m.ranking)

    buckets = xf[token_for_slot]                                  # [E, C, D]
    h_g = bmm(buckets, moe.w_gate)
    h_u = bmm(buckets, moe.w_up)
    act = (F.silu(h_g) if cfg.act == "silu"
           else F.gelu(h_g, approximate="tanh"))
    out_e = bmm(act * h_u, moe.w_down)                           # [E, C, D]

    cdt = torch.bfloat16 if m.combine_dtype == "bfloat16" else torch.float32
    y = combine(out_e, w_slot, flat_slot, cdt).float()
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
