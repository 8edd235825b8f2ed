"""Tensor-parallel SpMM: the paper's k-partition lifted to several cards.

Counterpart of the JAX package's ``core/tp.py``.  PopSparse Fig. 1a
spreads the non-zero blocks over the tiles of one IPU with uneven,
nnz-balanced k-splits, computes local products and reduces the partial
outputs once.  Across cards the same scheme maps onto the ``model`` axis
of a mesh: each shard owns one k-partition of the blocks
(``partitioner.shard_blocks_by_k``, stacked ``[q, slots, b, b]``),
computes its partial ``Y`` from them, and one sum over the axis gives
the output.

Two formulations, as in the reference, in its ``[K, N]`` layout:

* ``tp_spmm_shard_map``: each rank of a concrete mesh
  (``torch.distributed.device_mesh.DeviceMesh``) computes its own
  shard's partial, then one all-reduce over the group of the mesh's
  ``axis`` (the ``static_tp_shardmap`` plan route);
* ``tp_spmm_gspmd``: every shard's partial on this device, then a sum
  over ``q`` (the ``static_tp`` plan route; the reference leaves the
  reduction to GSPMD, which lowers it to the same all-reduce on a mesh
  and to a local sum without one).

Here the partials are plain PyTorch (a gather, ``einsum`` and
``index_add_``).  The plan routes (``sparse/plan.py``) run each shard's
partial as a bsmm launch through a static plan of that shard instead.

The backward of the explicit route is Megatron's conjugate pair:

* the output is replicated, so each rank's dL/dY is already the whole
  gradient: the output's all-reduce is an all-reduce forward with an
  identity backward (``_ReduceFromGroup``); differentiating the
  all-reduce itself would sum the gradient again, ``q`` times too big;
* ``x`` enters every rank replicated and dL/dx = sum_j W_j^T dY spans
  the shards: the input is an identity forward with an all-reduce
  backward (``_CopyToGroup``);
* dL/dvalues stays on its rank: rank ``j`` holds the gradient of shard
  ``j``'s blocks, zeros elsewhere (the sum over the group is the whole
  gradient).

Every rank joins every collective, a rank whose shard owns no block
included: it contributes zeros.

The same pair carries a model-parallel LM (``models/``): a
column-parallel projection's input through ``copy_to_group``, a
row-parallel one's output through ``reduce_from_group``, and the
vocabulary split over the ``"model"`` axis through ``vocab_embed``,
``vocab_nll`` (the cross-entropy), ``vocab_argmax`` (greedy sampling)
and ``gather_vocab`` (whole logits).  ``sum_over_group`` (a value every
rank's part reads, summed forward and backward), ``gather_dim`` (a
tensor split on one dim, whole) and ``rms_norm_split`` (an RMS norm over
split heads, Mamba-2's gated norm) serve the MoE layers and the mixers;
``gather_held`` gathers a parameter held split over ``"data"`` (FSDP)
where its module uses it, through ``gather_dim``.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.partitioner import ShardedBlocks
from repro_torch.launch.mesh import is_concrete, mesh_axes


def shard_map_executable(mesh, axis: str, q: int) -> bool:
    """Can ``tp_spmm_shard_map`` run on ``mesh``?  It needs a concrete
    ``DeviceMesh`` whose ``axis`` has size ``q``: an abstract mesh, or a
    ``tp_q`` past the mesh's axis, can only run the ``static_tp``
    formulation."""
    if not is_concrete(mesh):
        return False
    names, sizes = mesh_axes(mesh)
    if axis not in names:
        return False
    return sizes[names.index(axis)] == int(q)


def tp_group(mesh, axis: str):
    """``(process group of mesh axis ``axis``, this rank's shard index
    along it)``."""
    return mesh.get_group(axis), int(mesh.get_local_rank(axis))


class _CopyToGroup(torch.autograd.Function):
    """Identity forward, all-reduce of the gradient backward (the input
    of a tensor-parallel product, replicated on every rank)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dx):
        import torch.distributed as dist
        dx = dx.contiguous().clone()
        dist.all_reduce(dx, group=ctx.group)
        return dx, None


class _ReduceFromGroup(torch.autograd.Function):
    """All-reduce forward, identity backward (the output of a
    tensor-parallel product: its gradient is replicated already)."""

    @staticmethod
    def forward(ctx, y, group):
        import torch.distributed as dist
        y = y.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, dy):
        return dy, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """``_CopyToGroup`` over ``group`` (``x`` itself without one: a layer
    held whole)."""
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(y: torch.Tensor, group) -> torch.Tensor:
    """``_ReduceFromGroup`` over ``group`` (``y`` itself without one)."""
    return y if group is None else _ReduceFromGroup.apply(y, group)


# when a dict, ``all_gather_dim`` and ``reduce_scatter_dim`` add each
# call's host ms (after a device synchronise) under "fsdp_gather" and
# "fsdp_reduce_scatter": a measurement aid that adds syncs, off by default
COMM_MS: Optional[Dict[str, List[float]]] = None


@contextlib.contextmanager
def _timed(kind: str, t: torch.Tensor):
    if COMM_MS is None:
        yield
        return
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    yield
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    COMM_MS.setdefault(kind, []).append((time.perf_counter() - t0) * 1e3)


def all_gather_dim(x: torch.Tensor, group, dim: int, idx: int,
                   n: int) -> torch.Tensor:
    """The whole of a tensor split on ``dim`` over ``group`` (``x`` this
    rank's part, at ``idx`` of ``n``; no gradient): one
    ``all_gather_into_tensor`` into a buffer led by the split dim, moved
    back into place.  A card tensor over gloo (``launch.mesh.gathers``)
    is all-reduced instead, zeros beside this rank's part."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import gathers
    with _timed("fsdp_gather", x):
        if not gathers(group, x):
            shape = list(x.shape)
            shape[dim] *= n
            out = x.new_zeros(shape)
            out.narrow(dim, idx * x.shape[dim], x.shape[dim]).copy_(x)
            dist.all_reduce(out, group=group)
            return out
        part = x.movedim(dim, 0).contiguous()
        out = part.new_empty((n * part.shape[0],) + tuple(part.shape[1:]))
        dist.all_gather_into_tensor(out, part, group=group)
        return out if dim == 0 else out.movedim(0, dim).contiguous()


def reduce_scatter_dim(g: torch.Tensor, group, dim: int, idx: int,
                       n: int) -> torch.Tensor:
    """``g`` summed over ``group``, this rank's part on ``dim`` kept (at
    ``idx`` of ``n``): one ``reduce_scatter_tensor`` of ``g`` led by that
    dim.  A card tensor over gloo is all-reduced whole instead, then
    cut."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import gathers
    size = g.shape[dim] // n
    with _timed("fsdp_reduce_scatter", g):
        if not gathers(group, g):
            g = g.contiguous().clone()
            dist.all_reduce(g, group=group)
            return g.narrow(dim, idx * size, size).contiguous()
        whole = g.movedim(dim, 0).contiguous()
        out = whole.new_empty((size,) + tuple(whole.shape[1:]))
        dist.reduce_scatter_tensor(out, whole, group=group)
        return out if dim == 0 else out.movedim(0, dim).contiguous()


class _GatherDim(torch.autograd.Function):
    """The whole of a tensor split on ``dim`` over ``group`` (this rank's
    part at ``idx`` of ``n``): forward an all-gather, backward a
    reduce-scatter (the gradient summed over the group, this rank's part
    kept): ``all_gather_dim`` and ``reduce_scatter_dim``, NCCL's
    collectives, or over gloo for a card tensor an all-reduce each."""

    @staticmethod
    def forward(ctx, x, group, dim, idx, n):
        ctx.group, ctx.dim, ctx.idx, ctx.n = group, dim, idx, n
        return all_gather_dim(x, group, dim, idx, n)

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter_dim(g, ctx.group, ctx.dim, ctx.idx, ctx.n),
                None, None, None, None)


class _SumOverGroup(torch.autograd.Function):
    """The sum over ``group`` of a value each rank computed: forward and
    backward an all-reduce.  The sum enters every rank's loss, so the
    gradient of a rank's part is the sum of every rank's: summed over
    the ranks (the data-parallel step averages it), the gradients are
    those of the sum of the ranks' losses."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def sum_over_group(x: torch.Tensor, group) -> torch.Tensor:
    return _SumOverGroup.apply(x, group)


def gather_dim(x: torch.Tensor, group, dim: int, idx: int,
               n: int) -> torch.Tensor:
    return _GatherDim.apply(x, group, dim, idx, n)


def gather_held(p: torch.Tensor, held) -> torch.Tensor:
    """A parameter as its module uses it: a block held split over
    ``"data"`` (FSDP; ``held.data``, a ``launch.mesh.DataSplit``)
    gathered along that dim, its gradient reduce-scattered back
    (``gather_dim``); anything else ``p`` itself.  Called inside the
    module's forward, so under ``remat="full"`` the gathered weight
    lives no longer than its period's forward and the recompute gathers
    again."""
    data = None if held is None else held.data
    if data is None:
        return p
    return gather_dim(p, data.group, data.dim, data.idx, data.n)


def rms_norm_split(x: torch.Tensor, scale: torch.Tensor, d: int, group, *,
                   eps: float = 1e-6) -> torch.Tensor:
    """``layers.rms_norm`` over a last dim of ``d`` split across ``group``
    (``x`` and ``scale`` this rank's part): each rank's sum of squares
    summed over the group (``sum_over_group``: forward and backward an
    all-reduce, since every rank's part reads the whole sum), fp32,
    returned in ``x``'s dtype."""
    xf = x.float()
    ss = sum_over_group(torch.sum(xf * xf, dim=-1, keepdim=True), group)
    return (xf * torch.rsqrt(ss / d + eps) * scale).to(x.dtype)


# -- model parallelism over a vocabulary split on the "model" axis ------------
#
# A model-parallel LM holds rows [v0, v0 + V / m) of its embedding and
# unembedding tables on rank j of the "model" axis (Megatron's
# vocab-parallel layers).  Every op below is built from all-reduces
# only: gloo reduces card tensors but gathers none.


def vocab_embed(table: torch.Tensor, tokens: torch.Tensor, v0: int,
                group) -> torch.Tensor:
    """The rows of ``tokens`` from a table holding rows ``[v0, v0 +
    len(table))``: the rank's own rows, zeros where another rank holds
    the token, all-reduced (identity backward: each rank's rows take
    their own tokens' gradient)."""
    local = tokens - v0
    mine = (local >= 0) & (local < table.shape[0])
    rows = table[torch.clamp(local, 0, table.shape[0] - 1)]
    rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
    return reduce_from_group(rows, group)


def vocab_nll(logits: torch.Tensor, targets: torch.Tensor, v0: int,
              group) -> torch.Tensor:
    """Per-row ``logsumexp - logit[target]`` in fp32 over a vocabulary
    split across ``group`` (``logits`` the rank's columns ``[v0, v0 +
    V / m)``; a target no rank holds, the ``-1`` padding, has gold 0):
    the max all-reduced (MAX, no gradient), then the sum of exps and
    the target's logit (SUM, identity backward)."""
    import torch.distributed as dist
    logits = logits.float()
    with torch.no_grad():
        top = logits.max(dim=-1).values
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
    z = logits - top[..., None]
    sumexp = reduce_from_group(torch.exp(z).sum(dim=-1), group)
    local = targets - v0
    mine = (local >= 0) & (local < logits.shape[-1])
    gold = torch.gather(z, -1, torch.clamp(
        local, 0, logits.shape[-1] - 1)[..., None])[..., 0]
    gold = reduce_from_group(torch.where(mine, gold, torch.zeros_like(gold)),
                             group)
    return torch.log(sumexp) - gold


def vocab_argmax(logits: torch.Tensor, v0: int, group):
    """``(greedy ids [...], all finite)`` over a vocabulary split across
    ``group``: ties go to the lowest id, as ``torch.argmax`` / the
    reference's ``jnp.argmax`` break them.  Two all-reduces: the max
    (MAX), then the lowest id holding it and the finite flag (MIN; ids
    below 2^24 are exact in fp32)."""
    import torch.distributed as dist
    idx = torch.argmax(logits, dim=-1)
    val = torch.gather(logits, -1, idx[..., None])[..., 0].float()
    top = val.clone()
    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
    cand = torch.where(val == top, (idx + v0).float(),
                       torch.full_like(val, float(2 ** 24)))
    flag = torch.isfinite(logits).all().float().reshape(1)
    buf = torch.cat([cand.reshape(-1), flag])
    dist.all_reduce(buf, op=dist.ReduceOp.MIN, group=group)
    return buf[:-1].long().reshape(idx.shape), buf[-1] > 0


def gather_vocab(logits: torch.Tensor, v0: int, vocab: int,
                 group) -> torch.Tensor:
    """The whole ``[..., vocab]`` logits from each rank's columns (zeros
    beside them, all-reduced; no gradient)."""
    import torch.distributed as dist
    whole = logits.new_zeros((*logits.shape[:-1], vocab))
    whole[..., v0:v0 + logits.shape[-1]] = logits
    dist.all_reduce(whole, group=group)
    return whole


def _local_spmm(values: torch.Tensor, row_idx, col_idx, x: torch.Tensor,
                *, mb: int, b: int) -> torch.Tensor:
    """One shard's partial product: ``[slots, b, b]`` blocks against the
    full ``x [K, N]`` -> ``[M, N]``, in the output dtype."""
    n = x.shape[-1]
    kb = x.shape[0] // b
    dev = values.device
    cols = torch.as_tensor(col_idx, dtype=torch.long, device=dev)
    rows = torch.as_tensor(row_idx, dtype=torch.long, device=dev)
    gathered = x.reshape(kb, b, n)[cols]
    partial = torch.einsum("zab,zbn->zan", values, gathered)
    y = partial.new_zeros((mb, b, n)).index_add(0, rows, partial)
    return y.reshape(mb * b, n)


def tp_spmm_shard_map(sb: ShardedBlocks, x: torch.Tensor, *, mesh,
                      axis: str = "model") -> torch.Tensor:
    """The explicit formulation on this rank: shard ``r``'s partial (``r``
    this rank's index along ``axis``), all-reduced over the axis's
    group.  ``sb.q`` must equal the axis size (a mismatched shard plan
    would shard silently wrong)."""
    if not shard_map_executable(mesh, axis, sb.q):
        names, sizes = mesh_axes(mesh) if mesh is not None else ((), ())
        raise ValueError(
            f"tp_spmm_shard_map needs a concrete mesh with axis "
            f"{axis!r} of size q={sb.q}; got mesh axes {names} "
            f"{dict(zip(names, sizes))}")
    group, r = tp_group(mesh, axis)
    b = sb.block_size
    mb = sb.shape[0] // b
    y = _local_spmm(sb.values[r], sb.row_idx[r], sb.col_idx[r],
                    copy_to_group(x, group), mb=mb, b=b)
    return reduce_from_group(y, group)


def tp_spmm_gspmd(sb: ShardedBlocks, x: torch.Tensor, *,
                  axis: str = "model") -> torch.Tensor:
    """Every shard's partial on this device, summed over ``q`` in the
    output dtype (``axis`` names the mesh axis the sum runs over on the
    reference's mesh; here it is a local sum)."""
    b = sb.block_size
    q = sb.q
    mb = sb.shape[0] // b
    n = x.shape[-1]
    kb = x.shape[0] // b
    dev = sb.values.device
    cols = torch.as_tensor(sb.col_idx.reshape(-1), dtype=torch.long,
                           device=dev)
    gathered = x.reshape(kb, b, n)[cols].reshape(q, sb.slots, b, n)
    partial = torch.einsum("qzab,qzbn->qzan", sb.values, gathered)
    flat_rows = torch.as_tensor(
        sb.row_idx + (np.arange(q) * mb)[:, None],
        dtype=torch.long, device=dev).reshape(-1)
    y = partial.new_zeros((q * mb, b, n)).index_add(
        0, flat_rows, partial.reshape(q * sb.slots, b, n))
    return y.reshape(q, mb, b, n).sum(dim=0).reshape(mb * b, n)
