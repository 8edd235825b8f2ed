"""Block pruning and RigL topology updates.

Counterpart of the JAX package's ``core/pruning.py``: one-shot magnitude
block pruning (a static pattern for ``SparseLinear``), the RigL block
drop/regrow step (Evci et al. 2019, at block granularity) that drives
both a static plan's ``evolve`` and ``DynamicSparseLinear``'s mask, the
mask applied to a dense master weight, and the cubic density schedule
(Zhu & Gupta 2017).

``rigl_update`` runs on the tensors' device with no host read: the move
count stays a device scalar, so a captured train step can hold it.  Its
arithmetic is the reference's: the move count truncated in float32 and
clamped to the movable pool, a stable sort for the drop order (blocks
grown at the last step start at zero and tie; the lower index drops
first, as ``jnp.argsort`` orders them), and grow ties broken by a random
permutation from an explicit ``torch.Generator`` sorted stably (the
reference's ``rng``; the permutations of the two packages differ, so
their masks agree where grow scores do not tie).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import masks as masks_lib


def magnitude_block_prune(dense_w: np.ndarray, block_size: int,
                          density: float) -> np.ndarray:
    """One-shot static pattern: keep top-``density`` blocks by L1 norm."""
    return masks_lib.magnitude_block_mask(np.asarray(dense_w), block_size,
                                          density)


def _block_scores(x: torch.Tensor, b: int) -> torch.Tensor:
    m, k = x.shape
    return x.abs().reshape(m // b, b, k // b, b).sum(dim=(1, 3))


def _ranks(order: torch.Tensor) -> torch.Tensor:
    """The inverse permutation of ``order``: the rank of each index."""
    ranks = torch.empty_like(order)
    ranks[order] = torch.arange(order.numel(), device=order.device)
    return ranks


def rigl_update(w: torch.Tensor, grad: torch.Tensor, mask: torch.Tensor, *,
                block_size: int, fraction: float,
                generator: torch.Generator) -> torch.Tensor:
    """One RigL block topology update, on ``mask``'s device.

    Drops the ``fraction`` lowest-|W| active blocks and regrows as many
    inactive blocks with the largest |grad|, so the active count (and a
    dynamic layer's ``d_max`` capacity) is preserved.  ``w`` and ``grad``
    are dense ``[m, k]``, ``mask`` the ``[m / b, k / b]`` block mask;
    returns the new bool mask.  ``generator`` (on the mask's device, or
    the CPU) breaks ties among equal grow scores: early in training many
    inactive blocks have exactly zero gradient, and a plain sort would
    regrow the lowest block indices every step."""
    b = block_size
    dev = mask.device
    w_score = _block_scores(w, b).reshape(-1)
    g_score = _block_scores(grad, b).reshape(-1)
    active = mask.to(torch.bool).reshape(-1)
    total = active.numel()
    n_active = active.sum(dtype=torch.int32)
    n_inactive = total - n_active
    # clamp to the movable pool: near density 1 (or fraction 1) there are
    # fewer inactive blocks than drop candidates, and an unclamped count
    # would drop more than it grows
    n_move = (n_active.to(torch.float32) * fraction).to(torch.int32)
    n_move = torch.minimum(n_move.clamp_min(0),
                           torch.minimum(n_active, n_inactive))
    drop_key = torch.where(active, w_score, w_score.new_full((), np.inf))
    drop_rank = _ranks(torch.argsort(drop_key, stable=True))
    dropped = active & (drop_rank < n_move)
    grow_key = torch.where(~active, g_score, g_score.new_full((), -np.inf))
    shuffle = torch.randperm(total, generator=generator,
                             device=generator.device).to(dev)
    grow_order = shuffle[torch.argsort(-grow_key[shuffle], stable=True)]
    grown = ~active & (_ranks(grow_order) < n_move)
    return ((active & ~dropped) | grown).reshape(mask.shape)


def apply_block_mask(w: torch.Tensor, mask: torch.Tensor,
                     block_size: int) -> torch.Tensor:
    """Zero the masked-away blocks of a dense master weight."""
    b = block_size
    mk = mask.to(w.dtype).repeat_interleave(b, 0).repeat_interleave(b, 1)
    return w * mk


def density_schedule(step: int, *, start_step: int, end_step: int,
                     initial: float, final: float) -> float:
    """Cubic density decay (Zhu & Gupta 2017) for gradual block
    pruning."""
    if step <= start_step:
        return initial
    if step >= end_step:
        return final
    t = (step - start_step) / max(1, end_step - start_step)
    return final + (initial - final) * (1 - t) ** 3
