"""Plain PyTorch grouped GEMM: one batched product over the gathered
expert weights.

Counterpart of the JAX package's ``kernels/gmm/ref.py`` ``gmm_ref`` and
the plain version of ``csrc/gmm.cu``, which the wrapper runs for CPU
tensors.  fp32 products, cast to x's dtype.  A row tile whose expert id
lies outside ``[0, E)`` gives zero rows, as the kernel does (the JAX
oracle's ``jnp.take`` leaves such ids to its fill mode).
"""
from __future__ import annotations

import torch


def gmm_ref(x: torch.Tensor, w: torch.Tensor, expert_ids: torch.Tensor, *,
            tm: int) -> torch.Tensor:
    """``out[t] = x[t] @ w[expert_ids[t // tm]]``: x ``[T, D]``, w ``[E, D,
    F]``, expert_ids ``[T // tm]`` -> ``[T, F]``."""
    t_rows, d = x.shape
    e, _, f = w.shape
    ids = expert_ids.long()
    valid = (ids >= 0) & (ids < e)
    wg = w[ids.clamp(0, max(e - 1, 0))].float()            # [T/tm, D, F]
    out = torch.bmm(x.float().reshape(t_rows // tm, tm, d), wg)
    out = torch.where(valid[:, None, None], out, 0.0)
    return out.reshape(t_rows, f).to(x.dtype)
