"""Plain PyTorch block-sparse attention: a dense softmax over the element
mask.

Counterpart of the JAX package's ``kernels/bs_attn/ref.py``
``bs_attn_ref`` (and the plain version of ``csrc/bs_attn.cu``, which the
wrapper runs for CPU tensors).  Logits, the row max and the row sum are
fp32; masked logits are the finite ``-1e30``; the unnormalised
probabilities are rounded to v's dtype before the value product and the
sum divided out after it, at the point where the tile walk rounds them.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

NEG_INF = -1e30


def element_mask(block_mask, bq: int, bkv: int, *, causal: bool,
                 window: int = 0, global_prefix: int = 0,
                 device=None) -> torch.Tensor:
    """``[Sq, Skv]`` bool: the block mask expanded to elements, with the
    causal ``r >= c`` and the window ``(r - c < window) | (c <
    global_prefix)`` of the JAX tile walk applied on top."""
    bm = torch.as_tensor(np.array(block_mask, bool), device=device)
    el = bm.repeat_interleave(bq, 0).repeat_interleave(bkv, 1)
    ri = torch.arange(el.shape[0], device=el.device)[:, None]
    ci = torch.arange(el.shape[1], device=el.device)[None, :]
    if causal:
        el = el & (ri >= ci)
    if window > 0:
        el = el & ((ri - ci < window) | (ci < global_prefix))
    return el


def attend_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 el_mask: torch.Tensor, *, scale: float,
                 softcap: Optional[float] = None) -> torch.Tensor:
    """q ``[B, Sq, H, dh]``, k/v ``[B, Skv, KV, dh]`` (kv head ``h //
    (H // KV)``), ``el_mask`` ``[Sq, Skv]`` -> ``[B, Sq, H, dh]``."""
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    logits = logits.masked_fill(~el_mask, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    denom = torch.clamp(p.sum(dim=-1), min=1e-30)            # [B, H, Sq]
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return (out / denom.transpose(1, 2)[..., None]).to(q.dtype)


def bs_attn_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                block_mask, *, bq: int = 128, bkv: int = 128,
                scale: Optional[float] = None, causal: bool = True,
                softcap: Optional[float] = None) -> torch.Tensor:
    """``bs_attn_ref`` of the JAX package: q ``[H, Sq, dh]``, k/v
    ``[H, Skv, dh]``, ``block_mask`` ``[Sq / bq, Skv / bkv]``."""
    dh = q.shape[-1]
    scale = scale if scale is not None else 1.0 / np.sqrt(dh)
    el = element_mask(block_mask, bq, bkv, causal=causal, device=q.device)
    out = attend_plain(q.transpose(0, 1)[None], k.transpose(0, 1)[None],
                       v.transpose(0, 1)[None], el, scale=float(scale),
                       softcap=softcap)
    return out[0].transpose(0, 1)
