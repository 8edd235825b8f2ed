"""GQA attention with RoPE: full-sequence (prefill) and one-token decode.

Counterparts of the JAX package's ``models/attention.py`` GQA module
(``gqa_init``, ``_project_qkv``, ``gqa_prefill``, ``gqa_decode``,
``gqa_cache_init``, ``attend_decode``, and ``attend_train`` with no
window).  Attention is no kernel in the JAX package either: plain torch
ops with fp32 logits and a masked softmax.  The q/k/v/o projections go
through ``sparse.matmul`` (the dense_mm kernel on a card).

KV caches are ``{"k", "v"}`` of ``[B, S, KV, dh]`` per layer, RoPE
applied before caching; ``GQA.decode`` updates them in place.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.models.layers import Dense, RMSNorm, apply_rope, rope_freqs

NEG_INF = -1e30

Cache = Dict[str, torch.Tensor]


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """``[B, S, KV, dh] -> [B, S, KV * n_rep, dh]`` (head ``h`` reads kv
    head ``h // n_rep``)."""
    if n_rep == 1:
        return x
    return x.repeat_interleave(n_rep, dim=2)


def attend_causal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  scale: Optional[float] = None,
                  softcap: Optional[float] = None) -> torch.Tensor:
    """Full-sequence attention, q ``[B, S, H, dh]``, k/v
    ``[B, S, KV, dh]`` -> ``[B, S, H, dh]``.  fp32 logits and softmax;
    the probabilities are cast to v's dtype before the value product,
    as in the JAX tile walk."""
    b_, s, h, dh = q.shape
    scale = scale if scale is not None else 1.0 / np.sqrt(dh)
    k = repeat_kv(k, h // k.shape[2])
    v = repeat_kv(v, h // v.shape[2])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    keep = torch.ones((s, k.shape[1]), dtype=torch.bool,
                      device=q.device).tril()
    logits = logits.masked_fill(~keep, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def attend_decode(q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, *, lengths: torch.Tensor,
                  softcap: Optional[float] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q ``[B, 1, H, dh]`` against caches ``[B, S, KV, dh]``; ``lengths``
    ``[B]`` valid prefix per row.  fp32 logits and values."""
    b_, _, h, dh = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    g = h // kv
    scale = scale if scale is not None else 1.0 / np.sqrt(dh)
    qg = q.reshape(b_, kv, g, dh)
    logits = torch.einsum("bkgd,bskd->bkgs", qg.float(),
                          k_cache.float()) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    pos = torch.arange(s, device=q.device)[None, None, None, :]
    mask = pos < lengths[:, None, None, None]
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", w, v_cache.float())
    return out.reshape(b_, 1, h, dh).to(q.dtype)


def gqa_cache_init(cfg, batch: int, max_len: int, *,
                   dtype: torch.dtype, device) -> Cache:
    kv, dh = cfg.num_kv_heads, cfg.head_dim
    return {"k": torch.zeros((batch, max_len, kv, dh), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, max_len, kv, dh), dtype=dtype,
                             device=device)}


class GQA(nn.Module):
    """Grouped-query attention (``gqa_init``): ``wq``/``wk``/``wv``/``wo``
    dense projections, optional per-head q/k RMS norms."""

    def __init__(self, cfg, *, dtype: torch.dtype, device=None):
        super().__init__()
        d = cfg.d_model
        qd, kvd = cfg.attn_dims
        self.cfg = cfg
        self.wq = Dense(d, qd, bias=cfg.qkv_bias, dtype=dtype, device=device)
        self.wk = Dense(d, kvd, bias=cfg.qkv_bias, dtype=dtype, device=device)
        self.wv = Dense(d, kvd, bias=cfg.qkv_bias, dtype=dtype, device=device)
        self.wo = Dense(qd, d, dtype=dtype, device=device)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(cfg.head_dim, device=device)
            self.k_norm = RMSNorm(cfg.head_dim, device=device)
        else:
            self.q_norm = self.k_norm = None
        self.register_buffer(
            "rope_freqs", torch.as_tensor(
                rope_freqs(cfg.head_dim, cfg.rope_theta),
                dtype=torch.float32, device=device), persistent=False)

    @property
    def scale(self) -> float:
        return self.cfg.attn_scale or 1.0 / np.sqrt(self.cfg.head_dim)

    def project_qkv(self, x: torch.Tensor, positions: torch.Tensor):
        """``_project_qkv``: projected, normed and roped q, k, v."""
        cfg = self.cfg
        b_, s, _ = x.shape
        h, kv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q = self.wq(x).reshape(b_, s, h, dh)
        k = self.wk(x).reshape(b_, s, kv, dh)
        v = self.wv(x).reshape(b_, s, kv, dh)
        if self.q_norm is not None:
            q = self.q_norm(q)
            k = self.k_norm(k)
        if cfg.use_rope:
            q = apply_rope(q, positions, freqs=self.rope_freqs)
            k = apply_rope(k, positions, freqs=self.rope_freqs)
        return q, k, v

    def forward(self, x: torch.Tensor, positions: torch.Tensor
                ) -> torch.Tensor:
        """Full-sequence causal GQA (``gqa_train`` with no window)."""
        q, k, v = self.project_qkv(x, positions)
        out = attend_causal(q, k, v, scale=self.scale,
                            softcap=self.cfg.attn_softcap)
        b_, s = x.shape[:2]
        return self.wo(out.reshape(b_, s, -1))

    def prefill(self, x: torch.Tensor, positions: torch.Tensor, *,
                max_len: int):
        """``gqa_prefill``: causal forward plus the roped K/V cache padded
        to ``max_len``."""
        q, k, v = self.project_qkv(x, positions)
        out = attend_causal(q, k, v, scale=self.scale,
                            softcap=self.cfg.attn_softcap)
        b_, s = x.shape[:2]
        y = self.wo(out.reshape(b_, s, -1))
        pad = (0, 0, 0, 0, 0, max_len - s)
        cache = {"k": torch.nn.functional.pad(k, pad).to(x.dtype),
                 "v": torch.nn.functional.pad(v, pad).to(x.dtype)}
        return y, cache

    def decode(self, x: torch.Tensor, cache: Cache,
               positions: torch.Tensor):
        """``gqa_decode``: one token per row at ``positions`` ``[B]``; the
        new K/V are written into ``cache`` in place."""
        q, k_new, v_new = self.project_qkv(x, positions[:, None])
        bidx = torch.arange(x.shape[0], device=x.device)
        cache["k"][bidx, positions] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][bidx, positions] = v_new[:, 0].to(cache["v"].dtype)
        lengths = torch.clamp(positions + 1, max=cache["k"].shape[1])
        out = attend_decode(q, cache["k"], cache["v"], lengths=lengths,
                            softcap=self.cfg.attn_softcap, scale=self.scale)
        y = self.wo(out.reshape(x.shape[0], 1, -1))
        return y, cache
