"""GQA attention with RoPE, soft-cap and local windows: full-sequence
(training, prefill) and one-token decode.

Counterparts of the JAX package's ``models/attention.py`` GQA module
(``gqa_init``, ``_project_qkv``, ``gqa_train``, ``gqa_prefill``,
``gqa_decode``, ``gqa_cache_init``, ``attend_train``, ``attend_decode``).
``causal_block_mask`` is the tile mask the reference's static schedule
(``_causal_schedule``) visits, equal to it bit for bit; the reference's
rectangular scan schedules over that mask have no counterpart here,
since the kernel walks a CSR of the mask's pairs instead.

``attend_train`` folds the causal mask, the local window and the global
prefix into a static block mask over ``(q_tile, kv_tile)`` tiles -- the
paper's static block sparsity applied to the score matrix -- exactly as
the reference builds it (tile halving, ``wt`` window tiles, ``gt``
global tiles), and runs the block-sparse flash attention kernel
(``kernels/bs_attn``) over its pairs, with the reference walk's element
mask on top.  The kernel walks each q row-tile's pairs in parallel, so
the reference's ``"balanced"`` (folded-pair) schedule, which reorders a
serial scan without changing a row's pairs, selects the same pairs
here.  The backward is plain PyTorch that recomputes the probabilities
from the saved q, k and v (the reference differentiates its XLA walk;
there is no attention backward kernel).  Decode attention is plain
torch with fp32 logits, as in the reference.  The q/k/v/o projections
go through ``sparse.matmul`` (the dense_mm kernel on a card).

KV caches are ``{"k", "v"}`` of ``[B, S, KV, dh]`` per layer, RoPE
applied before caching; ``GQA.decode`` updates them in place.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.core import capture
from repro_torch.core import masks as masks_lib
from repro_torch.kernels.bs_attn import ops as bs_ops
from repro_torch.kernels.bs_attn.ref import attend_plain, element_mask
from repro_torch.models.layers import Dense, RMSNorm, apply_rope, rope_freqs

NEG_INF = -1e30

Cache = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Static block mask (host, numpy): the tiles the reference's schedule visits
# ---------------------------------------------------------------------------

# a few sequence lengths at a time (an engine's buckets); an odd exact
# length tiles to 1 and its [S, S] tile mask is S^2 bytes
@functools.lru_cache(maxsize=8)
def causal_block_mask(nq: int, nkv: int, window_tiles: int,
                      global_tiles: int, tile_q: int, tile_kv: int,
                      causal: bool = True) -> np.ndarray:
    """The ``[nq, nkv]`` tile mask ``_causal_schedule`` schedules: all
    tiles, the local+global band, or every tile with a key at or before
    the tile's last query.  Read-only (cached)."""
    if not causal:
        mask = np.ones((nq, nkv), bool)
    elif window_tiles > 0:
        mask = masks_lib.local_global_attention_mask(
            nq, nkv, window_blocks=window_tiles, global_blocks=global_tiles,
            causal=True)
    else:
        i = np.arange(nq)[:, None]
        j = np.arange(nkv)[None, :]
        mask = (j * tile_kv) <= ((i + 1) * tile_q - 1)
    mask.setflags(write=False)
    return mask


# ---------------------------------------------------------------------------
# Full-sequence attention over the block mask
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnSpec:
    """One ``attend_train`` problem: its tiling, block mask and element
    mask parameters."""

    nq: int
    nkv: int
    tile_q: int
    tile_kv: int
    window_tiles: int
    global_tiles: int
    causal: bool
    window: int
    global_prefix: int
    scale: float
    softcap: Optional[float]

    def block_mask(self) -> np.ndarray:
        return causal_block_mask(self.nq, self.nkv, self.window_tiles,
                                 self.global_tiles, self.tile_q,
                                 self.tile_kv, self.causal)

    def walk(self, device: torch.device) -> bs_ops.Walk:
        """The kernel's walk on ``device`` (cached).  A capture in
        progress keeps it alive: the cache may evict it while the
        captured graph still reads its tensors."""
        walk = _device_walk(self.nq, self.nkv, self.window_tiles,
                            self.global_tiles, self.tile_q, self.tile_kv,
                            self.causal, self.window, self.global_prefix,
                            str(device))
        capture.hold(walk)
        return walk

    def element_mask(self, device) -> torch.Tensor:
        """The ``[S, Skv]`` bool element mask, built once per device
        (cached; read-only)."""
        return _device_element_mask(self.nq, self.nkv, self.window_tiles,
                                    self.global_tiles, self.tile_q,
                                    self.tile_kv, self.causal, self.window,
                                    self.global_prefix, str(device))


@functools.lru_cache(maxsize=8)
def _device_walk(nq, nkv, wt, gt, tq, tkv, causal, window, global_prefix,
                 device: str) -> bs_ops.Walk:
    """The kernel's walk metadata for one block mask, uploaded once per
    device."""
    return bs_ops.make_walk(causal_block_mask(nq, nkv, wt, gt, tq, tkv,
                                              causal), tq, tkv,
                            torch.device(device), causal=causal,
                            window=window, global_prefix=global_prefix)


@functools.lru_cache(maxsize=4)
def _device_element_mask(nq, nkv, wt, gt, tq, tkv, causal, window,
                         global_prefix, device: str) -> torch.Tensor:
    return element_mask(causal_block_mask(nq, nkv, wt, gt, tq, tkv, causal),
                        tq, tkv, causal=causal, window=window,
                        global_prefix=global_prefix,
                        device=torch.device(device))


def _attend_forward(q, k, v, spec: AttnSpec) -> torch.Tensor:
    """The kernel for CUDA tensors, its plain version for CPU tensors."""
    if q.device.type == "cuda":
        return bs_ops.bs_attn_cuda(
            q, k, v, spec.walk(q.device), scale=spec.scale,
            causal=spec.causal, softcap=spec.softcap, window=spec.window,
            global_prefix=spec.global_prefix)
    if q.device.type != "cpu":
        raise ValueError(f"attend_train: unsupported device {q.device}")
    return attend_plain(q, k, v, spec.element_mask(q.device),
                        scale=spec.scale, softcap=spec.softcap)


class _BsAttnFn(torch.autograd.Function):
    """bs_attn forward; plain backward that recomputes the probabilities
    from the saved q, k, v."""

    @staticmethod
    def forward(ctx, q, k, v, spec):
        ctx.spec = spec
        ctx.save_for_backward(q, k, v)
        return _attend_forward(q, k, v, spec)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        spec = ctx.spec
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = attend_plain(*leaves, spec.element_mask(q.device),
                               scale=spec.scale, softcap=spec.softcap)
            grads = torch.autograd.grad(out, leaves, dout)
        return (*grads, None)


def attn_spec(s: int, skv: int, dh: int, *, causal: bool = True,
              window: int = 0, global_prefix: int = 0,
              softcap: Optional[float] = None,
              scale: Optional[float] = None, tile_q: int = 512,
              tile_kv: int = 512) -> AttnSpec:
    """``attend_train``'s problem for ``s`` queries and ``skv`` keys:
    tiles halved until they divide the sequences (down to 1), ``wt``
    window tiles and ``gt`` global tiles as the reference counts them."""
    scale = scale if scale is not None else 1.0 / np.sqrt(dh)
    tile_q = min(tile_q, s)
    tile_kv = min(tile_kv, skv)
    while s % tile_q:
        tile_q //= 2
    while skv % tile_kv:
        tile_kv //= 2
    # a query's window can straddle one extra back tile (the reference's
    # rule, kept: the schedule must equal the reference's)
    wt = (window - 1) // tile_kv + 2 if window > 0 else 0
    gt = -(-global_prefix // tile_kv) if global_prefix > 0 else 0
    return AttnSpec(s // tile_q, skv // tile_kv, tile_q, tile_kv, wt, gt,
                    bool(causal), int(window), int(global_prefix),
                    float(scale), softcap)


def attend_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool = True, window: int = 0,
                 global_prefix: int = 0, softcap: Optional[float] = None,
                 scale: Optional[float] = None, tile_q: int = 512,
                 tile_kv: int = 512, schedule: str = "row") -> torch.Tensor:
    """Full-sequence attention.  q ``[B, S, H, dh]``, k/v ``[B, Skv, KV,
    dh]`` -> ``[B, S, H, dh]``.

    ``window > 0`` restricts to a local causal window (plus
    ``global_prefix`` always-visible leading tokens); both are folded
    into the static block mask, so out-of-window tiles are never
    visited.  ``schedule`` ("row" or "balanced") is the reference's
    choice of serial scan order; both visit the same pairs, and the
    kernel walks every q row-tile at once, so it selects nothing here
    (it is checked and kept for the reference's signature)."""
    if schedule not in ("row", "balanced"):
        raise ValueError(f"attend_train: schedule must be 'row' or "
                         f"'balanced', not {schedule!r}")
    spec = attn_spec(q.shape[1], k.shape[1], q.shape[3], causal=causal,
                     window=window, global_prefix=global_prefix,
                     softcap=softcap, scale=scale, tile_q=tile_q,
                     tile_kv=tile_kv)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _BsAttnFn.apply(q, k, v, spec)
    return _attend_forward(q, k, v, spec)


# ---------------------------------------------------------------------------
# Decode: one new token against a cache (plain torch, as in the reference)
# ---------------------------------------------------------------------------

def attend_decode(q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, *, lengths: torch.Tensor,
                  softcap: Optional[float] = None,
                  scale: Optional[float] = None, window: int = 0,
                  global_prefix: int = 0) -> torch.Tensor:
    """q ``[B, 1, H, dh]`` against caches ``[B, S, KV, dh]``; ``lengths``
    ``[B]`` valid prefix per row; ``window > 0`` keeps the last
    ``window`` positions plus the first ``global_prefix``.  fp32 logits
    and values."""
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
    if window > 0:
        lo = lengths[:, None, None, None] - window
        mask = mask & ((pos >= lo) | (pos < global_prefix))
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
    dense projections, optional per-head q/k RMS norms.  ``local=True``
    (an ``attn_local`` layer) applies ``cfg.local_window`` and
    ``cfg.global_prefix``."""

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

    def _window(self, local: bool):
        """``(window, global_prefix)`` of a layer."""
        if not local:
            return 0, 0
        return self.cfg.local_window, self.cfg.global_prefix

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

    def _attend(self, q, k, v, local: bool) -> torch.Tensor:
        window, prefix = self._window(local)
        cfg = self.cfg
        return attend_train(q, k, v, causal=True, window=window,
                            global_prefix=prefix, softcap=cfg.attn_softcap,
                            scale=self.scale, tile_q=cfg.attn_tile_q,
                            tile_kv=cfg.attn_tile_kv,
                            schedule=cfg.attn_schedule)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *,
                local: bool = False) -> torch.Tensor:
        """``gqa_train``: full-sequence causal GQA."""
        q, k, v = self.project_qkv(x, positions)
        out = self._attend(q, k, v, local)
        b_, s = x.shape[:2]
        return self.wo(out.reshape(b_, s, -1))

    def prefill(self, x: torch.Tensor, positions: torch.Tensor, *,
                max_len: int, local: bool = False):
        """``gqa_prefill``: causal forward plus the roped K/V cache padded
        to ``max_len``."""
        q, k, v = self.project_qkv(x, positions)
        out = self._attend(q, k, v, local)
        b_, s = x.shape[:2]
        y = self.wo(out.reshape(b_, s, -1))
        pad = (0, 0, 0, 0, 0, max_len - s)
        cache = {"k": torch.nn.functional.pad(k, pad).to(x.dtype),
                 "v": torch.nn.functional.pad(v, pad).to(x.dtype)}
        return y, cache

    def decode(self, x: torch.Tensor, cache: Cache,
               positions: torch.Tensor, *, local: bool = False,
               window_filter: bool = True):
        """``gqa_decode``: one token per row at ``positions`` ``[B]``; the
        new K/V are written into ``cache`` in place.  A local layer keeps
        its window unless ``window_filter`` is off."""
        q, k_new, v_new = self.project_qkv(x, positions[:, None])
        bidx = torch.arange(x.shape[0], device=x.device)
        cache["k"][bidx, positions] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][bidx, positions] = v_new[:, 0].to(cache["v"].dtype)
        lengths = torch.clamp(positions + 1, max=cache["k"].shape[1])
        window, prefix = self._window(local and window_filter)
        out = attend_decode(q, cache["k"], cache["v"], lengths=lengths,
                            softcap=self.cfg.attn_softcap, scale=self.scale,
                            window=window, global_prefix=prefix)
        y = self.wo(out.reshape(x.shape[0], 1, -1))
        return y, cache
