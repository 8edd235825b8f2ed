"""GQA attention with RoPE, soft-cap and local windows (causal, or
bidirectional in an encoder), cross attention over an encoder's memory,
and DeepSeek-V2's multi-head latent attention (MLA): full-sequence
(training, prefill) and one-token decode.

Counterparts of the JAX package's ``models/attention.py`` GQA module
(``gqa_init``, ``_project_qkv``, ``gqa_train``, ``gqa_prefill``,
``gqa_decode``, ``gqa_cache_init``, ``attend_train``, ``attend_decode``),
its cross attention (``cross_init``, ``cross_kv``, ``cross_apply``)
and MLA module (``mla_init``, ``mla_train``, ``mla_cache_init``,
``mla_prefill``, ``mla_decode``).
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
applied before caching; ``GQA.decode`` updates them in place.  An MLA
layer caches ``{"latent", "k_rope"}`` (``[B, S, kv_lora_rank]`` and the
roped ``[B, S, qk_rope_dim]``) and decodes against the latent with the
key and value up-projections absorbed, in fp32, as the reference does.

On a model-parallel mesh (a concrete mesh whose ``"model"`` axis has
m > 1 ranks) every mixer here computes its rank's heads where they
split (``head_split`` for GQA and cross attention; m dividing MLA's
heads): column-parallel projections behind ``core.tp.copy_to_group``, a
row-parallel ``wo`` whose output is all-reduced; else it runs whole.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import capture
from repro_torch.core import masks as masks_lib
from repro_torch.kernels.bs_attn import ops as bs_ops
from repro_torch.kernels.bs_attn.ref import attend_plain, element_mask
from repro_torch.core import tp as tp_lib
from repro_torch.launch.mesh import Block, Held, owns_block
from repro_torch.models.layers import Dense, RMSNorm, apply_rope, rope_freqs
from repro_torch.sharding import rules
from repro_torch.sharding.rules import P

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
    """The kernel for CUDA tensors (its meta branch for meta tensors), its
    plain version for CPU tensors."""
    if q.device.type in ("cuda", "meta"):
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
    from the saved q, k, v.

    The backward's element mask is looked up in the forward: on a card
    autograd runs the backward on its own device thread, where no capture
    record is active (``core.capture`` is per thread), so a graph that
    captured the backward would otherwise read a cached mask nothing
    keeps alive."""

    @staticmethod
    def forward(ctx, q, k, v, spec):
        ctx.spec = spec
        ctx.mask = spec.element_mask(q.device)
        capture.hold(ctx.mask)
        ctx.save_for_backward(q, k, v)
        return _attend_forward(q, k, v, spec)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        spec = ctx.spec
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = attend_plain(*leaves, ctx.mask,
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
                   dtype: torch.dtype, device,
                   kv_heads: Optional[int] = None) -> Cache:
    """Zero K/V caches ``[B, max_len, KV, dh]``; ``kv_heads`` (a
    model-parallel rank's KV heads) replaces ``cfg.num_kv_heads``."""
    kv, dh = kv_heads or cfg.num_kv_heads, cfg.head_dim
    return {"k": torch.zeros((batch, max_len, kv, dh), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, max_len, kv, dh), dtype=dtype,
                             device=device)}


def head_split(num_heads: int, num_kv_heads: int, m: int, r: int):
    """Rank ``r`` of ``m`` on the ``"model"`` axis: ``(its query heads
    [h0, h0 + hl), its KV heads [k0, k0 + kl), shared)``.  The query heads
    split evenly; the rank holds the KV heads they read, ``shared`` when
    several ranks read one KV head (fewer KV heads than ranks: the
    reference's rule would cut ``wk``'s columns inside a head there).
    None where the heads do not split: H not a multiple of m, or a
    rank's heads cutting GQA groups unevenly (the layer then runs whole
    on every rank)."""
    if num_heads % m:
        return None
    hl, g = num_heads // m, num_heads // num_kv_heads
    if hl % g and g % hl:
        return None
    h0 = r * hl
    k0, k1 = h0 // g, (h0 + hl - 1) // g + 1
    return h0, hl, k0, k1 - k0, g > hl


def ssd_head_split(num_heads: int, m: int, r: int):
    """Rank ``r`` of ``m`` on the ``"model"`` axis: ``(its SSD heads
    [h0, h0 + hl), hl)`` of a Mamba-2 mixer (no KV groups to keep); None
    where the heads do not divide m (the mixer then runs whole on every
    rank)."""
    if m <= 1 or num_heads % m:
        return None
    hl = num_heads // m
    return r * hl, hl


def qkv_held(cfg, mesh, *, bias: bool):
    """The split of a ``wq``/``wk``/``wv``/``wo`` mixer (GQA, cross
    attention) on ``mesh``: ``(group, split, held)`` with ``split``
    ``head_split``'s and ``held`` the projections' blocks by module
    name, or ``(None, None, held)`` where it runs whole over
    ``"model"`` (no ``"model"`` axis past 1, or heads that do not
    split), ``held`` then the rules' ``"data"`` blocks only (FSDP; None
    entries where nothing splits)."""
    d, dh = cfg.d_model, cfg.head_dim
    qd, kvd = cfg.attn_dims
    leaves = (("w", (d, qd), (d, kvd)),) + (
        (("b", (qd,), (kvd,)),) if bias else ())
    m = rules.model_split(mesh)
    group = split = None
    if m > 1:
        group, r = tp_lib.tp_group(mesh, "model")
        split = head_split(cfg.num_heads, cfg.num_kv_heads, m, r)
    if split is None:
        held = {"wq": {k: rules.hold(f"wq.{k}", q_shape, mesh, model=False)
                       for k, q_shape, _ in leaves},
                "wk": {k: rules.hold(f"wk.{k}", shape, mesh, model=False)
                       for k, _, shape in leaves},
                "wo": {"w": rules.hold("wo.w", (qd, d), mesh, model=False)}}
        held["wv"] = held["wk"]
        return None, None, held
    h0, _, k0, kv_heads, shared = split
    held = {"wq": {k: rules.held_block(f"wq.{k}", q_shape, mesh)
                   for k, q_shape, _ in leaves},
            "wo": {"w": rules.held_block("wo.w", (qd, d), mesh)}}
    if shared:
        # the first rank reading a KV head writes it back
        first = h0 % (cfg.num_heads // cfg.num_kv_heads) == 0
        owner = first and owns_block(mesh, P("model"))
        cols = slice(k0 * dh, (k0 + kv_heads) * dh)
        kv = {k: rules.with_data(f"wk.{k}", Held.whole(Block(
            shape, (slice(None),) * (len(shape) - 1) + (cols,),
            owner, ("model",)), partial=True), mesh, first=first)
            for k, _, shape in leaves}
    else:
        # the rule's blocks hold whole heads: H and (unshared) KV divide
        # by m
        kv = {k: rules.held_block(f"wk.{k}", shape, mesh)
              for k, _, shape in leaves}
    held["wk"] = held["wv"] = kv
    return group, split, held


class GQA(nn.Module):
    """Grouped-query attention (``gqa_init``): ``wq``/``wk``/``wv``/``wo``
    dense projections, optional per-head q/k RMS norms.  ``local=True``
    (an ``attn_local`` layer) applies ``cfg.local_window`` and
    ``cfg.global_prefix``; ``causal=False`` (an encoder layer's) attends
    without the causal mask, RoPE at its positions all the same.

    On a model-parallel ``mesh`` (a concrete mesh whose ``"model"`` axis
    has m > 1 ranks) the rank computes ``H / m`` query heads
    (``head_split``) and the KV heads they read: ``wq``/``wk``/``wv`` and
    their biases column-parallel, ``wo`` row-parallel, the input through
    ``core.tp.copy_to_group`` and the output all-reduced
    (``reduce_from_group``).  KV heads that several ranks read are held
    by each of them, and their gradients, like ``q_norm``'s and
    ``k_norm``'s, are partial sums there (``held``: ``partial``).  Where
    the heads do not split (``head_split`` is None) the layer runs whole
    on every rank, as MLA does: its parameters whole (the optimizer
    state their rules' blocks), its input and output not reduced, its
    cache every KV head.  The reference's rule would cut ``wq``'s
    columns inside a head there (gemma2's 8 heads of 256 over 16
    ranks)."""

    def __init__(self, cfg, *, dtype: torch.dtype, device=None,
                 causal: bool = True, mesh=None):
        super().__init__()
        d = cfg.d_model
        qd, kvd = cfg.attn_dims
        dh = cfg.head_dim
        self.cfg = cfg
        self.causal = causal
        self.heads, self.kv_heads = cfg.num_heads, cfg.num_kv_heads
        self.group, split, held = qkv_held(cfg, mesh, bias=cfg.qkv_bias)
        if split is not None:
            _, self.heads, _, self.kv_heads, _ = split
        self.wq = Dense(d, qd, bias=cfg.qkv_bias, dtype=dtype, device=device,
                        held=held.get("wq"))
        self.wk = Dense(d, kvd, bias=cfg.qkv_bias, dtype=dtype,
                        device=device, held=held.get("wk"))
        self.wv = Dense(d, kvd, bias=cfg.qkv_bias, dtype=dtype,
                        device=device, held=held.get("wv"))
        self.wo = Dense(qd, d, dtype=dtype, device=device,
                        held=held.get("wo"))
        if cfg.qk_norm:
            self.q_norm = RMSNorm(cfg.head_dim, device=device)
            self.k_norm = RMSNorm(cfg.head_dim, device=device)
            if self.group is not None:
                for norm in (self.q_norm, self.k_norm):
                    norm.held = {"scale": Held.whole(
                        Block.whole((dh,), mesh), partial=True)}
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
        h, kv, dh = self.heads, self.kv_heads, cfg.head_dim
        if self.group is not None:
            x = tp_lib.copy_to_group(x, self.group)
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

    def _out(self, out: torch.Tensor) -> torch.Tensor:
        """``wo`` of the heads' outputs ``[B, S, H_loc, dh]``, all-reduced
        over the split heads."""
        y = self.wo(out.reshape(out.shape[0], out.shape[1], -1))
        if self.group is not None:
            y = tp_lib.reduce_from_group(y, self.group)
        return y

    def _attend(self, q, k, v, local: bool) -> torch.Tensor:
        window, prefix = self._window(local)
        cfg = self.cfg
        return attend_train(q, k, v, causal=self.causal, window=window,
                            global_prefix=prefix, softcap=cfg.attn_softcap,
                            scale=self.scale, tile_q=cfg.attn_tile_q,
                            tile_kv=cfg.attn_tile_kv,
                            schedule=cfg.attn_schedule)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *,
                local: bool = False) -> torch.Tensor:
        """``gqa_train``: full-sequence GQA."""
        q, k, v = self.project_qkv(x, positions)
        return self._out(self._attend(q, k, v, local))

    def prefill(self, x: torch.Tensor, positions: torch.Tensor, *,
                max_len: int, local: bool = False):
        """``gqa_prefill``: causal forward plus the roped K/V cache padded
        to ``max_len``."""
        q, k, v = self.project_qkv(x, positions)
        y = self._out(self._attend(q, k, v, local))
        pad = (0, 0, 0, 0, 0, max_len - x.shape[1])
        cache = {"k": torch.nn.functional.pad(k, pad).to(x.dtype),
                 "v": torch.nn.functional.pad(v, pad).to(x.dtype)}
        return y, cache

    def decode(self, x: torch.Tensor, cache: Cache,
               positions: torch.Tensor, *, local: bool = False,
               slot: Optional[torch.Tensor] = None,
               window_filter: bool = True):
        """``gqa_decode``: one token per row at ``positions`` ``[B]``; the
        new K/V are written into ``cache`` in place at ``slot``
        (``positions`` when None; a retained ring cache's slot, RoPE at
        the true position).  A local layer keeps its window unless
        ``window_filter`` is off (a ring cache holds the retained set)."""
        q, k_new, v_new = self.project_qkv(x, positions[:, None])
        slot = positions if slot is None else slot
        bidx = torch.arange(x.shape[0], device=x.device)
        cache["k"][bidx, slot] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][bidx, slot] = v_new[:, 0].to(cache["v"].dtype)
        lengths = torch.clamp(positions + 1, max=cache["k"].shape[1])
        window, prefix = self._window(local and window_filter)
        out = attend_decode(q, cache["k"], cache["v"], lengths=lengths,
                            softcap=self.cfg.attn_softcap, scale=self.scale,
                            window=window, global_prefix=prefix)
        return self._out(out), cache


# ---------------------------------------------------------------------------
# Cross attention (encoder-decoder layers; no RoPE, non-causal over memory)
# ---------------------------------------------------------------------------

class CrossAttention(nn.Module):
    """``cross_init`` / ``cross_kv`` / ``cross_apply``: ``wq``, ``wk``,
    ``wv``, ``wo`` without biases (also under ``qkv_bias``), no RoPE, no
    soft-cap, scale ``1 / sqrt(head_dim)``.  The queries attend over the
    whole memory through ``attend_train(causal=False)``: bs_attn on a
    card at prefill (S x T) and at decode (1 x T).

    On a model-parallel ``mesh`` it splits as GQA does (``qkv_held``):
    ``wq``/``wk``/``wv`` column-parallel, the decoder's rows and the
    encoder's memory through ``copy_to_group``, ``wo`` row-parallel and
    all-reduced; ``kv`` returns (and a cross cache holds) the rank's KV
    heads."""

    def __init__(self, cfg, *, dtype: torch.dtype, device=None, mesh=None):
        super().__init__()
        d = cfg.d_model
        qd, kvd = cfg.attn_dims
        self.cfg = cfg
        self.heads, self.kv_heads = cfg.num_heads, cfg.num_kv_heads
        self.group, split, held = qkv_held(cfg, mesh, bias=False)
        if split is not None:
            _, self.heads, _, self.kv_heads, _ = split
        self.wq = Dense(d, qd, dtype=dtype, device=device,
                        held=held.get("wq"))
        self.wk = Dense(d, kvd, dtype=dtype, device=device,
                        held=held.get("wk"))
        self.wv = Dense(d, kvd, dtype=dtype, device=device,
                        held=held.get("wv"))
        self.wo = Dense(qd, d, dtype=dtype, device=device,
                        held=held.get("wo"))

    def kv(self, memory: torch.Tensor):
        """``cross_kv``: the memory's K and V ``[B, T, KV, dh]`` (the
        rank's KV heads), computed once a prefill and read by every
        decode step."""
        b_, t, _ = memory.shape
        kv, dh = self.kv_heads, self.cfg.head_dim
        memory = tp_lib.copy_to_group(memory, self.group)
        return (self.wk(memory).reshape(b_, t, kv, dh),
                self.wv(memory).reshape(b_, t, kv, dh))

    def forward(self, x: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
        """``cross_apply``: x ``[B, S, D]`` over the memory's K/V."""
        cfg = self.cfg
        b_, s, _ = x.shape
        q = self.wq(tp_lib.copy_to_group(x, self.group)).reshape(
            b_, s, self.heads, cfg.head_dim)
        out = attend_train(q, k, v, causal=False,
                           scale=1.0 / np.sqrt(cfg.head_dim),
                           tile_q=cfg.attn_tile_q, tile_kv=cfg.attn_tile_kv)
        return tp_lib.reduce_from_group(self.wo(out.reshape(b_, s, -1)),
                                        self.group)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------

def mla_cache_init(cfg, batch: int, max_len: int, *,
                   dtype: torch.dtype, device) -> Cache:
    """``mla_cache_init``: the latent (``kv_lora_rank`` wide) and the
    roped key (``qk_rope_dim`` wide) per position, not per-head K and
    V."""
    return {"latent": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                                  dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_dim),
                                  dtype=dtype, device=device)}


class _MlaQ(nn.Module):
    """MLA's query under the reference's leaf names: one projection
    ``w`` (leaf ``q.w.w``), or with a ``rank`` the low-rank ``b(norm(a(
    x)))`` (``q.a.w``, ``q.norm.scale``, ``q.b.w``).  ``held`` (by
    module name) splits ``w`` or ``b`` column-parallel over ``group``:
    its input enters through ``copy_to_group`` (``a`` and the norm stay
    whole, their gradients whole on every rank)."""

    def __init__(self, d: int, rank: Optional[int], qd: int, *, dtype,
                 device, held=None, group=None):
        super().__init__()
        held = held or {}
        self.rank = rank
        self.group = group
        if rank:
            self.a = Dense(d, rank, dtype=dtype, device=device,
                           held=held.get("q.a"))
            self.norm = RMSNorm(rank, device=device)
            self.b = Dense(rank, qd, dtype=dtype, device=device,
                           held=held.get("q.b"))
        else:
            self.w = Dense(d, qd, dtype=dtype, device=device,
                           held=held.get("q.w"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rank:
            return self.b(tp_lib.copy_to_group(self.norm(self.a(x)),
                                               self.group))
        return self.w(tp_lib.copy_to_group(x, self.group))


class MLA(nn.Module):
    """Multi-head latent attention (``mla_init``): the query ``q`` (one
    projection, or a low-rank one with ``cfg.q_lora_rank``), the joint down-projection ``kv_a`` to the
    latent and the decoupled rope key, the latent's norm ``kv_norm``,
    its up-projection ``kv_b`` to per-head k_nope and v, and ``wo``.

    The full-sequence path attends with q·k heads of ``qk_nope_dim +
    qk_rope_dim`` (the rope key broadcast to every head) and v
    zero-padded to that width and cropped after, as the reference does,
    so bs_attn runs it at one head dim (192 for DeepSeek-V2).

    On a model-parallel ``mesh`` whose ``"model"`` axis's m ranks divide
    the heads the rank computes ``H / m`` heads
    (``rules.mla_held_blocks``): the query's ``w`` or ``b`` and ``kv_b``
    column-parallel, ``wo`` row-parallel and all-reduced.  ``q.a``,
    ``kv_a`` and both norms stay whole; the normed latent, the low-rank
    query and the rope key enter the split heads through
    ``copy_to_group``, so their gradients are whole on every rank.  The
    cache (latent and rope key, no heads) is whole on every rank.
    Where the heads do not divide m the mixer runs whole."""

    def __init__(self, cfg, *, dtype: torch.dtype, device=None, mesh=None):
        super().__init__()
        d, h = cfg.d_model, cfg.num_heads
        nope, rope, v_dim = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        r = cfg.kv_lora_rank
        qd = h * (nope + rope)
        self.cfg = cfg
        self.heads, self.group = h, None
        m = rules.model_split(mesh)
        split = m > 1 and h % m == 0
        if split:
            self.group, _ = tp_lib.tp_group(mesh, "model")
            self.heads = h // m
        held = rules.mla_held_blocks(cfg, mesh, model=split)
        self.q = _MlaQ(d, cfg.q_lora_rank, qd, dtype=dtype, device=device,
                       held=held, group=self.group)
        self.kv_a = Dense(d, r + rope, dtype=dtype, device=device,
                          held=held.get("kv_a"))
        self.kv_norm = RMSNorm(r, device=device)
        self.kv_b = Dense(r, h * (nope + v_dim), dtype=dtype, device=device,
                          held=held.get("kv_b"))
        self.wo = Dense(h * v_dim, d, dtype=dtype, device=device,
                        held=held.get("wo"))
        self.register_buffer(
            "rope_freqs", torch.as_tensor(
                rope_freqs(rope, cfg.rope_theta), dtype=torch.float32,
                device=device), persistent=False)

    @property
    def scale(self) -> float:
        return 1.0 / np.sqrt(self.cfg.qk_nope_dim + self.cfg.qk_rope_dim)

    def _out(self, out: torch.Tensor) -> torch.Tensor:
        """``wo`` of the heads' outputs ``[B, S, H_loc * v_dim]``,
        all-reduced over the split heads."""
        return tp_lib.reduce_from_group(self.wo(out), self.group)

    def _q(self, x: torch.Tensor):
        """``_mla_q``: per-head q (the rank's heads), split into its nope
        and rope parts."""
        b_, s, _ = x.shape
        cfg = self.cfg
        q = self.q(x).reshape(b_, s, self.heads,
                              cfg.qk_nope_dim + cfg.qk_rope_dim)
        return q[..., :cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]

    def _kv(self, x: torch.Tensor):
        """``_mla_kv``: the normed latent ``[B, S, r]`` and the unroped
        rope key ``[B, S, 1, rope]`` (on a mesh both through
        ``copy_to_group``: every split head reads them)."""
        b_, s, _ = x.shape
        r = self.cfg.kv_lora_rank
        kv_a = self.kv_a(x)
        latent = self.kv_norm(kv_a[..., :r])
        k_rope = kv_a[..., r:].reshape(b_, s, 1, self.cfg.qk_rope_dim)
        return (tp_lib.copy_to_group(latent, self.group),
                tp_lib.copy_to_group(k_rope, self.group))

    def _attend(self, x: torch.Tensor, positions: torch.Tensor):
        """``mla_train``'s output, with the latent and the roped key it
        computed (``mla_prefill`` caches them)."""
        cfg = self.cfg
        b_, s, _ = x.shape
        h, nope, v_dim = self.heads, cfg.qk_nope_dim, cfg.v_head_dim
        q_nope, q_rope = self._q(x)
        latent, k_rope = self._kv(x)
        kv = self.kv_b(latent).reshape(b_, s, h, nope + v_dim)
        k_nope, v = kv[..., :nope], kv[..., nope:]
        q_rope = apply_rope(q_rope, positions, freqs=self.rope_freqs)
        k_rope = apply_rope(k_rope, positions, freqs=self.rope_freqs)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope.expand(b_, s, h, cfg.qk_rope_dim)],
                      dim=-1)
        # v padded to the q.k head dim for the shared attend path, then
        # cropped
        v_p = F.pad(v, (0, q.shape[-1] - v_dim))
        out = attend_train(q, k, v_p, causal=True, scale=self.scale,
                           softcap=cfg.attn_softcap, tile_q=cfg.attn_tile_q,
                           tile_kv=cfg.attn_tile_kv,
                           schedule=cfg.attn_schedule)
        y = self._out(out[..., :v_dim].reshape(b_, s, -1))
        return y, latent, k_rope

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *,
                local: bool = False) -> torch.Tensor:
        """``mla_train``: full-sequence causal MLA (``local`` is the
        layer interface's and is unused: an MLA layer has no window)."""
        return self._attend(x, positions)[0]

    def prefill(self, x: torch.Tensor, positions: torch.Tensor, *,
                max_len: int, local: bool = False):
        """``mla_prefill``: causal forward plus the latent and roped-key
        cache padded to ``max_len``.  The reference recomputes the
        latent after ``mla_train``; here the one ``mla_train`` computed
        is kept (the same values)."""
        y, latent, k_rope = self._attend(x, positions)
        pad = (0, 0, 0, max_len - x.shape[1])
        cache = {"latent": F.pad(latent, pad).to(x.dtype),
                 "k_rope": F.pad(k_rope[:, :, 0, :], pad).to(x.dtype)}
        return y, cache

    def decode(self, x: torch.Tensor, cache: Cache,
               positions: torch.Tensor, *, local: bool = False,
               slot: Optional[torch.Tensor] = None,
               window_filter: bool = True):
        """``mla_decode``: one token per row at ``positions`` ``[B]``; the
        new latent and roped key are written into ``cache`` in place at
        ``slot`` (``positions`` when None; RoPE at the true position).
        MLA has no window, so ``window_filter`` changes nothing.
        Absorbed attention in fp32: ``q_nope . W_uk`` against the latent
        plus ``q_rope . k_rope``, the softmax, then ``ctx . W_uv`` (plain
        torch einsums, which the reference leaves to XLA)."""
        cfg = self.cfg
        b_ = x.shape[0]
        h, nope, r = self.heads, cfg.qk_nope_dim, cfg.kv_lora_rank
        q_nope, q_rope = self._q(x)
        latent_new, k_rope_new = self._kv(x)
        pos = positions[:, None]
        q_rope = apply_rope(q_rope, pos, freqs=self.rope_freqs)
        k_rope_new = apply_rope(k_rope_new, pos, freqs=self.rope_freqs)
        bidx = torch.arange(b_, device=x.device)
        slot = positions if slot is None else slot
        latent_c, k_rope_c = cache["latent"], cache["k_rope"]
        latent_c[bidx, slot] = latent_new[:, 0].to(latent_c.dtype)
        k_rope_c[bidx, slot] = k_rope_new[:, 0, 0].to(k_rope_c.dtype)
        s = latent_c.shape[1]
        lengths = torch.clamp(positions + 1, max=s)

        wkv = self.kv_b.weight().reshape(r, h, nope + cfg.v_head_dim).float()
        w_uk, w_uv = wkv[:, :, :nope], wkv[:, :, nope:]
        lat = latent_c.float()
        q_abs = torch.einsum("bqhn,rhn->bqhr", q_nope.float(), w_uk)
        logits = torch.einsum("bqhr,bsr->bhqs", q_abs, lat)
        logits = logits + torch.einsum("bqhn,bsn->bhqs", q_rope.float(),
                                       k_rope_c.float())
        logits = logits * self.scale
        mask = (torch.arange(s, device=x.device)[None, None, None, :]
                < lengths[:, None, None, None])
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
        w = torch.softmax(logits, dim=-1)
        ctx = torch.einsum("bhqs,bsr->bqhr", w, lat)
        out = torch.einsum("bqhr,rhv->bqhv", ctx, w_uv)
        y = self._out(out.reshape(b_, 1, -1).to(x.dtype))
        return y, cache
