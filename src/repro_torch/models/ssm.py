"""Mamba-2 (SSD, state-space duality) mixer: the attention-free layers of
mamba2-130m and the Mamba layers of the jamba hybrid.

Counterpart of the JAX package's ``models/ssm.py`` (``ssm_init``,
``_split_in``, ``_causal_conv``, ``_segsum``, ``ssd_scan``, ``ssm_train``,
``ssm_prefill``, ``ssm_cache_init``, ``ssm_decode``).  ``Mamba2`` holds
``ssm_init``'s parameters under its leaf names (``in_proj.w``,
``conv_w``, ``conv_b``, ``dt_bias``, ``A_log``, ``D``, ``norm.scale``,
``out_proj.w``); ``dt_bias``, ``A_log``, ``D`` and the norm scale are
fp32 in a bf16 model, as in the reference.

The chunked SSD scan (Dao & Gu 2024, arXiv:2405.21060) splits the
sequence into chunks of ``lc`` (the reference's rule: the configured
chunk, halved until it divides the length, so an odd length gives chunks
of 1); within a chunk the recurrence is a masked quadratic form, across
chunks a loop over the ``nc`` chunks carries the ``[B, H, P, N]`` state,
as the reference's ``lax.scan`` does.  Each product has two operands:
``dt`` and the decay are folded into ``x`` first, and the head groups
stay a separate axis of ``B`` and ``C`` (no copy per head), so no
``[b, c, h, l, s, p]`` intermediate is ever formed.  Decode is the O(1)
recurrent update and writes the cache in place.

On a model-parallel ``mesh`` (a concrete mesh whose ``"model"`` axis's
m ranks divide the heads: ``attention.ssd_head_split``) a rank computes
``H / m`` heads (``rules.ssm_held_blocks``): the in projection
column-parallel on its heads' ``z`` / ``x`` columns beside every ``B``,
``C`` and ``dt`` column (its input through ``core.tp.copy_to_group``),
the conv on its ``x`` channels and every ``B`` / ``C`` channel, the scan
on its heads, the gated norm over the whole ``d_inner`` (each rank's
sum of squares all-reduced forward and backward:
``core.tp.rms_norm_split``), and the out projection row-parallel, its
output all-reduced.  The cache holds the rank's heads' state and its
conv channels.  Where the heads do not divide m the mixer runs whole on
every rank.

The in/out projections go through ``sparse.matmul`` (the dense_mm
kernel on a card).  The scan, the depthwise causal conv and the gated
norm are plain PyTorch: the reference leaves them to XLA (no Pallas
kernel), so there is no TPU kernel to port here.

A prefill shorter than ``d_conv - 1`` tokens returns its conv tail
left-padded with zeros to ``d_conv - 1`` rows -- the rows the conv
itself pads with -- so decode after a 1- or 2-token prompt equals the
full-sequence forward (the reference returns the short tail as it is).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import tp as tp_lib
from repro_torch.launch.mesh import fill_normal
from repro_torch.models.attention import ssd_head_split
from repro_torch.models.layers import Dense, RMSNorm, rms_norm
from repro_torch.sharding import rules

Cache = Dict[str, torch.Tensor]


def _dims(cfg):
    """``(d_inner, heads, conv_dim, in_dim)`` of ``cfg``'s mixer."""
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    gn = s.n_groups * s.d_state
    nh = s.num_heads(cfg.d_model)
    return di, nh, di + 2 * gn, 2 * di + 2 * gn + nh


class Mamba2(nn.Module):
    """``ssm_init``'s parameters: the in projection to ``z, x, B, C,
    dt``, the depthwise conv over ``x, B, C``, the per-head ``dt_bias``,
    ``A_log`` and ``D``, the gated RMS norm and the out projection.

    ``heads`` / ``h0``: the heads this rank computes (all of them off a
    model-parallel mesh); ``group``: the ``"model"`` axis's process
    group where they are split, else None; ``held``: the blocks of this
    module's own parameters (its projections and norm hold theirs)."""

    def __init__(self, cfg, *, dtype: torch.dtype, device=None, mesh=None):
        super().__init__()
        s = cfg.ssm
        d = cfg.d_model
        di, nh, conv_dim, in_dim = _dims(cfg)
        self.cfg = cfg
        self.group, self.h0, self.heads = None, 0, nh
        blocks = {}
        m = rules.model_split(mesh)
        if m > 1:
            group, r = tp_lib.tp_group(mesh, "model")
            split = ssd_head_split(nh, m, r)
            if split is not None:
                self.group = group
                self.h0, self.heads = split
                blocks = rules.ssm_held_blocks(cfg, mesh, *split)
        self.held = {k: blocks[k] for k in ("conv_w", "conv_b", "dt_bias",
                                            "A_log", "D") if k in blocks}

        def param(name, shape, dt):
            if name in self.held:
                shape = self.held[name].block.block_shape
            return nn.Parameter(torch.zeros(shape, dtype=dt, device=device),
                                requires_grad=False)

        def fsdp(name, shape):
            """A projection's block: the rank's heads' (``blocks``), or
            the rule's ``"data"`` part where the heads run whole."""
            return {"w": blocks[name] if blocks else rules.hold(
                name, shape, mesh, model=False)}

        self.in_proj = Dense(d, in_dim, dtype=dtype, device=device,
                             held=fsdp("in_proj.w", (d, in_dim)))
        self.conv_w = param("conv_w", (s.d_conv, conv_dim), dtype)
        self.conv_b = param("conv_b", (conv_dim,), dtype)
        self.dt_bias = param("dt_bias", (nh,), torch.float32)
        self.A_log = param("A_log", (nh,), torch.float32)
        self.D = param("D", (nh,), torch.float32)
        self.norm = RMSNorm(s.head_dim * self.heads, device=device)
        if blocks:
            self.norm.held = {"scale": blocks["norm.scale"]}
        self.out_proj = Dense(di, d, dtype=dtype, device=device,
                              held=fsdp("out_proj.w", (di, d)))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """``ssm_init``: ``conv_w`` from the generator over
        ``sqrt(d_conv)``, ``conv_b`` and ``dt_bias`` zero, ``A_log =
        log(linspace(1, 16, heads))``, ``D`` one (the projections and
        the norm reset themselves); a held block takes its part of each
        (the conv's draw is the whole tensor's)."""
        w = self.conv_w
        fill_normal(w, generator, lambda v: v / np.sqrt(self.cfg.ssm.d_conv),
                    self.held.get("conv_w"))
        with torch.no_grad():
            self.conv_b.zero_()
            self.dt_bias.zero_()
            nh = self.cfg.ssm.num_heads(self.cfg.d_model)
            self.A_log.copy_(torch.log(torch.linspace(
                1.0, 16.0, nh, dtype=torch.float32,
                device=w.device))[self.h0:self.h0 + self.heads])
            self.D.fill_(1.0)

    def project_in(self, x: torch.Tensor) -> torch.Tensor:
        """The in projection (column-parallel over split heads)."""
        return self.in_proj(tp_lib.copy_to_group(x, self.group))

    def project_out(self, y: torch.Tensor) -> torch.Tensor:
        """The out projection (row-parallel over split heads: its output
        all-reduced)."""
        return tp_lib.reduce_from_group(self.out_proj(y), self.group)

    def gated_norm(self, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """``rms_norm(y * silu(z), norm.scale)`` over the whole
        ``d_inner``: over split heads each rank's sum of squares is
        summed over the group (forward and backward)."""
        g = y * F.silu(z)
        if self.group is None:
            return rms_norm(g, self.norm.scale)
        return tp_lib.rms_norm_split(g, self.norm.scale,
                                     self.cfg.ssm.d_inner(self.cfg.d_model),
                                     self.group)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ssm_train(self, self.cfg, x)

    def prefill(self, x: torch.Tensor):
        return ssm_prefill(self, self.cfg, x)

    def decode(self, x: torch.Tensor, cache: Cache):
        return ssm_decode(self, self.cfg, x, cache)


def _split_in(proj: torch.Tensor, cfg, params: "Mamba2"):
    """``z, x, B, C, dt`` along the last axis of the in projection (the
    rank's heads' ``z``, ``x`` and ``dt`` on a model-parallel mesh)."""
    s = cfg.ssm
    di = s.head_dim * params.heads
    gn = s.n_groups * s.d_state
    z, x, B, C, dt = torch.split(proj, [di, di, gn, gn, proj.shape[-1]
                                        - 2 * di - 2 * gn], dim=-1)
    if params.group is not None:
        dt = dt[..., params.h0:params.h0 + params.heads]
    return z, x, B, C, dt


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, x: ``[B, S, C]``, w: ``[K, C]``, then silu."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k))
    return F.silu(out + b)


def _segsum(dA: torch.Tensor) -> torch.Tensor:
    """Log-space cumulative decay matrix: ``out[i, j] = sum_{j < l <= i}
    dA[l]``, -inf above the diagonal.  dA: ``[..., L]`` -> ``[..., L, L]``."""
    seq = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    i = torch.arange(seq, device=dA.device)
    return diff.masked_fill(i[:, None] < i[None, :], float("-inf"))


def chunk_len(s: int, chunk: int) -> int:
    """The SSD chunk length of an ``s``-token sequence: ``chunk``, halved
    until it divides ``s`` (1 for an odd ``s``)."""
    lc = min(chunk, s)
    while s % lc:
        lc //= 2
    return lc


def ssd_scan(x, dt, A, B, C, *, chunk: int):
    """Chunked SSD.  x: ``[B, S, H, P]``, dt: ``[B, S, H]``
    (post-softplus), A: ``[H]`` (negative), B/C: ``[B, S, G, N]``.
    Returns y ``[B, S, H, P]`` and the final state ``[B, H, P, N]``
    (fp32)."""
    b_, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    lc = chunk_len(s, chunk)
    nc = s // lc
    rep = h // g

    xc = x.reshape(b_, nc, lc, h, p)
    dtc = dt.reshape(b_, nc, lc, h)
    Bc = B.reshape(b_, nc, lc, g, n)
    Cc = C.reshape(b_, nc, lc, g, n)
    dA = dtc * A                                      # [B,nc,L,H]
    dA_cs = torch.cumsum(dA, dim=2)                   # within-chunk cumsum

    def heads(t):   # [..., H, X] -> [..., G, rep, X]
        return t.reshape(*t.shape[:-2], g, rep, t.shape[-1])

    # intra-chunk: the masked quadratic form, scores [B,nc,G,rep,L,S]
    decay = torch.exp(_segsum(dA.transpose(2, 3)))    # [B,nc,H,L,S]
    cb = torch.einsum("bclgn,bcsgn->bcgls", Cc, Bc)
    scores = decay.reshape(b_, nc, g, rep, lc, lc) * cb[:, :, :, None]
    xdt = heads(xc * dtc[..., None])                  # [B,nc,S,G,rep,P]
    y_intra = torch.einsum("bcgrls,bcsgrp->bclgrp", scores, xdt)

    # chunk end-states [B,nc,H,P,N]
    decay_to_end = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)
    xw = heads(xc * (dtc * decay_to_end)[..., None])  # [B,nc,L,G,rep,P]
    states = torch.einsum("bclgn,bclgrp->bcgrpn", Bc, xw).reshape(
        b_, nc, h, p, n).float()

    # inter-chunk recurrence over the chunks, in order
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])[..., None, None]
    carry = torch.zeros((b_, h, p, n), dtype=torch.float32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c] + states[:, c]
    prev_states = torch.stack(prev, dim=1).to(Cc.dtype)   # [B,nc,H,P,N]

    y_inter = torch.einsum(
        "bclgn,bcgrpn->bclgrp", Cc,
        prev_states.reshape(b_, nc, g, rep, p, n))
    y_inter = y_inter * heads(torch.exp(dA_cs).to(Cc.dtype)[..., None])
    y = (y_intra + y_inter).reshape(b_, s, h, p)
    return y, carry


def _mix(params: Mamba2, cfg, x: torch.Tensor):
    """The full-sequence block: ``(out [B, S, D], conv input [B, S,
    conv_dim], final state)``."""
    s_cfg = cfg.ssm
    b_, s, d = x.shape
    nh = params.heads
    di = s_cfg.head_dim * nh
    gn = s_cfg.n_groups * s_cfg.d_state
    z, xs, B, C, dt = _split_in(params.project_in(x), cfg, params)
    conv_in = torch.cat([xs, B, C], dim=-1)
    conv_out = _causal_conv(conv_in, params.conv_w, params.conv_b)
    xs, B, C = torch.split(conv_out, [di, gn, gn], dim=-1)
    xs = xs.reshape(b_, s, nh, s_cfg.head_dim)
    B = B.reshape(b_, s, s_cfg.n_groups, s_cfg.d_state)
    C = C.reshape(b_, s, s_cfg.n_groups, s_cfg.d_state)
    dt = F.softplus(dt.float() + params.dt_bias)
    A = -torch.exp(params.A_log)
    y, state = ssd_scan(xs.float(), dt, A, B.float(), C.float(),
                        chunk=s_cfg.chunk)
    y = y + xs.float() * params.D[:, None]
    y = y.reshape(b_, s, di).to(x.dtype)
    return params.project_out(params.gated_norm(y, z)), conv_in, state


def ssm_train(params: Mamba2, cfg, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence Mamba-2 block.  x: ``[B, S, D]`` -> ``[B, S, D]``."""
    return _mix(params, cfg, x)[0]


def ssm_prefill(params: Mamba2, cfg, x: torch.Tensor):
    """Full-sequence forward that also returns the recurrent cache
    ``{"state": fp32 [B, H, P, N], "conv": [B, d_conv - 1, conv_dim]}``;
    the conv tail is left-padded with zeros below ``d_conv - 1``
    tokens."""
    out, conv_in, state = _mix(params, cfg, x)
    k = cfg.ssm.d_conv - 1
    tail = conv_in[:, -k:]
    if tail.shape[1] < k:
        tail = F.pad(tail, (0, 0, k - tail.shape[1], 0))
    return out, {"state": state, "conv": tail.contiguous()}


def ssm_cache_init(cfg, batch: int, *, dtype: torch.dtype,
                   device, heads: Optional[int] = None) -> Cache:
    """Zero ``{"state", "conv"}``; ``heads`` (a model-parallel rank's)
    replaces every head, and the conv then holds its ``x`` channels and
    every ``B`` / ``C`` channel."""
    s = cfg.ssm
    _, nh, conv_dim, _ = _dims(cfg)
    if heads is not None and heads != nh:
        conv_dim -= (nh - heads) * s.head_dim
        nh = heads
    return {"state": torch.zeros((batch, nh, s.head_dim, s.d_state),
                                 dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, s.d_conv - 1, conv_dim),
                                dtype=dtype, device=device)}


def ssm_decode(params: Mamba2, cfg, x: torch.Tensor, cache: Cache):
    """One-token recurrent update.  x: ``[B, 1, D]``.  Writes the new
    state and conv history into ``cache`` in place (a captured decode
    step replays fixed tensors) and returns ``(out, cache)``."""
    s_cfg = cfg.ssm
    b_ = x.shape[0]
    nh = params.heads
    di = s_cfg.head_dim * nh
    g, n = s_cfg.n_groups, s_cfg.d_state
    z, xs, B, C, dt = _split_in(params.project_in(x), cfg, params)
    conv_in = torch.cat([xs, B, C], dim=-1)               # [B, 1, conv_dim]
    hist = torch.cat([cache["conv"], conv_in], dim=1)
    conv_out = F.silu((hist * params.conv_w[None]).sum(dim=1, keepdim=True)
                      + params.conv_b)
    xs, B, C = torch.split(conv_out, [di, g * n, g * n], dim=-1)
    xs = xs.reshape(b_, nh, s_cfg.head_dim).float()
    rep = nh // g
    B = B.reshape(b_, g, 1, n).float().expand(b_, g, rep, n).reshape(
        b_, nh, n)
    C = C.reshape(b_, g, 1, n).float().expand(b_, g, rep, n).reshape(
        b_, nh, n)
    dt = F.softplus(dt[:, 0].float() + params.dt_bias)   # [B, H]
    A = -torch.exp(params.A_log)
    decay = torch.exp(dt * A)
    state = cache["state"] * decay[..., None, None] + \
        (dt[..., None] * xs)[..., None] * B[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", state, C) + xs * params.D[:, None]
    y = y.reshape(b_, 1, di).to(x.dtype)
    y = params.gated_norm(y, z)
    cache["state"].copy_(state)
    cache["conv"].copy_(hist[:, 1:])
    return params.project_out(y), cache
