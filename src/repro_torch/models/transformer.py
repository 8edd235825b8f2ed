"""Decoder (and encoder) layers and the layer stack.

Counterpart of the JAX package's ``models/transformer.py`` for the
``attn``, ``attn_local``, ``mla`` and ``mamba`` mixers with the ``mlp``,
``sparse``, ``moe`` and ``none`` FFN arms, the Gemma-2 pre+post
norms (``post_norm``: ``plus_one`` norms before and after each
sub-layer), bidirectional (``causal=False``) attention layers of an
encoder and the cross-attention sub-layer of an encoder-decoder's
decoder layers (``cross``: over the encoder's memory, after the mixer)
(``layer_apply``, ``layer_prefill``, ``layer_decode``,
``layer_cache_init`` and their stacks).  The full-sequence
stack sums the MoE layers' metrics (``aux_loss``, ``z_loss``,
``dropped_frac``) into a dict the caller passes, as the reference's
``stack_apply`` returns them; prefill and decode drop them, as the
reference does.
The JAX package scans one period over stacked params; here every layer
is its own module and the stack is a Python loop.

Rematerialisation follows ``cfg.remat`` as the reference's
``_remat_policy`` does: under ``"full"`` (every config's default) each
period of ``cfg.groups`` runs under activation checkpointing while
gradients are on, so only each period's input (and the running MoE
metrics) is saved for the backward and the period's forward runs again
there; ``"none"`` saves everything.  ``"dots"`` (save the dense
products' outputs) raises: the port's projections are hand-written
kernels behind autograd Functions, out of reach of an op-level saving
policy (ROADMAP queue 1, item 11b.5).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch
from torch import nn
from torch.utils import checkpoint as torch_checkpoint

from repro_torch import sparse as sparse_api
from repro_torch.core import capture
from repro_torch.core.sparse_layers import SparseFFN
from repro_torch.models.attention import (GQA, MLA, Cache, CrossAttention,
                                         gqa_cache_init, mla_cache_init)
from repro_torch.models.config import LayerSpec, ModelCfg
from repro_torch.models.layers import MLP, RMSNorm
from repro_torch.models.moe import MoE
from repro_torch.models.ssm import Mamba2, ssm_cache_init
from repro_torch.sharding import rules

METRICS = ("aux_loss", "z_loss", "dropped_frac")
REMAT = ("full", "dots", "none")


def zero_metrics(device) -> Dict[str, torch.Tensor]:
    """``_zero_metrics``: the stack metrics at zero, fp32 on ``device``."""
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in METRICS}


def model_dtype(cfg: ModelCfg) -> torch.dtype:
    """bf16 for a bf16 config, fp32 otherwise (the JAX package's rule)."""
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def sparse_ffn(cfg: ModelCfg, *, device, mesh=None) -> SparseFFN:
    """The sparse FFN arm, built as the JAX package builds it: seed 0 for
    every layer, gated when the activation is (on a model-parallel
    ``mesh`` each projection holds its rank's k-shard)."""
    return SparseFFN(cfg.d_model, cfg.d_ff, cfg.ffn_block_size,
                     cfg.ffn_density, gated=cfg.act in ("silu", "gelu"),
                     dtype=model_dtype(cfg), device=device, mesh=mesh)


class Layer(nn.Module):
    """Pre-norm decoder layer: ``h + post1(mix(norm1(h)))``, then
    ``h + post2(ffn(norm2(h)))``; the post norms exist with
    ``cfg.post_norm``, which also makes norm1 and norm2 ``plus_one``.
    The mixer is ``attn`` (GQA or MLA) or, for a ``mamba`` layer,
    ``mixer`` (the reference's leaf names); an ``ffn="none"`` layer has
    no FFN sub-layer and no ``norm2`` / ``post_norm2`` (the reference
    adds a zero FFN output).  A ``cross`` layer adds ``h +
    cross(norm_x(h), memory)`` between the mixer and the FFN; a
    ``causal=False`` attention layer (an encoder's) attends both ways.
    ``mesh`` reaches every mixer -- GQA, MLA, Mamba-2 and cross
    attention, each split over a model-parallel mesh's ``"model"`` axis
    where its heads divide, else whole on every rank --, the MLP and
    the sparse FFN (split there) and the MoE (its experts and shared
    experts); the router and the norms run whole."""

    def __init__(self, cfg: ModelCfg, spec: LayerSpec, *, device,
                 mesh=None):
        super().__init__()
        if spec.mixer not in ("attn", "attn_local", "mla", "mamba"):
            raise NotImplementedError(
                f"layer {spec}: the port runs 'attn', 'attn_local', 'mla' "
                f"and 'mamba' layers")
        if not spec.causal and spec.mixer not in ("attn", "attn_local"):
            raise NotImplementedError(
                f"layer {spec}: only an attention mixer runs non-causal")
        if spec.ffn not in ("mlp", "sparse", "moe", "none"):
            raise NotImplementedError(
                f"ffn {spec.ffn!r}: the port runs 'mlp', 'sparse', 'moe' "
                f"and 'none' only")
        dt = model_dtype(cfg)
        self.cfg = cfg
        self.local = spec.mixer == "attn_local"
        self.ssm = spec.mixer == "mamba"
        self.norm1 = RMSNorm(cfg.d_model, plus_one=cfg.post_norm,
                             device=device)
        if self.ssm:
            self.mixer = Mamba2(cfg, dtype=dt, device=device, mesh=mesh)
        else:
            self.attn = (MLA(cfg, dtype=dt, device=device, mesh=mesh)
                         if spec.mixer == "mla" else
                         GQA(cfg, dtype=dt, device=device,
                             causal=spec.causal, mesh=mesh))
        self.cross = self.norm_x = None
        if spec.cross:
            self.cross = CrossAttention(cfg, dtype=dt, device=device,
                                        mesh=mesh)
            self.norm_x = RMSNorm(cfg.d_model, plus_one=cfg.post_norm,
                                  device=device)
        self.moe = spec.ffn == "moe"
        has_ffn = spec.ffn != "none"
        self.norm2 = (RMSNorm(cfg.d_model, plus_one=cfg.post_norm,
                              device=device) if has_ffn else None)
        if not has_ffn:
            self.ffn = None
        elif spec.ffn == "mlp":
            self.ffn = MLP(cfg.d_model, cfg.d_ff, act=cfg.act, dtype=dt,
                           device=device, mesh=mesh)
        elif self.moe:
            self.ffn = MoE(cfg, dtype=dt, device=device, mesh=mesh)
        else:
            self.ffn = sparse_ffn(cfg, device=device, mesh=mesh)
        self.post_norm1 = self.post_norm2 = None
        if cfg.post_norm:
            self.post_norm1 = RMSNorm(cfg.d_model, plus_one=True,
                                      device=device)
            if has_ffn:
                self.post_norm2 = RMSNorm(cfg.d_model, plus_one=True,
                                          device=device)

    def _post(self, norm, x: torch.Tensor) -> torch.Tensor:
        return x if norm is None else norm(x, eps=self.cfg.norm_eps)

    def _ffn(self, h: torch.Tensor,
             metrics: Optional[Dict[str, torch.Tensor]] = None
             ) -> torch.Tensor:
        """``h`` plus the FFN sub-layer (``h`` itself without an FFN); an
        MoE layer adds its metrics into ``metrics`` when given (device
        adds, no host read)."""
        if self.ffn is None:
            return h
        hn = self.norm2(h, eps=self.cfg.norm_eps)
        if self.moe:
            out, m = self.ffn(hn)
            if metrics is not None:
                for name, val in zip(METRICS, m):
                    metrics[name] = metrics[name] + val
        else:
            out = self.ffn(hn)
        return h + self._post(self.post_norm2, out)

    def _cross(self, h: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor) -> torch.Tensor:
        """``h`` plus the cross-attention sub-layer over the memory's
        K/V."""
        return h + self.cross(self.norm_x(h, eps=self.cfg.norm_eps), k, v)

    def _memory_kv(self, memory: Optional[torch.Tensor]):
        if memory is None:
            raise ValueError("a cross-attention layer needs the encoder's "
                             "memory: pass enc_frames")
        return self.cross.kv(memory)

    def forward(self, h: torch.Tensor, positions: torch.Tensor,
                metrics: Optional[Dict[str, torch.Tensor]] = None,
                memory: Optional[torch.Tensor] = None):
        """``layer_apply``: full sequence, no cache; MoE metrics are
        summed into ``metrics`` when given; ``memory`` ``[B, T, D]`` is
        the encoder's output a cross layer attends over."""
        hn = self.norm1(h, eps=self.cfg.norm_eps)
        if self.ssm:
            mix = self.mixer(hn)
        else:
            mix = self.attn(hn, positions, local=self.local)
        h = h + self._post(self.post_norm1, mix)
        if self.cross is not None:
            h = self._cross(h, *self._memory_kv(memory))
        return self._ffn(h, metrics)

    def prefill(self, h: torch.Tensor, positions: torch.Tensor, *,
                max_len: int, memory: Optional[torch.Tensor] = None):
        """``layer_prefill``: full sequence, emits the layer's cache (a
        cross layer's also holds the memory's K/V, ``xk`` / ``xv``
        ``[B, T, KV, dh]``, unpadded)."""
        hn = self.norm1(h, eps=self.cfg.norm_eps)
        if self.ssm:
            mix, cache = self.mixer.prefill(hn)
        else:
            mix, cache = self.attn.prefill(hn, positions, max_len=max_len,
                                           local=self.local)
        h = h + self._post(self.post_norm1, mix)
        if self.cross is not None:
            cache["xk"], cache["xv"] = self._memory_kv(memory)
            h = self._cross(h, cache["xk"], cache["xv"])
        return self._ffn(h), cache

    def decode(self, h: torch.Tensor, cache: Cache,
               positions: torch.Tensor, *,
               slot: Optional[torch.Tensor] = None,
               window_filter: bool = True):
        """``layer_decode``: one token per row, cache updated in place at
        ``slot`` (``positions`` when None; a retained ring cache's slot
        otherwise); ``window_filter`` off lets a local layer attend to
        every cached slot.  A mamba layer ignores both."""
        hn = self.norm1(h, eps=self.cfg.norm_eps)
        if self.ssm:
            mix, cache = self.mixer.decode(hn, cache)
        else:
            mix, cache = self.attn.decode(hn, cache, positions,
                                          local=self.local, slot=slot,
                                          window_filter=window_filter)
        h = h + self._post(self.post_norm1, mix)
        if self.cross is not None:
            h = self._cross(h, cache["xk"], cache["xv"])
        return self._ffn(h), cache


def layer_specs(cfg: ModelCfg) -> List[LayerSpec]:
    """Layer specs in execution order (each period ``repeat`` times)."""
    return [spec for period, rep in cfg.groups for _ in range(rep)
            for spec in period]


def periods(layers) -> List[list]:
    """``layers`` cut into the periods of their config's groups, in
    execution order (one list of ``len(period)`` layers a repeat)."""
    out, i = [], 0
    for period, rep in (layers[0].cfg.groups if len(layers) else ()):
        for _ in range(rep):
            out.append(list(layers[i:i + len(period)]))
            i += len(period)
    if i != len(layers):
        raise ValueError(f"{len(layers)} layers do not match the config's "
                         f"groups ({i} layers)")
    return out


def _period_apply(period, h, positions, memory, *ms):
    """One period's layers over ``h``; ``ms``: the running MoE metrics in
    ``METRICS`` order (none when the caller keeps none), returned after
    the period's are added."""
    metrics = dict(zip(METRICS, ms)) if ms else None
    for layer in period:
        h = layer(h, positions, metrics, memory)
    return (h,) + (tuple(metrics[k] for k in METRICS) if ms else ())


def _recompute_context():
    """``context_fn`` of a period's checkpoint: the forward runs as it
    is; its recompute sees the thread-local state the forward saw (the
    plan context, the capture record, the activation mesh), so it
    launches the same kernels on the same plans and a graph captured
    around it keeps what it reads, and records no telemetry again."""
    ctx = sparse_api.current_ctx()
    rec = capture.active()
    mesh, split = rules.current_mesh(), rules.batch_split()

    @contextlib.contextmanager
    def again():
        with sparse_api.use_ctx(ctx), capture.recomputing(rec), \
                rules.activation_mesh(mesh, batch_split=split):
            yield
    return contextlib.nullcontext(), again()


def stack_apply(layers, h, *, positions, metrics=None, memory=None):
    """Full-sequence stack; with a ``metrics`` dict (``zero_metrics``)
    the MoE layers' metrics are summed into it; ``memory`` is what cross
    layers attend over.  Under ``cfg.remat == "full"`` with gradients on,
    each period is checkpointed (module docstring); the metrics are then
    the period's outputs, never added to in its recompute."""
    remat = layers[0].cfg.remat if len(layers) else "none"
    if remat not in REMAT:
        raise ValueError(f"remat {remat!r}: one of {REMAT}")
    keep = torch.is_grad_enabled() and remat != "none"
    if keep and remat == "dots":
        raise NotImplementedError(
            "remat='dots' (save the dense products' outputs) is not "
            "ported: the projections are hand-written kernels behind "
            "autograd Functions (ROADMAP queue 1, item 11b.5)")
    ms = tuple(metrics[k] for k in METRICS) if metrics is not None else ()
    for period in periods(layers):
        if keep:
            out = torch_checkpoint.checkpoint(
                _period_apply, period, h, positions, memory, *ms,
                use_reentrant=False, preserve_rng_state=False,
                context_fn=_recompute_context)
        else:
            out = _period_apply(period, h, positions, memory, *ms)
        h, ms = out[0], out[1:]
    if metrics is not None:
        metrics.update(zip(METRICS, ms))
    return h


def stack_prefill(layers, h, *, positions, max_len: int, memory=None):
    caches = []
    for layer in layers:
        h, c = layer.prefill(h, positions, max_len=max_len, memory=memory)
        caches.append(c)
    return h, caches


def stack_decode(layers, h, caches, *, positions, slot=None,
                 window_filter: bool = True):
    for layer, cache in zip(layers, caches):
        h, _ = layer.decode(h, cache, positions, slot=slot,
                            window_filter=window_filter)
    return h, caches


def stack_cache_init(cfg: ModelCfg, batch: int, max_len: int, *,
                     dtype: torch.dtype, device,
                     memory_len: int = 0,
                     kv_heads: Optional[int] = None,
                     ssm_heads: Optional[int] = None,
                     cross_kv_heads: Optional[int] = None) -> List[Cache]:
    """Each layer's cache by its mixer: ``{"k", "v"}`` of an attention
    layer, ``{"latent", "k_rope"}`` of an MLA layer (no heads: whole on
    every rank of a model-parallel mesh), ``{"state", "conv"}`` of a
    mamba layer (fp32 ``[B, H, P, N]`` and ``[B, d_conv - 1,
    conv_dim]``; no ``max_len`` axis); a cross layer's also ``{"xk",
    "xv"}``, zeros of ``[B, memory_len, KV, dh]``.  ``kv_heads``,
    ``ssm_heads`` and ``cross_kv_heads`` are a model-parallel rank's
    heads of a GQA, a Mamba-2 and a cross layer (its caches hold only
    those)."""
    caches = []
    for spec in layer_specs(cfg):
        if spec.mixer == "mamba":
            c = ssm_cache_init(cfg, batch, dtype=dtype, device=device,
                               heads=ssm_heads)
        elif spec.mixer == "mla":
            c = mla_cache_init(cfg, batch, max_len, dtype=dtype,
                               device=device)
        else:
            c = gqa_cache_init(cfg, batch, max_len, dtype=dtype,
                               device=device, kv_heads=kv_heads)
        if spec.cross:
            shape = (batch, memory_len, cross_kv_heads or cfg.num_kv_heads,
                     cfg.head_dim)
            c["xk"] = torch.zeros(shape, dtype=dtype, device=device)
            c["xv"] = torch.zeros(shape, dtype=dtype, device=device)
        caches.append(c)
    return caches
