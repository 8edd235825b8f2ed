"""Top-level language model: embeddings + layer stack + prefill / decode.

Counterpart of the JAX package's ``models/model.py`` ``LM`` for decoder-
only attention stacks, global and local (sliding-window) layers, with
Gemma's embedding scale, pre+post norms and soft-caps, and dense, sparse
or MoE FFNs (``forward``, ``loss``, ``prefill(last_index=)``,
``init_cache``, ``decode_step``; the retained ring cache, the encoder and
the frontends wait, and ``loss`` of an MoE config waits for MoE
training).  ``forward(..., return_metrics=True)`` also returns the
stack metrics the reference's ``forward`` returns (``aux_loss``,
``z_loss``, ``dropped_frac``, summed over the layers; zeros without
MoE).  ``LM`` is an
``nn.Module`` that holds its parameters: ``init(seed)`` fills them from a
seeded ``torch.Generator``,
``load_jax_params(tree)`` copies them from the JAX package's params
pytree converted to numpy, ``load_jax_train_state`` its optimizer state
as well.  Parameters are created frozen (serving); ``requires_grad_(True)``
makes them trainable, and ``loss`` is then differentiable.  ``forward``,
``prefill`` and ``decode_step`` always run under ``no_grad``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint as torch_checkpoint

from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import Cache
from repro_torch.models.config import ModelCfg
from repro_torch.models.layers import Embedding, RMSNorm, embed, unembed

# fields of ModelCfg the port does not implement yet, with the value it
# requires
_UNSUPPORTED = {"attn_impl": "gqa", "ssm": None,
                "encoder_layers": 0, "frontend": None,
                "long_attention": "full"}


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """Nested dicts -> ``{"a.b.c": leaf}``."""
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(_flatten(val, name + "."))
        else:
            out[name] = val
    return out


def _copy_into(params: Dict[str, nn.Parameter], leaves: Dict[str, Any],
               where: str) -> None:
    if set(params) != set(leaves):
        raise ValueError(
            f"{where}: JAX leaves and port parameters differ: only in JAX "
            f"{sorted(set(leaves) - set(params))}, only in the port "
            f"{sorted(set(params) - set(leaves))}")
    for name, p in params.items():
        arr = np.array(leaves[name], dtype=np.float32)
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{where}.{name}: shape {arr.shape} != "
                             f"{tuple(p.shape)}")
        with torch.no_grad():
            p.copy_(torch.as_tensor(arr).to(p.dtype))


class LM(nn.Module):
    """Decoder-only LM on ``device`` (``cuda`` unless the caller passes
    another device; without a card only an explicit ``"cpu"`` runs)."""

    def __init__(self, cfg: ModelCfg, *, device: DeviceLike = None,
                 seed: int = 0):
        super().__init__()
        for field, want in _UNSUPPORTED.items():
            if getattr(cfg, field) != want:
                raise NotImplementedError(
                    f"{cfg.name}: {field}={getattr(cfg, field)!r} is not "
                    f"ported yet (the port needs {want!r})")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = tfm.model_dtype(cfg)
        dev = self.device
        self.embed = Embedding(cfg.vocab_size, cfg.d_model,
                               dtype=self.dtype, device=dev)
        self.layers = nn.ModuleList(
            tfm.Layer(cfg, spec, device=dev)
            for spec in tfm.layer_specs(cfg))
        self.final_norm = RMSNorm(cfg.d_model, plus_one=cfg.post_norm,
                                  device=dev)
        self.lm_head = (None if cfg.tie_embeddings else
                        Embedding(cfg.vocab_size, cfg.d_model,
                                  dtype=self.dtype, device=dev))
        self.init(seed)

    # -- weights --------------------------------------------------------------
    def init(self, seed: int) -> "LM":
        """Fill every parameter from one seeded generator, module by
        module in registration order."""
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        for mod in self.modules():
            if mod is not self and hasattr(mod, "reset_parameters"):
                mod.reset_parameters(gen)
        return self

    def jax_leaves(self, tree) -> Dict[str, Any]:
        """A JAX params-shaped pytree (params, grads, or an optimizer's
        master/mu/nu; leaves as numpy) keyed by this model's parameter
        names.  The stacked ``[repeat, ...]`` layer axis of each period
        is unstacked into the per-layer modules."""
        out = {"embed.table": tree["embed"]["table"],
               "final_norm.scale": tree["final_norm"]["scale"]}
        if self.lm_head is not None:
            out["lm_head.table"] = tree["lm_head"]["table"]
        li = 0
        for (period, repeat), group in zip(self.cfg.groups, tree["stack"]):
            flat = [_flatten(pos) for pos in group]
            for r in range(repeat):
                for si in range(len(period)):
                    idx = li + r * len(period) + si
                    out.update({f"layers.{idx}.{k}": v[r]
                                for k, v in flat[si].items()})
            li += repeat * len(period)
        return out

    def load_jax_params(self, tree) -> "LM":
        """Copy the JAX ``LM.init`` params pytree (leaves converted to
        numpy) into this model."""
        _copy_into(dict(self.named_parameters()), self.jax_leaves(tree),
                   "LM")
        return self

    def load_jax_train_state(self, state):
        """Copy a JAX ``train.step.TrainState`` (leaves converted to
        numpy; the NamedTuple or a dict of its fields) into this model,
        make its parameters trainable, and return the port's
        ``TrainState`` over it: the params, the step, and the
        ``AdamState`` count with its fp32 master, mu and nu.
        Gradient-compression state is not ported."""
        from repro_torch.optim.adamw import AdamState
        from repro_torch.train.step import TrainState

        def field(obj, name):
            return obj[name] if isinstance(obj, dict) else getattr(obj, name)

        self.load_jax_params(field(state, "params"))
        self.requires_grad_(True)
        opt = field(state, "opt")
        names = [n for n, _ in self.named_parameters()]

        def fp32(tree):
            leaves = self.jax_leaves(tree)
            return {n: torch.as_tensor(np.array(leaves[n], np.float32),
                                       device=self.device) for n in names}

        adam = AdamState(count=int(np.asarray(field(opt, "count"))),
                         master=fp32(field(opt, "master")),
                         mu=fp32(field(opt, "mu")),
                         nu=fp32(field(opt, "nu")))
        return TrainState(step=int(np.asarray(field(state, "step"))),
                          params=dict(self.named_parameters()), opt=adam)

    # -- plumbing ---------------------------------------------------------------
    def _tokens(self, tokens) -> torch.Tensor:
        """Token or index ids as a long tensor on the model's device: a
        long tensor already there is returned as it is, with no copy (a
        captured program reads the engine's device buffers through it);
        anything else is copied there."""
        return torch.as_tensor(tokens, device=self.device).long()

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """Token rows, times ``sqrt(d_model)`` cast to their dtype with
        ``cfg.embed_scale`` (Gemma)."""
        h = embed(self.embed.table, tokens)
        if self.cfg.embed_scale:
            h = h * torch.tensor(np.sqrt(self.cfg.d_model), dtype=h.dtype)
        return h

    def _unembed(self, h: torch.Tensor) -> torch.Tensor:
        head = self.lm_head if self.lm_head is not None else self.embed
        table = head.table
        return unembed(table, h, softcap=self.cfg.final_softcap)

    def _final(self, h: torch.Tensor) -> torch.Tensor:
        return self.final_norm(h, eps=self.cfg.norm_eps)

    # -- entry points -------------------------------------------------------------
    @torch.no_grad()
    def forward(self, tokens, *, return_metrics: bool = False):
        """Full-sequence logits ``[B, S, V]`` for tokens ``[B, S]``; with
        ``return_metrics`` ``(logits, metrics)``, the stack metrics as
        fp32 device scalars."""
        t = self._tokens(tokens)
        h = self._embed(t)
        positions = torch.arange(t.shape[1], device=self.device)[None, :]
        metrics = tfm.zero_metrics(self.device) if return_metrics else None
        h = tfm.stack_apply(self.layers, h, positions=positions,
                            metrics=metrics)
        logits = self._unembed(self._final(h))
        return (logits, metrics) if return_metrics else logits

    def loss(self, tokens, targets, *, loss_chunk: int = 1024):
        """Next-token cross entropy in fp32 for tokens/targets ``[B, S]``
        (a ``-1`` target is padding).  Returns ``(loss, {"xent": ...})``.

        The unembed and the logsumexp run over sequence chunks of
        ``loss_chunk`` (halved until it divides S), each recomputed in
        the backward (activation checkpointing), so the ``[B, S, V]``
        logits are never held whole: one chunk's fp32 logits at a time.
        An MoE config raises: its router losses and the expert GEMMs'
        backward wait for the MoE training slice.
        """
        if self.cfg.moe is not None:
            raise NotImplementedError(
                f"{self.cfg.name}: LM.loss of an MoE config is not ported "
                f"yet (serving only)")
        t = self._tokens(tokens)
        tg = self._tokens(targets)
        h = self._embed(t)
        positions = torch.arange(t.shape[1], device=self.device)[None, :]
        h = self._final(tfm.stack_apply(self.layers, h,
                                        positions=positions))
        s = tg.shape[1]
        c = min(loss_chunk, s)
        while s % c:
            c //= 2
        tot = torch.zeros((), dtype=torch.float32, device=self.device)
        cnt = torch.zeros((), dtype=torch.float32, device=self.device)
        for i in range(0, s, c):
            hx, tx = h[:, i:i + c], tg[:, i:i + c]
            if torch.is_grad_enabled() and hx.requires_grad:
                nll, valid = torch_checkpoint.checkpoint(
                    self._chunk_nll, hx, tx, use_reentrant=False)
            else:
                nll, valid = self._chunk_nll(hx, tx)
            tot = tot + nll
            cnt = cnt + valid
        xent = tot / torch.clamp(cnt, min=1.0)
        return xent, {"xent": xent.detach()}

    def _chunk_nll(self, hx: torch.Tensor, tx: torch.Tensor):
        """Summed NLL and count of valid targets over one chunk."""
        logits = self._unembed(hx).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            torch.clamp(tx, min=0)[..., None])[..., 0]
        valid = (tx >= 0).float()
        return ((lse - gold) * valid).sum(), valid.sum()

    def init_cache(self, batch: int, max_len: int) -> List[Cache]:
        return tfm.stack_cache_init(self.cfg, batch, max_len,
                                    dtype=self.dtype, device=self.device)

    @torch.no_grad()
    def prefill(self, tokens, *, max_len: int,
                last_index: Optional[Any] = None):
        """Returns ``(logits [B, V], caches)``.  ``last_index`` ``[B]``
        gathers each row's logits at its true last prompt token (the
        serving engine right-pads prompts to a bucket)."""
        t = self._tokens(tokens)
        if t.shape[1] > max_len:
            raise ValueError(f"prompt of {t.shape[1]} tokens exceeds "
                             f"max_len={max_len}")
        h = self._embed(t)
        positions = torch.arange(t.shape[1], device=self.device)[None, :]
        h, caches = tfm.stack_prefill(self.layers, h, positions=positions,
                                      max_len=max_len)
        if last_index is None:
            h = h[:, -1:]
        else:
            idx = self._tokens(last_index).reshape(-1, 1, 1)
            h = torch.gather(h, 1, idx.expand(h.shape[0], 1, h.shape[2]))
        return self._unembed(self._final(h))[:, 0], caches

    @torch.no_grad()
    def decode_step(self, tokens, caches: List[Cache], positions):
        """One token per row: tokens ``[B, 1]``, positions ``[B]``.
        Returns ``(logits [B, V], caches)``; the caches are updated in
        place."""
        t = self._tokens(tokens)
        pos = self._tokens(positions)
        h = self._embed(t)
        h, caches = tfm.stack_decode(self.layers, h, caches, positions=pos)
        return self._unembed(self._final(h))[:, 0], caches
