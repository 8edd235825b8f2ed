"""Top-level language model: embeddings + layer stack(s) + prefill / decode.

Counterpart of the JAX package's ``models/model.py`` ``LM`` for stacks
of global and local (sliding-window) GQA layers, MLA layers and Mamba-2
(SSD) layers, alone or interleaved (the jamba hybrid), with Gemma's
embedding scale, pre+post norms and soft-caps, and dense, sparse, MoE or
no FFNs (``forward``, ``loss``, ``prefill(last_index=)``,
``init_cache``, ``decode_step``).  ``decode_step(retained=True)`` is
the reference's long-context decode: the cache of ``retained_prefix +
retained_window`` slots is written as a ring (``_ring_slot``: position
``p`` to slot ``p`` while ``p < g + w``, else ``g + (p - g) % w``), and
a local layer attends to the whole retained set (no window filter) --
the paper's static block sparsity applied to the KV cache.  The
``long_attention`` field is read nowhere, as in the reference.  The
two frontends are the reference's: a VLM's precomputed patch embeddings
(``frontend=`` ``[B, F, D]``) are cast to the model's dtype and
prepended to the token rows, positions ``0 .. F + S - 1``, and dropped
again after the final norm; an encoder-decoder's precomputed frame
embeddings (``enc_frames=`` ``[B, T, D]``) run through the
bidirectional encoder (``encoder_layers`` attention + MLP layers and
``enc_norm``), whose output is the memory the decoder's cross layers
attend over.  The frames are cast to the model's dtype first (the
reference feeds them uncast; at the model's dtype the two agree).
``loss`` of an MoE config adds the router losses, as the reference's
does.  ``forward(..., return_metrics=True)`` also
returns the stack metrics the reference's ``forward`` returns
(``aux_loss``, ``z_loss``, ``dropped_frac``, summed over the layers;
zeros without MoE).  ``LM`` is an ``nn.Module`` that holds its
parameters: ``init(seed)`` fills them from a seeded ``torch.Generator``,
``load_jax_params(tree)`` copies them from the JAX package's params
pytree converted to numpy, ``load_jax_train_state`` its optimizer state
as well.  Parameters are created frozen (serving); ``requires_grad_(True)``
makes them trainable, and ``loss`` is then differentiable.  ``forward``,
``prefill`` and ``decode_step`` always run under ``no_grad``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint as torch_checkpoint

from repro_torch.core import tp as tp_lib
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.launch.mesh import Held, is_concrete
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import GQA, Cache
from repro_torch.models.config import LayerSpec, ModelCfg
from repro_torch.models.layers import Embedding, RMSNorm, embed, unembed

# the fp32 logits of one loss chunk stay under this many bytes: a
# vocabulary the "model" axis does not split (seamless's 256206 rows
# over 16 ranks) is whole on every rank, and the reference's 1024-token
# chunk of a rank's 16 rows would hold 16.8 GB of it
LOSS_CHUNK_BYTES = 4 << 30


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


def _unstack(cfg: ModelCfg, stack, prefix: str) -> Dict[str, Any]:
    """A JAX ``stack_init`` tree keyed by the port's per-layer names
    (``{prefix}.{i}.…``): the stacked ``[repeat, ...]`` axis of each
    period unstacked, layer ``i`` in execution order."""
    out, li = {}, 0
    for (period, repeat), group in zip(cfg.groups, stack):
        flat = [_flatten(pos) for pos in group]
        for r in range(repeat):
            for si in range(len(period)):
                idx = li + r * len(period) + si
                out.update({f"{prefix}.{idx}.{k}": v[r]
                            for k, v in flat[si].items()})
        li += repeat * len(period)
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


def encoder_cfg(cfg: ModelCfg) -> ModelCfg:
    """``LM._encoder_cfg``: ``cfg`` with the encoder's stack, bidirectional
    attention + MLP layers ``encoder_layers`` deep (no groups without an
    encoder)."""
    spec = LayerSpec(mixer="attn", ffn="mlp", causal=False)
    groups = (((spec,), cfg.encoder_layers),) if cfg.encoder_layers else ()
    return dataclasses.replace(cfg, groups=groups)


class LM(nn.Module):
    """LM on ``device`` (``cuda`` unless the caller passes another device;
    without a card only an explicit ``"cpu"`` runs; on ``"meta"`` it has
    shapes only, for the sharding rules).  ``mesh`` reaches the MoE
    layers: on a concrete mesh each holds only its rank's blocks of the
    expert stacks (``models/moe.py``).

    Model parallelism: on a concrete mesh whose ``"model"`` axis has
    m > 1 ranks, the mixers whose heads split over it (GQA, MLA,
    Mamba-2 and cross attention, the encoder's layers among them), the
    MLPs (an MoE's shared experts among them), the sparse FFNs, the
    experts and the embedding and unembedding tables are split over that
    axis by the reference's rules (``held_blocks``; the layers'
    docstrings), and every rank runs the same program.  ``forward``,
    ``prefill`` and ``decode_step`` return the whole logits (gathered
    over the vocabulary; ``gather=False`` keeps the rank's columns,
    which ``greedy`` samples); ``loss`` is the vocab-parallel
    cross-entropy.  A mixer whose heads do not split
    (``attention.head_split``, ``attention.ssd_head_split``), the norms
    and the MoE router run whole on every rank."""

    def __init__(self, cfg: ModelCfg, *, device: DeviceLike = None,
                 seed: int = 0, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = tfm.model_dtype(cfg)
        self.mesh = mesh
        dev = self.device
        self.embed = Embedding(cfg.vocab_size, cfg.d_model,
                               dtype=self.dtype, device=dev, mesh=mesh)
        self.layers = nn.ModuleList(
            tfm.Layer(cfg, spec, device=dev, mesh=mesh)
            for spec in tfm.layer_specs(cfg))
        self.final_norm = RMSNorm(cfg.d_model, plus_one=cfg.post_norm,
                                  device=dev)
        self.lm_head = (None if cfg.tie_embeddings else
                        Embedding(cfg.vocab_size, cfg.d_model,
                                  dtype=self.dtype, device=dev, mesh=mesh))
        self.encoder = self.enc_norm = None
        if cfg.encoder_layers:
            ecfg = encoder_cfg(cfg)
            self.encoder = nn.ModuleList(
                tfm.Layer(ecfg, spec, device=dev, mesh=mesh)
                for spec in tfm.layer_specs(ecfg))
            self.enc_norm = RMSNorm(cfg.d_model, plus_one=cfg.post_norm,
                                    device=dev)
        if dev.type != "meta":
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
        is unstacked into the per-layer modules (``layers``, and an
        encoder's ``encoder``)."""
        out = {"embed.table": tree["embed"]["table"],
               "final_norm.scale": tree["final_norm"]["scale"]}
        if self.lm_head is not None:
            out["lm_head.table"] = tree["lm_head"]["table"]
        out.update(_unstack(self.cfg, tree["stack"], "layers"))
        if self.encoder is not None:
            out.update(_unstack(encoder_cfg(self.cfg), tree["encoder"],
                                "encoder"))
            out["enc_norm.scale"] = tree["enc_norm"]["scale"]
        return out

    def leaf_groups(self) -> List[tuple]:
        """This model's parameter names grouped as the reference's
        parameter tree holds them: the layers at one position of a
        period share one stacked ``[repeat, ...]`` leaf there, every
        other parameter is a leaf of its own.  Gradient compression
        takes one scale per group, as the reference takes one per
        leaf."""
        stacks = [("layers", self.cfg)]
        if self.encoder is not None:
            stacks.append(("encoder", encoder_cfg(self.cfg)))
        key_of = {}
        for prefix, cfg in stacks:
            li = 0
            for g, (period, repeat) in enumerate(cfg.groups):
                for r in range(repeat):
                    for si in range(len(period)):
                        key_of[f"{prefix}.{li + r * len(period) + si}"] = \
                            (prefix, g, si)
                li += repeat * len(period)
        groups: Dict[Any, List[str]] = {}
        for name, _ in self.named_parameters():
            head, _, rest = name.partition(".")
            idx, _, leaf = rest.partition(".")
            pos = key_of.get(f"{head}.{idx}")
            groups.setdefault(name if pos is None else (pos, leaf),
                              []).append(name)
        return [tuple(g) for g in groups.values()]

    def held_blocks(self) -> Dict[str, Any]:
        """``{name: launch.mesh.Held}`` of the parameters this rank holds
        as a block of the whole tensor, or whose gradient is a partial
        sum over the ranks (built with ``mesh``): an MoE's expert stacks,
        every weight the rules split over ``"data"`` (FSDP), and on a
        model-parallel mesh the split projections and tables, a sparse
        FFN's k-shards, the norms inside split heads and a Mamba-2
        mixer's in projection, conv and per-head parameters."""
        return {f"{prefix}.{leaf}": held
                for prefix, mod in self.named_modules()
                for leaf, held in getattr(mod, "held", {}).items()}

    @torch.no_grad()
    def gather_data(self) -> "LM":
        """Hold every parameter whole over ``"data"``: each block split
        over it (FSDP) gathered once, in place (``core.tp.all_gather_dim``;
        every rank calls it), so no forward gathers again.  What a
        serving engine runs from (``Engine``); the blocks are then no
        longer the rules', so the model is not trained after it."""
        for mod in self.modules():
            held = getattr(mod, "held", None) or {}
            for leaf, h in list(held.items()):
                d = h.data
                if d is None:
                    continue
                p = getattr(mod, leaf)
                p.data = tp_lib.all_gather_dim(p.data, d.group, d.dim,
                                               d.idx, d.n)
                held[leaf] = Held.whole(h.block.whole_on(d.dim),
                                        partial=h.partial)
        return self

    def load_jax_params(self, tree) -> "LM":
        """Copy the JAX ``LM.init`` params pytree (leaves converted to
        numpy) into this model (a held block takes its part of the
        leaf)."""
        leaves = self.jax_leaves(tree)
        for name, held in self.held_blocks().items():
            leaves[name] = held.block.take(np.asarray(leaves[name]))
        _copy_into(dict(self.named_parameters()), leaves, "LM")
        return self

    def load_jax_train_state(self, state):
        """Copy a JAX ``train.step.TrainState`` (leaves converted to
        numpy; the NamedTuple or a dict of its fields) into this model,
        make its parameters trainable, and return the port's
        ``TrainState`` over it: the params, the step, and the
        ``AdamState`` count (both 0-dim int32 tensors on the model's
        device, as the reference keeps them) with its fp32 master, mu
        and nu, and the compression residuals (``ef``) where the
        reference's state has them.  On a concrete mesh the state is
        this rank's blocks (``train.step.ShardLayout``), each leaf's part
        taken."""
        from repro_torch.optim.adamw import AdamState
        from repro_torch.train.step import TrainState

        def field(obj, name):
            return obj[name] if isinstance(obj, dict) else getattr(obj, name)

        self.load_jax_params(field(state, "params"))
        self.requires_grad_(True)
        opt = field(state, "opt")
        names = [n for n, _ in self.named_parameters()]
        layout = None
        if is_concrete(self.mesh):
            from repro_torch.train.step import ShardLayout
            layout = ShardLayout(self, self.mesh)

        def fp32(tree):
            leaves = self.jax_leaves(tree)
            if layout is not None:
                leaves = {n: layout.place[n].state.take(np.asarray(leaves[n]))
                          for n in names}
            return {n: torch.as_tensor(np.array(leaves[n], np.float32),
                                       device=self.device) for n in names}

        adam = AdamState(count=int(np.asarray(field(opt, "count"))),
                         master=fp32(field(opt, "master")),
                         mu=fp32(field(opt, "mu")),
                         nu=fp32(field(opt, "nu")))
        ef = field(state, "ef") if (isinstance(state, dict) and "ef" in state
                                    or hasattr(state, "ef")) else None
        if ef is not None:
            from repro_torch.optim.compress import EFState
            ef = EFState(fp32(field(ef, "residual")))
        return TrainState(step=int(np.asarray(field(state, "step"))),
                          params=dict(self.named_parameters()), opt=adam,
                          ef=ef, layout=layout)

    # -- plumbing ---------------------------------------------------------------
    def _tokens(self, tokens) -> torch.Tensor:
        """Token or index ids as a long tensor on the model's device: a
        long tensor already there is returned as it is, with no copy (a
        captured program reads the engine's device buffers through it);
        anything else is copied there."""
        return torch.as_tensor(tokens, device=self.device).long()

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """Token rows, times ``sqrt(d_model)`` cast to their dtype with
        ``cfg.embed_scale`` (Gemma); a split table's rows all-reduced
        over the vocabulary's ranks."""
        table = self.embed.weight()
        if self.embed.group is None:
            h = embed(table, tokens)
        else:
            h = tp_lib.vocab_embed(table, tokens, self.embed.v0,
                                   self.embed.group)
        if self.cfg.embed_scale:
            h = h * torch.tensor(np.sqrt(self.cfg.d_model), dtype=h.dtype)
        return h

    @property
    def _head(self) -> Embedding:
        return self.lm_head if self.lm_head is not None else self.embed

    def _unembed(self, h: torch.Tensor, gather: bool = True,
                 table: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits of ``h``: the whole vocabulary, or with ``gather=False``
        a split table's own columns (the input through
        ``copy_to_group``, so its gradient sums every rank's).  ``table``:
        the head's rows as ``Embedding.weight()`` gives them (gathered
        over ``"data"`` here when None)."""
        head = self._head
        table = head.weight() if table is None else table
        if head.group is None:
            return unembed(table, h, softcap=self.cfg.final_softcap)
        logits = unembed(table, tp_lib.copy_to_group(h, head.group),
                         softcap=self.cfg.final_softcap)
        if not gather:
            return logits
        return tp_lib.gather_vocab(logits, head.v0, head.vocab, head.group)

    def greedy(self, logits: torch.Tensor):
        """``(greedy ids, every logit finite)`` of ``logits`` as
        ``prefill`` / ``decode_step(gather=False)`` return them: the
        whole vocabulary's, or a split table's columns (the argmax over
        the ranks, ``core.tp.vocab_argmax``)."""
        head = self._head
        if head.group is None or logits.shape[-1] == head.vocab:
            return torch.argmax(logits, dim=-1), torch.isfinite(logits).all()
        return tp_lib.vocab_argmax(logits, head.v0, head.group)

    def _final(self, h: torch.Tensor) -> torch.Tensor:
        return self.final_norm(h, eps=self.cfg.norm_eps)

    def _floats(self, x) -> torch.Tensor:
        """Frontend rows or frames in the model's dtype on its device (a
        tensor already so is returned as it is)."""
        return torch.as_tensor(x, device=self.device).to(self.dtype)

    def _encode(self, enc_frames) -> torch.Tensor:
        """``_encode``: the bidirectional encoder over the frames,
        positions ``0 .. T - 1``, then ``enc_norm``."""
        if self.encoder is None:
            raise ValueError(f"{self.cfg.name} has no encoder: enc_frames "
                             f"are not taken")
        h = self._floats(enc_frames)
        positions = torch.arange(h.shape[1], device=self.device)[None, :]
        h = tfm.stack_apply(self.encoder, h, positions=positions)
        return self.enc_norm(h, eps=self.cfg.norm_eps)

    def _prepare(self, t: torch.Tensor, frontend, enc_frames):
        """``_prepare``: the embedded tokens with the frontend's rows in
        front, their positions, the encoder's memory (None without
        frames) and the frontend's length ``n_prefix``."""
        h = self._embed(t)
        n_prefix = 0
        if frontend is not None:
            f = self._floats(frontend)
            h = torch.cat([f, h], dim=1)
            n_prefix = f.shape[1]
        positions = torch.arange(h.shape[1], device=self.device)[None, :]
        memory = None if enc_frames is None else self._encode(enc_frames)
        return h, positions, memory, n_prefix

    # -- entry points -------------------------------------------------------------
    @torch.no_grad()
    def forward(self, tokens, *, frontend=None, enc_frames=None,
                return_metrics: bool = False):
        """Full-sequence logits ``[B, S, V]`` for tokens ``[B, S]`` (the
        frontend's rows dropped after the final norm); with
        ``return_metrics`` ``(logits, metrics)``, the stack metrics as
        fp32 device scalars."""
        h, positions, memory, n_prefix = self._prepare(
            self._tokens(tokens), frontend, enc_frames)
        metrics = tfm.zero_metrics(self.device) if return_metrics else None
        h = tfm.stack_apply(self.layers, h, positions=positions,
                            metrics=metrics, memory=memory)
        logits = self._unembed(self._final(h)[:, n_prefix:])
        return (logits, metrics) if return_metrics else logits

    def loss(self, tokens, targets, *, frontend=None, enc_frames=None,
             loss_chunk: int = 1024):
        """Next-token cross entropy in fp32 for tokens/targets ``[B, S]``
        (a ``-1`` target is padding), with a VLM's ``frontend`` or an
        encoder-decoder's ``enc_frames`` as ``forward`` takes them.
        Returns ``(loss, metrics)``: ``{"xent"}`` for a dense config;
        for an MoE config ``loss = xent + router_aux_weight * aux_loss +
        router_z_weight * z_loss`` and the metrics ``aux_loss``, ``z_loss``, ``dropped_frac`` (each
        summed over the layers) and ``xent``, as the reference's
        ``LM.loss``.  The returned metrics are detached.

        The unembed and the logsumexp run over sequence chunks of
        ``loss_chunk`` (halved until it divides S and its fp32 logits,
        over the vocabulary rows this rank holds, fit
        ``LOSS_CHUNK_BYTES``), each recomputed in
        the backward (activation checkpointing), so the ``[B, S, V]``
        logits are never held whole: one chunk's fp32 logits at a time.
        A chunk draws no random numbers, so its recompute neither saves
        nor restores the generators' states (a CUDA-graph capture may
        refuse a read of the CUDA generator's state).
        """
        moe = self.cfg.moe
        tg = self._tokens(targets)
        h, positions, memory, n_prefix = self._prepare(
            self._tokens(tokens), frontend, enc_frames)
        metrics = tfm.zero_metrics(self.device) if moe is not None else None
        h = self._final(tfm.stack_apply(
            self.layers, h, positions=positions, metrics=metrics,
            memory=memory))[:, n_prefix:]
        s = tg.shape[1]
        c = min(loss_chunk, s)
        row_bytes = tg.shape[0] * self._head.table.shape[0] * 4
        while s % c or (c > 1 and c * row_bytes > LOSS_CHUNK_BYTES):
            c //= 2
        tot = torch.zeros((), dtype=torch.float32, device=self.device)
        cnt = torch.zeros((), dtype=torch.float32, device=self.device)
        # the head's rows gathered over "data" once for every chunk
        table = self._head.weight()
        for i in range(0, s, c):
            hx, tx = h[:, i:i + c], tg[:, i:i + c]
            if torch.is_grad_enabled() and hx.requires_grad:
                nll, valid = torch_checkpoint.checkpoint(
                    self._chunk_nll, hx, tx, table, use_reentrant=False,
                    preserve_rng_state=False)
            else:
                nll, valid = self._chunk_nll(hx, tx, table)
            tot = tot + nll
            cnt = cnt + valid
        xent = tot / torch.clamp(cnt, min=1.0)
        loss = xent
        if moe is not None:
            loss = loss + moe.router_aux_weight * metrics["aux_loss"] \
                + moe.router_z_weight * metrics["z_loss"]
        out = {k: v.detach() for k, v in (metrics or {}).items()}
        out["xent"] = xent.detach()
        return loss, out

    def _chunk_nll(self, hx: torch.Tensor, tx: torch.Tensor,
                   table: torch.Tensor):
        """Summed NLL and count of valid targets over one chunk (over a
        split vocabulary, ``core.tp.vocab_nll``)."""
        valid = (tx >= 0).float()
        head = self._head
        if head.group is not None:
            nll = tp_lib.vocab_nll(self._unembed(hx, False, table), tx,
                                   head.v0, head.group)
            return (nll * valid).sum(), valid.sum()
        logits = self._unembed(hx, table=table).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            torch.clamp(tx, min=0)[..., None])[..., 0]
        return ((lse - gold) * valid).sum(), valid.sum()

    def init_cache(self, batch: int, max_len: int, *,
                   memory_len: int = 0) -> List[Cache]:
        """Every layer's cache; ``memory_len`` is the encoder memory's
        length the cross layers' ``xk`` / ``xv`` hold."""
        def first(heads):
            return next(iter(heads), None)
        layers = list(self.layers)
        return tfm.stack_cache_init(
            self.cfg, batch, max_len, dtype=self.dtype, device=self.device,
            memory_len=memory_len,
            kv_heads=first(layer.attn.kv_heads for layer in layers
                           if isinstance(getattr(layer, "attn", None),
                                         GQA)),
            ssm_heads=first(layer.mixer.heads for layer in layers
                            if layer.ssm),
            cross_kv_heads=first(layer.cross.kv_heads for layer in layers
                                 if layer.cross is not None))

    @torch.no_grad()
    def prefill(self, tokens, *, max_len: int, frontend=None,
                enc_frames=None, last_index: Optional[Any] = None,
                gather: bool = True):
        """Returns ``(logits [B, V], caches)`` (``gather=False``: a split
        vocabulary's own columns, for ``greedy``).  ``last_index`` ``[B]``
        gathers each row's logits at its true last prompt token (the
        serving engine right-pads prompts to a bucket).  With a
        ``frontend`` of F rows the sequence is ``F + S`` long: it must
        fit ``max_len``, ``last_index`` counts those positions, and the
        decode steps after go on from position ``F + S``."""
        t = self._tokens(tokens)
        n = t.shape[1] + (0 if frontend is None else frontend.shape[1])
        if n > max_len:
            raise ValueError(f"prompt of {n} positions exceeds "
                             f"max_len={max_len}")
        h, positions, memory, _ = self._prepare(t, frontend, enc_frames)
        h, caches = tfm.stack_prefill(self.layers, h, positions=positions,
                                      max_len=max_len, memory=memory)
        if last_index is None:
            h = h[:, -1:]
        else:
            idx = self._tokens(last_index).reshape(-1, 1, 1)
            h = torch.gather(h, 1, idx.expand(h.shape[0], 1, h.shape[2]))
        return self._unembed(self._final(h), gather)[:, 0], caches

    def _ring_slot(self, positions: torch.Tensor) -> torch.Tensor:
        """The cache slot of each position in a retained (local + global)
        ring cache: ``p`` while ``p < g + w``, else ``g + (p - g) % w``.
        Device ops only (no host read), so a captured decode step computes
        it from its positions buffer."""
        g, w = self.cfg.retained_prefix, self.cfg.retained_window
        return torch.where(positions < g + w, positions,
                           g + torch.remainder(positions - g, w))

    @torch.no_grad()
    def decode_step(self, tokens, caches: List[Cache], positions, *,
                    retained: bool = False, gather: bool = True):
        """One token per row: tokens ``[B, 1]``, positions ``[B]``.
        Returns ``(logits [B, V], caches)`` (``gather`` as ``prefill``
        takes it); the caches are updated in
        place.  ``retained`` writes the new K/V at the ring slot of each
        position (``_ring_slot``; RoPE keeps the true position) and lets a
        local layer attend to every retained slot, as the reference's
        ``decode_step(retained=True)`` does."""
        t = self._tokens(tokens)
        pos = self._tokens(positions)
        h = self._embed(t)
        slot = self._ring_slot(pos) if retained else pos
        h, caches = tfm.stack_decode(self.layers, h, caches, positions=pos,
                                     slot=slot, window_filter=not retained)
        return self._unembed(self._final(h), gather)[:, 0], caches
