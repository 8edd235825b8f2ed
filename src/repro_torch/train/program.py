"""The train step as one program over a persistent batch buffer, run
eagerly or replayed from a captured CUDA graph.

The port's counterpart of the reference launcher's
``jax.jit(train_step, donate_argnums=(0,))`` (``launch/train.py:62``):
forward, the planned backward, the global-norm clip and the AdamW update
of ``train.step.make_train_step`` as one ``serve.graphs.Program`` per
(batch, seq).  The state is the donated argument: the step updates its
tensors in place (parameters, fp32 master, moments, the compression
residuals with ``grad_compress``, and the step and update count, both
device tensors), so a graph captured once replays every later step on the same addresses.  The batch is uploaded into the
program's input buffer (``load``: tokens then targets, ``2 B S`` int64,
from pinned memory without a host wait), its float entries, where the
model takes them (a VLM's ``frontend``, an encoder-decoder's
``enc_frames``; their shapes are fixed at construction), into a second
buffer of the model's dtype in the same way, and the metrics are the
graph's own device tensors, rewritten by every replay.

A call that captures (the first, and the first after a change that
invalidates the graph) runs the step once eagerly as the capture's
warm-up and returns that run's metrics; the capture records without
running.  The graph is captured again before its next replay when

* a topology step (``rigl_evolve``, ``evolve_sparse_layer``) moved a
  module off a plan the graph holds (``Program.superseded``), or
* a tensor of the state was rebound rather than updated in place (a slot
  count that changed in ``optim.adamw.carry_slots``, a new ``values``
  parameter): the graph would read the old addresses.

Each capture takes a private memory pool of its own: the program holds
one graph, and a pool that its only graph left (``reset``) cannot be
captured into again.  Every train program of a process captures on one
stream per device (``_capture_stream``): cuBLAS keeps a workspace per
stream for the life of the process, so a stream per program would pin
one each.

A restore (``train.step.load_state_tree``) copies into the state's
tensors, so the graph reads the restored values.  On the CPU the step
runs eagerly; ``graph=True`` there raises.  A capture that fails raises:
nothing falls back to eager on a card.

A state sharded over a mesh (``init_train_state(mesh=)``) is captured
with its collectives when the mesh's backend is NCCL, whose collectives
a CUDA graph records (FSDP's all-gathers and reduce-scatters among
them); over gloo (which stages card tensors through the
host) a graph is refused, ``graph=None`` on a card included: pass
``graph=False``, as ``Engine(mesh=)`` asks.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import sparse as sparse_api
from repro_torch.serve.graphs import Program
from repro_torch.train.step import TrainHParams, TrainState, make_train_step

_STREAMS: Dict[torch.device, torch.cuda.Stream] = {}


def _capture_stream(dev: torch.device) -> torch.cuda.Stream:
    """The stream every train program on ``dev`` captures on."""
    dev = torch.device("cuda", torch.cuda.current_device()
                       if dev.index is None else dev.index)
    if dev not in _STREAMS:
        _STREAMS[dev] = torch.cuda.Stream(dev)
    return _STREAMS[dev]


class TrainProgram:
    """``make_train_step(lm, hp)`` on ``state`` over batches of
    ``batch x seq`` tokens, captured as a CUDA graph on a card
    (``graph=None``: on a card, eager elsewhere; ``graph=False``: eager),
    every run under the ``sparse.use_ctx`` context ambient at
    construction.  ``floats`` names the batch's float entries with their
    shapes (``{"enc_frames": (batch, T, d_model)}``); every batch loaded
    carries them."""

    def __init__(self, lm, state: TrainState,
                 hp: TrainHParams = TrainHParams(), *, batch: int, seq: int,
                 graph: Optional[bool] = None,
                 floats: Optional[Dict[str, Sequence[int]]] = None):
        dev = lm.device
        if graph is not False and state.layout is not None:
            backend = state.layout.backend()
            if backend != "nccl" and (graph or dev.type == "cuda"):
                raise NotImplementedError(
                    f"a train step over a {backend} mesh: a CUDA graph "
                    f"cannot capture its collectives; pass graph=False")
        if graph is None:
            graph = dev.type == "cuda"
        elif graph and dev.type != "cuda":
            raise ValueError(f"graph=True needs a card; the model is on "
                             f"{dev} (pass graph=None or False)")
        self.lm = lm
        self.state = state
        self.batch, self.seq = int(batch), int(seq)
        # each float entry's offset into the program's float buffer, and
        # its shape
        self.floats: Dict[str, tuple] = {}
        size = 0
        for name, shape in (floats or {}).items():
            shape = tuple(int(d) for d in shape)
            if not shape or shape[0] != self.batch:
                raise ValueError(f"float entry {name} of shape {shape}: "
                                 f"its first axis must be the batch "
                                 f"({self.batch})")
            self.floats[name] = (size, shape)
            size += int(np.prod(shape))
        self._step = make_train_step(lm, hp)
        self.program = Program(
            "train", self._body, 2 * self.batch * self.seq, device=dev,
            graph=graph, ctx=sparse_api.current_ctx(),
            stream=_capture_stream(dev) if graph else None,
            updates_state=True, fio_size=size, fio_dtype=lm.dtype)
        # the state's tensors the graph was captured on
        self._bound = ()

    def _body(self, io: torch.Tensor) -> Dict[str, torch.Tensor]:
        n = self.batch * self.seq
        batch = {"tokens": io[:n].view(self.batch, self.seq),
                 "targets": io[n:].view(self.batch, self.seq)}
        for name, (off, shape) in self.floats.items():
            batch[name] = self.program.fio[
                off:off + int(np.prod(shape))].view(shape)
        self.state, metrics = self._step(self.state, batch)
        return metrics

    def _tensors(self) -> tuple:
        st = self.state
        ef = () if st.ef is None else tuple(st.ef.residual.values())
        return (st.step, st.opt.count, *st.params.values(),
                *st.opt.master.values(), *st.opt.mu.values(),
                *st.opt.nu.values(), *ef)

    def load(self, batch: dict) -> None:
        """Upload one batch (``{"tokens", "targets"}``, ``[B, S]``, and
        the float entries named at construction)."""
        tokens = np.asarray(batch["tokens"])
        if tokens.shape != (self.batch, self.seq):
            raise ValueError(f"batch of shape {tokens.shape}; the program "
                             f"takes ({self.batch}, {self.seq})")
        extra = set(batch) - {"tokens", "targets"}
        if extra != set(self.floats):
            raise ValueError(f"batch entries {sorted(extra)} beside the "
                             f"tokens; the program takes "
                             f"{sorted(self.floats)}")
        floats = []
        for name, (off, shape) in self.floats.items():
            if tuple(batch[name].shape) != shape:
                raise ValueError(f"{name} of shape "
                                 f"{tuple(batch[name].shape)}; the program "
                                 f"takes {shape}")
            floats.append((off, batch[name]))
        self.program.load(np.concatenate(
            [tokens.reshape(-1), np.asarray(batch["targets"]).reshape(-1)]),
            floats)

    def __call__(self) -> Dict[str, torch.Tensor]:
        """One step on the loaded batch; its metrics (device tensors: a
        graph's are rewritten by the next step, so read them first)."""
        prog = self.program
        if prog.graph is not None:
            now = self._tensors()
            if len(now) != len(self._bound) or any(
                    a is not b for a, b in zip(now, self._bound)):
                prog.stale = True
        captures = prog.captures
        out = prog()
        if prog.captures != captures:
            self._bound = self._tensors()
        return out
