"""One program over persistent device buffers, run eagerly or replayed
from a captured CUDA graph: a serving step, or a train step.

The port's counterpart of the reference's ``jax.jit`` programs (the
engine's, ``serve/engine.py:267-270``, and the train step's,
``launch/train.py:62``): a ``Program`` owns its input buffer (the caller
loads each call's tokens, positions and slot, or a batch's tokens and
targets, into it), and on a card it captures the program once as a
``torch.cuda.CUDAGraph`` and replays it per call, so a call runs no
Python and launches no kernel from the host.  What the replay cannot do
by itself is kept beside the graph:

* **one stream**: the warm-up and the capture run on the stream the
  owner passes (``stream``; the engine owns one for all its programs),
  named explicitly to ``torch.cuda.graph``.  cuBLAS keeps a workspace
  per stream for the life of the process, so a fresh stream per capture
  would pin one workspace per program;
* **warm-up**: one eager call on that stream before the capture, so
  every kernel is built, every plan, walk and schedule is on the device
  and the allocator holds its blocks (a capture may not copy from the
  host or synchronise).  Its telemetry is dropped (it serves no request;
  ``core.capture``); its kernel launches are real and counted.  A body
  that updates state in place (``updates_state``: a train step) must not
  run twice for one call: its warm-up *is* the call (telemetry kept,
  outputs returned), the capture that follows records without running,
  and later calls replay;
* **launch accounting**: the kernels' launch counters
  (``kernels._build.COUNTERS``) are read around the capture, put back
  (a capture runs nothing), and each replay adds the launches the graph
  holds, by kernel and walk;
* **telemetry**: the ``record_dropped`` values the captured kernels
  write, concatenated per stream inside the graph; after each replay a
  device copy of each is queued (``sparse.queue_dropped``), so
  ``dropped_history`` reads the same values in the same order as eager;
* **device metadata**: every plan, walk and tile stack the captured
  kernels read (``capture.hold``), kept alive with the graph;
* **memory**: every graph of an engine captures into one memory pool
  (``pool``); a graph's outputs are its own tensors, which no other
  capture reuses.  Without ``pool`` each capture takes a private pool
  (the train program's one graph: a shared pool that its only graph
  left cannot be captured into again);
* **plans**: the keys of the plans the body called (``plan_keys``, from
  the capture's record, or the warm-up's when the program runs
  eagerly).  A re-planned verdict that changes one of their routes marks
  the program ``stale``; its next call ``recapture``s it first (the old
  graph, its outputs and the metadata it held go once its last replay
  has ended; the new one captures into the same pool on the same
  stream).  An eager program re-plans at its next call by itself.
  A topology update (``MatmulPlan.evolve``, ``SparseLinear.evolve``)
  marks the plans it moved a module off *superseded*: a graph holding
  one was captured on the old pattern and its old values, so it is
  stale too, and re-captured before its next replay.  The check costs an
  integer compare per call until some evolve runs
  (``sparse.supersede_epoch``).

A capture that fails raises; nothing falls back to eager.
"""
from __future__ import annotations

import contextlib
import gc
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import sparse as sparse_api
from repro_torch.core import capture
from repro_torch.kernels import _build


def _fill(buf: torch.Tensor, floats) -> None:
    """``(offset, array)`` pairs copied into the flat ``buf``."""
    for off, x in floats:
        x = torch.as_tensor(x).reshape(-1)
        buf[off:off + x.numel()].copy_(x)


class Program:
    """``body(io)`` over the persistent int64 buffer ``io`` (and, with
    ``fio_size``, the ``fio_dtype`` buffer ``fio`` beside it, which the
    body reads from the program; None without); with
    ``graph`` it is captured at the first call (or ``capture()``) and
    replayed after.  ``ctx`` is the ``sparse.use_ctx`` context every run
    of the body is under; ``stream`` the stream its warm-up and every
    capture run on (required with ``graph``: cuBLAS keeps a workspace per
    stream for the life of the process, so a fresh stream per capture
    would pin one each); ``capture_lock`` (a context manager) is held
    over each warm-up and capture, so another thread's device work that
    takes it never lands inside one.  With ``updates_state`` the body
    changes state in place (a train step): a call that captures returns
    its warm-up's outputs, which were that call's run, and frees the
    allocator's cached blocks (after collecting reference cycles) before
    the warm-up and before the capture (which takes the graph's own)."""

    def __init__(self, name: str, body: Callable, io_size: int, *,
                 device: torch.device, graph: bool, ctx, pool=None,
                 stream: Optional[torch.cuda.Stream] = None,
                 capture_lock=None, updates_state: bool = False,
                 fio_size: int = 0,
                 fio_dtype: Optional[torch.dtype] = None):
        if graph and stream is None:
            raise ValueError(f"{name}: a graph program needs the stream "
                             f"it captures on")
        self.name = name
        self.body = body
        self.device = device
        self.ctx = ctx
        self.pool = pool
        self.stream = stream
        self.capture_lock = capture_lock
        self.use_graph = graph
        self.updates_state = updates_state
        self.io = torch.zeros(io_size, dtype=torch.long, device=device)
        # a pinned host copy of io: one asynchronous upload a call, and
        # the event that says when it has been read
        self._host = (torch.zeros(io_size, dtype=torch.long,
                                  pin_memory=True)
                      if device.type == "cuda" else None)
        if fio_size and fio_dtype is None:
            raise ValueError(f"{name}: a float buffer needs its dtype")
        self.fio = (torch.zeros(fio_size, dtype=fio_dtype, device=device)
                    if fio_size else None)
        self._fhost = (torch.zeros(fio_size, dtype=fio_dtype,
                                   pin_memory=True)
                       if device.type == "cuda" and fio_size else None)
        self._uploaded = (torch.cuda.Event() if device.type == "cuda"
                          else None)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs = None
        self.captures = 0
        self.recaptures = 0
        self.replays = 0
        self.capture_s = 0.0
        self.plan_keys: frozenset = frozenset()
        self.stale = False
        # the plans the graph holds, and the supersede epoch it was
        # captured (or last found current) at
        self._plans = ()
        self._epoch = 0
        self._launches = ()
        self._drops = {}
        self._held = {}

    def load(self, values: np.ndarray, floats=()) -> None:
        """Copy one call's inputs into ``io``, and each ``(offset,
        array)`` of ``floats`` into ``fio`` from that offset, cast to its
        dtype on the way."""
        src = torch.from_numpy(np.ascontiguousarray(values, np.int64))
        if self._host is None:
            self.io.copy_(src)
            _fill(self.fio, floats)
            return
        # the previous upload must have read the pinned copies first
        self._uploaded.synchronize()
        self._host.copy_(src)
        self.io.copy_(self._host, non_blocking=True)
        if floats:
            _fill(self._fhost, floats)
            self.fio.copy_(self._fhost, non_blocking=True)
        self._uploaded.record()

    def run_eager(self):
        """The body on ``io``, eagerly, under the program's context."""
        with sparse_api.use_ctx(self.ctx):
            return self.body(self.io)

    def warm(self):
        """The body once, eagerly, under a record: its telemetry dropped,
        the keys of the plans it called kept (``plan_keys``)."""
        with capture.recording() as rec:
            out = self.run_eager()
        self.plan_keys = frozenset(rec.plans)
        return out

    def capture(self):
        """Warm up, then capture the body into a CUDA graph, both on the
        program's stream.  Returns the warm-up's outputs with
        ``updates_state`` (the call's own run), else None."""
        if self.device.type != "cuda":
            raise RuntimeError(f"{self.name}: a CUDA graph needs a card, "
                               f"not {self.device}")
        with self.capture_lock or contextlib.nullcontext():
            return self._capture()

    def _capture(self):
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(self.device)
        stream = self.stream
        if self.updates_state:
            # the warm-up allocates on the capture stream: blocks cached
            # for the caller's stream are of no use to it.  The cache
            # frees only whole segments, and a tensor kept by a reference
            # cycle of an earlier eager step (until the cycle collector
            # runs) keeps its segment: collect first
            gc.collect()
            torch.cuda.empty_cache()
        stream.wait_stream(cur)
        with torch.cuda.stream(stream):
            if self.updates_state:
                warm = self.run_eager()
            else:
                with capture.recording():
                    self.run_eager()
                warm = None
        cur.wait_stream(stream)
        if self.updates_state:
            # the warm-up's transient blocks back to the card: the graph
            # keeps its own for the step's transients
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
        before = _build.launch_counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with capture.recording() as rec:
                with torch.cuda.graph(graph, pool=self.pool, stream=stream):
                    outputs = self.run_eager()
                    drops = {name: torch.cat(vals)
                             for name, vals in rec.drops.items()}
        except Exception as exc:
            _build.set_launches(before)
            raise RuntimeError(f"capturing {self.name} as a CUDA graph "
                               f"failed: {exc}") from exc
        after = _build.launch_counts()
        _build.set_launches(before)
        self._launches = tuple((i, a - b) for i, (a, b)
                               in enumerate(zip(after, before)) if a != b)
        self._drops = drops
        self._held = rec.held
        self._plans = tuple(o for o in rec.held.values()
                            if isinstance(o, sparse_api.MatmulPlan))
        self._epoch = sparse_api.supersede_epoch()
        self.plan_keys = frozenset(rec.plans)
        self.graph = graph
        self.outputs = outputs
        self.stale = False
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        return warm

    def recapture(self):
        """Drop the graph and capture the body again, into the same pool
        on the same stream (its warm-up re-plans what was re-planned).
        The old graph, its outputs, telemetry values and held metadata go
        only after the device has run its last replay.  Returns what
        ``capture`` returns."""
        if self.graph is not None:
            torch.cuda.synchronize(self.device)
            self.graph.reset()
        self.graph = self.outputs = None
        self._launches, self._drops, self._held = (), {}, {}
        self._plans = ()
        warm = self.capture()
        self.recaptures += 1
        return warm

    def superseded(self) -> bool:
        """Has an evolve moved a module off a plan the graph holds since
        it was captured?  Marks the program ``stale`` if so."""
        epoch = sparse_api.supersede_epoch()
        if epoch != self._epoch:
            if any(p.superseded > self._epoch for p in self._plans):
                self.stale = True
            else:
                self._epoch = epoch
        return self.stale

    def __call__(self):
        """Run the program on ``io``: eagerly, or by replaying its graph
        (captured now if it is not yet, captured again first if it is
        ``stale`` or holds a superseded plan).  Returns the body's
        outputs (a graph's own tensors: read them before the next
        replay).  With ``updates_state`` a call that captures runs the
        body once, as its warm-up, and returns that run's outputs."""
        if not self.use_graph:
            self.stale = False
            return self.run_eager()
        if self.graph is None or self.stale or self.superseded():
            warm = (self.capture() if self.graph is None
                    else self.recapture())
            if self.updates_state:
                return warm
        self.graph.replay()
        self.replays += 1
        _build.add_launches(self._launches)
        for name, vals in self._drops.items():
            sparse_api.queue_dropped(name, vals.clone())
        return self.outputs

    def launches_per_replay(self) -> dict:
        """The kernel launches one replay adds, by launch counter (its
        index in ``kernels._build.COUNTERS``)."""
        return dict(self._launches)

    def stats(self) -> dict:
        return {"captures": self.captures, "recaptures": self.recaptures,
                "replays": self.replays,
                "capture_s": round(self.capture_s, 6),
                "launches_per_replay": int(sum(n for _, n in
                                               self._launches))}
