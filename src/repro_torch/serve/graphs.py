"""One serving program over persistent device buffers, run eagerly or
replayed from a captured CUDA graph.

The port's counterpart of the reference engine's ``jax.jit`` programs
(``serve/engine.py:267-270``): a ``Program`` owns its input buffer (the
caller loads each call's tokens, positions and slot into it), and on a
card it captures the program once as a ``torch.cuda.CUDAGraph`` and
replays it per call, so a call runs no Python and launches no kernel
from the host.  What the replay cannot do by itself is kept beside the
graph:

* **warm-up**: one eager call on a side stream before the capture, so
  every kernel is built, every plan, walk and schedule is on the device
  and the allocator holds its blocks (a capture may not copy from the
  host or synchronise).  Its telemetry is dropped (it serves no request;
  ``core.capture``); its kernel launches are real and counted;
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
  capture reuses.

A capture that fails raises; nothing falls back to eager.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import sparse as sparse_api
from repro_torch.core import capture
from repro_torch.kernels import _build


class Program:
    """``body(io)`` over the persistent int64 buffer ``io``; with
    ``graph`` it is captured at the first call (or ``capture()``) and
    replayed after.  ``ctx`` is the ``sparse.use_ctx`` context every run
    of the body is under."""

    def __init__(self, name: str, body: Callable, io_size: int, *,
                 device: torch.device, graph: bool, ctx, pool=None):
        self.name = name
        self.body = body
        self.device = device
        self.ctx = ctx
        self.pool = pool
        self.use_graph = graph
        self.io = torch.zeros(io_size, dtype=torch.long, device=device)
        # a pinned host copy of io: one asynchronous upload a call, and
        # the event that says when it has been read
        self._host = (torch.zeros(io_size, dtype=torch.long,
                                  pin_memory=True)
                      if device.type == "cuda" else None)
        self._uploaded = (torch.cuda.Event() if device.type == "cuda"
                          else None)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs = None
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0
        self._launches = ()
        self._drops = {}
        self._held = {}

    def load(self, values: np.ndarray) -> None:
        """Copy one call's inputs into ``io``."""
        src = torch.from_numpy(np.ascontiguousarray(values, np.int64))
        if self._host is None:
            self.io.copy_(src)
            return
        # the previous upload must have read the pinned copy first
        self._uploaded.synchronize()
        self._host.copy_(src)
        self.io.copy_(self._host, non_blocking=True)
        self._uploaded.record()

    def run_eager(self):
        """The body on ``io``, eagerly, under the program's context."""
        with sparse_api.use_ctx(self.ctx):
            return self.body(self.io)

    def capture(self) -> None:
        """Warm up, then capture the body into a CUDA graph."""
        if self.device.type != "cuda":
            raise RuntimeError(f"{self.name}: a CUDA graph needs a card, "
                               f"not {self.device}")
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side), capture.recording():
            self.run_eager()
        cur.wait_stream(side)
        before = _build.launch_counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with capture.recording() as rec:
                with torch.cuda.graph(graph, pool=self.pool):
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
        self.graph = graph
        self.outputs = outputs
        self.captures += 1
        self.capture_s += time.perf_counter() - t0

    def __call__(self):
        """Run the program on ``io``: eagerly, or by replaying its graph
        (captured now if it is not yet).  Returns the body's outputs (a
        graph's own tensors: read them before the next replay)."""
        if not self.use_graph:
            return self.run_eager()
        if self.graph is None:
            self.capture()
        self.graph.replay()
        self.replays += 1
        _build.add_launches(self._launches)
        for name, vals in self._drops.items():
            sparse_api.queue_dropped(name, vals.clone())
        return self.outputs

    def stats(self) -> dict:
        return {"captures": self.captures, "replays": self.replays,
                "capture_s": round(self.capture_s, 6),
                "launches_per_replay": int(sum(n for _, n in
                                               self._launches))}
