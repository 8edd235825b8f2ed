"""What a program run under a CUDA-graph capture leaves for its graph.

A captured graph holds raw device pointers and runs no Python when it is
replayed, so two things that eager code does in Python have to be kept
beside the graph (``serve/graphs.py``):

* **device metadata the kernels read** (an attention walk, a plan's tile
  schedule or expert ids): an entry of a bounded cache or of the plan
  cache may be dropped after the capture, and its memory reused while
  the graph still reads it.  Code that hands such a tensor to a kernel
  calls ``hold(obj)``; under a record the object is kept alive with it.
* **telemetry values** (``sparse.record_dropped``): a value written by a
  captured kernel exists once, in the graph's memory, and is rewritten by
  every replay.  Under a record the value is noted per stream instead of
  being queued; the graph copies it out after each replay.

A record is also what the engine's warm-up runs under: their telemetry
belongs to no request and is dropped with the record.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional

_state = threading.local()


class Record:
    """Objects to keep alive, and device telemetry values per stream, in
    call order, of one program run."""

    def __init__(self):
        self.held: Dict[int, object] = {}
        self.drops: Dict[str, List] = {}


def active() -> Optional[Record]:
    """The record of the run in progress on this thread, if any."""
    return getattr(_state, "record", None)


@contextlib.contextmanager
def recording():
    """Run the body under a fresh ``Record`` (nested records stack)."""
    prev = active()
    rec = _state.record = Record()
    try:
        yield rec
    finally:
        _state.record = prev


def hold(obj) -> None:
    """Keep ``obj`` alive as long as the record that is active (if any)."""
    rec = active()
    if rec is not None:
        rec.held[id(obj)] = obj
