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

A record also notes the key of every plan the run called
(``hold_plan``): a graph replays the routes it captured, so the engine's
re-planner re-captures exactly the programs whose plans changed route.

A record is also what the engine's warm-up runs under: their telemetry
belongs to no request and is dropped with the record.

A forward that activation checkpointing recomputes in the backward
(``models/transformer.py`` ``stack_apply`` under ``remat="full"``) runs
again under the record of the forward it repeats (``recomputing``): on a
card autograd runs the backward on its own device thread, where no
record would be active otherwise.  Its telemetry was noted by the first
run and is not noted again (``is_recomputing``).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional

_state = threading.local()


class Record:
    """Objects to keep alive, device telemetry values per stream in call
    order, and the keys of the plans called, of one program run."""

    def __init__(self):
        self.held: Dict[int, object] = {}
        self.drops: Dict[str, List] = {}
        self.plans: Dict[str, None] = {}


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


def is_recomputing() -> bool:
    """Is this thread running a forward again for the backward?"""
    return getattr(_state, "recompute", False)


@contextlib.contextmanager
def recomputing(record: Optional[Record]):
    """Run the body as a recomputed forward under ``record`` (the record
    that was active when the forward first ran, or None)."""
    prev = active(), is_recomputing()
    _state.record, _state.recompute = record, True
    try:
        yield
    finally:
        _state.record, _state.recompute = prev


def hold(obj) -> None:
    """Keep ``obj`` alive as long as the record that is active (if any)."""
    rec = active()
    if rec is not None:
        rec.held[id(obj)] = obj


def hold_plan(plan) -> None:
    """Keep ``plan`` alive with the active record (if any) and note its
    key (``plan.key``) as one the run called."""
    rec = active()
    if rec is not None:
        rec.held[id(plan)] = plan
        rec.plans[plan.key] = None
