"""Persistent route-verdict cache of the port's plan layer.

Counterpart of the JAX package's ``sparse/cache.py``: a measured (or
analytic) route verdict is a stable property of the logical problem on
one card and toolchain, so it is written to a versioned JSON file and
reloaded by later processes -- a serving restart re-plans with zero
decisions and zero measurements.

Layout: one file per cache dir,

    <dir>/sparse-plans-torch-v<SCHEMA_VERSION>.json
    {"env": {"schema": .., "torch": .., "cuda": .., "device": ..,
             "gpu": ..},
     "entries": {"<key>": {"route": .., "source": .., "est_seconds": ..,
                           "capacity": .., "grad": .., "evolution": ..}}}

A file whose ``env`` does not match the running process (a schema bump,
another torch or CUDA version, another device type or card) is *stale*:
it is ignored on read (counted in ``stale_drops``) and overwritten on
the next store.  A file that does not parse is stale too.  Files are
replaced atomically (a temporary file, then ``os.replace``).

``cache_stats()`` exposes the counters: ``plans_built / plan_hits /
decisions / measurements / disk_hits / disk_misses / disk_writes /
stale_drops``.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Dict, Optional

import torch

# v1: the port's first schema: records of the port's routes (``*_cuda``
# kernels, ``*_torch`` plain versions) with the capacity and grad
# sections; keys carry n, the density bucket, the skew and the grad knobs
# v2: a record may carry an "evolution" lineage section (parent and root
# keys, generation, drift, re-race verdict: ``MatmulPlan.evolve``); a v1
# file has none, so it is stale as a whole
# v3: a verdict's key may carry the tensor-parallel section ("tp", q,
# tp_axis, tp_balanced, the mesh's axis names and sizes) and a record the
# TP routes, their estimates' source ("tp_source") and the "tp" report;
# a v2 key knew no mesh, so a v2 verdict could answer for another mesh
# (or for none): stale as a whole
SCHEMA_VERSION = 3

_lock = threading.RLock()
_configured_dir: Optional[str] = None
# per-dir loaded entries: {dir: {key: record}}
_loaded: Dict[str, Dict[str, dict]] = {}

_COUNTERS = ("plans_built", "plan_hits", "decisions", "measurements",
             "disk_hits", "disk_misses", "disk_writes", "stale_drops")
_stats: Dict[str, int] = {c: 0 for c in _COUNTERS}


def bump(counter: str, by: int = 1):
    with _lock:
        _stats[counter] += by


def cache_stats() -> dict:
    with _lock:
        return dict(_stats)


def configure(cache_dir: Optional[str] = None):
    """Set the process-default persistent cache directory (pass None to
    clear)."""
    global _configured_dir
    with _lock:
        _configured_dir = cache_dir
        _loaded.clear()


def configured_cache_dir() -> Optional[str]:
    return _configured_dir


def reset():
    """Forget all in-memory cache state (loaded files, counters).  Disk
    files are untouched: this is what a fresh process sees."""
    with _lock:
        _loaded.clear()
        for c in _COUNTERS:
            _stats[c] = 0


def _env() -> dict:
    cuda = torch.cuda.is_available()
    return {"schema": SCHEMA_VERSION,
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "device": "cuda" if cuda else "cpu",
            "gpu": torch.cuda.get_device_name(0) if cuda else None}


def _path(cache_dir: str) -> str:
    return os.path.join(cache_dir,
                        f"sparse-plans-torch-v{SCHEMA_VERSION}.json")


def _load(cache_dir: str) -> Dict[str, dict]:
    with _lock:
        cached = _loaded.get(cache_dir)
        if cached is not None:
            return cached
        entries: Dict[str, dict] = {}
        try:
            with open(_path(cache_dir)) as f:
                blob = json.load(f)
            if blob.get("env") != _env():
                bump("stale_drops")
            else:
                entries = dict(blob.get("entries", {}))
        except FileNotFoundError:
            pass
        except (OSError, TypeError, ValueError, AttributeError):
            bump("stale_drops")      # a corrupt file is a stale file
        _loaded[cache_dir] = entries
        return entries


def key_string(fingerprint: tuple) -> str:
    return "|".join(str(part) for part in fingerprint)


def load_decision(cache_dir: Optional[str],
                  key: str) -> Optional[dict]:
    """-> the stored record or None.  Bumps disk_hits / disk_misses."""
    if not cache_dir:
        return None
    rec = _load(cache_dir).get(key)
    bump("disk_hits" if rec is not None else "disk_misses")
    return rec


def store_decision(cache_dir: Optional[str], key: str, record: dict):
    """Merge one verdict into the cache file (atomic replace); an
    identical record writes nothing."""
    if not cache_dir:
        return
    with _lock:
        entries = dict(_load(cache_dir))
        if entries.get(key) == record:
            return
        entries[key] = record
        os.makedirs(cache_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=cache_dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump({"env": _env(), "entries": entries}, f, indent=1)
            os.replace(tmp, _path(cache_dir))
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return                     # persistence is best-effort
        _loaded[cache_dir] = entries
        bump("disk_writes")
