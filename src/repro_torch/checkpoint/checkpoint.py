"""Atomic, asynchronous checkpoints of nested dicts of tensors.

Counterpart of the JAX package's ``checkpoint/checkpoint.py`` on one
process:

* **atomic**: a save writes ``step_N.tmp`` and renames it to ``step_N``
  only once every leaf and the JSON index are written, so a preempted
  writer never corrupts the latest checkpoint; a stale ``.tmp`` is
  ignored;
* **async**: ``Checkpointer.save_async`` copies the tree to host memory
  (the only stall of the training loop) and writes it on a thread, one
  save in flight at a time, keeping the newest ``keep``;
* leaves are ``.npy`` files addressed by a hash of their path in the
  tree, listed in ``manifest.json`` with shape and dtype (bf16 is stored
  as its 16-bit pattern and restored by the recorded dtype).

Mesh-aware re-sharding on restore waits for sharded training (ROADMAP
queue 1, item 11b).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

_SEP = "/"


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(_flatten(val, name + _SEP))
        else:
            out[name] = val
    return out


def _unflatten(flat: Dict[str, Any]) -> dict:
    tree: dict = {}
    for key, val in flat.items():
        node = tree
        *parents, leaf = key.split(_SEP)
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


def _leaf_file(key: str) -> str:
    return hashlib.sha1(key.encode()).hexdigest()[:16] + ".npy"


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as a numpy array to write, and the dtype name to record."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        name = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), name
        return t.numpy(), name
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    # (ascontiguousarray makes a 0-dim array 1-dim: a step, a count)
    t = torch.from_numpy(np.ascontiguousarray(arr)).reshape(arr.shape)
    if dtype == "bfloat16":
        return t.view(torch.bfloat16)
    return t


def save(path: str, tree: dict, *, step: int,
         extra: Optional[dict] = None) -> str:
    """Synchronous atomic save of a nested dict of tensors, arrays and
    numbers; returns the checkpoint's directory."""
    final = os.path.join(path, f"step_{step}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    for key, leaf in _flatten(tree).items():
        arr, dtype = _to_numpy(leaf)
        fname = _leaf_file(key)
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][key] = {"file": fname, "shape": list(arr.shape),
                                   "dtype": dtype,
                                   "scalar": not isinstance(
                                       leaf, (torch.Tensor, np.ndarray))}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)         # atomicity point
    return final


def _steps(path: str):
    return sorted(int(d.split("_")[1]) for d in os.listdir(path)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = _steps(path)
    return steps[-1] if steps else None


def restore(path: str, like: Optional[dict] = None, *,
            step: Optional[int] = None):
    """Returns ``(tree, extra, step)`` of checkpoint ``step`` (the
    latest by default).  With ``like`` the tree takes its structure, and
    each tensor leaf its dtype and device (shapes must match); without,
    array leaves come back as CPU tensors and number leaves as numbers."""
    step = step if step is not None else latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {path}")
    d = os.path.join(path, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    info = manifest["leaves"]

    def load(key):
        meta = info.get(key)
        if meta is None:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = np.load(os.path.join(d, meta["file"]))
        if meta.get("scalar"):
            return arr.item()
        return _from_numpy(arr, meta["dtype"])

    if like is None:
        return _unflatten({k: load(k) for k in info}), \
            manifest["extra"], step
    out = {}
    for key, ref in _flatten(like).items():
        val = load(key)
        if isinstance(ref, torch.Tensor):
            # a number stored as one (a step or count saved as an int)
            val = torch.as_tensor(val)
            if tuple(val.shape) != tuple(ref.shape):
                raise ValueError(f"{key}: shape {tuple(val.shape)} != "
                                 f"{tuple(ref.shape)}")
            val = val.to(device=ref.device, dtype=ref.dtype)
        elif isinstance(ref, (int, float)) and not isinstance(ref, bool):
            val = type(ref)(val if not isinstance(val, torch.Tensor)
                            else val.item())
        out[key] = val
    return _unflatten(out), manifest["extra"], step


class Checkpointer:
    """Async writer with one save in flight and a retention policy."""

    def __init__(self, path: str, *, keep: int = 3):
        self.path = path
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(path, exist_ok=True)

    def wait(self) -> None:
        """Join the save in flight; re-raise its failure here."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_async(self, tree: dict, *, step: int,
                   extra: Optional[dict] = None) -> None:
        self.wait()
        # the host snapshot is the only part on the training loop's path
        host = _unflatten({k: (v.detach().to("cpu", copy=True)
                               if isinstance(v, torch.Tensor) else v)
                           for k, v in _flatten(tree).items()})

        def work():
            try:
                save(self.path, host, step=step, extra=extra)
                self._gc()
            except Exception as e:   # re-raised by the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self) -> None:
        for s in _steps(self.path)[:-self.keep]:
            shutil.rmtree(os.path.join(self.path, f"step_{s}"),
                          ignore_errors=True)
