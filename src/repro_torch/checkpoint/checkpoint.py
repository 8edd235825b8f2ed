"""Atomic, asynchronous, elastic checkpoints of nested dicts of tensors.

Counterpart of the JAX package's ``checkpoint/checkpoint.py``:

* **atomic**: a save writes ``step_N.tmp`` and renames it to ``step_N``
  only once every leaf and the JSON index are written, so a preempted
  writer never corrupts the latest checkpoint; a stale ``.tmp`` is
  ignored;
* **async**: ``Checkpointer.save_async`` copies the tree to host memory
  (the only stall of the training loop) and writes it on a thread, one
  save in flight at a time, keeping the newest ``keep``;
* leaves are ``.npy`` files addressed by a hash of their path in the
  tree, listed in ``manifest.json`` with shape and dtype (bf16 is stored
  as its 16-bit pattern and restored by the recorded dtype);
* **elastic**: a checkpoint holds whole tensors whatever mesh wrote it.
  ``Checkpointer.save_async`` of a state sharded over a concrete mesh
  (``mesh=`` and ``specs=``, a tree of ``PartitionSpec`` or
  ``launch.mesh.Block`` beside the tree: how each leaf is held) gathers
  the leaves whole one at a time (``launch.mesh.Block.gather``: each
  block's writers write their part, so blocks that overlap in part, a
  Mamba-2 rank's in projection, are written once; rank 0 keeps a host
  copy), rank 0
  writes, and the other ranks wait at a barrier (``Checkpointer.wait``).
  ``restore(..., mesh=, specs=)`` keeps the caller's block of each
  leaf, so a checkpoint of one mesh restores onto another, one process
  included.
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


@torch.no_grad()
def gather_whole(tree: dict, mesh, specs: dict, keep: bool) -> dict:
    """``tree`` with every leaf held as a block under ``specs`` (a
    ``PartitionSpec`` or a ``launch.mesh.Block``) gathered whole, one
    leaf at a time (every rank calls it, in the same order); with
    ``keep`` the whole leaves as host copies, else nothing."""
    from repro_torch.launch import mesh as mesh_lib
    flat_specs = _flatten(specs)
    out = {}
    for key, leaf in _flatten(tree).items():
        spec = flat_specs.get(key, ())
        if isinstance(spec, mesh_lib.Block) and isinstance(leaf,
                                                           torch.Tensor):
            whole = spec.gather(leaf, mesh)
            if keep:
                out[key] = whole.to("cpu")
            del whole
            continue
        if not isinstance(leaf, torch.Tensor) \
                or not mesh_lib.spec_axes(spec):
            if keep:
                out[key] = (leaf.detach().to("cpu", copy=True)
                            if isinstance(leaf, torch.Tensor) else leaf)
            continue
        shape = list(leaf.shape)
        for d, e in enumerate(spec):
            if e is not None:
                shape[d] *= mesh_lib.axis_index(
                    mesh, (e,) if isinstance(e, str) else e)[1]
        whole = mesh_lib.gather_block(leaf, shape, spec, mesh)
        if keep:
            out[key] = whole.to("cpu")
        del whole
    return _unflatten(out) if keep else {}


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
            step: Optional[int] = None, mesh=None,
            specs: Optional[dict] = None):
    """Returns ``(tree, extra, step)`` of checkpoint ``step`` (the
    latest by default).  With ``like`` the tree takes its structure, and
    each tensor leaf its dtype and device (shapes must match); without,
    array leaves come back as CPU tensors and number leaves as numbers.
    With ``mesh`` and ``specs`` (a tree of ``PartitionSpec`` or
    ``launch.mesh.Block``) a leaf is this rank's block of the stored
    tensor (the whole tensor off a concrete mesh), and ``like`` holds
    the blocks."""
    from repro_torch.launch.mesh import Block, block
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
    flat_specs = _flatten(specs) if specs is not None else {}
    out = {}
    for key, ref in _flatten(like).items():
        val = load(key)
        if isinstance(ref, torch.Tensor):
            # a number stored as one (a step or count saved as an int)
            val = torch.as_tensor(val)
            spec = flat_specs.get(key)
            if isinstance(spec, Block):
                val = spec.take(val)
            elif spec is not None:
                val = block(val, spec, mesh)
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
        self._barrier = False
        os.makedirs(path, exist_ok=True)

    def wait(self) -> None:
        """Join the save in flight (after a sharded save every rank meets
        at a barrier once rank 0 has written); re-raise its failure
        here."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:
            import torch.distributed as dist
            self._barrier = False
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_async(self, tree: dict, *, step: int,
                   extra: Optional[dict] = None, mesh=None,
                   specs: Optional[dict] = None) -> None:
        """Snapshot ``tree`` to host memory and write it on a thread.
        With a concrete ``mesh`` and ``specs`` every rank calls it: the
        leaves are gathered whole (``gather_whole``) and rank 0 writes;
        the next ``wait`` is a barrier of all ranks."""
        from repro_torch.launch.mesh import is_concrete
        self.wait()
        if specs is not None and is_concrete(mesh):
            import torch.distributed as dist
            lead = dist.get_rank() == 0
            # the gather's host copies are the snapshot
            host = gather_whole(tree, mesh, specs, keep=lead)
            self._barrier = True
            if not lead:
                return
        else:
            # the host snapshot is the only part on the training loop's
            # path
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
