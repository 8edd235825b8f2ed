"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled on its own with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so <source>

into ``build/kernels/`` at the root of the checkout, keyed by a hash of
the source, every header it includes with ``#include "..."`` (found
beside the source or in ``kernels/``, which is passed as ``-I``) and the
flags, and loaded with ``ctypes``.  The sources have a plain C interface
(no PyTorch headers), so a build takes seconds.  ``build_all`` starts
one ``nvcc`` per source at once.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` turns a non-zero code into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Tuple

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO = os.path.dirname(os.path.dirname(_PKG))
# shared headers (``hopper.cuh``) live here; nvcc gets it as -I
INCLUDE_DIR = os.path.join(_PKG, "kernels")
BUILD_DIR = os.path.join(_REPO, "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# name -> path of the CUDA source, relative to the package root
SOURCES: Dict[str, str] = {
    "bs_attn": os.path.join("kernels", "bs_attn", "csrc", "bs_attn.cu"),
    "bsmm": os.path.join("kernels", "bsmm", "csrc", "bsmm.cu"),
    "bsmm_balanced": os.path.join("kernels", "bsmm", "csrc",
                                  "bsmm_balanced.cu"),
    "dsmm": os.path.join("kernels", "dsmm", "csrc", "dsmm.cu"),
    "gmm": os.path.join("kernels", "gmm", "csrc", "gmm.cu"),
    "dense_mm": os.path.join("kernels", "dense_mm", "csrc", "dense_mm.cu"),
    "sddmm": os.path.join("kernels", "sddmm", "csrc", "sddmm.cu"),
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# seconds each library took to build in this process (0.0 = found built)
BUILD_SECONDS: Dict[str, float] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under CUDA_HOME): the CUDA "
        "kernels of repro_torch cannot be built on this machine")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def includes(path: str) -> List[str]:
    """Every header ``path`` includes with ``#include "..."``, directly or
    through another header, resolved beside the including file or in
    ``INCLUDE_DIR`` (sorted, each once)."""
    seen: Dict[str, None] = {}
    todo = [path]
    while todo:
        cur = todo.pop()
        with open(cur, "rb") as f:
            names = _INCLUDE.findall(f.read())
        for raw in names:
            name = raw.decode()
            for base in (os.path.dirname(cur), INCLUDE_DIR):
                cand = os.path.normpath(os.path.join(base, name))
                if os.path.exists(cand):
                    break
            else:
                raise FileNotFoundError(f"{cur} includes {name!r}, found "
                                        f"neither beside it nor in "
                                        f"{INCLUDE_DIR}")
            if cand not in seen:
                seen[cand] = None
                todo.append(cand)
    return sorted(seen)


def _target(name: str) -> Tuple[str, str]:
    src = os.path.join(_PKG, SOURCES[name])
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in [src] + includes(src):
        with open(path, "rb") as f:
            digest.update(f.read())
    return src, os.path.join(BUILD_DIR,
                             f"{name}-{digest.hexdigest()[:16]}.so")


def _start(name: str):
    """Start ``nvcc`` for ``name`` unless its library is built; returns
    ``(popen or None, tmp path, final path, start time)``."""
    src, out = _target(name)
    if os.path.exists(out):
        return None, None, out, time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", INCLUDE_DIR, "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, started) -> str:
    proc, tmp, out, t0 = started
    if proc is None:
        BUILD_SECONDS.setdefault(name, 0.0)
        return out
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} (exit "
                           f"{proc.returncode}):\n{log}")
    os.replace(tmp, out)        # atomic: a concurrent builder sees all or none
    BUILD_SECONDS[name] = time.perf_counter() - t0
    return out


def build_all(names: List[str] | None = None) -> Dict[str, float]:
    """Compile every kernel library (one ``nvcc`` per source, all started
    together) and load them.  Returns the build seconds per library."""
    names = list(SOURCES) if names is None else list(names)
    with _LOCK:
        todo = [n for n in names if n not in _LIBS]
        started = {n: _start(n) for n in todo}
        for n in todo:
            _LIBS[n] = ctypes.CDLL(_finish(n, started[n]))
    return {n: BUILD_SECONDS.get(n, 0.0) for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = _LIBS[name]
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch "
                           f"(cudaGetLastError)")


def entry(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """C entry point ``symbol`` of library ``name`` with its signature
    declared (every entry point returns an ``int`` CUDA error code)."""
    fn = getattr(library(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn


class LaunchCounter:
    """Launch count of one CUDA kernel: its wrapper adds one per launch
    and nowhere else, and a replayed CUDA graph adds the launches it
    captured (``launch_counts`` / ``add_launches``)."""

    def __init__(self):
        self.launches = 0
        COUNTERS.append(self)

    def reset(self):
        self.launches = 0


# every LaunchCounter, in creation order
COUNTERS: list = []


def launch_counts() -> tuple:
    """Every counter's launches, in ``COUNTERS`` order."""
    return tuple(c.launches for c in COUNTERS)


def set_launches(counts) -> None:
    """Put every counter back to ``counts`` (a ``launch_counts()``)."""
    for c, n in zip(COUNTERS, counts):
        c.launches = n


def add_launches(delta) -> None:
    """Add ``(counter index, launches)`` pairs to their counters."""
    for i, n in delta:
        COUNTERS[i].launches += n


DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# the C entry points' dtype argument
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
