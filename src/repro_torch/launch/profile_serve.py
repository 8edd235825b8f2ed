"""Where serving time goes on the card: one prefill and a run of decode
steps of a full-width model under ``torch.profiler``: llama3.2-1b (by
default) or ``--arch gemma2-2b`` with every FFN block-sparse at
``--density``, or ``--arch qwen3-moe-30b-a3b`` with its 128 experts
(``--density`` does not apply to an MoE config).

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        [--arch llama3.2-1b] [--density 0.125] [--batch 4] \
        [--prompt 256] [--max-len 512] [--steps 16] [--out profile.json]

Reports, per phase, the host wall time (clock around work that ends in a
``synchronize``), the device busy time (sum of the kernels' own device
times from the profiler), the device's idle share, and the device time
by kernel family (the bs_attn, bsmm, dense_mm, gmm and sddmm kernels,
the library GEMM of the unembed and the router, everything else); and, for the decode step,
the Python functions that take the host's time (``cProfile``).  Needs a
card.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models.model import LM


FAMILIES = ("bs_attn", "bsmm", "dense_mm", "gmm", "sddmm", "library_gemm",
            "other")


def _family(name: str) -> str:
    if "bs_attn" in name:
        return "bs_attn"
    if "gmm_kernel" in name or "gmm_tc_kernel" in name:
        return "gmm"
    if "bsmm" in name:                  # every walk, and bsmm_balanced
        return "bsmm"
    if "dense_mm" in name or "splitk_reduce" in name:
        return "dense_mm"
    if "sddmm" in name:
        return "sddmm"
    if "gemm" in name.lower() or "cutlass" in name.lower() or \
            "sm90_xmma" in name:
        return "library_gemm"
    return "other"


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        val = getattr(evt, attr, None)
        if val is not None:
            return float(val)
    return 0.0


def _profile(fn, reps: int, top_n: int = 8):
    """Host wall time and device kernel time of ``reps`` calls of ``fn``."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fam = dict.fromkeys(FAMILIES, 0.0)
    top = []
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = _device_us(evt)
        if us <= 0:
            continue
        fam[_family(evt.key)] += us
        top.append((us, evt.key, evt.count))
    busy_ms = sum(fam.values()) / 1e3 / reps
    wall_ms = wall * 1e3 / reps
    top.sort(reverse=True)
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms if busy_ms > 0 else None,
        "device_idle_share": (1.0 - busy_ms / wall_ms) if busy_ms > 0
        else None,
        "device_ms_by_family": {k: v / 1e3 / reps for k, v in fam.items()},
        "top_kernels": [{"name": k[:90], "device_ms": us / 1e3 / reps,
                         "calls_per_rep": c / reps}
                        for us, k, c in top[:top_n]],
    }


def _wall_ms(fn, reps: int) -> float:
    """Host wall time per call with no profiler attached."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def _host_profile(fn, reps: int, top: int = 12):
    """Python functions by own (host) time per call of ``fn``, under
    ``cProfile`` (which slows Python calls, so read shares, not ms)."""
    import cProfile
    import pstats
    pr = cProfile.Profile()
    torch.cuda.synchronize()
    pr.enable()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    pr.disable()
    st = pstats.Stats(pr)
    total = st.total_tt
    rows = sorted(st.stats.items(), key=lambda kv: kv[1][2], reverse=True)
    return {"host_ms_per_call": total * 1e3 / reps,
            "by_function": [
                {"function": f"{os.path.basename(f)}:{line}:{name}",
                 "self_share": tt / total, "calls_per_rep": nc / reps}
                for (f, line, name), (cc, nc, tt, ct, _) in rows[:top]]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--density", type=float, default=0.125)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=256)
    ap.add_argument("--max-len", type=int, default=512)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA device")

    cfg = configs.get(args.arch)
    if cfg.moe is None:
        cfg = configs.sparsify_ffn(cfg, args.density)
    lm = LM(cfg, device="cuda", seed=args.seed)
    rng = np.random.default_rng(args.seed)
    max_len = args.max_len
    prompt = rng.integers(0, cfg.vocab_size, size=(1, args.prompt))
    tokens = rng.integers(0, cfg.vocab_size, size=(args.batch, 1))
    positions = np.full(args.batch, args.prompt, np.int64)
    caches = lm.init_cache(args.batch, max_len)

    def prefill():
        lm.prefill(prompt, max_len=max_len, last_index=[args.prompt - 1])

    def decode():
        lm.decode_step(tokens, caches, positions)

    for fn in (prefill, decode, decode):       # warm-up
        fn()
    out = {"card": torch.cuda.get_device_name(0), "arch": cfg.name,
           "max_len": max_len,
           "density": args.density if cfg.moe is None else None,
           "batch": args.batch,
           "prompt": args.prompt,
           "prefill_wall_ms": _wall_ms(prefill, 3),
           "decode_step_wall_ms": _wall_ms(decode, args.steps),
           "prefill": _profile(prefill, 3),
           "decode_step": _profile(decode, args.steps),
           "decode_step_host": _host_profile(decode, args.steps)}
    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    return out


if __name__ == "__main__":
    main()
