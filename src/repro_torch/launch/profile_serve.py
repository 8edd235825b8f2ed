"""Where serving time goes on the card: one prefill and a run of decode
steps of a full-width model under ``torch.profiler``: llama3.2-1b (by
default) or ``--arch gemma2-2b`` with every FFN block-sparse at
``--density``, or ``--arch qwen3-moe-30b-a3b`` with its 128 experts
(``--density`` applies only to a config whose FFNs are all dense MLPs:
not to an MoE config, mamba2-130m or jamba-v0.1-52b).

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        [--arch llama3.2-1b] [--layers N] [--density 0.125] [--batch 4] \
        [--prompt 256] [--max-len 512] [--steps 16] [--out profile.json]

``--layers`` cuts the depth as ``profile_train`` does (``cut_depth``:
whole periods, full width; jamba-v0.1-52b at 16 is 2 of its 4 periods).
A model with mamba layers also reports its SSD scan alone
(``ssd_scan``: ``ssm.ssd_scan`` at the prefill's shape: one call's ms
on the stream by CUDA events, its busy device ms by family under the
profiler, that times the mamba layers, and its shares of the prefill's
busy time and of its "other" family; the scan is plain PyTorch, its
batched products in ``library_gemm``, the rest in ``other``).

Reports, per phase, the host wall time (clock around work that ends in a
``synchronize``), the device busy time (sum of the kernels' own device
times from the profiler), the device's idle share, and the device time
by kernel family (the bs_attn, bsmm, dense_mm, gmm and sddmm kernels,
the library GEMM of the unembed and the router, everything else); and, for the decode step,
the Python functions that take the host's time (``cProfile``).  Needs a
card.

``--graphs`` also profiles the serving engine's CUDA graphs in the same
process: an ``Engine`` over the same model captures its decode step and
the ``--prompt`` bucket's prefill, and the same phases are reported for
their replays (``graph_prefill``, ``graph_decode_step``,
``graph_decode_step_host``; a call is the engine's: one upload of its
inputs and one replay), beside the eager ones.  A stack the engine may
not pad (mamba layers) prefills eagerly in the engine, so only its
decode step is captured.
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


def _replay_ms(prog, reps: int) -> float:
    """Device time per replay of a captured program (CUDA events; a sleep
    kernel holds the stream while the host enqueues the replays, so host
    time between them does not count)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(1e8))
    start.record()
    for _ in range(reps):
        prog()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _graph_phases(lm, args, prompt):
    """The same phases through the engine's captured programs: the
    ``--prompt`` bucket's prefill into slot 0 (where the engine may pad
    the stack) and the decode step of the whole batch at position
    ``--prompt``."""
    from repro_torch.serve import Engine

    eng = Engine(lm, batch=args.batch, max_len=args.max_len, device="cuda",
                 buckets=(args.prompt,), warm_plans=False, graphs=True)
    dec = eng._decode
    dio = np.concatenate([np.arange(args.batch) % lm.cfg.vocab_size,
                          np.full(args.batch, args.prompt)]).astype(np.int64)
    dec.load(dio)
    dec.capture()

    def decode():
        dec.load(dio)
        dec()

    out = {}
    if eng.pad_safe:
        pre = eng._prefill_program(args.prompt)
        io = np.zeros(args.prompt + 2, np.int64)
        io[:args.prompt] = prompt[0]
        io[args.prompt:] = (args.prompt - 1, 0)
        pre.load(io)
        pre.capture()

        def prefill():
            pre.load(io)
            pre()

        prefill()                               # warm-up
        out.update(graph_prefill_device_ms=_replay_ms(pre, 3),
                   graph_prefill_wall_ms=_wall_ms(prefill, 3),
                   graph_prefill=_profile(prefill, 3))
    for _ in range(2):                          # warm-up
        decode()
    out.update(graph_capture_s={"decode": dec.capture_s},
               graph_decode_step_device_ms=_replay_ms(dec, args.steps),
               graph_decode_step_wall_ms=_wall_ms(decode, args.steps),
               graph_decode_step=_profile(decode, args.steps),
               graph_decode_step_host=_host_profile(decode, args.steps))
    if eng.pad_safe:
        out["graph_capture_s"]["prefill"] = pre.capture_s
    return out


def _ssd_scan(cfg, s: int, reps: int = 5):
    """``ssm.ssd_scan`` alone at an ``s``-token prefill's shape (batch 1,
    fp32 as the mixer calls it): its chunk length and count, the ms of
    one call on the stream by CUDA events (launch gaps included: at
    chunks of 1 the inter-chunk loop is launch-bound), its busy device
    ms under the profiler by family, and the busy ms times the mamba
    layers."""
    from repro_torch.models import ssm
    from repro_torch.models.transformer import layer_specs

    c = cfg.ssm
    h = c.num_heads(cfg.d_model)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    x = rand(1, s, h, c.head_dim)
    dt = torch.nn.functional.softplus(rand(1, s, h))
    a = -torch.exp(rand(h) * 0.5)
    b, cc = rand(1, s, c.n_groups, c.d_state), rand(1, s, c.n_groups,
                                                    c.d_state)

    def scan():
        ssm.ssd_scan(x, dt, a, b, cc, chunk=c.chunk)

    scan()                                              # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        scan()
    end.record()
    torch.cuda.synchronize()
    prof = _profile(scan, reps)
    layers = sum(spec.mixer == "mamba" for spec in layer_specs(cfg))
    lc = ssm.chunk_len(s, c.chunk)
    return {"tokens": s, "chunk_len": lc, "chunks": s // lc,
            "mamba_layers": layers,
            "stream_ms_per_call": start.elapsed_time(end) / reps,
            "busy_ms_per_call": prof["device_busy_ms"],
            "busy_ms_by_family_per_call": prof["device_ms_by_family"],
            "busy_ms_per_prefill": (prof["device_busy_ms"] or 0.0) * layers}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (full width)")
    ap.add_argument("--density", type=float, default=0.125)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=256)
    ap.add_argument("--max-len", type=int, default=512)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--graphs", action="store_true",
                    help="also profile the engine's CUDA-graph replays")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA device")

    cfg = configs.get(args.arch)
    dense = configs.dense_ffns(cfg)
    if dense:
        cfg = configs.sparsify_ffn(cfg, args.density)
    if args.layers is not None:
        from repro_torch.launch.profile_train import cut_depth
        cfg = cut_depth(cfg, args.layers)
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
           "layers": cfg.num_layers, "max_len": max_len,
           "density": args.density if dense else None,
           "batch": args.batch,
           "prompt": args.prompt,
           "prefill_wall_ms": _wall_ms(prefill, 3),
           "decode_step_wall_ms": _wall_ms(decode, args.steps),
           "prefill": _profile(prefill, 3),
           "decode_step": _profile(decode, args.steps),
           "decode_step_host": _host_profile(decode, args.steps)}
    if cfg.ssm is not None:
        scan = _ssd_scan(cfg, args.prompt)
        pre = out["prefill"]
        fam = scan["busy_ms_by_family_per_call"]
        other = pre["device_ms_by_family"]["other"]
        scan.update(
            share_of_prefill_busy=(scan["busy_ms_per_prefill"]
                                   / pre["device_busy_ms"]
                                   if pre["device_busy_ms"] else None),
            share_of_prefill_other=(fam["other"] * scan["mamba_layers"]
                                    / other if other else None))
        out["ssd_scan"] = scan
    if args.graphs:
        out.update(_graph_phases(lm, args, prompt))
    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    return out


if __name__ == "__main__":
    main()
