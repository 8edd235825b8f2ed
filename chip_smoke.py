#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--out results.json] [--seed 0]

Run from the root of a checkout on a machine with one NVIDIA H100.
Phases, each fatal on failure:

1. environment: card name and power limit, torch/CUDA versions, and the
   build of every CUDA kernel from ``src/repro_torch/**/csrc/*.cu``
   (one ``nvcc`` per source, started together);
2. kernels: bsmm and dense_mm against their plain PyTorch versions on
   the card at the serving shapes of llama3.2-1b (bsmm up/gate
   8192x2048 and down 2048x8192 at b=16, d=1/8; dense_mm q/o 2048x2048
   and k/v 2048x512; N in {4, 256}; bf16 and fp32), with each kernel's
   time, its plain version's time, one library call's time and the
   least time the card could take (the bound);
3. serve: full-width llama3.2-1b (16 layers, d_model 2048, d_ff 8192,
   vocab 128256) with every FFN block-sparse at d=1/8, b=16, in bf16,
   seeded random weights, through ``Engine(batch=4, max_len=512)``: 8
   requests with seeded prompt lengths in 16..384, 16 new tokens each.
   The kernels' launch counters are zeroed just before and read just
   after; both must have launched;
4. consistency: for one prompt, padded ``prefill(last_index)`` logits
   and two ``decode_step``s against ``forward`` on the same tokens.

Prints the card line and a ``{"kernels": [...]}`` line before the last
line, which is ``{"ok": true, "device": {...}}``.  Exits non-zero and
prints no result without a CUDA device or outside a checkout.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and FLOP/s per
# operand type (fp32 outside the tensor cores)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
# rel-max budgets (error over the plain version's max magnitude): fp32
# differs only by summation order; bf16 by one rounding of each output
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the repo's bf16 budget (tests/conftest.py GRAD_TOLS): the decode path
# differs from the full-sequence path by bf16 roundings through the stack
CONSISTENCY_TOL = 6e-2
# timed launches cycle through enough input copies to exceed the 50 MB
# L2, as the serving path (16 layers of distinct weights) finds it cold
ROTATE_BYTES = 160 * 2 ** 20


def fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 2


def rel_err(got, want) -> tuple:
    diff = (got.float() - want.float()).abs().max().item()
    scale = max(want.float().abs().max().item(), 1e-6)
    return diff / scale, diff


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def timed_ms(torch, fn, arg_sets, iters: int) -> float:
    """Device time per call: a sleep kernel holds the stream while the
    host enqueues every launch, so the events bracket device work only
    (host overhead per launch does not count)."""
    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(1e8))
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def copies(make, nbytes: int):
    """``make()`` repeated until the sets hold ``ROTATE_BYTES``."""
    n = max(1, math.ceil(ROTATE_BYTES / max(nbytes, 1)))
    return [make() for _ in range(min(n, 64))]


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / PEAK_BYTES
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(torch, args):
    from repro_torch import sparse
    from repro_torch.core import masks
    from repro_torch.core.bsr import BlockSparseMatrix
    from repro_torch.kernels.bsmm import ops as bsmm_ops
    from repro_torch.kernels.dense_mm import ops as dmm_ops

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    rows = []
    b, density = 16, 1 / 8
    for shape_name, m, k in (("up/gate", 8192, 2048), ("down", 2048, 8192)):
        mask = masks.random_block_mask(m, k, b, density, seed=args.seed + 1)
        for dname, dt in dtypes.items():
            nnz = int(mask.sum())
            vals = torch.randn((nnz, b, b), generator=gen, device=dev,
                               dtype=torch.float32).to(dt) / math.sqrt(
                                   k * density)
            bsr = BlockSparseMatrix.from_mask(mask, b, values=vals)
            p = sparse.plan(bsr, 0, device=dev)
            tiles = p.pack(vals)
            dense_w = bsr.to_dense()
            es = vals.element_size()
            for n in (4, 256):
                x = torch.randn((n, k), generator=gen, device=dev,
                                dtype=torch.float32).to(dt)
                got = bsmm_ops.bsmm_nt_cuda(x, tiles, p.row_ptr,
                                            p.tile_cols, m)
                want = bsmm_ops.bsmm_nt_plain(x, tiles, p.tile_rows.long(),
                                              p.tile_cols.long(), m)
                torch.cuda.synchronize()
                err, abs_err = rel_err(got, want)
                call_bytes = (n * k + tiles.numel() + n * m) * es
                sets = copies(lambda: (x.clone(), tiles.clone()), call_bytes)
                ms = timed_ms(torch, lambda xx, tt: bsmm_ops.bsmm_nt_cuda(
                    xx, tt, p.row_ptr, p.tile_cols, m), sets, 100)
                plain_ms = timed_ms(
                    torch, lambda xx, tt: bsmm_ops.bsmm_nt_plain(
                        xx, tt, p.tile_rows.long(), p.tile_cols.long(), m),
                    sets[:4], 10)
                lsets = copies(lambda: (x.clone(), dense_w.clone()),
                               m * k * es)
                lib_ms = timed_ms(torch, lambda xx, ww: torch.matmul(
                    xx, ww.t()), lsets, 50)
                nbytes = ((n * k + nnz * b * b + n * m) * es
                          + (p.row_ptr.numel() + p.tile_cols.numel()) * 4)
                b_ms, b_by = bound(nbytes, 2.0 * n * nnz * b * b, dname)
                rows.append(dict(
                    kernel="bsmm", shape=f"{shape_name} {m}x{k}", n=n,
                    dtype=dname, rel_err=err, max_abs_err=abs_err,
                    tol=KERNEL_TOL[dname], ms=ms, plain_ms=plain_ms,
                    library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                    tiles=int(tiles.shape[0]), nnz_blocks=nnz))
                del sets, lsets
    for shape_name, k, d in (("q/o", 2048, 2048), ("k/v", 2048, 512)):
        for dname, dt in dtypes.items():
            w = (torch.randn((k, d), generator=gen, device=dev) /
                 math.sqrt(k)).to(dt)
            es = w.element_size()
            for n in (4, 256):
                x = torch.randn((n, k), generator=gen, device=dev).to(dt)
                got = dmm_ops.dense_mm_cuda(x, w)
                want = dmm_ops.dense_mm_plain(x, w)
                torch.cuda.synchronize()
                err, abs_err = rel_err(got, want)
                call_bytes = (n * k + k * d + n * d) * es
                sets = copies(lambda: (x.clone(), w.clone()), call_bytes)
                ms = timed_ms(torch, dmm_ops.dense_mm_cuda, sets, 100)
                plain_ms = timed_ms(torch, dmm_ops.dense_mm_plain, sets, 50)
                lib_ms = timed_ms(torch, torch.matmul, sets, 100)
                b_ms, b_by = bound(call_bytes, 2.0 * n * k * d, dname)
                rows.append(dict(
                    kernel="dense_mm", shape=f"{shape_name} {k}x{d}", n=n,
                    dtype=dname, rel_err=err, max_abs_err=abs_err,
                    tol=KERNEL_TOL[dname], ms=ms, plain_ms=plain_ms,
                    library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by))
                del sets
    return rows


def serve_phase(torch, args):
    import numpy as np

    from repro_torch import configs
    from repro_torch.kernels import bsmm, dense_mm
    from repro_torch.models.model import LM
    from repro_torch.serve import Engine, Request

    cfg = configs.sparsify_ffn(configs.get("llama3_2_1b"), 1 / 8)
    assert cfg.dtype == "bfloat16" and cfg.ffn_block_size == 16
    t0 = time.perf_counter()
    lm = LM(cfg, device="cuda", seed=args.seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in lm.parameters())

    nonfinite = {"calls": 0, "bad": 0}

    def checked(fn):
        def run(*a, **kw):
            logits, caches = fn(*a, **kw)
            nonfinite["calls"] += 1
            nonfinite["bad"] += int(not bool(torch.isfinite(logits).all()))
            return logits, caches
        return run

    lm.prefill = checked(lm.prefill)
    lm.decode_step = checked(lm.decode_step)

    rng = np.random.default_rng(args.seed)

    def requests(count, lo, hi, new):
        return [Request(uid=i, prompt=rng.integers(
                    0, cfg.vocab_size, size=int(rng.integers(lo, hi + 1))),
                    max_new_tokens=new) for i in range(count)]

    # warm-up (first cuBLAS/allocator use), then the measured run
    Engine(lm, batch=4, max_len=512, device="cuda").run(
        requests(2, 16, 64, 3))
    eng = Engine(lm, batch=4, max_len=512, device="cuda")
    reqs = requests(8, 16, 384, 16)
    torch.cuda.synchronize()
    bsmm.COUNTER.reset()
    dense_mm.COUNTER.reset()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"bsmm": bsmm.COUNTER.launches,
                "dense_mm": dense_mm.COUNTER.launches}

    if not all(r.done and len(r.output) == 16 for r in reqs):
        raise RuntimeError("not every request finished with 16 tokens")
    if nonfinite["bad"]:
        raise RuntimeError(f"{nonfinite['bad']} of {nonfinite['calls']} "
                           f"prefill/decode calls gave non-finite logits")
    if not all(0 <= t < cfg.vocab_size for r in reqs for t in r.output):
        raise RuntimeError("a generated token is outside the vocabulary")
    for name, count in launches.items():
        if count <= 0:
            raise RuntimeError(f"kernel {name} was not launched while "
                               f"serving")

    # launches of one decode step and one prefill
    caches = lm.init_cache(4, 512)
    per = {}
    for what, call in (
            ("prefill", lambda: lm.prefill(
                np.zeros((1, 64), np.int64), max_len=512, last_index=[63])),
            ("decode_step", lambda: lm.decode_step(
                np.zeros((4, 1), np.int64), caches,
                np.zeros(4, np.int64)))):
        bsmm.COUNTER.reset()
        dense_mm.COUNTER.reset()
        call()
        per[what] = {"bsmm": bsmm.COUNTER.launches,
                     "dense_mm": dense_mm.COUNTER.launches}
    torch.cuda.synchronize()

    st = eng.stats()
    tokens = sum(len(r.output) for r in reqs)
    return dict(
        params=n_params, init_s=init_s, requests=len(reqs),
        prompt_lens=[int(len(r.prompt)) for r in reqs], tokens=tokens,
        wall_s=wall, tokens_per_s=tokens / wall,
        prefill_p50_ms=st["prefill_latency"]["p50_ms"],
        decode_step_p50_ms=st["step_latency"]["p50_ms"],
        decode_steps=st["steps"], buckets=list(eng.buckets),
        bucket_stats={str(L): v for L, v in st["buckets"].items()},
        launches=launches, launches_per_call=per,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
        logit_checks=nonfinite["calls"]), lm


def consistency_phase(torch, lm, args):
    import numpy as np

    rng = np.random.default_rng(args.seed + 7)
    n = 64
    toks = rng.integers(0, lm.cfg.vocab_size, size=n + 2)
    full = lm.forward(toks[None, :]).float()               # [1, n+2, V]
    padded = np.zeros((1, 96), np.int64)
    padded[0, :n] = toks[:n]
    logits, caches = lm.prefill(padded, max_len=128, last_index=[n - 1])
    errs = {"prefill": rel_err(logits[0], full[0, n - 1])[0]}
    for i in range(2):
        pos = n + i
        logits, caches = lm.decode_step(toks[None, pos:pos + 1], caches,
                                         np.asarray([pos]))
        errs[f"decode_{i}"] = rel_err(logits[0], full[0, pos])[0]
    if not bool(torch.isfinite(full).all()):
        raise RuntimeError("forward gave non-finite logits")
    bad = {k: v for k, v in errs.items() if not v <= CONSISTENCY_TOL}
    if bad:
        raise RuntimeError(f"consistency beyond {CONSISTENCY_TOL}: {bad}")
    return errs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args(argv)

    try:
        import torch
    except ImportError:
        return fail("torch is not installed")
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: no card to run on")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        return fail(f"{SRC}/repro_torch not found: run from a checkout")
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import _build

    card = card_line()
    print(f"[env] card: {card}")
    print(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"[env] kernels built in {time.perf_counter() - t0:.2f}s "
          f"(per source: {json.dumps(built)})")

    rows = kernel_phase(torch, args)
    for r in rows:
        print(f"[kernel] {r['kernel']:8s} {r['shape']:18s} n={r['n']:<4d} "
              f"{r['dtype']:8s} rel_err={r['rel_err']:.2e} "
              f"ms={r['ms']:.5f} plain_ms={r['plain_ms']:.5f} "
              f"library_ms={r['library_ms']:.5f} "
              f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']})")
    bad = [r for r in rows if not r["rel_err"] <= r["tol"]]
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions: "
                           f"{bad}")

    serve, lm = serve_phase(torch, args)
    print(f"[serve] {serve['requests']} requests, {serve['tokens']} tokens "
          f"in {serve['wall_s']:.3f}s = {serve['tokens_per_s']:.1f} tok/s; "
          f"prefill p50 {serve['prefill_p50_ms']} ms, decode step p50 "
          f"{serve['decode_step_p50_ms']} ms; launches {serve['launches']}")
    print(f"[serve] detail {json.dumps(serve)}")

    errs = consistency_phase(torch, lm, args)
    print(f"[consistency] rel-max err vs forward: "
          f"{json.dumps(errs)} (budget {CONSISTENCY_TOL})")

    sources = {"bsmm": ("src/repro_torch/kernels/bsmm/csrc/bsmm.cu",
                        "src/repro/kernels/bsmm/bsmm.py:50",
                        "up/gate 8192x2048"),
               "dense_mm": ("src/repro_torch/kernels/dense_mm/csrc/"
                            "dense_mm.cu",
                            "src/repro/kernels/dense_mm/dense_mm.py:38",
                            "q/o 2048x2048")}
    kernels = []
    for name, (source, replaces, shape) in sources.items():
        # the decode shape of the main path: the most frequent launch
        r = next(r for r in rows if r["kernel"] == name and r["n"] == 4
                 and r["dtype"] == "bfloat16" and r["shape"].startswith(
                     shape.split()[0]))
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": serve["launches"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "at": f"{r['shape']} n={r['n']} {r['dtype']}"})

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "torch": torch.__version__,
                       "cuda": torch.version.cuda, "build_s": built,
                       "kernel_rows": rows, "serve": serve,
                       "consistency": errs, "kernels": kernels}, f,
                      indent=1)

    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
