"""Every walk of the dense_mm kernel, forced, at the served projection
shapes: device time per call (L2 cold), beside the walk ``dense_mm.walk``
picks, its time model and ``torch.matmul``.  Needs a card.

    PYTHONPATH=src python -m repro_torch.launch.bench_dense_mm \
        [--dtype bfloat16] [--out walks.json]

Rows: qwen3-moe's q (2048 -> 4096), k/v (2048 -> 512) and o (4096 ->
2048) and llama3.2-1b's q/o (2048 -> 2048) at N in {1, 4, 8, 16, 32,
64}; each forced walk is the decode walk at column lanes 8 / 16 / 32 and
cluster sizes 4 / 8, and the wgmma walk at 64 x 64 tiles with K unsplit
and split in 2, and at 128 x 128 tiles.  This is the race ``walk``'s
time model stands in for at N <= 16.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess

import torch

from repro_torch.kernels.dense_mm import ops

SHAPES = (("qwen3 q", 2048, 4096), ("qwen3 k/v", 2048, 512),
          ("qwen3 o", 4096, 2048), ("llama q/o", 2048, 2048))
NS = (1, 4, 8, 16, 32, 64)
ROTATE_BYTES = 160 * 2 ** 20     # input copies past the 50 MB L2


def _timed_ms(fn, sets, iters=60) -> float:
    fn(*sets[0])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(5e7))       # the events bracket device work only
    start.record()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _plans(n, k, d, dtype):
    plans = {f"decode cl{cl} s{s}": ops.Walk("decode", cl=cl, slices=s)
             for cl in (8, 16, 32) for s in (4, 8) if n <= ops.DECODE_MAX_N}
    if ops.tma_ok(k, d, dtype):
        plans.update({"wgmma 64x64 s1": ops.Walk("wgmma", bm=64, bn=64),
                      "wgmma 64x64 s2": ops.Walk("wgmma", bm=64, bn=64,
                                                 slices=2),
                      "wgmma 128x128 s1": ops.Walk("wgmma", bm=128,
                                                   bn=128)})
    return plans


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float16", "float32"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_dense_mm needs a CUDA device")
    dev = torch.device("cuda", 0)
    dt = getattr(torch, args.dtype)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for name, k, d in SHAPES:
        for n in NS:
            es = torch.empty((), dtype=dt).element_size()
            count = max(1, min(64, math.ceil(ROTATE_BYTES
                                             / ((n * k + k * d) * es))))
            sets = [(torch.randn((n, k), generator=gen, device=dev).to(dt),
                     (torch.randn((k, d), generator=gen, device=dev)
                      / math.sqrt(k)).to(dt)) for _ in range(count)]
            picked = ops.walk(n, k, d, dt)
            row = dict(shape=name, n=n, k=k, d=d, dtype=args.dtype,
                       walk=picked.name, model_ms={
                           w: ops.walk_seconds(w, n, k, d, dt) * 1e3
                           for w in ("decode", "wgmma")
                           if w != "wgmma" or ops.tma_ok(k, d, dt)},
                       ms=_timed_ms(ops.dense_mm_cuda, sets),
                       matmul_ms=_timed_ms(torch.matmul, sets),
                       forced={})
            for label, plan in _plans(n, k, d, dt).items():
                row["forced"][label] = _timed_ms(
                    lambda a, b, plan=plan: ops.dense_mm_cuda(a, b, plan),
                    sets)
            best = min(row["forced"], key=row["forced"].get)
            print(f"{name:10s} n={n:<3d} picked {picked.name:6s} "
                  f"{row['ms']:.4f} ms, best forced {best} "
                  f"{row['forced'][best]:.4f}, torch.matmul "
                  f"{row['matmul_ms']:.4f}; model "
                  + " ".join(f"{w} {v:.4f}"
                             for w, v in row["model_ms"].items()),
                  flush=True)
            rows.append(row)
            del sets
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
