#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--out results.json] [--seed 0]

Run from the root of a checkout on a machine with one NVIDIA H100.
Phases, each fatal on failure:

1. environment: card name and power limit, torch/CUDA versions, and the
   build of every CUDA kernel from ``src/repro_torch/**/csrc/*.cu``
   (one ``nvcc`` per source, started together);
2. kernels: every kernel against its plain PyTorch version on the card
   at the shapes of the main paths of llama3.2-1b (b=16, d=1/8; bsmm
   up/gate 8192x2048 and down 2048x8192, dense_mm q/o 2048x2048 and
   k/v 2048x512; bf16 and fp32): bsmm forward and on the transposed
   patterns at N in {4, 16, 256, 2048} (decode, prefill, training N =
   batch 4 x seq 512), the forward in bf16 also at N 8 and 64 (the
   crossover of its decode and mma walks), and at gemma2-2b's FFN (up/gate
   9216x2304, down 2304x9216) at the length its serve run prefills most
   prompts at (6112); dense_mm at serving N in {4, 256} and training N;
   sddmm at N in {256, 2048}; dense_mm also at
   llama's served prefill lengths, at gemma2-2b's q/k/v/o (decode N 2 and
   its served prefills), at qwen3-moe's q/k/v/o (N 4, 256, 1008 and its
   served prefills) and Table 3's 4096^3 in fp16, each row naming the
   walk the kernel took (decode, wgmma or ffma; sddmm's mma or ffma,
   with the FFMA walk's ms on the same 16-bit inputs; bsmm's decode, mma
   or ffma, with every other walk that takes N forced on the same 16-bit
   inputs: ffma_ms, and decode_ms or mma_ms); with each kernel's
   time, its plain version's time, one library call's time and the least
   time the card could take (the bound).  Each main-path phase below also
   reports the launches of dense_mm, bs_attn, gmm, dsmm, sddmm, bsmm and
   bsmm_balanced by walk, and fails if a 16-bit bs_attn or gmm launch of
   it ran off the wgmma walk, a 16-bit dsmm or sddmm launch at b >= 16
   off the mma walk, or a 16-bit bsmm launch at b = 16 on the ffma walk
   (mma or decode);
3. serve: full-width llama3.2-1b (16 layers, d_model 2048, d_ff 8192,
   vocab 128256) with every FFN block-sparse at d=1/8, b=16, in bf16,
   seeded random weights, through ``Engine(batch=4, max_len=512)``: 8
   requests with seeded prompt lengths in 16..384, 16 new tokens each,
   first with the engine's programs run eagerly (``graphs=False``), then
   through its CUDA graphs (one per prefill bucket and one decode step,
   captured at startup: ``warm_compile=True``), the main path.  The
   kernels' launch counters are zeroed just before the graph run and read
   just after (each replay adds the launches its graph holds); every
   kernel must have launched, no call's logits be non-finite (the
   engine's finite-logits flag, read with the tokens).  ``[graphs]``
   prints both runs' decode step p50, prefill p50 per bucket, tokens/s
   and peak GiB, the captures and their seconds, and fails unless every
   generated token is identical (phases 11 and 12 print theirs too);
4. consistency: for one prompt, padded ``prefill(last_index)`` logits
   and two ``decode_step``s against ``forward`` on the same tokens;
5. gradients: one full-width SparseLinear (up and down), bf16 and fp32,
   N = 2048: autograd dx and dvalues through the kernels against
   ``core/static_sparse``'s plain formulation on the card;
6. train: ``launch.train.train_loop`` on full-width llama3.2-1b with
   every FFN block-sparse (d=1/8, b=16), bf16, batch 4 x seq 512, 10
   AdamW steps from a seeded init, no checkpoint.  The launch counters
   are zeroed just before and read just after; every kernel must have
   launched, every loss and grad norm be finite, and the last loss be
   below the first;
7. dynamic kernels: dsmm against its plain version at the FFN shapes
   (d_max = 1/8, b = 16, N in {4, 256, 2048}), at Table 3's shape
   (4096 x 4096, d = 1/16, b in {4, 16}, N = 4096, fp16 and fp32) and
   on the grouped routes' t = 128 packed tiles (with the device tile
   pack's ms), each row naming its walk (mma in 16-bit at b >= 16, ffma
   else) and, on the mma walk, the FFMA walk's ms; bsmm_balanced on the
   skew grid (4096 x 4096, b = 16, d = 1/32, N = 4096; uniform,
   power-law and DLMC masks; bf16 and fp32), naming its walk (mma in
   16-bit, with the FFMA walk's ms), beside the uniform bsmm walk on the
   same tiles (these rows print with the kernel rows of phase 2);
8. table3: the paper's Table 3 (m = k = 4096, d = 1/16, N = 4096, b in
   {1, 4, 16}, fp16 and fp32; b = 1 packed into 4 x 4 tiles on the
   static routes and re-blocked on the device on dynamic_cuda): one line
   per route (dense_cuda, static_cuda, static_balanced_cuda,
   dynamic_cuda with its encode, and the grouped
   routes at worst-case capacity) with its ms and its speedup against
   dense_cuda and torch.matmul; every output checked against the fp32
   dense product, every kernel of the routes launched, every sparse
   route's launches (bsmm, bsmm_balanced, dsmm) on the walk its walked
   block takes;
9. dynamic: a SwiGLU FFN of three DynamicSparseLinear at llama3.2-1b
   width (2048 -> 8192 -> 2048, d_max = 1/8, b = 16, bf16), N = 2048,
   5 forward + backward steps with a fresh seeded mask each; step 0
   against the plain formulation; the mask must change every step, no
   plan be built after step 0 and dsmm launch on every step; then one
   planned-capacity pass on the grouped route for its capacity report;
10. attn (after phase 2's rows): bs_attn against its plain version (a
   dense softmax over the element mask) in bf16 and fp32 (fp16 too at
   llama's and qwen3's rows) at gemma2-2b's
   global layer (B 1, H 8, KV 4, dh 256, S 4096, causal, soft-cap 50),
   its local layer (S 8192, window 4096), the prefill lengths phase 11
   serves on its engine's ladder (global and local; at 8176 the tiles
   halve to 16), llama3.2-1b's (H 32, KV 8, dh 64, S 2048) and an odd S (1023)
   whose tiles halve to 1, with ms, plain ms, bound ms and one library
   call's ms (SDPA, or compiled flex_attention where a soft-cap or a
   window rules SDPA out), the library's output also held against the
   plain version; each row names its walk (wgmma in 16-bit, cuda_core in
   fp32) and, in 16-bit, the CUDA-core walk's ms on the same inputs; the
   llama serve and train phases launch bs_attn too;
11. serve-gemma2: full-width gemma2-2b (26 layers of alternating local
   and global attention, d_model 2304, head dim 256, d_ff 9216, vocab
   256000) with every FFN block-sparse at d=1/8, b=16, bf16, through
   ``Engine(batch=2, max_len=8192)``: 4 seeded requests of 1024..7000
   prompt tokens (one over 4608), 8 new tokens each, eagerly and through
   the engine's graphs as in phase 3; bs_attn, bsmm and dense_mm must
   launch in the graph run; local layers must visit fewer (q, kv) tile
   pairs than global ones at the longest prompt; decode after a
   5118-token prompt, prefilled in the engine's bucket, must match
   ``forward`` layer by layer in bf16 (each layer's attention, same
   inputs) and end to end in fp32 (the same seeded weights), the bf16
   end-to-end gap printed;
12. serve-qwen3-moe: full-width, full-depth qwen3-moe-30b-a3b (48
   layers, d_model 2048, GQA 32/4, head dim 128, QK-norm, 128 experts
   top-8 of d_ff 768, vocab 151936; 30.5 B parameters) in bf16 from
   ``init(seed)`` on the card, through ``Engine(batch=4,
   max_len=1024)``: 6 seeded requests of 32..900 prompt tokens, 8 new
   tokens each, eagerly and through the engine's graphs as in phase 3;
   gmm, dense_mm and bs_attn must launch in the graph run; each
   prefill's routing drops printed, the graph run's equal to the eager
   run's (count and values); one layer's ``moe_apply`` on a prefill hidden
   state, gmm route against the plain route (same fp32 routing), within
   the bf16 kernel budget.  Its gmm kernel rows print with phase 2's: the
   expert GEMMs (E 128, gate/up 2048 -> 768, down 768 -> 2048) at the
   decode capacity C = 8 and at the largest prefill's (one row tile of C
   rows per expert), and the reference test's general case (random ids),
   bf16, fp16 and fp32, each row naming its walk (wgmma in 16-bit, ffma
   in fp32) and, in 16-bit, the FFMA walk's ms on the same inputs;
12b. qwen3-fp32: the same model at full width in fp32, depth cut to 4
   layers: decode after a 6-token prompt, prefilled in its bucket,
   against ``forward`` within the fp32 budget, ``forward`` dropping no
   assignment.

Prints the card line and a ``{"kernels": [...]}`` line before the last
line, which is ``{"ok": true, "device": {...}}``.  Exits non-zero and
prints no result without a CUDA device or outside a checkout.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import subprocess
import sys
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and FLOP/s per
# operand type (fp32 outside the tensor cores)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
# rel-max budgets (error over the plain version's max magnitude): fp32
# differs only by summation order; bf16 by one rounding of each output
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 2e-2}
# the repo's bf16 budget (tests/conftest.py GRAD_TOLS): the decode path
# differs from the full-sequence path by bf16 roundings through the stack
CONSISTENCY_TOL = 6e-2
# the repo's fp32 budget for a model's logits against another path
# (tests/test_torch_model.py, tests/test_torch_gemma2.py)
LOGITS_TOL_FP32 = 2e-4
# timed launches cycle through enough input copies to exceed the 50 MB
# L2, as the serving path (16 layers of distinct weights) finds it cold
ROTATE_BYTES = 160 * 2 ** 20
# the train phase: AdamW steps from a seeded init, with a short warmup
TRAIN_STEPS = 10
TRAIN_HP = dict(peak_lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS)


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


WALK_KERNELS = ("dense_mm", "bs_attn", "gmm", "dsmm", "sddmm", "bsmm",
                "bsmm_balanced")
# each kernel's tensor-core walk (what its 16-bit launches at b >= 16 take)
TC_WALK = {"bs_attn": "wgmma", "gmm": "wgmma", "dsmm": "mma",
           "sddmm": "mma", "bsmm": "mma", "bsmm_balanced": "mma"}
# the other walks a 16-bit launch at b >= 16 may take: bsmm's decode walk
# for the fewest tokens
ALSO_ALLOWED = {"bsmm": ("decode",)}


def with_walks(counters):
    """``counters`` plus the launch counter of each walk of the kernels
    that have several (dense_mm, bs_attn, gmm, dsmm, sddmm, bsmm,
    bsmm_balanced), under ``<kernel>:<walk>``."""
    from repro_torch.kernels.bs_attn import ops as bs_ops
    from repro_torch.kernels.bsmm import balanced as bal_ops
    from repro_torch.kernels.bsmm import ops as bsmm_ops
    from repro_torch.kernels.dense_mm import ops as dmm_ops
    from repro_torch.kernels.dsmm import ops as dsmm_ops
    from repro_torch.kernels.gmm import ops as gmm_ops
    from repro_torch.kernels.sddmm import ops as sddmm_ops
    out = dict(counters)
    for kernel, ops in zip(WALK_KERNELS, (dmm_ops, bs_ops, gmm_ops, dsmm_ops,
                                          sddmm_ops, bsmm_ops, bal_ops)):
        out.update({f"{kernel}:{w}": c for w, c in ops.WALK_COUNTERS.items()})
    return out


def split_walks(launches):
    """``(kernel launches, {kernel: launches by walk})`` of a reading of
    ``with_walks`` counters."""
    walks = {k: {} for k in WALK_KERNELS}
    for key, v in launches.items():
        if ":" in key:
            kernel, w = key.split(":", 1)
            walks[kernel][w] = v
    return {k: v for k, v in launches.items() if ":" not in k}, walks


def check_tensor_core_walks(phase, walks, kernels=("bs_attn", "gmm")):
    """Every launch of ``kernels`` on a 16-bit main path (whose sparse
    blocks are b = 16) ran on its tensor-core walk (bsmm: or its decode
    walk)."""
    off = {k: {w: n for w, n in walks[k].items()
               if w != TC_WALK[k] and w not in ALSO_ALLOWED.get(k, ()) and n}
           for k in kernels}
    if any(off.values()):
        raise RuntimeError(f"[{phase}] 16-bit launches off the tensor-core "
                           f"walks: {off}")


def serve_run(torch, eng, prompts, new):
    """Serve ``prompts`` (``new`` tokens each) through ``eng``: the
    requests, the host wall and the engine's stats.  The peak memory is
    the card's since the caller's last ``reset_peak_memory_stats``."""
    from repro_torch.serve import Request

    reqs = [Request(uid=i, prompt=p, max_new_tokens=new)
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = eng.stats()
    if not all(r.done and len(r.output) == new for r in reqs):
        raise RuntimeError(f"not every request finished with {new} tokens")
    if st["logits"]["nonfinite"]:
        raise RuntimeError(f"{st['logits']['nonfinite']} of "
                           f"{st['logits']['checks']} prefill/decode calls "
                           f"gave non-finite logits")
    return dict(reqs=reqs, wall_s=wall, stats=st,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30)


def graphs_line(eager, graph):
    """The [graphs] comparison of one model: the same seeded requests
    through the engine run eagerly (``graphs=False``) and through its
    CUDA graphs (captured at startup), in one call; fails if a generated
    token differs."""
    def per_bucket(st):
        return {str(L): b["latency"]["p50_ms"]
                for L, b in st["buckets"].items() if b["prefills"]}

    def tokens_per_s(run):
        return sum(len(r.output) for r in run["reqs"]) / run["wall_s"]

    g = graph["stats"]["graphs"]

    def both(stream):
        return {"eager": eager["stats"][stream]["p50_ms"],
                "graphs": graph["stats"][stream]["p50_ms"]}

    out = dict(
        decode_step_p50_ms=both("step_latency"),
        prefill_p50_ms=both("prefill_latency"),
        prefill_p50_ms_by_bucket={"eager": per_bucket(eager["stats"]),
                                  "graphs": per_bucket(graph["stats"])},
        tokens_per_s={"eager": tokens_per_s(eager),
                      "graphs": tokens_per_s(graph)},
        capture_s=g["capture_s"],
        captures={"prefill": {str(L): v["captures"]
                              for L, v in g["prefill"].items()},
                  "decode": g["decode"]["captures"]},
        replays=g["replays"],
        peak_mem_gb={"eager": eager["peak_mem_gb"],
                     "graphs": graph["peak_mem_gb"]},
        tokens_identical=[r.output for r in eager["reqs"]]
        == [r.output for r in graph["reqs"]])
    if not out["tokens_identical"]:
        raise RuntimeError(f"[graphs] tokens differ between the eager and "
                           f"the graph run: {out}")
    return out


def print_graphs(name, g):
    print(f"[graphs] {name}: decode step p50 eager "
          f"{g['decode_step_p50_ms']['eager']} / graphs "
          f"{g['decode_step_p50_ms']['graphs']} ms; prefill p50 by bucket "
          f"eager {json.dumps(g['prefill_p50_ms_by_bucket']['eager'])} / "
          f"graphs {json.dumps(g['prefill_p50_ms_by_bucket']['graphs'])} ms; "
          f"tokens/s eager {g['tokens_per_s']['eager']:.2f} / graphs "
          f"{g['tokens_per_s']['graphs']:.2f}; capture "
          f"{g['capture_s']:.3f} s (captures {json.dumps(g['captures'])}); "
          f"peak GiB eager {g['peak_mem_gb']['eager']:.2f} / graphs "
          f"{g['peak_mem_gb']['graphs']:.2f}; tokens identical "
          f"{g['tokens_identical']}")


def measured_row(torch, kernel, shape, n, dname, run, plain, library,
                 sets, lib_sets, nbytes, flops):
    """One kernel row: ``run`` against ``plain`` on the first input set,
    then device ms of ``run``, ``plain`` and ``library`` over the sets
    (``library`` takes ``lib_sets``; None where no one library call
    computes the function), and the bound for ``nbytes`` and ``flops``."""
    got, want = run(*sets[0]), plain(*sets[0])
    torch.cuda.synchronize()
    err, abs_err = rel_err(got, want)
    b_ms, b_by = bound(nbytes, flops, dname)
    small = n <= 256             # short launches: more of them per timing
    return dict(kernel=kernel, shape=shape, n=n, dtype=dname, rel_err=err,
                max_abs_err=abs_err, tol=KERNEL_TOL[dname],
                ms=timed_ms(torch, run, sets, 100 if small else 30),
                plain_ms=timed_ms(torch, plain, sets[:2], 10 if small else 4),
                library_ms=(None if library is None else
                            timed_ms(torch, library, lib_sets,
                                     50 if small else 20)),
                bound_ms=b_ms, bound_by=b_by)


def kernel_phase(torch, args):
    """Every kernel against its plain version at the shapes of the main
    paths: serving (N = 4 decode, 256 prefill) and training (N = batch 4
    x seq 512 = 2048 tokens; sddmm also at 256)."""
    from repro_torch import sparse
    from repro_torch.core import masks
    from repro_torch.core.bsr import BlockSparseMatrix
    from repro_torch.kernels.bsmm import ops as bsmm_ops
    from repro_torch.kernels.dense_mm import ops as dmm_ops
    from repro_torch.kernels.sddmm import ops as sddmm_ops

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    rows = []
    b, density, train_n = 16, 1 / 8, 2048

    def randn(shape, dt, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32) * scale).to(dt)

    def bsmm_rows(shape, tiles, meta, d_in, d_out, dense_w, lib, ns, dname,
                  dt, nnz):
        """bsmm rows of x [N, d_in] -> [N, d_out] over ``tiles`` walked by
        ``meta`` (a plan or its grad plan): the walk ``walk()`` names,
        and in 16-bit every other walk that takes N forced on the same
        inputs (``walk_ms``: ffma, and decode or mma)."""
        es = torch.empty((), dtype=dt).element_size()
        for n in ns:
            a = randn((n, d_in), dt)
            nbytes = (n * d_in + tiles.numel() + n * d_out) * es
            sets = copies(lambda: (a.clone(), tiles.clone()), nbytes)
            lib_sets = copies(lambda: (a.clone(), dense_w.clone()),
                              (n * d_in + d_in * d_out) * es)

            def run(a_, t_, plan=None):
                return bsmm_ops.bsmm_nt_cuda(a_, t_, meta.row_ptr,
                                             meta.tile_cols, d_out,
                                             meta.mma, plan=plan)
            row = dict(measured_row(
                torch, "bsmm", shape, n, dname, run,
                lambda a_, t_: bsmm_ops.bsmm_nt_plain(
                    a_, t_, meta.tile_rows.long(), meta.tile_cols.long(),
                    d_out),
                lib, sets, lib_sets,
                # the non-zero blocks, not the pad tiles
                nbytes - (tiles.numel() - nnz * b * b) * es
                + (meta.row_ptr.numel() + meta.tile_cols.numel()) * 4,
                n * 2.0 * nnz * b * b), tiles=int(tiles.shape[0]),
                nnz_blocks=nnz)
            wk = bsmm_ops.walk(b, dt, n)
            others = []
            if dt != torch.float32:
                others = [w for w in ("decode", "mma", "ffma") if w != wk
                          and (w != "decode"
                               or n <= bsmm_ops.DECODE_CAPACITY[b])]
            row.update(walk=wk, walk_ms={
                w: timed_ms(torch, lambda a_, t_, w=w: run(a_, t_, w), sets,
                            30 if n <= 256 else 10) for w in others})
            # the FFMA walk (every dtype's walk past decode before the
            # tensor-core one) on the same 16-bit inputs
            row["before_ms"] = row["walk_ms"].get("ffma")
            if meta.mma is not None:
                row.update(mma_groups=meta.mma.groups,
                           mma_stages=meta.mma.stages)
            rows.append(row)
            del sets, lib_sets

    for shape_name, m, k in (("up/gate", 8192, 2048), ("down", 2048, 8192)):
        mask = masks.random_block_mask(m, k, b, density, seed=args.seed + 1)
        nnz = int(mask.sum())
        flops = 2.0 * nnz * b * b          # per activation row
        for dname, dt in dtypes.items():
            es = torch.empty((), dtype=dt).element_size()
            vals = randn((nnz, b, b), dt, 1 / math.sqrt(k * density))
            bsr = BlockSparseMatrix.from_mask(mask, b, values=vals)
            p = sparse.plan(bsr, 0, device=dev)
            g = p.grad
            dense_w = bsr.to_dense()
            # bsmm forward x [N, k] -> [N, m] (decode, the crossover of
            # decode and mma in 16-bit, prefill and training N) and dL/dx
            # over W^T's tiles dy [N, m] -> [N, k]
            fwd_ns = ((4, 8, 16, 64, 256, train_n) if dt != torch.float32
                      else (4, 16, 256, train_n))
            bsmm_rows(f"{shape_name} {m}x{k}", p.pack(vals), p, k, m,
                      dense_w, lambda a_, w_: torch.matmul(a_, w_.t()),
                      fwd_ns, dname, dt, nnz)
            bsmm_rows(f"{shape_name} {m}x{k} transposed", p.pack_t(vals), g,
                      m, k, dense_w, torch.matmul, (4, 16, 256, train_n),
                      dname, dt, nnz)
            # dL/dvalues: dy [N, m], x [N, k] -> [nnz, b, b]; the library
            # call is the dense product the sampled one is a part of
            for n in (256, train_n):
                dy, x = randn((n, m), dt), randn((n, k), dt)
                nbytes = (n * m + n * k + nnz * b * b) * es
                sets = copies(lambda: (dy.clone(), x.clone()), nbytes)
                row = measured_row(
                    torch, "sddmm", f"{shape_name} {m}x{k}", n, dname,
                    lambda d_, x_: sddmm_ops.sddmm_cuda(
                        d_, x_, g.block_row_ptr, g.col_idx, b),
                    lambda d_, x_: sddmm_ops.sddmm_plain(
                        d_, x_, g.row_idx.long(), g.col_idx.long(), b),
                    lambda d_, x_: torch.matmul(d_.t(), x_), sets, sets,
                    nbytes + (g.block_row_ptr.numel() + nnz) * 4, n * flops)
                # what the kernel's activation-major reads avoid: one
                # transposing copy of both operands per call
                row["transpose_ms"] = timed_ms(
                    torch, lambda d_, x_: (d_.t().contiguous(),
                                           x_.t().contiguous()), sets, 20)
                wk = sddmm_ops.walk(b, dt)
                row.update(walk=wk, splits=sddmm_ops.n_splits(n, m // b, wk))
                # the FFMA walk (every dtype's walk before the tensor-core
                # one) on the same 16-bit inputs, timed beside it
                row["before_ms"] = (timed_ms(
                    torch, lambda d_, x_: sddmm_ops.sddmm_cuda(
                        d_, x_, g.block_row_ptr, g.col_idx, b, plan="ffma"),
                    sets, 10) if wk != "ffma" else None)
                rows.append(row)
                del sets
            del dense_w
    # bsmm at gemma2-2b's FFN (d_model 2304, d_ff 9216, d = 1/8, b = 16)
    # at the length [serve-gemma2] prefills most of its prompts at
    from repro_torch import configs
    gemma = configs.get("gemma2-2b")
    gemma_pre = min(gemma2_prefill_lens(args))
    for shape_name, m, k in (("gemma2 up/gate", gemma.d_ff, gemma.d_model),
                             ("gemma2 down", gemma.d_model, gemma.d_ff)):
        mask = masks.random_block_mask(m, k, b, density, seed=args.seed + 4)
        nnz = int(mask.sum())
        for dname, dt in dtypes.items():
            vals = randn((nnz, b, b), dt, 1 / math.sqrt(k * density))
            bsr = BlockSparseMatrix.from_mask(mask, b, values=vals)
            p = sparse.plan(bsr, 0, device=dev)
            bsmm_rows(f"{shape_name} {m}x{k}", p.pack(vals), p, k, m,
                      bsr.to_dense(), lambda a_, w_: torch.matmul(a_, w_.t()),
                      (gemma_pre,), dname, dt, nnz)
            del bsr, p, vals
    # dense_mm at llama's q/o and k/v (decode N 4, N 256, training N and
    # every prefill length [serve] runs), gemma2's attention projections
    # (q 2304 -> 8 x 256, k/v 2304 -> 4 x 256, o 2048 -> 2304) at its
    # decode batch 2 and every prefill length [serve-gemma2] runs,
    # qwen3-moe's (q 2048 -> 32 x 128, k/v 2048 -> 4 x 128, o 4096 ->
    # 2048) at its decode batch, at N 256 and 1008 and at every prefill
    # length [serve-qwen3-moe] runs, and Table 3's 4096^3 in fp16; each
    # row names the walk the kernel took
    llama_ns = sorted({4, 256, train_n} | set(llama_prefill_lens(args)))
    g_q, g_kv = (gemma.num_heads * gemma.head_dim,
                 gemma.num_kv_heads * gemma.head_dim)
    gemma_ns = sorted({GEMMA2_BATCH} | set(gemma2_prefill_lens(args)))
    qwen_ns = sorted({QWEN3_BATCH, 256, 1008} | set(qwen3_prefill_lens(args)))
    fp16 = {"float16": torch.float16}
    for shape_name, k, d, ns, dts in (
            ("q/o", 2048, 2048, llama_ns, dtypes),
            ("k/v", 2048, 512, llama_ns, dtypes),
            ("gemma2 q", gemma.d_model, g_q, gemma_ns, dtypes),
            ("gemma2 k/v", gemma.d_model, g_kv, gemma_ns, dtypes),
            ("gemma2 o", g_q, gemma.d_model, gemma_ns, dtypes),
            ("qwen3 q", 2048, 4096, qwen_ns, dtypes),
            ("qwen3 k/v", 2048, 512, qwen_ns, dtypes),
            ("qwen3 o", 4096, 2048, qwen_ns, dtypes),
            ("table3 dense", 4096, 4096, (4096,), fp16)):
        for dname, dt in dts.items():
            w = randn((k, d), dt, 1 / math.sqrt(k))
            for n in ns:
                x = randn((n, k), dt)
                nbytes = (n * k + k * d + n * d) * w.element_size()
                sets = copies(lambda: (x.clone(), w.clone()), nbytes)
                row = measured_row(
                    torch, "dense_mm", f"{shape_name} {k}x{d}", n, dname,
                    dmm_ops.dense_mm_cuda, dmm_ops.dense_mm_plain,
                    torch.matmul, sets, sets, nbytes, 2.0 * n * k * d)
                wk = dmm_ops.walk(n, k, d, dt)
                row.update(walk=wk.name, tile=f"{wk.bm}x{wk.bn}",
                           slices=wk.slices, blocks=wk.blocks)
                rows.append(row)
                del sets
    return rows


def grad_phase(torch, args):
    """Autograd through one full-width SparseLinear on the kernels
    against the plain formulation of ``core/static_sparse``."""
    from repro_torch.core import static_sparse
    from repro_torch.core.sparse_layers import SparseLinear

    dev = torch.device("cuda", 0)
    out = []
    n, b = 2048, 16
    for name, d_in, d_out in (("up", 2048, 8192), ("down", 8192, 2048)):
        for dname, dt in (("bfloat16", torch.bfloat16),
                          ("float32", torch.float32)):
            layer = SparseLinear.random_pattern(
                d_in, d_out, b, 1 / 8, seed=args.seed + 1, dtype=dt,
                device=dev)
            layer.reset_parameters(
                torch.Generator(device=dev).manual_seed(args.seed))
            layer.requires_grad_(True)
            g = torch.Generator(device=dev).manual_seed(args.seed + 3)
            x = torch.randn((n, d_in), generator=g, device=dev).to(dt)
            gy = torch.randn((n, d_out), generator=g, device=dev).to(dt)
            x.requires_grad_(True)
            layer(x).backward(gy)
            f = static_sparse.make_spmm(layer.row_idx, layer.col_idx,
                                        (d_out // b, d_in // b), b)
            v = layer.values.detach().clone().requires_grad_(True)
            xt = x.detach().t().contiguous().requires_grad_(True)
            f(v, xt).backward(gy.t())
            torch.cuda.synchronize()
            dv_err = rel_err(layer.values.grad, v.grad)[0]
            dx_err = rel_err(x.grad, xt.grad.t())[0]
            out.append(dict(layer=name, dtype=dname, n=n,
                            dvalues_rel_err=dv_err, dx_rel_err=dx_err,
                            tol=KERNEL_TOL[dname]))
            del layer, x, gy, v, xt, f
    bad = [r for r in out if not (r["dvalues_rel_err"] <= r["tol"]
                                  and r["dx_rel_err"] <= r["tol"])]
    if bad:
        raise RuntimeError(f"kernel gradients disagree with the plain "
                           f"formulation: {bad}")
    return out


def train_phase(torch, args):
    """``train_loop`` at full width; launch counts per step and overall."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.kernels import bs_attn, bsmm, dense_mm, sddmm
    from repro_torch.launch.train import train_loop
    from repro_torch.train.step import TrainHParams

    cfg = configs.sparsify_ffn(configs.get("llama3_2_1b"), 1 / 8)
    assert cfg.dtype == "bfloat16" and cfg.ffn_block_size == 16
    counters = with_walks({"bsmm": bsmm.COUNTER, "sddmm": sddmm.COUNTER,
                           "dense_mm": dense_mm.COUNTER,
                           "bs_attn": bs_attn.COUNTER})
    steps, batch, seq = TRAIN_STEPS, 4, 512
    hp = TrainHParams(**TRAIN_HP)
    per_step = []
    last = {k: 0 for k in counters}
    records = []

    def on_step(step, metrics):
        now = {k: c.launches for k, c in counters.items()}
        per_step.append({k: now[k] - last[k] for k in counters})
        last.update(now)
        records.append(dict(step=step, loss=float(metrics["loss"]),
                            grad_norm=float(metrics["grad_norm"]),
                            lr=float(metrics["lr"]),
                            step_s=float(metrics["step_s"])))
        print(f"[train] step {step} loss {records[-1]['loss']:.4f} "
              f"gnorm {records[-1]['grad_norm']:.4f} "
              f"wall {records[-1]['step_s'] * 1e3:.1f} ms "
              f"launches {per_step[-1]}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    _, losses = train_loop(cfg, steps=steps, batch_per_shard=batch,
                           seq=seq, ckpt_dir=None, hp=hp, device="cuda",
                           log_every=10 ** 9, on_step=on_step,
                           seed=args.seed)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, walks = split_walks({k: c.launches
                                   for k, c in counters.items()})
    check_tensor_core_walks("train", walks, ("bs_attn", "sddmm", "bsmm"))
    walls = sorted(r["step_s"] for r in records)
    p50 = float(np.median(walls))
    result = dict(
        steps=steps, batch=batch, seq=seq, hp=dict(TRAIN_HP),
        losses=losses, records=records, launches=launches,
        walks=walks, launches_per_step=per_step, wall_s=wall,
        step_p50_ms=p50 * 1e3,
        tokens_per_s=batch * seq / p50,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
    if not all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
               for r in records):
        raise RuntimeError(f"non-finite loss or grad norm: {records}")
    for name, count in launches.items():
        if count <= 0:
            raise RuntimeError(f"kernel {name} was not launched while "
                               f"training")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"loss did not fall: first {losses[0]}, last "
                           f"{losses[-1]}")
    return result


def serve_phase(torch, args):
    """[serve]: llama3.2-1b through ``Engine(batch=4, max_len=512)``: a
    warm-up run (eager), the seeded requests eagerly, then through the
    engine's CUDA graphs (every bucket and the decode step captured at
    startup): the main path, whose launch counters are zeroed just
    before and read just after."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.kernels import bs_attn, bsmm, dense_mm
    from repro_torch.models.model import LM
    from repro_torch.serve import Engine, Request

    counters = with_walks({"bsmm": bsmm.COUNTER, "dense_mm": dense_mm.COUNTER,
                           "bs_attn": bs_attn.COUNTER})
    cfg = configs.sparsify_ffn(configs.get("llama3_2_1b"), 1 / 8)
    assert cfg.dtype == "bfloat16" and cfg.ffn_block_size == 16
    t0 = time.perf_counter()
    lm = LM(cfg, device="cuda", seed=args.seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in lm.parameters())

    rng = np.random.default_rng(args.seed)

    def requests(bounds, new):
        return [Request(uid=i, prompt=rng.integers(
                    0, cfg.vocab_size, size=int(rng.integers(lo, hi + 1))),
                    max_new_tokens=new) for i, (lo, hi) in enumerate(bounds)]

    kw = dict(batch=4, max_len=LLAMA_MAX_LEN, device="cuda")
    # warm-up (first cuBLAS/allocator use, eager), then the same requests
    # eagerly and through the graphs
    Engine(lm, graphs=False, warm_plans=False, **kw).run(
        requests(LLAMA_WARMUP, 3))
    prompts = [r.prompt for r in requests(LLAMA_PROMPTS, LLAMA_NEW)]
    if [len(p) for p in prompts] != llama_prompt_lens(args):
        raise RuntimeError("llama_prompt_lens does not replay the run")
    torch.cuda.reset_peak_memory_stats()
    eager = serve_run(torch, Engine(lm, graphs=False, **kw), prompts,
                      LLAMA_NEW)
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(lm, warm_compile=True, **kw)
    torch.cuda.synchronize()
    for c in counters.values():
        c.reset()
    run = serve_run(torch, eng, prompts, LLAMA_NEW)
    launches, walks = split_walks({k: c.launches
                                   for k, c in counters.items()})
    check_tensor_core_walks("serve", walks, ("bs_attn", "gmm", "bsmm"))
    reqs, wall, st = run["reqs"], run["wall_s"], run["stats"]
    graphs = graphs_line(eager, run)

    if not all(0 <= t < cfg.vocab_size for r in reqs for t in r.output):
        raise RuntimeError("a generated token is outside the vocabulary")
    for name, count in launches.items():
        if count <= 0:
            raise RuntimeError(f"kernel {name} was not launched while "
                               f"serving")

    # launches of one decode step and one prefill (eager)
    caches = lm.init_cache(4, LLAMA_MAX_LEN)
    per = {}
    for what, call in (
            ("prefill", lambda: lm.prefill(
                np.zeros((1, 64), np.int64), max_len=LLAMA_MAX_LEN,
                last_index=[63])),
            ("decode_step", lambda: lm.decode_step(
                np.zeros((4, 1), np.int64), caches,
                np.zeros(4, np.int64)))):
        for c in counters.values():
            c.reset()
        call()
        per[what] = split_walks({k: c.launches
                                 for k, c in counters.items()})[0]
    torch.cuda.synchronize()

    tokens = sum(len(r.output) for r in reqs)
    return dict(
        params=n_params, init_s=init_s, requests=len(reqs),
        prompt_lens=[int(len(r.prompt)) for r in reqs], tokens=tokens,
        wall_s=wall, tokens_per_s=tokens / wall,
        prefill_p50_ms=st["prefill_latency"]["p50_ms"],
        decode_step_p50_ms=st["step_latency"]["p50_ms"],
        decode_steps=st["steps"], buckets=list(eng.buckets),
        bucket_stats={str(L): v for L, v in st["buckets"].items()},
        launches=launches, walks=walks, launches_per_call=per,
        peak_mem_gb=run["peak_mem_gb"],
        logit_checks=st["logits"]["checks"], graphs=graphs), lm


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


# [attn] shapes: (name, S, heads, kv heads, head dim, window, softcap,
# scale); tiles start at 512 and halve until they divide S (8176: to 16,
# walked 4 q tiles a block; 1023: to 1).  The "served" rows
# (gemma2_attn_shapes, qwen3_attn_shapes) are the prefill lengths the
# serve runs make on their engines' ladders
ATTN_SHAPES = (
    ("gemma2 global", 4096, 8, 4, 256, 0, 50.0, 1 / 16),
    ("gemma2 local", 8192, 8, 4, 256, 4096, 50.0, 1 / 16),
    ("llama", 2048, 32, 8, 64, 0, None, 1 / 8),
    ("llama odd S", 1023, 32, 8, 64, 0, None, 1 / 8),
)
# rows also run in fp16 (the tensor-core walk's other type)
ATTN_FP16 = ("llama", "llama odd S", "qwen3 served")
# [serve-gemma2]: Engine(batch=2, max_len=8192); seeded prompts of
# 1024..7000 tokens (the last one over window + tile = 4608), 8 new each
GEMMA2_MAX_LEN, GEMMA2_NEW, GEMMA2_BATCH = 8192, 8, 2
GEMMA2_PROMPTS = ((1024, 7000),) * 3 + ((4609, 7000),)
GEMMA2_WARMUP = ((64, 128),) * 2
# [serve]: llama3.2-1b through Engine(batch=4, max_len=512); seeded
# prompts of 16..384 tokens, 16 new each, after 2 warm-up requests
LLAMA_MAX_LEN, LLAMA_NEW = 512, 16
LLAMA_PROMPTS = ((16, 384),) * 8
LLAMA_WARMUP = ((16, 64),) * 2


def prefill_lens(cfg, max_len, prompt_lens):
    """The length each prompt is prefilled at (B = 1 per prefill):
    ``Engine.bucket_for``'s rule on the engine's own ladder -- the
    smallest bucket holding the prompt, or the prompt's own length where
    that bucket's priced padding passes ``pad_max_frac``."""
    from repro_torch.serve import engine

    shapes = engine._stack_shapes(cfg)
    pad_max_frac = 0.75                  # Engine's default
    ladder = engine._auto_buckets(max_len - 1, shapes, pad_max_frac,
                                  dtype=cfg.dtype)
    out = []
    for n in prompt_lens:
        b = next(b for b in ladder if b >= n)
        waste = 1.0 - (engine.price_tokens(shapes, n, dtype=cfg.dtype)
                       / engine.price_tokens(shapes, b, dtype=cfg.dtype))
        out.append(b if waste <= pad_max_frac else n)
    return out


def replay_prompt_lens(seed, vocab, warmup, prompts):
    """A serve run's prompt lengths: its generator (a length in [lo, hi],
    then the prompt's tokens, per request) replayed through the warm-up
    requests' draws."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = []
    for lo, hi in warmup + prompts:
        n = int(rng.integers(lo, hi + 1))
        rng.integers(0, vocab, size=n)
        lens.append(n)
    return lens[len(warmup):]


def gemma2_prompt_lens(args):
    """The [serve-gemma2] run's prompt lengths."""
    from repro_torch import configs
    return replay_prompt_lens(args.seed + 5,
                              configs.get("gemma2-2b").vocab_size,
                              GEMMA2_WARMUP, GEMMA2_PROMPTS)


def gemma2_prefill_lens(args):
    """The length each [serve-gemma2] prompt is prefilled at."""
    from repro_torch import configs
    cfg = configs.sparsify_ffn(configs.get("gemma2-2b"), 1 / 8)
    return prefill_lens(cfg, GEMMA2_MAX_LEN, gemma2_prompt_lens(args))


def llama_prompt_lens(args):
    """The [serve] run's prompt lengths."""
    from repro_torch import configs
    return replay_prompt_lens(args.seed,
                              configs.get("llama3_2_1b").vocab_size,
                              LLAMA_WARMUP, LLAMA_PROMPTS)


def llama_prefill_lens(args):
    """The length each [serve] prompt is prefilled at."""
    from repro_torch import configs
    cfg = configs.sparsify_ffn(configs.get("llama3_2_1b"), 1 / 8)
    return prefill_lens(cfg, LLAMA_MAX_LEN, llama_prompt_lens(args))


def gemma2_attn_shapes(args):
    """[attn] rows at the prefill lengths [serve-gemma2] runs, global and
    local layers."""
    rows = []
    for s in sorted(set(gemma2_prefill_lens(args))):
        rows += [("gemma2 global served", s, 8, 4, 256, 0, 50.0, 1 / 16),
                 ("gemma2 local served", s, 8, 4, 256, 4096, 50.0, 1 / 16)]
    return tuple(rows)


def qwen3_attn_shapes(args):
    """[attn] rows at the prefill lengths [serve-qwen3-moe] runs on the
    ladder of Engine(batch=4, max_len=1024) (at 1008 the tiles halve to
    16 and are walked 4 q tiles a block): 32 heads over 4 kv heads of
    128, causal, no soft-cap, scale 1/sqrt(128)."""
    return tuple(("qwen3 served", s, 32, 4, 128, 0, None, 1 / math.sqrt(128))
                 for s in sorted(set(qwen3_prefill_lens(args))))


def attn_library(torch, s, window, global_prefix, softcap, scale,
                 device="cuda"):
    """One PyTorch call computing bs_attn's function on ``[B, S, H, dh]``
    tensors: SDPA where the mask is plain causal with no soft-cap, else
    compiled ``flex_attention`` with the soft-cap as its score
    modification and the causal window as its mask.  Timed beside the
    kernel, never called by the port."""
    import torch.nn.functional as F

    if softcap is None and window == 0:
        def sdpa(q_, k_, v_):
            return F.scaled_dot_product_attention(
                q_.transpose(1, 2), k_.transpose(1, 2), v_.transpose(1, 2),
                is_causal=True, scale=scale, enable_gqa=True
            ).transpose(1, 2)
        return sdpa, "sdpa"
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)

    def mask_mod(b, h, qi, ki):
        keep = qi >= ki
        if window > 0:
            keep = keep & ((qi - ki < window) | (ki < global_prefix))
        return keep

    def score_mod(score, b, h, qi, ki):
        return softcap * torch.tanh(score / softcap)

    block_mask = create_block_mask(mask_mod, None, None, s, s,
                                   device=device)
    flex = torch.compile(flex_attention, dynamic=False)

    def run(q_, k_, v_):
        return flex(q_.transpose(1, 2), k_.transpose(1, 2),
                    v_.transpose(1, 2),
                    score_mod=None if softcap is None else score_mod,
                    block_mask=block_mask, scale=scale,
                    enable_gqa=True).transpose(1, 2)
    return run, "flex_attention"


def attn_phase(torch, args):
    """bs_attn against its plain version (dense softmax over the element
    mask) at gemma2-2b's global and local layers, llama3.2-1b's and
    qwen3-moe's, and at an odd S whose tiles halve to 1; bf16 and fp32.  The bound counts
    the visible element pairs (4 FLOPs per pair and head dim: QK^T and
    PV) against q, k, v read and o written once.  The library call
    (``attn_library``) is held against the plain version too."""
    import torch._dynamo

    from repro_torch.kernels.bs_attn import ops as bs_ops
    from repro_torch.kernels.bs_attn.ref import attend_plain
    from repro_torch.models import attention

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 21)
    # one flex_attention compile per row (shape, dtype, mask): more than
    # dynamo's default recompile limit, past which it would run eagerly
    for knob in ("recompile_limit", "cache_size_limit",
                 "accumulated_recompile_limit",
                 "accumulated_cache_size_limit"):
        if hasattr(torch._dynamo.config, knob):
            setattr(torch._dynamo.config, knob, 256)
    rows = []
    for name, s, h, kvh, dh, window, softcap, scale in (
            ATTN_SHAPES + gemma2_attn_shapes(args)
            + qwen3_attn_shapes(args)):
        spec = attention.attn_spec(s, s, dh, window=window, softcap=softcap,
                                   scale=scale)
        walk = spec.walk(dev)
        el = spec.element_mask(dev)
        pairs = int(el.sum().item())
        dtypes = [("bfloat16", torch.bfloat16), ("float32", torch.float32)]
        if name in ATTN_FP16:
            dtypes.append(("float16", torch.float16))
        for dname, dt in dtypes:
            es = torch.empty((), dtype=dt).element_size()
            q = torch.randn((1, s, h, dh), generator=gen, device=dev).to(dt)
            k = torch.randn((1, s, kvh, dh), generator=gen, device=dev).to(dt)
            v = torch.randn((1, s, kvh, dh), generator=gen, device=dev).to(dt)
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * es
            sets = copies(lambda: (q.clone(), k.clone(), v.clone()), nbytes)
            library, lib_name = attn_library(torch, s, window, 0, softcap,
                                             scale)
            lib_err = rel_err(library(q, k, v),
                              attend_plain(q, k, v, el, scale=scale,
                                           softcap=softcap))[0]
            def kernel(q_, k_, v_, plan=None):
                return bs_ops.bs_attn_cuda(q_, k_, v_, walk, scale=scale,
                                           softcap=softcap, window=window,
                                           plan=plan)
            row = measured_row(
                torch, "bs_attn", name, s, dname, kernel,
                lambda q_, k_, v_: attend_plain(q_, k_, v_, el, scale=scale,
                                                softcap=softcap),
                library, sets, sets, nbytes, 4.0 * pairs * dh * h)
            # the CUDA-core walk (every dtype's walk before the tensor-core
            # one) on the same 16-bit inputs, timed beside it
            row["walk"] = bs_ops.kernel_walk(dt)
            row["before_ms"] = (timed_ms(
                torch, lambda *a: kernel(*a, plan="cuda_core"), sets, 4)
                if dt != torch.float32 else None)
            row.update(heads=h, kv_heads=kvh, head_dim=dh, window=window,
                       softcap=softcap, tile=spec.tile_q, library=lib_name,
                       library_rel_err=lib_err,
                       tiles_visited=int(spec.block_mask().sum()),
                       element_pairs=pairs, group=walk.group)
            rows.append(row)
            del sets, q, k, v
        del el, walk
    bad = [r for r in rows if not r["rel_err"] <= r["tol"]]
    if bad:
        raise RuntimeError(f"bs_attn disagrees with its plain version: "
                           f"{bad}")
    bad = [r for r in rows if not r["library_rel_err"] <= r["tol"]]
    if bad:
        raise RuntimeError(f"the library call computes another function "
                           f"than the plain version: {bad}")
    return rows


def serve_gemma2_phase(torch, args):
    """Full-width gemma2-2b (26 layers of alternating local / global
    attention, d_model 2304, 8 heads, GQA 4, head dim 256, d_ff 9216,
    vocab 256000) with every FFN block-sparse (d = 1/8, b = 16), bf16,
    seeded random weights, through ``Engine(batch=2, max_len=8192)``: 4
    seeded requests of 1024..7000 prompt tokens (one over window + tile
    = 4608), 8 new tokens each, eagerly and then through the engine's
    CUDA graphs (captured at startup; the main path); the bs_attn, bsmm
    and dense_mm counters are zeroed just before the graph run and read
    just after."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.kernels import bs_attn, bsmm, dense_mm
    from repro_torch.models import attention
    from repro_torch.models.model import LM
    from repro_torch.serve import Engine, Request

    cfg = configs.sparsify_ffn(configs.get("gemma2-2b"), 1 / 8)
    assert cfg.dtype == "bfloat16" and cfg.ffn_block_size == 16
    counters = with_walks({"bs_attn": bs_attn.COUNTER, "bsmm": bsmm.COUNTER,
                           "dense_mm": dense_mm.COUNTER})
    t0 = time.perf_counter()
    lm = LM(cfg, device="cuda", seed=args.seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in lm.parameters())
    max_len, new = GEMMA2_MAX_LEN, GEMMA2_NEW
    rng = np.random.default_rng(args.seed + 5)

    def request(uid, lo, hi, n_new):
        return Request(uid=uid, prompt=rng.integers(
            0, cfg.vocab_size, size=int(rng.integers(lo, hi + 1))),
            max_new_tokens=n_new)

    kw = dict(batch=GEMMA2_BATCH, max_len=max_len, device="cuda")
    # warm-up (first launches, allocator; eager), then the same requests
    # eagerly and through the graphs
    Engine(lm, graphs=False, warm_plans=False, **kw).run(
        [request(i, lo, hi, 2) for i, (lo, hi) in enumerate(GEMMA2_WARMUP)])
    prompts = [request(i, lo, hi, new).prompt
               for i, (lo, hi) in enumerate(GEMMA2_PROMPTS)]
    if [len(p) for p in prompts] != gemma2_prompt_lens(args):
        raise RuntimeError("gemma2_prompt_lens does not replay the run")
    torch.cuda.reset_peak_memory_stats()
    eager = serve_run(torch, Engine(lm, graphs=False, **kw), prompts, new)
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(lm, warm_compile=True, **kw)
    torch.cuda.synchronize()
    for c in counters.values():
        c.reset()
    run = serve_run(torch, eng, prompts, new)
    launches, walks = split_walks({k: c.launches
                                   for k, c in counters.items()})
    check_tensor_core_walks("serve-gemma2", walks,
                            ("bs_attn", "gmm", "bsmm"))
    reqs, wall, peak = run["reqs"], run["wall_s"], run["peak_mem_gb"]
    graphs = graphs_line(eager, run)

    if not all(0 <= t < cfg.vocab_size for r in reqs for t in r.output):
        raise RuntimeError("a generated token is outside the vocabulary")
    for name, count in launches.items():
        if count <= 0:
            raise RuntimeError(f"kernel {name} was not launched while "
                               f"serving gemma2-2b")

    # visited (q_tile, kv_tile) pairs of a local and a global layer at
    # the longest prompt's prefill length
    longest = max(reqs, key=lambda r: len(r.prompt))
    s_pre = longest.bucket or len(longest.prompt)
    visited = {}
    for what, window in (("local", cfg.local_window), ("global", 0)):
        spec = attention.attn_spec(
            s_pre, s_pre, cfg.head_dim, window=window,
            global_prefix=cfg.global_prefix if window else 0,
            tile_q=cfg.attn_tile_q, tile_kv=cfg.attn_tile_kv)
        visited[what] = dict(pairs=int(spec.block_mask().sum()),
                             tiles=spec.nq, tile=spec.tile_q,
                             element_pairs=int(spec.element_mask(
                                 "cuda").sum().item()))
    if not visited["local"]["pairs"] < visited["global"]["pairs"]:
        raise RuntimeError(f"local layers visit no fewer pairs than "
                           f"global ones: {visited}")

    st = eng.stats()
    tokens = sum(len(r.output) for r in reqs)
    return dict(
        params=n_params, init_s=init_s, requests=len(reqs),
        prompt_lens=[int(len(r.prompt)) for r in reqs],
        prefill_lens=[int(r.bucket or len(r.prompt)) for r in reqs],
        tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
        prefill_p50_ms=st["prefill_latency"]["p50_ms"],
        decode_step_p50_ms=st["step_latency"]["p50_ms"],
        decode_steps=st["steps"], launches=launches, walks=walks,
        visited=visited, buckets=list(eng.buckets), peak_mem_gb=peak,
        graphs=graphs), lm, eng


def gemma2_consistency_phase(torch, lm, eng, args):
    """Decode after a 5118-token prompt (past window + tile = 4608, so
    the local layers' windows cut keys), prefilled padded to the bucket
    the engine gives it (6112 on the H100-priced ladder: tiles of 32),
    against the full-sequence path at 5120 tokens (tiles of 512), on
    full-width gemma2-2b:

    * every layer's attention in bf16 (the served model): the decode
      path's output for positions n and n + 1, from the prefill's cache,
      against ``forward``'s at the same positions, with the same layer
      inputs (taken from ``forward``), within the bf16 budget;
    * end to end in fp32 (the same seeded weights, unrounded): padded
      prefill and two decode steps' logits against ``forward``'s within
      the fp32 logits budget;
    * end to end in bf16: reported.  At random init the bf16 model is
      chaotic: the same seed's weights rounded to bf16 instead of fp32
      move ``forward``'s logits by ~0.8 of their scale (llama3.2-1b:
      ~0.02), so the two paths' different roundings are not held to a
      budget end to end.  The JAX LM shows the same at gemma2's depth
      (tests/test_torch_gemma2.py, the bf16 decode-gap test)."""
    import dataclasses

    import numpy as np

    from repro_torch.models.model import LM

    cfg = lm.cfg
    n = 5118
    bucket = eng.bucket_for(n)
    if bucket is None or bucket <= n + 2:
        raise RuntimeError(f"a {n}-token prompt gets no padded bucket: "
                           f"{eng.buckets}")
    max_len = eng.max_len
    rng = np.random.default_rng(args.seed + 9)
    toks = rng.integers(0, cfg.vocab_size, size=n + 2)
    padded = np.zeros((1, bucket), np.int64)
    padded[0, :n] = toks[:n]
    pos = [torch.tensor([n + j], device="cuda") for j in range(2)]

    # bf16, layer by layer: inputs and attention outputs of forward
    layer_in, attn_out, hooks = {}, {}, []
    for i, layer in enumerate(lm.layers):
        hooks.append(layer.register_forward_pre_hook(
            lambda m, a, i=i: layer_in.__setitem__(
                i, a[0][:, n:n + 2].clone())))
        hooks.append(layer.attn.register_forward_hook(
            lambda m, a, out, i=i: attn_out.__setitem__(
                i, out[:, n:n + 2].clone())))
    want_bf16 = lm.forward(toks[None, :])[0, n - 1:].float()
    for h in hooks:
        h.remove()
    _, caches = lm.prefill(padded, max_len=max_len, last_index=[n - 1])
    layer_errs = {"local": 0.0, "global": 0.0}
    with torch.no_grad():
        for j in range(2):
            for i, layer in enumerate(lm.layers):
                x = layer.norm1(layer_in[i][:, j:j + 1], eps=cfg.norm_eps)
                y, _ = layer.attn.decode(x, caches[i], pos[j],
                                         local=layer.local)
                kind = "local" if layer.local else "global"
                layer_errs[kind] = max(layer_errs[kind], rel_err(
                    y, attn_out[i][:, j:j + 1])[0])
    del caches, layer_in, attn_out

    def end_to_end(model, want):
        logits, caches = model.prefill(padded, max_len=max_len,
                                       last_index=[n - 1])
        errs = {"prefill": rel_err(logits[0], want[0])[0]}
        for j in range(2):
            logits, caches = model.decode_step(
                toks[None, n + j:n + j + 1], caches, np.asarray([n + j]))
            errs[f"decode_{j}"] = rel_err(logits[0], want[1 + j])[0]
        return errs

    e2e_bf16 = end_to_end(lm, want_bf16)
    lm32 = LM(dataclasses.replace(cfg, dtype="float32"), device="cuda",
              seed=args.seed)
    want32 = lm32.forward(toks[None, :])[0, n - 1:].float()
    e2e_fp32 = end_to_end(lm32, want32)
    sensitivity = rel_err(want_bf16, want32)[0]
    del lm32, want32
    out = dict(prompt=n, bucket=bucket, layer_attention_bf16=layer_errs,
               end_to_end_fp32=e2e_fp32, end_to_end_bf16=e2e_bf16,
               bf16_vs_fp32_weights_forward=sensitivity)
    bad = {k: v for k, v in layer_errs.items() if not v <= CONSISTENCY_TOL}
    bad.update({k: v for k, v in e2e_fp32.items()
                if not v <= LOGITS_TOL_FP32})
    if bad:
        raise RuntimeError(f"gemma2 decode disagrees with forward: {bad} "
                           f"({out})")
    return out


def dynamic_kernel_phase(torch, args):
    """The dsmm and bsmm_balanced kernels against their plain versions:
    dsmm at the FFN shapes of llama3.2-1b (d_max = 1/8, b = 16, N in {4,
    256, 2048}), at Table 3's shape (4096 x 4096, d = 1/16, b in {4,
    16}, N = 4096) and on the grouped routes' t = 128 packed tiles;
    bsmm_balanced on the skew grid (4096 x 4096, b = 16, d = 1/32, N =
    4096; uniform, power-law and DLMC masks)."""
    from repro_torch import sparse
    from repro_torch.core import dynamic_sparse as dsp
    from repro_torch.core import masks, partitioner
    from repro_torch.core.bsr import BlockSparseMatrix
    from repro_torch.kernels.bsmm import balanced as bal_ops
    from repro_torch.kernels.dsmm import ops as dsmm_ops
    from repro_torch.kernels.gmm import ops as gmm_ops

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 11)
    rows = []

    def randn(shape, dt, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32) * scale).to(dt)

    def dsmm_rows(shape_name, m, k, b, density, dt, dname, ns, mask_seed,
                  tile=None):
        es = torch.empty((), dtype=dt).element_size()
        mask = masks.random_block_mask(m, k, b, density, seed=mask_seed)
        grid = (m // b) * (k // b)
        nnz_max = max(1, math.ceil(grid * density))
        w = randn((m, k), dt, 1 / math.sqrt(k * density))
        op = dsp.encode(w, torch.as_tensor(mask, device=dev), block_size=b,
                        nnz_max=nnz_max)
        what = ""
        raw = op
        if tile:
            cap = min(op.capacity, (m // tile) * (k // tile))
            op, _ = gmm_ops.pack_tiles_device(op, tile=tile, tiles_cap=cap,
                                              with_stats=False)
            what = f" t={tile} tiles"
        srows, scols, svals = dsmm_ops.encode_slots(op)
        dense_w = op.to_dense()
        bb = op.block_size
        nnz = int(op.nnz)
        for n in ns:
            x = randn((n, k), dt)
            nbytes = (n * k + nnz * bb * bb + n * m) * es \
                + 2 * 4 * srows.numel()
            sets = copies(lambda: (x.clone(), svals.clone()),
                          nbytes + svals.numel() * es)
            lib_sets = copies(lambda: (x.clone(), dense_w.clone()),
                              (n * k + m * k) * es)
            row = measured_row(
                torch, "dsmm", f"{shape_name} {m}x{k} b={b}{what}", n,
                dname,
                lambda a_, v_: dsmm_ops.dsmm_cuda(a_, v_, srows, scols, m),
                lambda a_, v_: dsmm_ops.dsmm_plain(a_, v_, srows, scols, m),
                lambda a_, w_: torch.matmul(a_, w_.t()), sets, lib_sets,
                nbytes, 2.0 * nnz * bb * bb * n)
            # the slot encoder each call of the dynamic_cuda route adds,
            # and on the grouped routes' tiles their device tile pack
            row["encode_ms"] = timed_ms(
                torch, lambda: dsmm_ops.encode_slots(op), [()], 20)
            row["pack_ms"] = (timed_ms(torch, lambda: gmm_ops.pack_tiles_device(
                raw, tile=tile, tiles_cap=cap, with_stats=False), [()], 10)
                if tile else None)
            wk = dsmm_ops.walk(bb, dt)
            # the FFMA walk (every dtype's walk before the tensor-core
            # one) on the same 16-bit inputs, timed beside it
            row.update(slots=int(srows.numel()), nnz_blocks=nnz, walk=wk,
                       before_ms=(timed_ms(
                           torch, lambda a_, v_: dsmm_ops.dsmm_cuda(
                               a_, v_, srows, scols, m, plan="ffma"),
                           sets, 10) if wk != "ffma" else None))
            rows.append(row)
            del sets, lib_sets

    for dname, dt in (("bfloat16", torch.bfloat16),
                      ("float32", torch.float32)):
        for shape_name, m, k in (("up/gate", 8192, 2048),
                                 ("down", 2048, 8192)):
            dsmm_rows(shape_name, m, k, 16, 1 / 8, dt, dname,
                      (4, 256, 2048), args.seed + 1)
        dsmm_rows("ffn up/gate", 8192, 2048, 16, 1 / 8, dt, dname, (2048,),
                  args.seed + 1, tile=128)
    for dname, dt in (("float16", torch.float16),
                      ("float32", torch.float32)):
        for b in (4, 16):
            dsmm_rows("table3", 4096, 4096, b, 1 / 16, dt, dname, (4096,),
                      args.seed + 2)
        dsmm_rows("table3", 4096, 4096, 16, 1 / 16, dt, dname, (4096,),
                  args.seed + 2, tile=128)

    # bsmm_balanced on the skew grid, beside the uniform walk (bsmm) on
    # the same tiles
    m = k = n = 4096
    b, density = 16, 1 / 32
    gens = {"uniform": masks.random_block_mask,
            "power_law": masks.power_law_block_mask,
            "dlmc": masks.dlmc_block_mask}
    for dname, dt in (("bfloat16", torch.bfloat16),
                      ("float32", torch.float32)):
        es = torch.empty((), dtype=dt).element_size()
        for kind, gen_fn in gens.items():
            mask = gen_fn(m, k, b, density, seed=args.seed)
            nnz = int(mask.sum())
            vals = randn((nnz, b, b), dt, 1 / math.sqrt(k * density))
            bsr = BlockSparseMatrix.from_mask(mask, b, values=vals)
            p = sparse.plan(bsr, n, device=dev, ctx=sparse.PlanContext(
                mode="static_balanced"))
            vr, vc, vs = p.visit
            tiles = p.pack(vals)
            dense_w = bsr.to_dense()
            x = randn((n, k), dt)
            nbytes = (n * k + nnz * b * b + n * m) * es + 3 * 4 * vr.numel()
            sets = copies(lambda: (x.clone(), tiles.clone()), nbytes)
            lib_sets = copies(lambda: (x.clone(), dense_w.clone()),
                              (n * k + m * k) * es)
            row = measured_row(
                torch, "bsmm_balanced", f"skew {kind} {m}x{k} d=1/32", n,
                dname,
                lambda a_, t_: bal_ops.bsmm_balanced_cuda(a_, t_, vr, vc,
                                                          vs, m, p.mma),
                lambda a_, t_: bal_ops.bsmm_balanced_plain(a_, t_, vr, vc,
                                                           vs, m),
                lambda a_, w_: torch.matmul(a_, w_.t()), sets, lib_sets,
                nbytes, 2.0 * nnz * b * b * n)
            # the FFMA walk (every dtype's walk before the tensor-core
            # one) on the same 16-bit inputs, and the uniform walk (bsmm,
            # the walk its plan names) on the same pattern (no pad tile)
            wk = bal_ops.walk(b, dt)
            row.update(walk=wk, before_ms=(timed_ms(
                torch, lambda a_, t_: bal_ops.bsmm_balanced_cuda(
                    a_, t_, vr, vc, vs, m, p.mma, plan="ffma"), sets, 10)
                if wk != "ffma" else None))
            pu = sparse.plan(bsr, n, device=dev)
            usets = [(a_, t_[:-1].contiguous()) for a_, t_ in sets]
            row["uniform_bsmm_ms"] = timed_ms(
                torch, lambda a_, t_: pu.run_packed(t_, a_), usets, 30)
            row.update(bins=p.artifacts["swizzle_bins"],
                       steps_per_bin=p.artifacts["swizzle_steps_per_bin"],
                       swizzle_imbalance=p.artifacts["swizzle_imbalance"],
                       row_imbalance=partitioner.balance_report(
                           mask.sum(axis=1))["imbalance"])
            rows.append(row)
            del sets, lib_sets, usets
    return rows


TABLE3_ROUTES = ("dense_cuda", "static_cuda", "static_balanced_cuda",
                 "dynamic_cuda", "dynamic_grouped_cuda",
                 "dynamic_grouped_balanced_cuda")


def table3_phase(torch, args):
    """The paper's Table 3 on the card: m = k = 4096, d = 1/16, N =
    4096, b in {1, 4, 16}, fp16 and fp32, one time per route through the
    plan layer, against dense_cuda and torch.matmul.  dynamic_cuda is
    timed with the encode from the dense weight and mask included (the
    pattern is data); the grouped routes run at worst-case capacity (no
    tile dropped).  Every route's output is checked against the fp32
    dense product."""
    from repro_torch import sparse
    from repro_torch.core import dynamic_sparse as dsp
    import numpy as np

    from repro_torch.core import masks
    from repro_torch.core.bsr import BlockSparseMatrix
    from repro_torch.kernels import contract
    from repro_torch.kernels.bsmm import balanced as bal_ops
    from repro_torch.kernels.bsmm import ops as bsmm_ops
    from repro_torch.kernels.dense_mm import ops as dmm_ops
    from repro_torch.kernels.dsmm import ops as dsmm_ops
    from repro_torch.kernels.gmm import ops as gmm_ops
    from repro_torch.sparse.plan import kernel_tile

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 13)
    m = k = n = 4096
    density = 1 / 16
    lines = []
    for dname, dt in (("float16", torch.float16),
                      ("float32", torch.float32)):
        for b in (1, 4, 16):
            mask = masks.random_block_mask(m, k, b, density,
                                           seed=args.seed + 3)
            mask_t = torch.as_tensor(mask, device=dev)
            nnz = int(mask.sum())
            nnz_max = math.ceil((m // b) * (k // b) * density)
            w = (torch.randn((m, k), generator=gen, device=dev)
                 / math.sqrt(k * density)).to(dt)
            w = w * torch.repeat_interleave(torch.repeat_interleave(
                mask_t, b, 0), b, 1).to(dt)
            r_idx, c_idx = (torch.as_tensor(a, device=dev)
                            for a in np.nonzero(mask))
            bsr = BlockSparseMatrix.from_mask(
                mask, b, values=w.reshape(m // b, b, k // b, b).permute(
                    0, 2, 1, 3)[r_idx, c_idx].contiguous())
            x = (torch.randn((n, k), generator=gen, device=dev)).to(dt)
            want = torch.matmul(x.float(), w.float().t())
            wt = w.t().contiguous()
            runs = {"dense_cuda": lambda: dmm_ops.dense_mm_cuda(x, wt)}
            for mode, route in (("static", "static_cuda"),
                                ("static_balanced", "static_balanced_cuda")):
                p = sparse.plan(bsr, n, device=dev,
                                ctx=sparse.PlanContext(mode=mode))
                assert p.route == route
                packed = p.pack(bsr.values)
                runs[route] = (lambda p=p, packed=packed:
                               p.run_packed(packed, x))
            for mode, route, kw in (
                    ("dynamic", "dynamic_cuda", {}),
                    ("dynamic_grouped", "dynamic_grouped_cuda",
                     dict(capacity_policy="worst", telemetry=False)),
                    ("dynamic_grouped_balanced",
                     "dynamic_grouped_balanced_cuda",
                     dict(capacity_policy="worst", telemetry=False))):
                ctx = sparse.PlanContext(mode=mode, **kw)
                runs[route] = (lambda ctx=ctx: sparse.spmm_nt(
                    dsp.encode(w, mask_t, block_size=b, nnz_max=nnz_max),
                    x, ctx=ctx))
            lib_ms = timed_ms(torch, lambda: torch.matmul(x, wt), [()], 30)
            flops = 2.0 * n * m * k
            res = {}
            # the block each dynamic route's dsmm walks: the split or
            # re-blocked b (dynamic_cuda), the packed tile (grouped)
            walked = {"dynamic_cuda": max(contract.sub_block(
                b, dsmm_ops.BLOCK_SIZES), dsmm_ops.BLOCK_SIZES[0])}
            walked.update({r_: gmm_ops.grouped_tile(m, k, b)
                           for r_ in TABLE3_ROUTES
                           if r_.startswith("dynamic_grouped")})
            # each sparse route's kernel, its walk counters, the block it
            # walks and the walk that block names
            tile = kernel_tile(b)[0]
            route_walk = {
                "static_cuda": ("bsmm", bsmm_ops.WALK_COUNTERS, tile,
                                bsmm_ops.walk(tile, dt, n)),
                "static_balanced_cuda": ("bsmm_balanced",
                                         bal_ops.WALK_COUNTERS, tile,
                                         bal_ops.walk(tile, dt))}
            route_walk.update({r_: ("dsmm", dsmm_ops.WALK_COUNTERS, t_,
                                    dsmm_ops.walk(t_, dt))
                               for r_, t_ in walked.items()})
            for route in TABLE3_ROUTES:
                kernel, ctrs, block, want_walk = route_walk.get(
                    route, (None, {}, None, None))
                before = {w_: c.launches for w_, c in ctrs.items()}
                err = rel_err(runs[route](), want)[0]
                torch.cuda.synchronize()
                kernel_walks = {w_: c.launches - before[w_]
                                for w_, c in ctrs.items()}
                off = {w_: v for w_, v in kernel_walks.items()
                       if w_ != want_walk and v}
                if kernel and (not kernel_walks[want_walk] or off):
                    raise RuntimeError(
                        f"[table3] {route} b={b} {dname}: {kernel} at block "
                        f"{block} launched {kernel_walks}, want every launch "
                        f"on {want_walk}")
                slow = route.startswith(("dense", "dynamic_grouped")) \
                    or b <= 4
                ms = timed_ms(torch, runs[route], [()], 10 if slow else 30)
                res[route] = ms
                lines.append(dict(
                    route=route, b=b, dtype=dname, m=m, k=k, n=n,
                    density=density, nnz_blocks=nnz, ms=ms,
                    rel_err=err, tol=KERNEL_TOL[dname],
                    dense_flops=flops, sparse_flops=flops * density,
                    torch_matmul_ms=lib_ms, kernel=kernel,
                    kernel_walks=kernel_walks))
            for line in lines[-len(TABLE3_ROUTES):]:
                line["speedup_vs_dense_cuda"] = res["dense_cuda"] / line["ms"]
                line["speedup_vs_torch_matmul"] = lib_ms / line["ms"]
            del runs, bsr, w, wt, x, want
            torch.cuda.empty_cache()
    bad = [r for r in lines if not r["rel_err"] <= r["tol"]]
    if bad:
        raise RuntimeError(f"[table3] routes disagree with the dense "
                           f"product: {bad}")
    return lines


def dynamic_phase(torch, args):
    """The paper's dynamic mode at llama3.2-1b width: a SwiGLU FFN of
    three DynamicSparseLinear (2048 -> 8192 -> 2048, d_max = 1/8, b =
    16, bf16), N = 2048 tokens (batch 4 x seq 512), 5 forward + backward
    steps, each with a freshly drawn seeded block mask.  Step 0 is held
    against the plain formulation (``core/dynamic_sparse._dspmm``) on
    the same card tensors."""
    import numpy as np
    import torch.nn.functional as F

    from repro_torch import sparse
    from repro_torch.core import dynamic_sparse as dsp
    from repro_torch.core import masks
    from repro_torch.core.sparse_layers import DynamicSparseLinear
    from repro_torch.kernels.dsmm import ops as dsmm_ops

    dev = torch.device("cuda", 0)
    d_model, d_ff, b, d_max = 2048, 8192, 16, 1 / 8
    batch, seq = 4, 512
    dt = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(args.seed + 17)
    layers = {"up": DynamicSparseLinear(d_model, d_ff, b, d_max, dtype=dt,
                                        device=dev),
              "gate": DynamicSparseLinear(d_model, d_ff, b, d_max, dtype=dt,
                                          device=dev),
              "down": DynamicSparseLinear(d_ff, d_model, b, d_max, dtype=dt,
                                          device=dev)}
    for i, layer in enumerate(layers.values()):
        layer.reset_parameters(gen, mask_seed=args.seed + 100 + i)

    def ffn(x, lin):
        return lin["down"](F.silu(lin["gate"](x)) * lin["up"](x))

    def plain_lin(layer):
        def run(x):
            op = layer.encode()
            x2 = x.reshape(-1, layer.in_features)
            y = dsp._dspmm(op.values, op.row_idx, op.col_idx, x2.t(),
                           layer.out_features // b, b).t()
            return y.reshape(*x.shape[:-1], layer.out_features)
        return run

    x0 = torch.randn((batch, seq, d_model), generator=gen,
                     device=dev).to(dt)
    gy = torch.randn((batch, seq, d_model), generator=gen,
                     device=dev).to(dt)
    check = {}
    masks_seen, step_ms, launches = [], [], []
    sparse.reset()
    torch.cuda.synchronize()
    dsmm_ops.COUNTER.reset()
    plans_after = []
    syncs = []
    for step in range(5):
        for i, (name, layer) in enumerate(layers.items()):
            layer.set_mask(masks.random_block_mask(
                layer.out_features, layer.in_features, b, d_max,
                seed=args.seed + 1000 * (step + 1) + i))
        masks_seen.append(tuple(hash(layer.mask.cpu().numpy().tobytes())
                                for layer in layers.values()))
        for layer in layers.values():
            layer.weight.grad = None
        x = x0.clone().requires_grad_(True)
        before = dsmm_ops.COUNTER.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # after step 0 the forward (encode, plan lookup, slot encode,
        # dsmm) must not wait for the device: count the synchronizing
        # calls PyTorch reports
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if step:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                y = ffn(x, layers)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        # each synchronizing call warns ("called a synchronizing CUDA
        # operation"); the mode's notice that it is a prototype is no sync
        syncs += [str(w.message) for w in caught
                  if "synchroniz" in str(w.message)
                  and "prototype" not in str(w.message)]
        y.backward(gy)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(dsmm_ops.COUNTER.launches - before)
        plans_after.append(sparse.cache_stats()["plans_built"])
        if step == 0:
            check = dict(y=y.detach(), dx=x.grad.detach(),
                         dw={k: v.weight.grad.detach().clone()
                             for k, v in layers.items()})
    total_launches = dsmm_ops.COUNTER.launches
    # the plain formulation on the last step's masks, step 0 held apart:
    # re-draw step 0's masks and run both on them
    for i, (name, layer) in enumerate(layers.items()):
        layer.set_mask(masks.random_block_mask(
            layer.out_features, layer.in_features, b, d_max,
            seed=args.seed + 1000 + i))
        layer.weight.grad = None
    x = x0.clone().requires_grad_(True)
    y_plain = ffn(x, {k_: plain_lin(v) for k_, v in layers.items()})
    y_plain.backward(gy)
    torch.cuda.synchronize()
    errs = {"y": rel_err(check["y"], y_plain.detach())[0],
            "dx": rel_err(check["dx"], x.grad)[0]}
    for k_, v in layers.items():
        errs[f"dW_{k_}"] = rel_err(check["dw"][k_], v.weight.grad)[0]
    # one extra pass at planned capacity on the grouped route
    sparse.reset_telemetry()
    with torch.no_grad():
        for layer in layers.values():
            layer.backend = "grouped"
        ffn(x0, layers)
        for layer in layers.values():
            layer.backend = "auto"
    torch.cuda.synchronize()
    cap = sparse.capacity_report()["totals"]
    result = dict(
        d_model=d_model, d_ff=d_ff, b=b, d_max=d_max, tokens=batch * seq,
        steps=5, step_ms=step_ms, step_p50_ms=float(np.median(step_ms)),
        step_p50_after_first_ms=float(np.median(step_ms[1:])),
        dsmm_launches_per_step=launches, dsmm_launches=total_launches,
        plans_built=plans_after, masks_distinct=len(set(masks_seen)),
        forward_host_syncs=len(syncs),
        errs=errs, tol=KERNEL_TOL["bfloat16"], capacity_totals=cap)
    if len(set(masks_seen)) != 5:
        raise RuntimeError("the mask did not change on every step")
    if any(p != plans_after[0] for p in plans_after):
        raise RuntimeError(f"plans were built after step 0: {plans_after}")
    if syncs:
        raise RuntimeError(f"the dynamic forward waited for the device "
                           f"{len(syncs)} times after step 0: {syncs[:3]}")
    if any(n_ <= 0 for n_ in launches):
        raise RuntimeError(f"dsmm not launched on every step: {launches}")
    bad = {k_: v for k_, v in errs.items() if not v <= result["tol"]}
    if bad:
        raise RuntimeError(f"[dynamic] step 0 disagrees with the plain "
                           f"formulation: {bad}")
    return result


# qwen3-moe-30b-a3b serving: Engine(batch=4, max_len=1024), 6 seeded
# requests of 32..900 prompt tokens (the last one over the 256 bucket),
# 8 new tokens each
QWEN3_BATCH, QWEN3_MAX_LEN, QWEN3_NEW = 4, 1024, 8
# the fp32 end-to-end check: full width, depth cut to 4 layers (fp32 at
# full depth would need 122 GB)
QWEN3_FP32_LAYERS = 4


def qwen3_prompt_lens(args):
    """The serve run's prompt lengths: five seeded in 32..900, the sixth
    in 601..900, so the largest bucket is prefilled."""
    import numpy as np
    rng = np.random.default_rng(args.seed + 11)
    lens = [int(n) for n in rng.integers(32, 901, size=5)]
    return lens + [int(rng.integers(601, 901))]


def qwen3_prefill_lens(args):
    """The length each prompt of the serve run is prefilled at (B = 1 per
    prefill): ``Engine.bucket_for``'s rule on the engine's own ladder --
    the smallest bucket holding the prompt, or the prompt's own length
    where that bucket's priced padding passes ``pad_max_frac``."""
    from repro_torch import configs

    return prefill_lens(configs.get("qwen3-moe-30b-a3b"), QWEN3_MAX_LEN,
                        qwen3_prompt_lens(args))


def qwen3_prefill_capacity(args):
    """C of the largest prefill the serve run makes, and its length."""
    from repro_torch import configs
    from repro_torch.models import moe

    n = max(qwen3_prefill_lens(args))
    return moe._capacity(n, configs.get("qwen3-moe-30b-a3b")), n


def gmm_kernel_phase(torch, args):
    """gmm against its plain version at qwen3-moe's expert GEMMs (E 128;
    gate/up D 2048 -> F 768, down D 768 -> F 2048; bf16 and fp32) at the
    decode capacity C = 8 (tm 8) and at the capacity of the largest
    prefill the serve run makes, with the ids ``batched_matmul`` builds
    (each expert one run of C / tm row tiles); and at the reference
    test's general case (E 8, tm 64, T 256, D 128, F 96, random
    non-monotone ids).  Library: ``torch.bmm`` on the ``[E, C, D]``
    buckets (cuBLAS batched), where the ids are the batched layout."""
    from repro_torch.kernels.gmm import ops as gmm_ops
    from repro_torch.kernels.gmm.ref import gmm_ref
    from repro_torch.sparse.plan import batched_row_tile

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 3)
    dtypes = {"bfloat16": torch.bfloat16, "float16": torch.float16,
              "float32": torch.float32}
    c_pre, _ = qwen3_prefill_capacity(args)
    e = 128
    rows = []

    def randn(shape, dt, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32) * scale).to(dt)

    cases = [(f"{name} C={c}", e, c, d, f, "batched")
             for name, d, f in (("gate/up", 2048, 768), ("down", 768, 2048))
             for c in (8, c_pre)]
    cases.append(("general E=8 random ids", 8, 256, 128, 96, "random"))
    for dname, dt in dtypes.items():
        for shape, ne, c, d, f, kind in cases:
            # batched_matmul's row tile for this walk; 64 for the general
            # case
            tm = (batched_row_tile(c, gmm_ops.tma_ok(d, f, dt))
                  if kind == "batched" else 64)
            es = torch.empty((), dtype=dt).element_size()
            if kind == "batched":
                t_rows = ne * c
                ids = torch.arange(ne, dtype=torch.int32,
                                   device=dev).repeat_interleave(c // tm)
            else:
                t_rows = c
                ids = torch.randint(0, ne, (t_rows // tm,), generator=gen,
                                    device=dev).to(torch.int32)
            x = randn((t_rows, d), dt)
            w = randn((ne, d, f), dt, 1 / math.sqrt(d))
            used = int(torch.unique(ids).numel())
            nbytes = ((t_rows * d + used * d * f + t_rows * f) * es
                      + ids.numel() * 4)
            sets = copies(lambda: (x.clone(), w.clone(), ids.clone()),
                          nbytes)
            library = lib_sets = None
            if kind == "batched":
                lib_sets = [(a.view(ne, c, d), b) for a, b, _ in sets]
                library = torch.bmm
            row = measured_row(
                torch, "gmm", shape, t_rows, dname,
                lambda a, b, i, tm=tm: gmm_ops.gmm_cuda(a, b, i, tm=tm),
                lambda a, b, i, tm=tm: gmm_ref(a, b, i, tm=tm),
                library, sets, lib_sets, nbytes, 2.0 * t_rows * d * f)
            # the FFMA walk (every dtype's walk before the tensor-core
            # one) on the same 16-bit inputs, timed beside it
            ffma = gmm_ops.Walk("ffma")
            row.update(tm=tm, experts=ne, experts_used=used, c=c,
                       walk=gmm_ops.walk(tm, d, f, dt).name,
                       before_ms=(timed_ms(
                           torch, lambda a, b, i, tm=tm: gmm_ops.gmm_cuda(
                               a, b, i, tm=tm, plan=ffma), sets, 10)
                           if dt != torch.float32 else None))
            rows.append(row)
            del sets, lib_sets, x, w
    return rows


def serve_qwen3_phase(torch, args):
    """Full-width, full-depth qwen3-moe-30b-a3b (48 layers, d_model 2048,
    GQA 32/4, head dim 128, QK-norm, 128 experts top-8 of d_ff 768,
    vocab 151936) in bf16 from ``init(seed)`` on the card, through
    ``Engine(batch=4, max_len=1024)``: 6 seeded requests of 32..900
    prompt tokens, 8 new tokens each, eagerly and then through the
    engine's CUDA graphs (captured at startup; the main path).  The gmm,
    dense_mm and bs_attn counters are zeroed just before the graph run
    and read just after.  The routing drops are read once after each run
    from the ``"moe_dispatch"`` stream (one value a layer a forward, in
    call order): mean and max over the layers for each prefill, and over
    every decode step; the graph run's equal the eager run's."""
    import numpy as np

    from repro_torch import configs
    from repro_torch import sparse
    from repro_torch.kernels import bs_attn, dense_mm, gmm
    from repro_torch.models.model import LM
    from repro_torch.serve import Engine, Request

    cfg = configs.get("qwen3-moe-30b-a3b")
    assert cfg.dtype == "bfloat16" and cfg.num_layers == 48
    counters = with_walks({"gmm": gmm.COUNTER, "dense_mm": dense_mm.COUNTER,
                           "bs_attn": bs_attn.COUNTER})
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = LM(cfg, device="cuda", seed=args.seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in lm.parameters())

    rng = np.random.default_rng(args.seed + 13)

    def request(uid, n, new):
        return Request(uid=uid, prompt=rng.integers(0, cfg.vocab_size,
                                                    size=n),
                       max_new_tokens=new)

    def noted(eng, calls):
        """Note which forward each group of num_layers drop values came
        from: the engine's admit (a prefill) and step (a decode step, if
        any slot is live); no device work, no read."""
        admit, step = eng.admit, eng.step

        def noted_admit(req):
            calls.append("prefill")
            return admit(req)

        def noted_step():
            if eng.live:
                calls.append("decode")
            return step()

        eng.admit, eng.step = noted_admit, noted_step
        return eng

    kw = dict(batch=QWEN3_BATCH, max_len=QWEN3_MAX_LEN, device="cuda")
    # warm-up (first launches, allocator; eager), then the same requests
    # eagerly and through the graphs
    Engine(lm, graphs=False, warm_plans=False, **kw).run(
        [request(i, 40, 2) for i in range(2)])
    prompts = [request(i, n, QWEN3_NEW).prompt
               for i, n in enumerate(qwen3_prompt_lens(args))]
    eager_calls = []
    torch.cuda.reset_peak_memory_stats()
    eager_eng = noted(Engine(lm, graphs=False, **kw), eager_calls)
    sparse.reset_telemetry()
    eager_calls.clear()
    eager = serve_run(torch, eager_eng, prompts, QWEN3_NEW)
    eager_hist = sparse.dropped_history("moe_dispatch")
    del eager_eng
    calls = []
    torch.cuda.reset_peak_memory_stats()
    eng = noted(Engine(lm, warm_compile=True, **kw), calls)
    torch.cuda.synchronize()
    sparse.reset_telemetry()
    calls.clear()
    for c in counters.values():
        c.reset()
    run = serve_run(torch, eng, prompts, QWEN3_NEW)
    launches, walks = split_walks({k: c.launches
                                   for k, c in counters.items()})
    check_tensor_core_walks("serve-qwen3-moe", walks)
    reqs, wall, peak = run["reqs"], run["wall_s"], run["peak_mem_gb"]
    hist = sparse.dropped_history("moe_dispatch")
    graphs = graphs_line(eager, run)
    graphs["drops_identical"] = (hist == eager_hist
                                 and calls == eager_calls)
    if not graphs["drops_identical"]:
        raise RuntimeError(f"routing drops differ between the eager and "
                           f"the graph run: {len(eager_hist)} values for "
                           f"{eager_calls} against {len(hist)} for {calls}")

    if not all(0 <= t < cfg.vocab_size for r in reqs for t in r.output):
        raise RuntimeError("a generated token is outside the vocabulary")
    for name, count in launches.items():
        if count <= 0:
            raise RuntimeError(f"kernel {name} was not launched while "
                               f"serving qwen3-moe-30b-a3b")
    nl = cfg.num_layers
    if len(hist) != nl * len(calls):
        raise RuntimeError(f"{len(hist)} routing drop values for "
                           f"{len(calls)} forwards of {nl} layers")
    per_call = [hist[i * nl:(i + 1) * nl] for i in range(len(calls))]
    drops = [{"mean": float(np.mean(v)), "max": max(v)}
             for kind, v in zip(calls, per_call) if kind == "prefill"]
    dec = [f for kind, v in zip(calls, per_call) if kind == "decode"
           for f in v]
    # a decode step routes QWEN3_BATCH <= 8 tokens into capacity 8, and a
    # token's top-k experts are distinct: no expert can overflow
    if len(drops) != len(reqs) or not dec or max(dec) != 0.0:
        raise RuntimeError(f"routing drops: {len(drops)} prefills for "
                           f"{len(reqs)} requests, decode steps' max "
                           f"{max(dec, default=None)} (must be 0)")

    st = eng.stats()
    tokens = sum(len(r.output) for r in reqs)
    return dict(
        params=n_params, init_s=init_s, requests=len(reqs),
        prompt_lens=[int(len(r.prompt)) for r in reqs],
        prefill_lens=[int(r.bucket or len(r.prompt)) for r in reqs],
        tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
        prefill_p50_ms=st["prefill_latency"]["p50_ms"],
        decode_step_p50_ms=st["step_latency"]["p50_ms"],
        decode_steps=st["steps"], launches=launches, walks=walks,
        dropped_frac_per_prefill=drops,
        decode_dropped_frac={"layer_calls": len(dec),
                             "mean": float(np.mean(dec)), "max": max(dec)},
        buckets=list(eng.buckets), peak_mem_gb=peak, graphs=graphs), lm, eng


def qwen3_moe_layer_check(torch, lm, eng, args):
    """One layer's ``moe_apply`` on a prefill hidden state (the FFN input
    of a middle layer during the longest prompt's bucketed prefill): the
    gmm route against the plain route (``gmm_ref`` for the three expert
    products), both through the same fp32 routing, within the bf16
    kernel budget."""
    import numpy as np

    from repro_torch import sparse
    from repro_torch.kernels import gmm
    from repro_torch.kernels.gmm.ref import gmm_ref
    from repro_torch.models import moe as moe_lib

    n = max(qwen3_prompt_lens(args))
    bucket = eng.bucket_for(n)
    layer = lm.layers[len(lm.layers) // 2]
    rng = np.random.default_rng(args.seed + 17)
    toks = np.zeros((1, bucket or n), np.int64)
    toks[0, :n] = rng.integers(0, lm.cfg.vocab_size, size=n)
    got = {}
    hook = layer.norm2.register_forward_hook(
        lambda m, a, out: got.__setitem__("h", out.clone()))
    lm.prefill(toks, max_len=eng.max_len, last_index=[n - 1])
    hook.remove()
    h = got["h"]

    def plain_bmm(a, b):
        e, c, d = a.shape
        ids = torch.arange(e, dtype=torch.int32, device=a.device)
        return gmm_ref(a.reshape(e * c, d), b, ids, tm=c).reshape(
            e, c, b.shape[-1])

    before = gmm.COUNTER.launches
    y_kernel, m_kernel = moe_lib.moe_apply(layer.ffn, lm.cfg, h)
    launched = gmm.COUNTER.launches - before
    kernel_bmm = sparse.batched_matmul
    sparse.batched_matmul = plain_bmm
    try:
        y_plain, m_plain = moe_lib.moe_apply(layer.ffn, lm.cfg, h)
    finally:
        sparse.batched_matmul = kernel_bmm
    plain_launched = gmm.COUNTER.launches - before - launched
    torch.cuda.synchronize()
    err = rel_err(y_kernel, y_plain)[0]
    out = dict(layer=len(lm.layers) // 2, tokens=int(h.shape[1]),
               capacity=moe_lib._capacity(int(h.shape[1]), lm.cfg),
               rel_err=err, tol=KERNEL_TOL["bfloat16"],
               gmm_launches=launched, plain_route_gmm_launches=plain_launched,
               dropped_frac=float(m_kernel.dropped_frac),
               same_routing=float(m_kernel.dropped_frac)
               == float(m_plain.dropped_frac))
    if launched != 3 or plain_launched != 0 \
            or not err <= KERNEL_TOL["bfloat16"]:
        raise RuntimeError(f"qwen3 MoE layer: gmm route vs plain {out}")
    return out


def qwen3_fp32_phase(torch, args):
    """qwen3-moe-30b-a3b at full width in fp32, depth cut to 4 layers,
    from ``init(seed)``: a 6-token prompt prefilled in the bucket an
    ``Engine(batch=1, max_len=64)`` gives it (16), then two decode steps,
    against ``forward`` on the same 8 tokens, within the fp32 logits
    budget.  ``forward`` must drop no assignment for that prompt: drops
    differ legitimately between ``forward`` (C from the sequence) and
    decode (C from the batch).  At random init a prompt's hidden states
    are alike, so its tokens pick the same experts and a 32-token
    ``forward`` overflows capacity 8 by the dozens of assignments a
    layer; 8 tokens cannot (top-k experts are distinct, so no expert
    gets more than one assignment a token), and the real tokens of the
    padded prefill rank first, so they keep their slots there too."""
    import dataclasses

    import numpy as np

    from repro_torch import configs
    from repro_torch.models.model import LM
    from repro_torch.serve import Engine

    base = configs.get("qwen3-moe-30b-a3b")
    cfg = dataclasses.replace(
        base, dtype="float32",
        groups=((base.groups[0][0], QWEN3_FP32_LAYERS),))
    lm = LM(cfg, device="cuda", seed=args.seed)
    n, max_len = 6, 64
    bucket = Engine(lm, batch=1, max_len=max_len, device="cuda").bucket_for(n)
    rng = np.random.default_rng(args.seed + 19)
    toks = rng.integers(0, cfg.vocab_size, size=n + 2)
    want, metrics = lm.forward(toks[None, :], return_metrics=True)
    want = want[0, n - 1:].float()
    drops = float(metrics["dropped_frac"]) * (n + 2) * cfg.moe.top_k
    padded = np.zeros((1, bucket or n), np.int64)
    padded[0, :n] = toks[:n]
    logits, caches = lm.prefill(padded, max_len=max_len, last_index=[n - 1])
    errs = {"prefill": rel_err(logits[0], want[0])[0]}
    for j in range(2):
        logits, caches = lm.decode_step(toks[None, n + j:n + j + 1], caches,
                                         np.asarray([n + j]))
        errs[f"decode_{j}"] = rel_err(logits[0], want[1 + j])[0]
    out = dict(layers=QWEN3_FP32_LAYERS, prompt=n, bucket=bucket,
               forward_dropped_assignments=drops, errs=errs,
               tol=LOGITS_TOL_FP32)
    del lm, caches
    bad = {k: v for k, v in errs.items() if not v <= LOGITS_TOL_FP32}
    if bad or round(drops) != 0:
        raise RuntimeError(f"qwen3 fp32 decode disagrees with forward "
                           f"(or forward dropped): {out}")
    return out


def main(argv=None) -> int:
    # torch.compile's caches (the flex_attention library rows) stay in
    # the checkout's build directory, beside the kernels
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, os.path.join(HERE, "build", sub))
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

    rows = (kernel_phase(torch, args) + dynamic_kernel_phase(torch, args)
            + gmm_kernel_phase(torch, args))
    torch.cuda.empty_cache()
    for r in rows:
        extra = ""
        ffma = ("" if r.get("before_ms") is None
                else f" ffma_ms={r['before_ms']:.5f}")
        if r["kernel"] == "sddmm":
            extra = (f" walk={r['walk']} transpose_ms="
                     f"{r['transpose_ms']:.5f} splits={r['splits']}{ffma}")
        elif r["kernel"] == "dsmm":
            extra = (f" walk={r['walk']} encode_ms={r['encode_ms']:.5f} "
                     f"slots={r['slots']}{ffma}"
                     + ("" if r["pack_ms"] is None
                        else f" pack_ms={r['pack_ms']:.5f}"))
        elif r["kernel"] == "gmm":
            extra = (f" walk={r['walk']} tm={r['tm']} "
                     f"experts={r['experts']} "
                     f"experts_used={r['experts_used']}{ffma}")
        elif r["kernel"] == "dense_mm":
            extra = (f" walk={r['walk']} tile={r['tile']} "
                     f"slices={r['slices']} blocks={r['blocks']}")
        elif r["kernel"] == "bsmm":
            extra = (f" walk={r['walk']}"
                     + "".join(f" {w}_ms={v:.5f}"
                               for w, v in r["walk_ms"].items())
                     + ("" if "mma_stages" not in r else
                        f" groups={r['mma_groups']} "
                        f"stages={r['mma_stages']}"))
        elif r["kernel"] == "bsmm_balanced":
            extra = (f" walk={r['walk']}{ffma} "
                     f"uniform_bsmm_ms={r['uniform_bsmm_ms']:.5f} "
                     f"bins={r['bins']} steps={r['steps_per_bin']} "
                     f"row_imbalance={r['row_imbalance']:.2f}")
        print(f"[kernel] {r['kernel']:13s} {r['shape']:40s} n={r['n']:<4d} "
              f"{r['dtype']:8s} rel_err={r['rel_err']:.2e} "
              f"ms={r['ms']:.5f} plain_ms={r['plain_ms']:.5f} "
              f"library_ms={r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 5)} "
              f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']}){extra}")
    bad = [r for r in rows if not r["rel_err"] <= r["tol"]]
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions: "
                           f"{bad}")

    attn_rows = attn_phase(torch, args)
    for r in attn_rows:
        lib = f"{r['library_ms']:.4f}"
        before = ("" if r["before_ms"] is None
                  else f" cuda_core_ms={r['before_ms']:.4f}")
        print(f"[attn] {r['shape']:14s} S={r['n']:<5d} H={r['heads']} "
              f"KV={r['kv_heads']} dh={r['head_dim']} window={r['window']} "
              f"softcap={r['softcap']} tile={r['tile']} "
              f"{r['dtype']:8s} walk={r['walk']} rel_err={r['rel_err']:.2e} "
              f"ms={r['ms']:.4f}{before} plain_ms={r['plain_ms']:.4f} "
              f"library_ms={lib} ({r['library']}, rel_err "
              f"{r['library_rel_err']:.2e}) bound_ms={r['bound_ms']:.4f} "
              f"({r['bound_by']}) tiles_visited={r['tiles_visited']} "
              f"element_pairs={r['element_pairs']}")
    torch.cuda.empty_cache()

    serve, lm = serve_phase(torch, args)
    print(f"[serve] {serve['requests']} requests, {serve['tokens']} tokens "
          f"in {serve['wall_s']:.3f}s = {serve['tokens_per_s']:.1f} tok/s; "
          f"prefill p50 {serve['prefill_p50_ms']} ms, decode step p50 "
          f"{serve['decode_step_p50_ms']} ms; launches {serve['launches']}; "
          f"launches by walk {serve['walks']}")
    print(f"[serve] detail {json.dumps(serve)}")
    print_graphs("llama3.2-1b", serve["graphs"])

    errs = consistency_phase(torch, lm, args)
    print(f"[consistency] rel-max err vs forward: "
          f"{json.dumps(errs)} (budget {CONSISTENCY_TOL})")

    del lm
    torch.cuda.empty_cache()
    grads = grad_phase(torch, args)
    for r in grads:
        print(f"[grad] {r['layer']:4s} {r['dtype']:8s} n={r['n']} "
              f"dvalues rel_err={r['dvalues_rel_err']:.2e} "
              f"dx rel_err={r['dx_rel_err']:.2e} (budget {r['tol']})")

    train = train_phase(torch, args)
    print(f"[train] {train['steps']} steps of batch {train['batch']} x seq "
          f"{train['seq']}: loss {train['losses'][0]:.4f} -> "
          f"{train['losses'][-1]:.4f}; step p50 "
          f"{train['step_p50_ms']:.1f} ms = "
          f"{train['tokens_per_s']:.0f} tokens/s; peak memory "
          f"{train['peak_mem_gb']:.2f} GiB; launches {train['launches']}; "
          f"launches by walk {train['walks']}")
    print(f"[train] detail {json.dumps(train)}")

    from repro_torch.kernels import (bsmm, dense_mm, dsmm,  # noqa: F401
                                     sddmm)
    counters = with_walks({"bsmm": bsmm.COUNTER,
                           "dense_mm": dense_mm.COUNTER,
                           "sddmm": sddmm.COUNTER, "dsmm": dsmm.COUNTER,
                           "bsmm_balanced": bsmm.BALANCED_COUNTER})
    for c in counters.values():
        c.reset()
    table3 = table3_phase(torch, args)
    table3_launches, table3_walks = split_walks(
        {k: c.launches for k, c in counters.items()})
    for r in table3:
        print(f"[table3] b={r['b']:<2d} {r['dtype']:8s} {r['route']:30s} "
              f"ms={r['ms']:.4f} speedup_vs_dense_cuda="
              f"{r['speedup_vs_dense_cuda']:.3f} speedup_vs_torch_matmul="
              f"{r['speedup_vs_torch_matmul']:.3f} (torch.matmul "
              f"{r['torch_matmul_ms']:.4f} ms) rel_err={r['rel_err']:.2e}")
    print(f"[table3] launches {json.dumps(table3_launches)}; launches by "
          f"walk {json.dumps(table3_walks)}")
    for name in ("bsmm", "bsmm_balanced", "dsmm", "dense_mm"):
        if table3_launches[name] <= 0:
            raise RuntimeError(f"kernel {name} was not launched in "
                               f"[table3]")

    torch.cuda.empty_cache()
    for c in counters.values():
        c.reset()
    dyn = dynamic_phase(torch, args)
    dyn_launches, dyn_walks = split_walks(
        {k: c.launches for k, c in counters.items()})
    check_tensor_core_walks("dynamic", dyn_walks, ("dsmm",))
    print(f"[dynamic] SwiGLU FFN of 3 DynamicSparseLinear "
          f"{dyn['d_model']}->{dyn['d_ff']}->{dyn['d_model']}, d_max "
          f"{dyn['d_max']}, b {dyn['b']}, bf16, N {dyn['tokens']}: step "
          f"p50 {dyn['step_p50_ms']:.2f} ms (steps {[round(t, 2) for t in dyn['step_ms']]}); "
          f"dsmm launches per step {dyn['dsmm_launches_per_step']} "
          f"(by walk {json.dumps(dyn_walks['dsmm'])}); "
          f"forward host syncs after step 0 {dyn['forward_host_syncs']}; "
          f"plans_built {dyn['plans_built']}; masks distinct "
          f"{dyn['masks_distinct']}/5")
    print(f"[dynamic] step 0 vs plain: {json.dumps(dyn['errs'])} (budget "
          f"{dyn['tol']}); grouped capacity pass totals "
          f"{json.dumps(dyn['capacity_totals'])}")

    torch.cuda.empty_cache()
    gemma, lm, eng = serve_gemma2_phase(torch, args)
    print(f"[serve-gemma2] {gemma['requests']} requests (prompts "
          f"{gemma['prompt_lens']}, prefilled at {gemma['prefill_lens']}), "
          f"{gemma['tokens']} tokens in {gemma['wall_s']:.3f}s = "
          f"{gemma['tokens_per_s']:.2f} tok/s; prefill p50 "
          f"{gemma['prefill_p50_ms']} ms, decode step p50 "
          f"{gemma['decode_step_p50_ms']} ms; launches "
          f"{json.dumps(gemma['launches'])}; launches by walk "
          f"{json.dumps(gemma['walks'])}; peak memory "
          f"{gemma['peak_mem_gb']:.2f} GiB")
    print_graphs("gemma2-2b", gemma["graphs"])
    print(f"[serve-gemma2] visited pairs at S={gemma['prefill_lens']}'s "
          f"longest: {json.dumps(gemma['visited'])}")
    gemma["consistency"] = gemma2_consistency_phase(torch, lm, eng, args)
    del lm, eng
    cons = gemma["consistency"]
    print(f"[serve-gemma2] decode after a {cons['prompt']}-token prompt "
          f"(prefilled at {cons['bucket']}) vs forward: every layer's "
          f"attention, bf16, max rel err "
          f"{json.dumps(cons['layer_attention_bf16'])} (budget "
          f"{CONSISTENCY_TOL}); end to end fp32 "
          f"{json.dumps(cons['end_to_end_fp32'])} (budget "
          f"{LOGITS_TOL_FP32}); end to end bf16 "
          f"{json.dumps(cons['end_to_end_bf16'])} (not held: forward with "
          f"the weights rounded to bf16 vs fp32 differs by "
          f"{cons['bf16_vs_fp32_weights_forward']:.3f})")

    gc.collect()
    torch.cuda.empty_cache()
    qwen, lm, eng = serve_qwen3_phase(torch, args)
    print(f"[serve-qwen3-moe] {qwen['params'] / 1e9:.2f} B parameters "
          f"initialised on the card in {qwen['init_s']:.2f}s; "
          f"{qwen['requests']} requests (prompts {qwen['prompt_lens']}, "
          f"prefilled at {qwen['prefill_lens']}; buckets "
          f"{qwen['buckets']}), {qwen['tokens']} tokens in "
          f"{qwen['wall_s']:.3f}s = {qwen['tokens_per_s']:.2f} tok/s; "
          f"prefill p50 {qwen['prefill_p50_ms']} ms, decode step p50 "
          f"{qwen['decode_step_p50_ms']} ms; launches "
          f"{json.dumps(qwen['launches'])}; launches by walk "
          f"{json.dumps(qwen['walks'])}; peak memory "
          f"{qwen['peak_mem_gb']:.2f} GiB")
    print_graphs("qwen3-moe-30b-a3b", qwen["graphs"])
    print(f"[serve-qwen3-moe] dropped_frac per prefill (mean, max over 48 "
          f"layers): {json.dumps(qwen['dropped_frac_per_prefill'])}; "
          f"decode steps: {json.dumps(qwen['decode_dropped_frac'])}")
    qwen["moe_layer"] = qwen3_moe_layer_check(torch, lm, eng, args)
    ml = qwen["moe_layer"]
    print(f"[serve-qwen3-moe] layer {ml['layer']} moe_apply on a "
          f"{ml['tokens']}-token prefill state (C={ml['capacity']}, "
          f"dropped {ml['dropped_frac']:.4f}): gmm route vs plain rel err "
          f"{ml['rel_err']:.2e} (budget {ml['tol']}), gmm launches "
          f"{ml['gmm_launches']} (plain route {ml['plain_route_gmm_launches']})")
    del lm, eng
    gc.collect()
    torch.cuda.empty_cache()
    qwen["fp32"] = qwen3_fp32_phase(torch, args)
    q32 = qwen["fp32"]
    print(f"[qwen3-fp32] {q32['layers']} layers at full width, fp32: decode "
          f"after a {q32['prompt']}-token prompt (prefilled at "
          f"{q32['bucket']}) vs forward {json.dumps(q32['errs'])} (budget "
          f"{q32['tol']}); forward dropped "
          f"{q32['forward_dropped_assignments']:.3f} assignments")

    # name -> (source, replaces, the row the line reports, its path)
    sources = {"bsmm": ("src/repro_torch/kernels/bsmm/csrc/bsmm.cu",
                        "src/repro/kernels/bsmm/bsmm.py:50",
                        ("up/gate 8192x2048", 4), "serve"),
               "dense_mm": ("src/repro_torch/kernels/dense_mm/csrc/"
                            "dense_mm.cu",
                            "src/repro/kernels/dense_mm/dense_mm.py:38",
                            ("q/o 2048x2048", 4), "serve"),
               "sddmm": ("src/repro_torch/kernels/sddmm/csrc/sddmm.cu",
                         "src/repro/kernels/sddmm/sddmm.py:53",
                         ("up/gate 8192x2048", 2048), "train"),
               "bsmm_balanced": ("src/repro_torch/kernels/bsmm/csrc/"
                                 "bsmm_balanced.cu",
                                 "src/repro/kernels/bsmm/balanced.py:59",
                                 ("skew power_law 4096x4096 d=1/32", 4096),
                                 "table3"),
               "dsmm": ("src/repro_torch/kernels/dsmm/csrc/dsmm.cu",
                        "src/repro/kernels/dsmm/dsmm.py:53",
                        ("up/gate 8192x2048 b=16", 2048), "dynamic")}
    by_path = {"serve": serve["launches"], "train": train["launches"],
               "table3": table3_launches, "dynamic": dyn_launches,
               "serve_gemma2": gemma["launches"],
               "serve_qwen3": qwen["launches"]}
    walks_by_path = {"serve": serve["walks"], "train": train["walks"],
                     "table3": table3_walks, "dynamic": dyn_walks,
                     "serve_gemma2": gemma["walks"],
                     "serve_qwen3": qwen["walks"]}
    kernels = []
    for name, (source, replaces, (shape, n), path) in sources.items():
        # serving kernels at the decode shape (their most frequent
        # launch), the sddmm at the training shape, dsmm at the dynamic
        # FFN's shape, bsmm_balanced on the power-law skew grid
        r = next(r for r in rows if r["kernel"] == name
                 and r["n"] == n and r["dtype"] == "bfloat16"
                 and r["shape"] == shape)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": by_path[path][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "at": f"{r['shape']} n={r['n']} {r['dtype']}",
            "launches_by_path": {k: v.get(name, 0)
                                 for k, v in by_path.items()}})
        if name in WALK_KERNELS:
            kernels[-1]["launches_by_walk"] = {
                p: w[name] for p, w in walks_by_path.items()}
        if name in ("dsmm", "sddmm", "bsmm", "bsmm_balanced"):
            kernels[-1].update(walk=r["walk"], before_ms=r["before_ms"])
    # bs_attn at gemma2-2b's global layer (S = 4096, bf16); its main path
    # is the gemma2 serve run
    r = next(r for r in attn_rows if r["shape"] == "gemma2 global"
             and r["dtype"] == "bfloat16")
    kernels.append({
        "name": "bs_attn", "route": "cuda",
        "source": "src/repro_torch/kernels/bs_attn/csrc/bs_attn.cu",
        "replaces": "src/repro/kernels/bs_attn/bs_attn.py:73",
        "launches": gemma["launches"]["bs_attn"],
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "at": f"{r['shape']} S={r['n']} {r['dtype']}", "walk": r["walk"],
        "before_ms": r["before_ms"],
        "launches_by_path": {k: v.get("bs_attn", 0)
                             for k, v in by_path.items()},
        "launches_by_walk": {p: w["bs_attn"]
                             for p, w in walks_by_path.items()}})

    # gmm at qwen3's decode gate/up (C = 8, bf16), its most frequent
    # launch; its main path is the qwen3 serve run
    r = next(r for r in rows if r["kernel"] == "gmm"
             and r["shape"] == "gate/up C=8" and r["dtype"] == "bfloat16")
    kernels.append({
        "name": "gmm", "route": "cuda",
        "source": "src/repro_torch/kernels/gmm/csrc/gmm.cu",
        "replaces": "src/repro/kernels/gmm/gmm.py:41",
        "launches": qwen["launches"]["gmm"],
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "at": f"{r['shape']} T={r['n']} {r['dtype']}", "walk": r["walk"],
        "before_ms": r["before_ms"],
        "launches_by_path": {k: v.get("gmm", 0)
                             for k, v in by_path.items()},
        "launches_by_walk": {p: w["gmm"]
                             for p, w in walks_by_path.items()}})

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "torch": torch.__version__,
                       "cuda": torch.version.cuda, "build_s": built,
                       "kernel_rows": rows, "serve": serve,
                       "consistency": errs, "grads": grads, "train": train,
                       "table3": table3, "dynamic": dyn,
                       "attn": attn_rows, "serve_gemma2": gemma,
                       "serve_qwen3": qwen, "kernels": kernels}, f,
                      indent=1)

    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
