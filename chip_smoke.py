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
   ``[serve] plans`` lists every plan of the engine's pool with its
   route and the route's source (the plan layer's race: "analytic" for
   the static FFN plans, "forced" for one-candidate plans);
4. consistency: for one prompt, padded ``prefill(last_index)`` logits
   and two ``decode_step``s against ``forward`` on the same tokens;
4b. race-serve: the same requests through ``Engine(plan_cache_dir=...)``
   (graphs captured at startup), then ``sparse.remeasure_plan`` on every
   analytic plan of its pool (each candidate timed on the card on
   synthesized inputs), a second engine (it adopts the measured routes),
   then a fresh process state (``sparse.reset()`` and the cache module's
   reset) and a third engine from the directory: its startup must make
   zero decisions, every plan come from disk (the static ones
   "measured"), its tokens equal the second engine's, and the first
   engine's too where no route changed;
4c. replan: the engine's re-planner on llama's graphs.  A deliberately
   wrong calibration (``REPLAN_WRONG_SCALE``: static_cuda's model x4,
   through ``dispatch.set_cost_coeffs``) makes "auto" capture the FFN
   plans on other routes; the engine serves the requests,
   ``replan_once()`` times every analytic plan on the card, and the
   requests are served again.  It fails unless a program was
   re-captured, every program replayed after the sweep was re-captured
   first, the served routes are the measured verdicts, the launches per
   replay moved to the new routes' kernels and the tokens equal a
   second engine's built on those verdicts; then ``Engine(...,
   replanner=True)`` serves rounds of the requests while its thread
   sweeps, until no analytic plan is left, and ``stop_replanner()``
   joins it.  Prints the routes before and after, the programs
   re-captured and their capture s, launches per replay by kernel, and
   the decode step p99 with and without a sweep running.  The active
   calibration is restored after it;
4d. evolve (serving guard): llama's requests through the graphs of a
   fresh engine, then the up projection of all 16 layers evolved onto
   one RigL mask (``SparseLinear.evolve``), then the requests again: it
   fails unless the evolve made no route decision, every program that
   replays was re-captured once first (its graph held a superseded
   plan) and the tokens equal a fresh engine's on the evolved model;
5. gradients: one full-width SparseLinear (up and down), bf16 and fp32,
   N = 2048: autograd dx and dvalues through the kernels against
   ``core/static_sparse``'s plain formulation on the card; then up in
   bf16 with each backward route a race can pick forced (dL/dx on each
   static-admissible family, dL/dvalues sddmm or dense_mm and a gather),
   each route's kernel launched;
6. train: ``launch.train.train_loop`` on full-width llama3.2-1b with
   every FFN block-sparse (d=1/8, b=16), bf16, batch 4 x seq 512, 10
   AdamW steps from a seeded init, no checkpoint, then a topology step
   on layer 0's up projection (``evolve_sparse_layer``, a fifth of its
   blocks moved, constant count) and 2 more steps: once eagerly
   (``graphs=False``) and once replaying the step captured as one CUDA
   graph (``train/program.py``; the main path whose launch counters are
   read).  The counters are zeroed just before each run and read just
   after; every kernel must have launched (bsmm and sddmm on their mma
   walks, bs_attn on wgmma), every loss and grad norm be finite, the
   tenth loss below the first, the graph run re-captured exactly once
   (after the topology step), and its 12 losses, final parameters and
   launches of every step equal the eager run's (to the bit).  Prints each run's step p50,
   tokens/s, peak GiB allocated and reserved, the host syncs of one step
   (``set_sync_debug_mode("warn")``), the graph's capture seconds and
   launches per replay by kernel and walk.  Every layer is recomputed in
   the backward (``remat="full"``, the configs' default); 3 more eager
   steps at ``remat="none"`` must equal the eager run's first 3 losses
   and parameters to the bit, and both runs' peaks and step p50s print;
6b. dryrun: ``launch/dryrun.py``'s meta-device predictions of the eager
   [train] step, a [serve] prefill at its bucket and a decode step at
   batch 4, against the card: argument bytes equal to the byte, the peak
   within ``DRYRUN_PEAK_TOL`` of the card's, the plans' routes and walks
   and the kernels' launches by walk equal (``dryrun_phase``);
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
8b. race: the plan layer's measured route race at each Table 3 cell
   (``PlanContext(measure=True, cache_dir=...)``, forward verdicts):
   every admissible candidate's measured ms, the fastest, the verdict
   (the fastest only where it beats the analytic pick by more than the
   noise margin, ``core.dispatch.MEASURE_MARGIN``), the analytic
   verdict (the H100 model's) with the measured ms of the route it
   picked; then a fresh process state plans every cell again from the
   directory and must make zero decisions and zero measurements, read
   every verdict from disk and pick the same routes; the backward
   race (dL/dx, dL/dvalues) at llama's FFN training shapes, measured and
   analytic; and the dynamic kind's race (the three dsmm routes and the
   dense one) at phase 9's shapes;
9. dynamic: a SwiGLU FFN of three DynamicSparseLinear at llama3.2-1b
   width (2048 -> 8192 -> 2048, d_max = 1/8, b = 16, bf16), N = 2048,
   on the dsmm slot walk named (``backend="pallas"``), 5 forward +
   backward steps with a fresh seeded mask each; step 0 against the
   plain formulation; the mask must change every step, no plan be built
   after step 0 and dsmm launch on every step; then one step on the
   race's analytic verdict (``backend="auto"``) against the same plain
   step, its route's kernel launched; then one planned-capacity pass on
   the grouped route for its capacity report;
9b. evolve: RigL on llama3.2-1b's sparse FFN at full width (up and
   gate 2048 -> 8192, down 8192 -> 2048, d = 1/8, b = 16, bf16), N =
   2048, an MSE loss, AdamW, 20 steps after 2 warm-up ones, a topology
   step (``rigl_evolve``, fraction 0.2: 1638 of 8192 blocks) on every
   projection every 2 steps with the values, plans and AdamW's master
   and moments carried.  The launch counters are zeroed after the
   warm-up and read after the last topology step.  It fails unless the
   loss is finite, nnz is constant, no route decision or measurement
   follows the warm-up, each plan is at generation 10, every bsmm and
   sddmm launch is on its tensor-core walk, the steps after a topology
   step synchronise no more than the ones before, and the last
   generation's forward, dL/dx and dL/dvalues equal the plain
   formulation on its pattern (bf16 budget).  Prints the step p50
   before and after the first topology step, the topology step's ms
   per projection (rigl_update on the device, rigl_evolve's host wall,
   the module's carries), the GiB allocated after each generation and
   the launches by walk; then a DynamicSparseLinear at llama width on a
   ``rigl_update`` mask against the plain formulation (dsmm);
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
   assignment;
12c. train-qwen3-moe: ``launch.train.train_loop`` on the same model at
   full width in bf16, depth cut to 4 layers (~3.1 B parameters, ~50 GB
   of training state), batch 4 x seq 512 (C = 160, row tile 80), 10
   AdamW steps from a seeded init, eagerly and then replaying the
   captured step, as [train] (without the topology step).  The launch
   counters are zeroed just before each run and read just after; the
   eager run's gmm launches are split into the forward's and the
   backward's (dL/da on W^T).  It fails unless every loss is finite and
   the last below the first, gmm, dense_mm and bs_attn launch, gmm
   launches in both directions, all on the wgmma walk, the graph run's
   losses, final parameters and launches per step equal the eager
   run's, and one trained layer's ``batched_matmul`` backward (dL/da by
   gmm on W^T, dL/dW by ``torch.bmm``) equals ``torch.matmul``'s
   autograd in fp32 on the same bf16 inputs within the bf16 budget.
   Prints each run's step p50, tokens/s, peak GiB allocated and
   reserved, each step's ``aux_loss``, ``z_loss`` and ``dropped_frac``,
   gmm's launches by walk and direction, the host syncs of one step
   (``torch.cuda.set_sync_debug_mode("warn")``; reported, not failed),
   the graph's capture seconds and launches per replay;
12d. serve-deepseek, train-deepseek, serve-qwen2, serve-glm4: MLA and
   deepseek-v2-lite-16b served as published and trained at 4 layers,
   qwen2-1.5b and glm4-9b served with the sparse FFN (see each phase's
   docstring);
12e. serve-mamba2: full-width, full-depth mamba2-130m (24 SSD layers,
   d_model 768, 24 heads of 64, d_state 128, vocab 50280, tied) in bf16
   through ``Engine(batch=4, max_len=1024)``: 8 seeded requests of
   16..900 tokens (one a multiple of 256, one odd), 16 new each, eagerly
   and through the graphs.  The stack is pad-unsafe: no buckets, every
   prompt prefilled eagerly at its exact length, the decode step one
   captured graph.  Fails unless dense_mm launches on its 16-bit walks,
   the tokens are identical, every cache is ``{state, conv}``, and
   decode after a prompt matches ``forward`` in bf16 layer by layer
   (each mamba layer on the same inputs, 6e-2) and end to end at the
   same seeded weights in fp32 (2e-4), also after 1- and 2-token
   prompts (the bf16 end-to-end gap printed).  Prints each prefill's
   SSD chunk length and count beside its ms;
12f. train-mamba2: ``train_loop`` on the same model, batch 4 x seq 512
   (2 SSD chunks), 60 AdamW steps, eagerly and then replaying the
   captured step: bit-equal, the mean of the last 5 losses below the
   first 5's, dense_mm on its 16-bit walks;
12g. serve-jamba: jamba-v0.1-52b at published widths, depth cut 32 ->
   16 layers (2 of its 4 periods: 14 mamba, 2 attention without rope, 8
   MoE of 16 experts top-2; 26.00 B parameters), served as qwen3 is (6
   requests of 32..900 tokens, each at its exact length): gmm, dense_mm
   and bs_attn launch on their 16-bit walks, tokens and routing drops
   equal, caches ``{state, conv}`` and ``{k, v}``; one MoE layer's gmm
   route against plain;
12h. serve-internvl2: internvl2-1b as text through the engine, as
   serve-qwen2 (the engine takes no frontend); vlm-internvl2: the
   published model with 256 seeded patch rows a row through
   ``LM.prefill(frontend=)`` and greedy ``decode_step``s at positions
   offset by them; decode vs forward in bf16 and in an fp32 copy;
12i. serve-seamless: seamless-m4t-medium at full width and depth (12
   encoder layers over 1024 frames, 12 decoder layers with cross
   attention) through ``prefill(enc_frames=)`` and eager
   ``decode_step`` (the engine refuses a stack with cross layers):
   bs_attn 36 launches a prefill and 12 a decode step, on wgmma; the
   encoder's ms apart; decode vs forward in bf16 and in an fp32 copy;
12j. train-seamless: ``train_loop`` on it with 4 x 1024 seeded frames a
   batch (``TrainProgram``'s float buffer), eager and captured,
   bit-equal, the loss falls; the ``[attn]`` phase also holds bs_attn
   without the causal mask at its encoder (1024 x 1024), cross prefill
   (300 x 1024) and cross decode (1 x 1024) against plain and SDPA;
12k. long: the long_500k cell's batch (1) on llama3.2-1b at full width
   and depth (d = 1/8 FFNs, bf16) through the retained ring cache of the
   published 1024 + 4096 slots: ``LM.prefill`` of a seeded 5120-token
   prompt, then 256 greedy ``decode_step(retained=True)``s past the
   wrap (slots 1024..1279), once eagerly and once replayed from a CUDA
   graph captured through ``serve/graphs.py``'s ``Program``; tokens
   identical, every step's logits within the bf16 budget of the forward
   whose layers keep window 4096 and prefix 1024 (bs_attn with a global
   prefix at S 5376), an fp32 copy at 4 layers within the fp32 budget;
   one ``attend_decode`` at the ring timed apart;
12l. serve-long: gemma2-2b at full width (d = 1/8) through
   ``Engine(retained=True, batch=2, max_len=5120)``: 4 seeded requests
   of 3000..5100 tokens, 16 new each, eager and graphs, tokens
   identical, the graph engine's logits against ``decode_step(
   retained=True)`` driven by hand; the ``[attn]`` phase also holds
   bs_attn at both phases' shapes with the window and the prefix
   (``long_attn_rows``) against plain and one library call with the same
   mask;
13. roofline (after 11): ``sparse.roofline_report()`` totals of the
   llama and gemma2 engines and each served static plan's chosen route
   on the H100's roofline (efficiency, headroom, dominant term,
   flagged); the bound a plan gives bsmm up/gate 8192x2048 at N 2048 in
   bf16 must equal the ``[kernel]`` row's within 1 %;
14. calibrate: the committed calibration
   (``src/repro_torch/analysis/baselines/cost_coeffs.json``) against the
   identity on this run's measurements: each Table 3 cell's analytic
   verdict beside the measured fastest, model / measured per route
   family, the llama and gemma2 bucket ladders and served routes.  The
   run's calibration corpus (every raced candidate's measured ms with
   the raw model's inputs: ``[race]``, race-serve, the backward races
   and the skew grid) is written with ``--out`` (``corpus``), the input
   of ``python -m repro_torch.analysis.calibrate``;
15. tp (after serve-long): tensor parallelism of llama3.2-1b's sparse
   FFN.  ``static_tp`` at its up/gate and down patterns (N 4 and 2048, q
   2 and 4, nnz-balanced and even k-splits) forward and backward against
   the fp32 plain version and the unsharded plan (bf16 2e-2; fails unless
   a forward launches bsmm q times on its mma or decode walk and a
   backward q dL/dx walks and q SDDMMs), with device ms beside the
   unsharded plan's, ``tp_imbalance`` and ``tp_slots``;
   ``static_tp_shardmap`` on 2 gloo ranks of the one card (spawned;
   both ranks identical and within bf16 2e-2 of ``static_tp``, one bsmm
   launch a rank a call); the full-width, full-depth llama engine with an abstract
   (1, 4) ``("data", "model")`` mesh and [serve]'s requests, eager then
   through its graphs (the main path, counters zeroed just before):
   tokens identical, every static plan with a ``tp`` section, the decode
   plans on ``static_tp`` from the analytic verdict, q bsmm launches per
   sparse projection a decode replay, a prefill's logits within 6e-2 of
   the unsharded plans';
16. dp (after tp): data parallelism with the state sharded by the
   reference's rules, llama3.2-1b (d = 1/8) at full width and depth,
   ``train_loop(mesh=)`` on 2 gloo ranks of the card against the
   one-process run (``dp_phase``); a checkpoint re-sharded both ways;
17. ep: MoE expert parallelism, qwen3-moe-30b-a3b at full width, 2
   layers, ``impl="shard_map"``, 64 experts a rank (``ep_phase``); then
   the same cut under ``impl="gspmd"`` on (2, 1) (the routing over the
   global batch) and (1, 2) (64 experts held a rank), each MoE layer
   against one process on the global batch (``ep_gspmd_job``).

A ``[mem]`` line gives the card memory still allocated as each phase
starts (the peaks the phases report include it); each engine warms up
and captures its graphs on one stream, so its captures keep at most one
cuBLAS workspace; the last ``[mem]`` line measures which stream holds
the workspaces (``capture_stream_memory``).  Prints the card line
and a ``{"kernels": [...]}`` line before the last
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
# the step whose host syncs the train phases count (a replay in a graph
# run: the first step is the capture's)
TRAIN_SYNC_STEP = 5
# [train]: steps after the topology step that follows the TRAIN_STEPS
# steps, and the seed of the blocks it moves
TOPOLOGY_AFTER, TOPOLOGY_SEED = 2, 29
# [train]: eager steps at remat="none" held bit-equal to the remat="full"
# run's first steps
REMAT_STEPS = 3


def jsonable(obj):
    """``obj`` with every dict key JSON takes none of (a mesh shape's
    tuple) written as its ``str``."""
    if isinstance(obj, dict):
        return {k if isinstance(k, (str, int, float, bool)) or k is None
                else str(k): jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [jsonable(v) for v in obj]
    return obj


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
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations over the peak of their type (the
    H100's peaks of ``repro_torch.analysis.roofline``, the plan layer's
    roofline too)."""
    from repro_torch.analysis.roofline import PEAK_BYTES, PEAK_FLOPS
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


def served_plans(eng):
    """Every plan of the engine's pool with its route and the route's
    source: the static FFN plans by shape and token count (the decode
    batch and each prefill bucket), the one-candidate plans (dense
    projections, MoE expert GEMMs) counted by route."""
    from repro_torch import sparse
    out = {}
    for p in sparse.pool_plans(eng.pool):
        if p.kind == "static":
            out[f"{p.m}x{p.k} n={p.n}"] = f"{p.route} ({p.source})"
        else:
            key = f"{p.kind} {p.route} ({p.source})"
            out[key] = out.get(key, 0) + 1
    return out


def served_models(eng):
    """Every static plan of the engine's pool: its route and candidates,
    the raw model's inputs (``analysis.calibrate.plan_model_inputs``)
    and the roofline of its chosen route (``MatmulPlan.roofline``)."""
    from repro_torch import sparse
    from repro_torch.analysis import calibrate
    out = []
    for p in sparse.pool_plans(eng.pool):
        if p.kind != "static":
            continue
        out.append(dict(plan=f"{p.m}x{p.k} n={p.n}", route=p.route,
                        source=p.source, routes=sorted(p.est_seconds),
                        model=calibrate.plan_model_inputs(p),
                        roofline=p.roofline()["chosen"]))
    return out


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
    # internvl2-1b's k/v projection (896 -> 2 x 64: 128 wide, the
    # kernel's narrowest tile) at [serve-internvl2]'s decode batch and
    # [vlm-internvl2]'s prefill (patch rows + prompt, 4 rows); seamless's
    # FFN (1024 -> 4096 -> 1024) at decode batch 4 and at its encoder's 4
    # x 1024 frames (N 4096)
    fp16 = {"float16": torch.float16}
    vlm_n = VLM_BATCH * (configs.get(INTERNVL2).frontend_len + VLM_PROMPT)
    for shape_name, k, d, ns, dts in (
            ("q/o", 2048, 2048, llama_ns, dtypes),
            ("k/v", 2048, 512, llama_ns, dtypes),
            ("gemma2 q", gemma.d_model, g_q, gemma_ns, dtypes),
            ("gemma2 k/v", gemma.d_model, g_kv, gemma_ns, dtypes),
            ("gemma2 o", g_q, gemma.d_model, gemma_ns, dtypes),
            ("qwen3 q", 2048, 4096, qwen_ns, dtypes),
            ("qwen3 k/v", 2048, 512, qwen_ns, dtypes),
            ("qwen3 o", 4096, 2048, qwen_ns, dtypes),
            ("internvl2 k/v", 896, 128, (DENSE_BATCH, vlm_n), dtypes),
            ("seamless up", 1024, 4096, (4, 4096), dtypes),
            ("seamless down", 4096, 1024, (4, 4096), dtypes),
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
    out += backward_routes(torch, args)
    bad = [r for r in out if not (r["dvalues_rel_err"] <= r["tol"]
                                  and r["dx_rel_err"] <= r["tol"])]
    if bad:
        raise RuntimeError(f"kernel gradients disagree with the plain "
                           f"formulation: {bad}")
    return out


# every backward route a static plan's race can pick: dL/dx as each
# static-admissible family on the transposed problem (a forward plan of
# W^T where it leaves bsmm), dL/dvalues the block SDDMM or the dense
# product and a gather
GRAD_DX_MODES = ("static", "static_balanced", "dense", "dynamic",
                 "dynamic_grouped", "dynamic_grouped_balanced")
GRAD_DV_MODES = ("sddmm_grouped", "sddmm_dense")


def backward_routes(torch, args):
    """llama's FFN up projection (2048 -> 8192, d = 1/8, b = 16, bf16, N
    2048) through autograd with each backward route forced, against the
    plain formulation of ``core/static_sparse``; each route's kernel
    must launch."""
    from repro_torch import sparse
    from repro_torch.core import static_sparse
    from repro_torch.core.sparse_layers import SparseLinear
    from repro_torch.kernels import bsmm, dense_mm, dsmm, sddmm

    dev = torch.device("cuda", 0)
    n, b, d_in, d_out, dt = 2048, 16, 2048, 8192, torch.bfloat16
    layer = SparseLinear.random_pattern(d_in, d_out, b, 1 / 8,
                                        seed=args.seed + 1, dtype=dt,
                                        device=dev)
    layer.reset_parameters(torch.Generator(device=dev).manual_seed(
        args.seed))
    layer.requires_grad_(True)
    g = torch.Generator(device=dev).manual_seed(args.seed + 5)
    x0 = torch.randn((n, d_in), generator=g, device=dev).to(dt)
    gy = torch.randn((n, d_out), generator=g, device=dev).to(dt)
    f = static_sparse.make_spmm(layer.row_idx, layer.col_idx,
                                (d_out // b, d_in // b), b)
    v = layer.values.detach().clone().requires_grad_(True)
    xt = x0.t().contiguous().requires_grad_(True)
    f(v, xt).backward(gy.t())
    want_dv, want_dx = v.grad, xt.grad.t()
    kernel = {"static": bsmm.COUNTER, "static_balanced":
              bsmm.BALANCED_COUNTER, "dense": dense_mm.COUNTER,
              "sddmm_grouped": sddmm.COUNTER,
              "sddmm_dense": dense_mm.COUNTER}
    out = []
    for gm in GRAD_DX_MODES:
        for sm in GRAD_DV_MODES:
            cs = (kernel.get(gm, dsmm.COUNTER), kernel[sm])
            before = [c.launches for c in cs]
            layer.values.grad = None
            x = x0.clone().requires_grad_(True)
            with sparse.use_ctx(sparse.PlanContext(
                    mode="static", grad_mode=gm, sddmm_mode=sm)):
                layer(x).backward(gy)
                routes = layer.plan(n).grad_routes
            torch.cuda.synchronize()
            launched = [c.launches - b0 for c, b0 in zip(cs, before)]
            if not all(k_ > 0 for k_ in launched):
                raise RuntimeError(f"[grad] backward {routes} did not "
                                   f"launch its kernels: {launched}")
            out.append(dict(layer=f"up dx={routes['dx']} "
                                  f"dvalues={routes['dvalues']}",
                            dtype="bfloat16", n=n,
                            dvalues_rel_err=rel_err(layer.values.grad,
                                                    want_dv)[0],
                            dx_rel_err=rel_err(x.grad, want_dx)[0],
                            tol=KERNEL_TOL["bfloat16"]))
    sparse.reset()
    return out


def counter_index_names(counters):
    """Launch counter index (``kernels._build.COUNTERS``) -> its name in
    ``counters`` (a ``with_walks`` dict: kernels and ``kernel:walk``)."""
    from repro_torch.kernels import _build
    named = {id(c): k for k, c in counters.items()}
    return {i: named[id(c)] for i, c in enumerate(_build.COUNTERS)
            if id(c) in named}


def train_run(torch, label, cfg, *, graphs, counters, args, steps, batch,
              seq, metric_keys=("loss", "grad_norm", "lr"), after_step=None,
              float_inputs=None, total_steps=TRAIN_STEPS):
    """``launch.train.train_loop`` on ``cfg`` from ``args.seed``, each step
    run eagerly or replayed from the captured step (``graphs``), no
    checkpoint.  The launch counters are zeroed just before and read just
    after.  Returns each step's metrics, wall and launches by counter,
    the run's launches by kernel and walk, the step p50 over the first
    ``TRAIN_STEPS`` steps (each ending in its loss read) and tokens/s,
    the peak GiB allocated and reserved, the host syncs of step
    ``TRAIN_SYNC_STEP`` under ``torch.cuda.set_sync_debug_mode("warn")``
    (its batch upload, the step and the loss read), the program's
    captures, re-captures, capture seconds and launches per replay by
    kernel and walk, and the parameters after the last step (on the host,
    under ``params``).  ``after_step(step, program)`` runs after each
    step's own reads, in ``train_loop``'s ``on_step``.
    ``float_inputs(step)`` gives each batch's float entries (an
    encoder-decoder's frames), ``train_loop``'s.  ``total_steps``: the
    cosine schedule's length (``TRAIN_HP``'s by default)."""
    import numpy as np

    from repro_torch.launch.train import train_loop
    from repro_torch.train.step import TrainHParams

    hp = TrainHParams(**dict(TRAIN_HP, total_steps=total_steps))
    names = counter_index_names(counters)
    tag = f"[{label}] [{'graphs' if graphs else 'eager'}]"
    per_step, records, sync, prog = [], [], {}, {}
    last = {k: 0 for k in counters}

    def stop_sync(step):
        torch.cuda.set_sync_debug_mode(0)
        sync.pop("catcher").__exit__(None, None, None)
        # (torch's own notice that the debug mode is a prototype is no
        # synchronisation)
        log = [w for w in sync.pop("log")
               if "synchroniz" in str(w.message).lower()
               and "prototype" not in str(w.message).lower()]
        sync.update(step=step, count=len(log), at=sorted(
            {"/".join(w.filename.split(os.sep)[-2:]) + f":{w.lineno}"
             for w in log}))

    def on_step(step, metrics, program):
        if "catcher" in sync:
            stop_sync(step)
        now = {k: c.launches for k, c in counters.items()}
        per_step.append({k: now[k] - last[k] for k in counters})
        last.update(now)
        records.append(dict(step=step, step_s=float(metrics["step_s"]),
                            **{k: float(metrics[k]) for k in metric_keys}))
        r = records[-1]
        print(f"{tag} step {step} "
              + " ".join(f"{k} {r[k]:.4f}" for k in metric_keys)
              + f" wall {r['step_s'] * 1e3:.1f} ms launches "
              f"{json.dumps({k: v for k, v in per_step[-1].items() if v})}")
        # the program's counts as of this step (the last step's are the
        # run's)
        prog.update(program.program.stats(), per_replay={
            names[i]: n for i, n in sorted(
                program.program.launches_per_replay().items())
            if i in names})
        if after_step is not None:
            after_step(step, program)
        if step == TRAIN_SYNC_STEP - 1:
            sync["catcher"] = warnings.catch_warnings(record=True)
            sync["log"] = sync["catcher"].__enter__()
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    try:
        state, losses = train_loop(
            cfg, steps=steps, batch_per_shard=batch, seq=seq, ckpt_dir=None,
            hp=hp, device="cuda", log_every=10 ** 9, on_step=on_step,
            seed=args.seed, graphs=graphs, float_inputs=float_inputs)
        torch.cuda.synchronize()
    finally:
        if "catcher" in sync:
            stop_sync(None)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    reserved = torch.cuda.max_memory_reserved() / 2 ** 30
    params = {n: p.detach().cpu() for n, p in state.params.items()}
    del state
    launches, walks = split_walks({k: c.launches
                                   for k, c in counters.items()})
    p50 = float(np.median([r["step_s"] for r in records[:TRAIN_STEPS]]))
    return dict(
        graphs=bool(graphs), steps=steps, batch=batch, seq=seq,
        hp=dict(TRAIN_HP), n_params=sum(p.numel() for p in params.values()),
        losses=losses, records=records, launches=launches, walks=walks,
        launches_per_step=per_step, wall_s=wall, step_p50_ms=p50 * 1e3,
        tokens_per_s=batch * seq / p50, peak_alloc_gib=peak,
        peak_reserved_gib=reserved, host_syncs=sync,
        captures=prog["captures"], recaptures=prog["recaptures"],
        replays=prog["replays"], capture_s=prog["capture_s"],
        launches_per_replay=prog["per_replay"], params=params)


def same_run(torch, a, b) -> dict:
    """Two runs' losses and final parameters: bit-equal, and the largest
    absolute differences."""
    dl = max(abs(x - y) for x, y in zip(a["losses"], b["losses"]))
    equal, dp = a["losses"] == b["losses"], 0.0
    for n, p in a["params"].items():
        q = b["params"][n]
        if not torch.equal(p, q):
            equal = False
            dp = max(dp, (p.float() - q.float()).abs().max().item())
    return dict(bit_equal=equal, loss_max_abs=dl, param_max_abs=dp)


def loss_fell(losses, steps: int = TRAIN_STEPS, window: int = 1) -> bool:
    """The mean of the losses of steps ``steps - window .. steps - 1``
    below the mean of the first ``window``."""
    return (sum(losses[steps - window:steps]) / window
            < sum(losses[:window]) / window)


def eager_and_graphs(torch, label, cfg, eager=None, fall=loss_fell, **kw):
    """``train_run`` eagerly (unless ``eager`` is that run, made by the
    caller), then replaying the captured step, from the same seed.  The
    graph run's losses and final parameters must equal the eager run's to
    the bit (the step's kernels and library ops use no atomics, so two
    runs of it agree on one card), and its launches of every step (the
    first, the capture's warm-up, and the replays) the eager step's, by
    kernel and walk.  Returns ``(eager, graph, check)``; the parameters
    are dropped."""
    if eager is None:
        eager = train_run(torch, label, cfg, graphs=False, **kw)
    graph = train_run(torch, label, cfg, graphs=True, **kw)
    check = same_run(torch, eager, graph)
    if not check["bit_equal"]:
        raise RuntimeError(f"[{label}] the graph run differs from the "
                           f"eager run: {check}")
    for r in (eager, graph):
        del r["params"]
    if graph["launches_per_step"] != eager["launches_per_step"]:
        raise RuntimeError(f"[{label}] launches per step, graphs "
                           f"{graph['launches_per_step']} != eager "
                           f"{eager['launches_per_step']}")
    for r in (eager, graph):
        if not all(math.isfinite(x["loss"]) and math.isfinite(x["grad_norm"])
                   for x in r["records"]):
            raise RuntimeError(f"[{label}] non-finite loss or grad norm: "
                               f"{r['records']}")
        if not fall(r["losses"]):
            raise RuntimeError(f"[{label}] loss did not fall: "
                               f"{r['losses']}")
    for name, count in graph["launches"].items():
        if count <= 0:
            raise RuntimeError(f"[{label}] kernel {name} was not launched "
                               f"while training")
    return eager, graph, check


def topology_step(program, timing):
    """One RigL-style topology step on layer 0's up projection: a fifth of
    its blocks moved to seeded free positions (constant block count),
    through ``train.step.evolve_sparse_layer`` (the optimizer's slots
    carried)."""
    import numpy as np

    from repro_torch.train.step import evolve_sparse_layer

    up = program.lm.layers[0].ffn.up
    rng = np.random.default_rng(TOPOLOGY_SEED)
    mask = up.pattern.copy()
    flat = mask.reshape(-1)
    on, off = np.flatnonzero(flat), np.flatnonzero(~flat)
    k = on.size // 5
    flat[rng.choice(on, k, replace=False)] = False
    flat[rng.choice(off, k, replace=False)] = True
    t0 = time.perf_counter()
    evolve_sparse_layer(program.state, "layers.0.ffn.up.values", up, mask)
    timing.update(moved=int(k), nnz=int(on.size),
                  evolve_s=time.perf_counter() - t0)


def print_train(label, t):
    """A train phase's lines: each run's loss, step p50, tokens/s, peak
    GiB, host syncs and launches; the graph's captures and launches per
    replay; graph against eager."""
    for r in (t["eager"], t):
        hs = r["host_syncs"]
        print(f"[{label}] {'graphs' if r['graphs'] else 'eager'}: "
              f"{TRAIN_STEPS} steps of batch {r['batch']} x seq {r['seq']}: "
              f"loss {r['losses'][0]:.4f} -> "
              f"{r['losses'][TRAIN_STEPS - 1]:.4f}; step p50 "
              f"{r['step_p50_ms']:.2f} ms = {r['tokens_per_s']:.0f} "
              f"tokens/s; peak {r['peak_alloc_gib']:.2f} GiB allocated, "
              f"{r['peak_reserved_gib']:.2f} GiB reserved; host syncs in "
              f"step {hs.get('step')} (batch upload, step, loss read): "
              f"{hs.get('count')} at {json.dumps(hs.get('at'))}; launches "
              f"{json.dumps(r['launches'])}; by walk "
              f"{json.dumps(r['walks'])}")
    print(f"[{label}] graphs: captures {t['captures']}, re-captures "
          f"{t['recaptures']}, replays {t['replays']}, capture "
          f"{t['capture_s']:.3f} s; launches per replay "
          f"{json.dumps(t['launches_per_replay'])}")
    c = t["check"]
    print(f"[{label}] graphs vs eager: {len(t['losses'])} losses and the "
          f"final parameters bit-equal {c['bit_equal']} (max abs: loss "
          f"{c['loss_max_abs']:.3g}, parameters {c['param_max_abs']:.3g})")


def train_phase(torch, args):
    """[train]: ``train_loop`` on full-width llama3.2-1b with every FFN
    block-sparse, eagerly and then replaying the captured step, each
    ``TRAIN_STEPS`` steps, then a topology step on layer 0's up
    projection (``topology_step``) and two more steps: the graph run must
    re-capture exactly once, and every step equal the eager run's.  The
    config rematerialises each layer (``remat="full"``, every config's
    default); ``REMAT_STEPS`` more eager steps at ``remat="none"`` must
    give the eager run's first losses and parameters to the bit (every
    kernel's sums are deterministic, so the recomputed forward is the
    forward), and both runs' peaks and step p50s are printed."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels import bs_attn, bsmm, dense_mm, sddmm

    cfg = configs.sparsify_ffn(configs.get("llama3_2_1b"), 1 / 8)
    assert cfg.dtype == "bfloat16" and cfg.ffn_block_size == 16
    assert cfg.remat == "full"
    counters = with_walks({"bsmm": bsmm.COUNTER, "sddmm": sddmm.COUNTER,
                           "dense_mm": dense_mm.COUNTER,
                           "bs_attn": bs_attn.COUNTER})
    topo, snap = {}, {}

    def topology(step, program):
        if step == REMAT_STEPS - 1 and not program.program.use_graph:
            snap.update({n: p.detach().cpu()
                         for n, p in program.state.params.items()})
        if step == TRAIN_STEPS - 1:
            topology_step(program, topo.setdefault(
                "graphs" if program.program.use_graph else "eager", {}))

    eager, graph, check = eager_and_graphs(
        torch, "train", cfg, counters=counters, args=args,
        steps=TRAIN_STEPS + TOPOLOGY_AFTER, batch=4, seq=512,
        after_step=topology)
    none = train_run(torch, "train", dataclasses.replace(cfg, remat="none"),
                     graphs=False, counters=counters, args=args,
                     steps=REMAT_STEPS, batch=4, seq=512)
    remat = same_run(torch, dict(losses=eager["losses"][:REMAT_STEPS],
                                 params=snap), none)
    del none["params"], snap
    remat.update(
        peak_gib={"full": eager["peak_alloc_gib"],
                  "none": none["peak_alloc_gib"]},
        step_p50_ms={"full": eager["step_p50_ms"],
                     "none": none["step_p50_ms"]},
        none_steps=REMAT_STEPS, none_losses=none["losses"],
        none_launches_per_step=none["launches_per_step"])
    if not remat["bit_equal"]:
        raise RuntimeError(f"[train] remat 'full' and 'none' differ over "
                           f"{REMAT_STEPS} steps: {remat}")
    for r in (eager, graph):
        check_tensor_core_walks("train", r["walks"],
                                ("bs_attn", "sddmm", "bsmm"))
    if (graph["captures"], graph["recaptures"]) != (2, 1):
        raise RuntimeError(f"[train] the topology step must re-capture the "
                           f"graph once: captures {graph['captures']}, "
                           f"re-captures {graph['recaptures']}")
    return dict(graph, eager=eager, check=check, topology=topo,
                remat=remat)


# [dryrun]: the predicted peak (arguments + the second call's transient
# peak on the meta device) against the card's (its arguments + what
# max_memory_allocated() rose to over them from a reset), relative; read
# 0.0000 for each of the three programs in two runs on an H100 (every
# allocation the tracker counts is one the caching allocator makes,
# rounded alike), so 1 % leaves room only for the allocator keeping a
# block's unsplit remainder
DRYRUN_PEAK_TOL = 0.01


def dryrun_programs(torch, cfg, device, args, hp):
    """``{name: (run, argument tensors)}`` of [dryrun]'s three programs
    on ``device`` ("meta" or "cuda"): the eager [train] step (4 x 512,
    ``make_train_step``), the [serve] prefill of one request at its
    bucket (the first served prompt's) and a decode step at batch 4
    over ``LLAMA_MAX_LEN`` slots.  Same shapes and dtypes on both."""
    import numpy as np

    from repro_torch.launch import dryrun
    from repro_torch.models.model import LM
    from repro_torch.train.step import init_train_state, make_train_step

    rng = np.random.default_rng(args.seed)

    def ints(shape, hi):
        t = torch.as_tensor(rng.integers(0, hi, size=shape).astype(np.int32))
        return t.to(device)
    progs = {}
    lm_t = LM(cfg, device=device, seed=args.seed)
    state = init_train_state(lm_t, hp=hp)
    step = make_train_step(lm_t, hp)
    batch = {"tokens": ints((4, 512), cfg.vocab_size),
             "targets": ints((4, 512), cfg.vocab_size)}
    progs["train"] = (lambda: step(state, batch)[1], dict(
        dryrun.state_tensors(lm_t, state),
        **{f"batch.{k}": v for k, v in batch.items()}))
    lm = LM(cfg, device=device, seed=args.seed)
    n = llama_prompt_lens(args)[0]
    bucket = llama_prefill_lens(args)[0]
    toks = ints((1, bucket), cfg.vocab_size)
    last = torch.tensor([n - 1], dtype=torch.int32, device=device)
    progs["prefill"] = (
        lambda: lm.prefill(toks, max_len=LLAMA_MAX_LEN, last_index=last),
        dict(dryrun.state_tensors(lm), tokens=toks, last_index=last))
    caches = lm.init_cache(4, LLAMA_MAX_LEN)
    dtok = ints((4, 1), cfg.vocab_size)
    pos = ints((4,), 64)
    progs["decode"] = (
        lambda: lm.decode_step(dtok, caches, pos)[0],
        dict(dryrun.state_tensors(lm), tokens=dtok, positions=pos,
             caches=caches))
    return progs, dict(bucket=bucket, prompt=n)


def dryrun_phase(torch, args):
    """[dryrun]: ``launch/dryrun.py``'s predictions on the meta device of
    three programs of this run, held against the card: the eager [train]
    step (llama3.2-1b, every FFN block-sparse at d = 1/8, bf16, batch 4 x
    512, one card, ``remat="full"``), the [serve] prefill of one request
    at its bucket and a decode step at batch 4.  Each program runs once
    (its plans built) and again, traced on meta and measured on the card
    from a reset of the peak once its arguments are resident.  Fails
    unless (a) the predicted argument bytes (parameters, optimizer state,
    the step's batch, caches) equal the card tensors' ``nbytes`` to the
    byte, (b) the predicted peak (arguments + the traced transient peak)
    is within ``DRYRUN_PEAK_TOL`` of the card's (arguments + what
    ``max_memory_allocated()`` rose to from the reset), and (c) every
    plan the card's call recorded has the route, backward routes and
    walk the meta plan of that problem has, and the kernels' launches by
    walk equal the meta branches' counts."""
    from repro_torch import configs
    from repro_torch.core import capture
    from repro_torch.launch import dryrun
    from repro_torch.train.step import TrainHParams

    t0 = time.perf_counter()
    cfg = configs.sparsify_ffn(configs.get("llama3_2_1b"), 1 / 8)
    assert cfg.remat == "full"
    hp = TrainHParams(**TRAIN_HP)
    meta_progs, at = dryrun_programs(torch, cfg, "meta", args, hp)
    pred = {}
    for name, (run, targs) in meta_progs.items():
        t1 = time.perf_counter()
        first = dryrun.trace(run, count_flops=True)
        again = dryrun.trace(run)
        pred[name] = dict(
            args=dryrun.tensor_bytes(targs, round_up=False),
            args_rounded=dryrun.tensor_bytes(targs),
            transient=again["peak_transient"], plans=again["plans"],
            walks={k: w["walks"] for k, w in again["kernels"].items()
                   if w["calls"]},
            flops=first["aten_flops"] + first["kernel_flops"],
            hbm_bytes=first["aten_bytes"] + first["kernel_bytes"],
            trace_s=time.perf_counter() - t1)
    del meta_progs
    counters = with_walks(kernel_counters())
    gc.collect()
    torch.cuda.empty_cache()
    progs, _ = dryrun_programs(torch, cfg, "cuda", args, hp)
    out = dict(bucket=at["bucket"], prompt=at["prompt"], programs={})
    for name, (run, targs) in progs.items():
        p = pred[name]
        run()
        torch.cuda.synchronize()
        gc.collect()
        real_args = dryrun.tensor_bytes(targs, round_up=False)
        real_rounded = dryrun.tensor_bytes(targs)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        for c in counters.values():
            c.reset()
        with capture.recording() as rec:
            res = run()
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        del res
        _, walks = split_walks({k: c.launches for k, c in counters.items()})
        walks = {k: v for k, v in walks.items() if any(v.values())}
        walks = {k: {w: n for w, n in v.items() if n} for k, v in
                 walks.items()}
        card_plans = {q["problem"]: q for q in (
            dryrun.plan_summary(x) for x in rec.held.values()
            if type(x).__name__ == "MatmulPlan")}
        meta_plans = {q["problem"]: q for q in p["plans"]}
        strip = ("source",)
        plan_diff = {k: (q, meta_plans.get(k)) for k, q in card_plans.items()
                     if {a: b for a, b in q.items() if a not in strip}
                     != {a: b for a, b in (meta_plans.get(k) or {}).items()
                         if a not in strip}}
        predicted = p["args_rounded"] + p["transient"]
        measured = real_rounded + (peak - base)
        o = dict(args_predicted=p["args"], args_card=real_args,
                 transient_predicted=p["transient"],
                 transient_card=peak - base, other_resident=base
                 - real_rounded, peak_predicted=predicted,
                 peak_card=measured, peak_rel=abs(predicted - measured)
                 / measured, walks_predicted=p["walks"], walks_card=walks,
                 plans_card=len(card_plans), plans_meta=len(meta_plans),
                 plan_diff=plan_diff, flops_predicted=p["flops"],
                 hbm_bytes_predicted=p["hbm_bytes"], trace_s=p["trace_s"])
        out["programs"][name] = o
        if o["args_predicted"] != o["args_card"]:
            raise RuntimeError(f"[dryrun] {name}: predicted argument bytes "
                               f"{o['args_predicted']} != the card's "
                               f"{o['args_card']}")
        if not o["peak_rel"] <= DRYRUN_PEAK_TOL:
            raise RuntimeError(f"[dryrun] {name}: predicted peak "
                               f"{predicted} B vs the card's {measured} B "
                               f"({o['peak_rel']:.3f} > {DRYRUN_PEAK_TOL}): "
                               f"{o}")
        if plan_diff or not card_plans or walks != p["walks"]:
            raise RuntimeError(f"[dryrun] {name}: routes or walks differ: "
                               f"plans {plan_diff} (card {len(card_plans)}, "
                               f"meta {len(meta_plans)}), launches by walk "
                               f"card {walks} vs meta {p['walks']}")
    del progs
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    return out


def print_dryrun(d):
    for name, o in d["programs"].items():
        gib = 2 ** 30
        print(f"[dryrun] {name}: arguments predicted {o['args_predicted']} "
              f"B, card {o['args_card']} B (equal "
              f"{o['args_predicted'] == o['args_card']}); peak predicted "
              f"{o['peak_predicted'] / gib:.3f} GiB (transient "
              f"{o['transient_predicted'] / gib:.3f}), card "
              f"{o['peak_card'] / gib:.3f} GiB (transient "
              f"{o['transient_card'] / gib:.3f}; other resident "
              f"{o['other_resident'] / gib:.3f}), rel "
              f"{o['peak_rel']:.4f} (budget {DRYRUN_PEAK_TOL}); plans "
              f"card {o['plans_card']} / meta {o['plans_meta']}, routes "
              f"and walks equal {not o['plan_diff']}; launches by walk "
              f"{json.dumps(o['walks_card'])}; predicted "
              f"{o['flops_predicted']:.4g} FLOP, "
              f"{o['hbm_bytes_predicted']:.4g} B HBM; traced in "
              f"{o['trace_s']:.2f} s")
    print(f"[dryrun] prefill at bucket {d['bucket']} (prompt "
          f"{d['prompt']}); phase {d['phase_s']:.1f} s")


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
        logit_checks=st["logits"]["checks"], graphs=graphs,
        plans=served_plans(eng), models=served_models(eng),
        roofline_totals=eng.plan_report()["roofline"]["totals"]), lm


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
    tensors: SDPA where there is no soft-cap (causal, or with the causal
    window and global prefix as a boolean mask), else compiled
    ``flex_attention`` with the soft-cap as its score modification and
    the causal window as its mask.  Timed beside the kernel, never
    called by the port."""
    import torch.nn.functional as F

    if softcap is None and window == 0:
        def sdpa(q_, k_, v_):
            return F.scaled_dot_product_attention(
                q_.transpose(1, 2), k_.transpose(1, 2), v_.transpose(1, 2),
                is_causal=True, scale=scale, enable_gqa=True
            ).transpose(1, 2)
        return sdpa, "sdpa"
    if softcap is None:
        # a causal window (and global prefix) without a soft-cap: SDPA
        # with the same mask as a boolean attention mask
        idx = torch.arange(s, device=device)
        d = idx[:, None] - idx[None, :]
        allowed = (d >= 0) & ((d < window) | (idx[None, :] < global_prefix))

        def sdpa_masked(q_, k_, v_):
            return F.scaled_dot_product_attention(
                q_.transpose(1, 2), k_.transpose(1, 2), v_.transpose(1, 2),
                attn_mask=allowed, scale=scale, enable_gqa=True
            ).transpose(1, 2)
        return sdpa_masked, "sdpa"
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
    mask) at gemma2-2b's global and local layers, llama3.2-1b's,
    qwen3-moe's, deepseek-v2-lite's MLA (dh 192, served and trained),
    qwen2-1.5b's and glm4-9b's (GQA groups 6 and 16), at an odd S
    whose tiles halve to 1, and at seamless-m4t-medium's and
    internvl2-1b's main-path shapes (``encdec_attn_rows``); bf16 and
    fp32.  The bound counts
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
            + qwen3_attn_shapes(args) + deepseek_attn_shapes(args)
            + dense_attn_shapes(args)):
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
            if dh == 192:
                # MLA's v: 128 wide, zero-padded to the q.k head dim
                v[..., 128:] = 0
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
    rows += encdec_attn_rows(torch, args, gen)
    rows += long_attn_rows(torch, args, gen)
    bad = [r for r in rows if not r["rel_err"] <= r["tol"]]
    if bad:
        raise RuntimeError(f"bs_attn disagrees with its plain version: "
                           f"{bad}")
    bad = [r for r in rows if not r["library_rel_err"] <= r["tol"]]
    if bad:
        raise RuntimeError(f"the library call computes another function "
                           f"than the plain version: {bad}")
    return rows


def encdec_attn_shapes():
    """[attn] rows at every shape bs_attn runs on the main paths of
    seamless-m4t-medium (16 heads of 64, MHA) and internvl2-1b (14 over
    2 kv heads of 64), batch 4, at the configs' tiles (512, halved until
    they divide the sequence, as ``attend_train`` takes them): the
    encoder's T x T over the 1024 frames, the decoder's causal
    self-attention and its cross attention over the frames at
    [serve-seamless]'s padded prefill length, at decode (one query row)
    and at [train-seamless]'s sequence, and [vlm-internvl2]'s causal
    prefill over the patch rows and the prompt.  Each row: name, the
    path whose launches it reads, config, B, S, Skv, causal."""
    from repro_torch import configs
    sm, vl = configs.get(SEAMLESS), configs.get(INTERNVL2)
    t, s, ts = sm.frontend_len, max(SEAMLESS_PROMPTS), SEAMLESS_TRAIN_SEQ
    sv = vl.frontend_len + VLM_PROMPT
    return (("seamless encoder", "serve_seamless", sm, 4, t, t, False),
            ("seamless serve self", "serve_seamless", sm, 4, s, s, True),
            ("seamless cross prefill", "serve_seamless", sm, 4, s, t, False),
            ("seamless cross decode", "serve_seamless", sm, 4, 1, t, False),
            ("seamless train self", "train_seamless", sm,
             SEAMLESS_TRAIN_BATCH, ts, ts, True),
            ("seamless train cross", "train_seamless", sm,
             SEAMLESS_TRAIN_BATCH, ts, t, False),
            ("internvl2 vlm prefill", "vlm_internvl2", vl, VLM_BATCH, sv, sv,
             True))


def encdec_attn_rows(torch, args, gen):
    """bs_attn against its plain version at ``encdec_attn_shapes`` (the
    walk ``attend_train`` builds there, causal or not, S queries over Skv
    keys), bf16 and fp32, each beside one SDPA call; the bound counts
    the B x visible element pairs a head."""
    import torch.nn.functional as F

    from repro_torch.kernels.bs_attn import ops as bs_ops
    from repro_torch.kernels.bs_attn.ref import attend_plain
    from repro_torch.models import attention

    dev = torch.device("cuda", 0)
    rows = []
    for name, path, cfg, b_, s, skv, causal in encdec_attn_shapes():
        h, kvh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        spec = attention.attn_spec(s, skv, dh, causal=causal,
                                   tile_q=cfg.attn_tile_q,
                                   tile_kv=cfg.attn_tile_kv)
        scale = spec.scale
        walk = spec.walk(dev)
        el = spec.element_mask(dev)
        pairs = b_ * int(el.sum().item())

        def sdpa(q_, k_, v_):
            return F.scaled_dot_product_attention(
                q_.transpose(1, 2), k_.transpose(1, 2), v_.transpose(1, 2),
                is_causal=causal, scale=scale,
                enable_gqa=h != kvh).transpose(1, 2)

        for dname, dt in (("bfloat16", torch.bfloat16),
                          ("float32", torch.float32)):
            es = torch.empty((), dtype=dt).element_size()
            q = torch.randn((b_, s, h, dh), generator=gen, device=dev).to(dt)
            k = torch.randn((b_, skv, kvh, dh), generator=gen,
                            device=dev).to(dt)
            v = torch.randn((b_, skv, kvh, dh), generator=gen,
                            device=dev).to(dt)
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * es
            sets = copies(lambda: (q.clone(), k.clone(), v.clone()), nbytes)

            def kernel(q_, k_, v_, plan=None):
                return bs_ops.bs_attn_cuda(q_, k_, v_, walk, scale=scale,
                                           causal=causal, plan=plan)

            def plain(q_, k_, v_):
                return attend_plain(q_, k_, v_, el, scale=scale)
            lib_err = rel_err(sdpa(q, k, v), plain(q, k, v))[0]
            row = measured_row(torch, "bs_attn", name, s, dname, kernel,
                               plain, sdpa, sets, sets, nbytes,
                               4.0 * pairs * dh * h)
            row["walk"] = bs_ops.kernel_walk(dt)
            row["before_ms"] = (timed_ms(
                torch, lambda *a: kernel(*a, plan="cuda_core"), sets, 4)
                if dt != torch.float32 else None)
            row.update(heads=h, kv_heads=kvh, head_dim=dh, window=0,
                       softcap=None, tile=spec.tile_q, library="sdpa",
                       library_rel_err=lib_err, causal=causal, batch=b_,
                       skv=skv, path=path,
                       tiles_visited=int(spec.block_mask().sum()),
                       element_pairs=pairs, group=walk.group)
            rows.append(row)
            del sets, q, k, v
        del el, walk
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
        graphs=graphs, plans=served_plans(eng), models=served_models(eng),
        roofline_totals=eng.plan_report()["roofline"]["totals"]), lm, eng


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
    from repro_torch.analysis import calibrate
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
            pu = sparse.plan(bsr, n, device=dev,
                             ctx=sparse.PlanContext(mode="static"))
            usets = [(a_, t_[:-1].contiguous()) for a_, t_ in sets]
            row["uniform_bsmm_ms"] = timed_ms(
                torch, lambda a_, t_: pu.run_packed(t_, a_), usets, 30)
            # a corpus record: the two walks on this skew, with the raw
            # model's inputs (the calibration's skewed observations)
            row["corpus"] = calibrate.corpus_record(
                calibrate.static_model_inputs(bsr.row_idx, bsr.col_idx, m,
                                              k, n, b, dname),
                {"static_cuda": row["uniform_bsmm_ms"] / 1e3,
                 "static_balanced_cuda": row["ms"] / 1e3})
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


TABLE3_CELLS = tuple((dname, b) for dname in ("float16", "float32")
                     for b in (1, 4, 16))


def table3_operand(torch, dev, dname, b, seed):
    """Table 3's operand at block ``b`` (m = k = 4096, d = 1/16, the
    ``[table3]`` phase's mask) with seeded values, and its N = 4096
    activations."""
    from repro_torch.core import masks
    from repro_torch.core.bsr import BlockSparseMatrix
    m = k = n = 4096
    dt = getattr(torch, dname)
    mask = masks.random_block_mask(m, k, b, 1 / 16, seed=seed + 3)
    gen = torch.Generator(device=dev).manual_seed(seed + 29)
    vals = (torch.randn((int(mask.sum()), b, b), generator=gen, device=dev)
            / math.sqrt(k / 16)).to(dt)
    x = torch.randn((n, k), generator=gen, device=dev).to(dt)
    return BlockSparseMatrix.from_mask(mask, b, values=vals), x


def race_phase(torch, args):
    """[race]: the plan layer's measured route race at each Table 3 cell
    (m = k = N = 4096, d = 1/16, b in {1, 4, 16}, fp16 and fp32): every
    admissible candidate timed on the card (``PlanContext(measure=True,
    cache_dir=...)``, forward verdicts), the winner, and the analytic
    verdict (the H100 model's) with the measured ms of the route it
    picked.  Then a restart (``sparse.reset()`` and the cache module's
    reset) plans every cell again from the same directory: it must make
    zero decisions and zero measurements, read every verdict from disk
    and pick the same routes."""
    import shutil

    from repro_torch import sparse
    from repro_torch.analysis import calibrate
    from repro_torch.sparse import cache as cache_lib

    dev = torch.device("cuda", 0)
    cache_dir = os.path.join(HERE, "build", f"race-cache-{os.getpid()}")
    shutil.rmtree(cache_dir, ignore_errors=True)
    measure = sparse.PlanContext(measure=True, cache_dir=cache_dir,
                                 differentiable=False)
    analytic = sparse.PlanContext(differentiable=False)
    sparse.reset()
    cells = []
    for dname, b in TABLE3_CELLS:
        bsr, x = table3_operand(torch, dev, dname, b, args.seed)
        t0 = time.perf_counter()
        p = sparse.plan(bsr, x.shape[0], x=x, device=dev, ctx=measure)
        race_s = time.perf_counter() - t0
        a = sparse.plan(bsr, x.shape[0], device=dev, ctx=analytic)
        if p.source != "measured" or a.source != "analytic":
            raise RuntimeError(f"[race] b={b} {dname}: sources "
                               f"{p.source} / {a.source}")
        ms = {r: v * 1e3 for r, v in p.est_seconds.items()}
        fastest = min(ms, key=ms.get)
        cells.append(dict(
            b=b, dtype=dname, winner=p.route, winner_ms=ms[p.route],
            fastest=fastest, fastest_ms=ms[fastest],
            measured_ms=ms, analytic=a.route,
            analytic_est_ms={r: v * 1e3 for r, v in a.est_seconds.items()},
            analytic_pick_measured_ms=ms[a.route],
            agree=a.route == p.route, race_s=race_s, key=p.key,
            corpus=calibrate.corpus_record(calibrate.plan_model_inputs(p),
                                           p.est_seconds)))
        del bsr, x, p, a
        torch.cuda.empty_cache()
    first = sparse.cache_stats()
    # a fresh process: no plan, decision or loaded file in memory
    sparse.reset()
    cache_lib.reset()
    for cell in cells:
        bsr, x = table3_operand(torch, dev, cell["dtype"], cell["b"],
                                args.seed)
        q = sparse.plan(bsr, x.shape[0], x=x, device=dev, ctx=measure)
        cell["restart"] = dict(route=q.route, from_disk=q.from_disk,
                               source=q.source)
        del bsr, x, q
    again = sparse.cache_stats()
    shutil.rmtree(cache_dir, ignore_errors=True)
    # the dynamic kind at the [dynamic] phase's shapes (llama3.2-1b's FFN,
    # d_max 1/8, b 16, bf16, N 2048): the three dynamic walks and the
    # dense route (a densify, then dense_mm), raced on the card
    from repro_torch.core.sparse_layers import DynamicSparseLinear
    dynamic = []
    gen = torch.Generator(device=dev).manual_seed(args.seed + 29)
    for name, d_in, d_out in (("up/gate", 2048, 8192),
                              ("down", 8192, 2048)):
        layer = DynamicSparseLinear(d_in, d_out, 16, 1 / 8,
                                    dtype=torch.bfloat16, device=dev)
        layer.reset_parameters(gen, mask_seed=args.seed + 100)
        x = torch.randn((2048, d_in), generator=gen,
                        device=dev).to(torch.bfloat16)
        op = layer.encode()
        p = sparse.plan(op, 2048, x=x, device=dev,
                        ctx=sparse.PlanContext(measure=True))
        a = sparse.plan(op, 2048, device=dev)
        if p.source != "measured" or a.source != "analytic":
            raise RuntimeError(f"[race] dynamic {name}: sources "
                               f"{p.source} / {a.source}")
        ms = {r: v * 1e3 for r, v in p.est_seconds.items()}
        dynamic.append(dict(
            shape=f"{name} {d_out}x{d_in}", n=2048, winner=p.route,
            fastest=min(ms, key=ms.get), measured_ms=ms, analytic=a.route,
            analytic_est_ms={r: v * 1e3 for r, v in a.est_seconds.items()},
            analytic_pick_measured_ms=ms[a.route],
            corpus=calibrate.corpus_record(calibrate.plan_model_inputs(p),
                                           p.est_seconds)))
        del layer, x, op, p, a
    bad = [c for c in cells if not (c["restart"]["from_disk"]
                                    and c["restart"]["route"] == c["winner"]
                                    and c["restart"]["source"] == "measured")]
    if bad or again["decisions"] or again["measurements"] \
            or again["disk_hits"] != len(cells):
        raise RuntimeError(f"[race] the restart did not replay every "
                           f"verdict from disk: {again}, {bad}")
    # the backward race at llama's FFN training shapes (N = batch 4 x seq
    # 512, bf16): dL/dx over the transposed problem, dL/dvalues the sddmm
    # against the dense product and a gather; measured and analytic
    from repro_torch.core import masks
    from repro_torch.core.bsr import BlockSparseMatrix
    grads = []
    gen = torch.Generator(device=dev).manual_seed(args.seed + 31)
    for name, m, k in (("up/gate", 8192, 2048), ("down", 2048, 8192)):
        mask = masks.random_block_mask(m, k, 16, 1 / 8, seed=args.seed + 1)
        vals = torch.randn((int(mask.sum()), 16, 16), generator=gen,
                           device=dev).to(torch.bfloat16)
        bsr = BlockSparseMatrix.from_mask(mask, 16, values=vals)
        x = torch.randn((2048, k), generator=gen,
                        device=dev).to(torch.bfloat16)
        meas = sparse.plan(bsr, 2048, x=x, device=dev,
                           ctx=sparse.PlanContext(measure=True))
        ana = sparse.plan(bsr, 2048, device=dev)
        row = dict(shape=f"{name} {m}x{k}", n=2048,
                   forward=dict(measured=meas.route, analytic=ana.route))
        inputs = calibrate.grad_model_inputs(meas)
        for side in ("dx", "dvalues"):
            gm, ga = meas.artifacts["grad"][side], ana.artifacts["grad"][side]
            row[side] = dict(
                measured=gm["route"], analytic=ga["route"],
                measured_ms={r: v * 1e3 for r, v in gm["est_seconds"].items()},
                model_ms={r: v * 1e3 for r, v in ga["est_seconds"].items()},
                corpus=calibrate.corpus_record(inputs[side],
                                               gm["est_seconds"]))
        grads.append(row)
        del bsr, x, meas, ana
    sparse.reset()                # the race's plans, not the next phases'
    return dict(cells=cells, first=first, restart=again, grads=grads,
                dynamic=dynamic)


def race_serve_phase(torch, lm, args):
    """[race] serving: llama3.2-1b through ``Engine(plan_cache_dir=...)``
    (graphs captured at startup): the seeded requests, then
    ``remeasure_plan`` on every analytic plan of its pool (the
    re-planner's body), a second engine in the same process (it adopts
    the measured routes), then a fresh process state (``sparse.reset()``
    and the cache module's reset) and a third engine from the directory:
    its startup must make zero decisions, its plans come from disk with
    the static ones ``measured``, and its tokens equal the second
    engine's (the same routes).  The first engine's tokens are held to
    them too where the measured routes are the analytic ones."""
    import shutil

    import numpy as np

    from repro_torch import sparse
    from repro_torch.analysis import calibrate
    from repro_torch.serve import Engine, Request
    from repro_torch.sparse import cache as cache_lib

    cache_dir = os.path.join(HERE, "build", f"serve-cache-{os.getpid()}")
    shutil.rmtree(cache_dir, ignore_errors=True)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, lm.cfg.vocab_size,
                            size=int(rng.integers(lo, hi + 1)))
               for lo, hi in LLAMA_PROMPTS]
    kw = dict(batch=4, max_len=LLAMA_MAX_LEN, device="cuda",
              warm_compile=True, plan_cache_dir=cache_dir)

    def serve(eng):
        reqs = [Request(uid=i, prompt=p, max_new_tokens=LLAMA_NEW)
                for i, p in enumerate(prompts)]
        eng.run(reqs)
        torch.cuda.synchronize()
        return [r.output for r in reqs]

    sparse.reset()
    first = Engine(lm, **kw)
    tokens1 = serve(first)
    routes1 = served_plans(first)
    t0 = time.perf_counter()
    upgrades = []
    for p in sparse.analytic_plans(first.pool):
        inputs, model = calibrate.plan_model_inputs(p), dict(p.est_seconds)
        u = sparse.remeasure_plan(p)
        u.update(plan=f"{p.m}x{p.k} n={p.n}", model=model,
                 corpus=calibrate.corpus_record(inputs, u["measured"]))
        upgrades.append(u)
    remeasure_s = time.perf_counter() - t0
    del first
    second = Engine(lm, **kw)
    tokens2 = serve(second)
    routes2 = served_plans(second)
    del second
    sparse.reset()
    cache_lib.reset()
    third = Engine(lm, **kw)
    tokens3 = serve(third)
    rep = third.plan_report()
    per = rep["plans"]["per_plan"]
    static = [r for r in per.values() if r["kind"] == "static"]
    shutil.rmtree(cache_dir, ignore_errors=True)
    out = dict(
        upgrades=[{k: u[k] for k in ("plan", "route_before", "route_after")}
                  | {"measured_ms": {r: v * 1e3
                                     for r, v in u["measured"].items()},
                     "model_ms": {r: v * 1e3
                                  for r, v in u["model"].items()},
                     "corpus": u["corpus"]}
                  for u in upgrades],
        remeasure_s=remeasure_s, routes_analytic=routes1,
        routes_measured=routes2, restart_startup=rep["startup"],
        restart_from_disk=sum(r["from_disk"] for r in per.values()),
        restart_plans=len(per),
        tokens_equal_restart=tokens3 == tokens2,
        tokens_equal_first=tokens3 == tokens1,
        routes_changed=routes1 != routes2)
    if not upgrades:
        raise RuntimeError("[race] no analytic plan in the engine's pool")
    if rep["startup"]["decisions"] or not static or not all(
            r["from_disk"] and r["source"] == "measured" for r in static) \
            or out["restart_from_disk"] != len(per):
        raise RuntimeError(f"[race] the restarted engine did not replay "
                           f"its plans from disk: {rep['startup']}, {per}")
    if not out["tokens_equal_restart"] or (
            not out["routes_changed"] and not out["tokens_equal_first"]):
        raise RuntimeError(f"[race] the restarted engine's tokens differ: "
                           f"{out}")
    del third
    sparse.reset()
    gc.collect()              # the engines hold the model in cycles
    return out


# route family -> the kernel its forward launches (the grouped dynamic
# routes walk their packed tiles with dsmm)
ROUTE_KERNEL = {"static": "bsmm", "static_balanced": "bsmm_balanced",
                "dense": "dense_mm", "dynamic": "dsmm",
                "dynamic_grouped": "dsmm", "dynamic_grouped_balanced": "dsmm"}
# [replan]: the wrong calibration that makes "auto" capture llama's FFN
# plans off static_cuda (its raw model priced at 4x)
REPLAN_WRONG_SCALE = {"static_cuda": 4.0}


def kernel_counters():
    """The seven kernels' launch counters (totals), by kernel."""
    from repro_torch.kernels import bs_attn, bsmm, dense_mm, dsmm, gmm, sddmm
    return {"bsmm": bsmm.COUNTER, "bsmm_balanced": bsmm.BALANCED_COUNTER,
            "dense_mm": dense_mm.COUNTER, "dsmm": dsmm.COUNTER,
            "gmm": gmm.COUNTER, "sddmm": sddmm.COUNTER,
            "bs_attn": bs_attn.COUNTER}


def counter_names():
    """Launch counter index (``kernels._build.COUNTERS``) -> kernel name,
    for the seven kernels' totals (their walk counters are left out)."""
    return counter_index_names(kernel_counters())


def replay_launches(eng, names):
    """Each program's kernel launches per replay, by kernel."""
    return {p.name: {names[i]: n
                     for i, n in sorted(p.launches_per_replay().items())
                     if i in names}
            for p in eng.programs()}


def static_routes(served):
    """``served_plans``' static entries: plan -> route."""
    return {k: v.split(" ")[0] for k, v in served.items() if " n=" in k}


def program_tokens(name: str, batch: int) -> int:
    """The token count a program's plans are built for: the decode
    batch, or the prefill's bucket."""
    return batch if name == "decode" else int(name.split("[")[1][:-1])


def capture_stream_memory(torch, captures: int = 4) -> dict:
    """MiB still allocated per capture after ``captures`` CUDA graphs of
    a bf16 ``torch.matmul`` (a cuBLAS GEMM) are made and dropped, by the
    streams their warm-up and capture run on: a fresh side stream for
    the warm-up and PyTorch's default capture stream (how programs
    captured before an engine owned a stream), one fresh stream each, or
    one stream for all (what an engine does).  cuBLAS keeps a workspace
    per stream for the life of the process, so this says which stream
    held them.  Run last: what it pins stays."""
    a = torch.randn(64, 2048, device="cuda", dtype=torch.bfloat16)
    w = torch.randn(2048, 2048, device="cuda", dtype=torch.bfloat16)
    torch.matmul(a, w)
    one = torch.cuda.Stream()
    streams = {"side_then_default": lambda: (torch.cuda.Stream(), None),
               "fresh_stream": lambda: (torch.cuda.Stream(),) * 2,
               "one_stream": lambda: (one, one)}
    rows = {}
    for name in ("one_stream", "side_then_default", "fresh_stream"):
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        keep = []
        for _ in range(captures):
            warm, cap = streams[name]()
            cur = torch.cuda.current_stream()
            warm.wait_stream(cur)
            with torch.cuda.stream(warm):
                torch.matmul(a, w)
            cur.wait_stream(warm)
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, stream=cap):
                out = torch.matmul(a, w)
            keep.append((g, out))
        torch.cuda.synchronize()
        del keep, g, out
        gc.collect()
        torch.cuda.synchronize()
        rows[name] = (torch.cuda.memory_allocated() - base) / captures \
            / 2 ** 20
    return rows


def replan_phase(torch, lm, args):
    """[replan]: the engine's re-planner on llama3.2-1b's graphs.  Under a
    deliberately wrong calibration (``REPLAN_WRONG_SCALE``: static_cuda's
    raw model x4, installed with ``dispatch.set_cost_coeffs``) "auto"
    captures the FFN plans on other routes; the engine serves the seeded
    requests, ``replan_once()`` times every analytic plan of its pool on
    the card and the requests are served again: every program whose
    plans changed route must have been re-captured, its launches per
    replay moved to the measured routes' kernels, every served static
    plan's route be the measured verdict, and the tokens equal a second
    engine built on those verdicts.  Then a third engine serves with
    ``replanner=True`` (the thread sweeping while requests are served)
    until its pool holds no analytic plan, and ``stop_replanner()``
    joins it.  The p99 decode step with and without a sweep running is
    printed.  The active calibration is restored after the phase."""
    import numpy as np

    from repro_torch import sparse
    from repro_torch.core import dispatch
    from repro_torch.serve import Engine

    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, lm.cfg.vocab_size,
                            size=int(rng.integers(lo, hi + 1)))
               for lo, hi in LLAMA_PROMPTS]
    kw = dict(batch=4, max_len=LLAMA_MAX_LEN, device="cuda",
              warm_compile=True)
    names = counter_names()
    prev = dispatch.cost_coeffs()
    wrong = dispatch.CostCoeffs(
        route_scale=dict(REPLAN_WRONG_SCALE), version=1,
        digest=dispatch.coeffs_digest(
            {r: {"scale": v} for r, v in REPLAN_WRONG_SCALE.items()},
            dispatch.SKEW_KNEES, 1))
    dispatch.set_cost_coeffs(wrong)
    sparse.reset()
    try:
        eng = Engine(lm, **kw)
        routes_before = served_plans(eng)
        launches_before = replay_launches(eng, names)
        g0 = eng.stats()["graphs"]
        first = serve_run(torch, eng, prompts, LLAMA_NEW)
        t0 = time.perf_counter()
        upgrades = eng.replan_once()
        sweep_s = time.perf_counter() - t0
        stale = sorted(p.name for p in eng.programs() if p.stale)
        replays = {p.name: p.replays for p in eng.programs()}
        second = serve_run(torch, eng, prompts, LLAMA_NEW)
        st = eng.stats()
        recaptured = sorted(p.name for p in eng.programs() if p.recaptures)
        replayed = {p.name for p in eng.programs()
                    if p.replays > replays[p.name]}
        still_stale = sorted(p.name for p in eng.programs()
                             if p.stale and p.name in replayed)
        routes_after = served_plans(eng)
        launches_after = replay_launches(eng, names)
        static = [p for p in sparse.pool_plans(eng.pool)
                  if p.kind == "static"]
        fresh = Engine(lm, **kw)
        check = serve_run(torch, fresh, prompts, LLAMA_NEW)
        routes_fresh = served_plans(fresh)
        out = dict(
            upgrades=upgrades, sweep_s=sweep_s, stale=stale,
            recaptured=recaptured, routes_before=routes_before,
            routes_after=routes_after, routes_fresh=routes_fresh,
            recaptures=st["replanner"]["recaptures"],
            recapture_s=st["graphs"]["capture_s"] - g0["capture_s"],
            startup_capture_s=g0["capture_s"],
            captures=st["graphs"]["captures"] - g0["captures"],
            launches_per_replay_before=launches_before,
            launches_per_replay_after=launches_after,
            decode_p99_ms_no_sweep=first["stats"]["step_latency"]["p99_ms"],
            decode_p50_ms_no_sweep=first["stats"]["step_latency"]["p50_ms"],
            tokens_equal_fresh=[r.output for r in second["reqs"]]
            == [r.output for r in check["reqs"]])
        if not recaptured or not set(recaptured) <= set(stale) \
                or still_stale:
            raise RuntimeError(f"[replan] the programs whose routes changed "
                               f"were not re-captured before their next "
                               f"replay ({still_stale} still stale): {out}")
        after_s, fresh_s = (static_routes(routes_after),
                            static_routes(routes_fresh))
        bad = [p.key for p in static if p.source != "measured"]
        if bad or any(fresh_s.get(k) != v for k, v in after_s.items()):
            raise RuntimeError(f"[replan] served routes are not the "
                               f"measured verdicts: {bad}, {out}")
        before_s = static_routes(routes_before)
        for name in recaptured:
            before, after = launches_before[name], launches_after[name]
            n = program_tokens(name, kw["batch"])
            moved = {ROUTE_KERNEL[dispatch.family(r)]
                     for k, r in after_s.items()
                     if k.endswith(f" n={n}") and before_s.get(k) != r}
            if before == after or any(after.get(kn, 0) <= before.get(kn, 0)
                                      for kn in moved):
                raise RuntimeError(f"[replan] {name}'s launches per replay "
                                   f"did not move to the new routes' "
                                   f"kernels: {before} -> {after}")
        if not out["tokens_equal_fresh"]:
            raise RuntimeError(f"[replan] tokens differ from an engine on "
                               f"the measured verdicts: {out}")
        del eng, fresh

        # the thread: serve rounds of the requests while it sweeps
        sparse.reset()
        eng = Engine(lm, replanner=True, **kw)
        rounds, t0 = 0, time.perf_counter()
        while sparse.analytic_plans(eng.pool) \
                or not eng.stats()["replanner"]["sweeps"]:
            serve_run(torch, eng, prompts, LLAMA_NEW)
            rounds += 1
            if time.perf_counter() - t0 > 300:
                raise RuntimeError("[replan] the thread did not finish a "
                                   "sweep in 300 s")
        during = eng.stats()
        last = serve_run(torch, eng, prompts, LLAMA_NEW)
        eng.stop_replanner()
        st = eng.stats()
        out["thread"] = dict(
            rounds=rounds, seconds=time.perf_counter() - t0,
            sweeps=st["replanner"]["sweeps"],
            upgrades=st["replanner"]["upgrades"],
            recaptures=st["replanner"]["recaptures"],
            running_after_stop=st["replanner"]["running"],
            analytic_left=len(sparse.analytic_plans(eng.pool)),
            decode_p99_ms_sweeping=during["step_latency"]["p99_ms"],
            decode_p50_ms_sweeping=during["step_latency"]["p50_ms"],
            decode_steps_sweeping=during["steps"],
            tokens_equal_fresh=[r.output for r in last["reqs"]]
            == [r.output for r in check["reqs"]])
        if out["thread"]["analytic_left"] or st["replanner"]["running"]:
            raise RuntimeError(f"[replan] the thread left analytic plans "
                               f"or kept running: {out['thread']}")
        del eng
    finally:
        dispatch.set_cost_coeffs(prev)
        sparse.reset()
    return out


def roofline_phase(torch, args, rows, serve, gemma):
    """[roofline]: ``sparse.roofline_report()`` totals of the llama and
    gemma2 engines, each served static plan's chosen route on the H100's
    roofline (efficiency, headroom, the dominant term, flagged), and the
    bound a plan gives bsmm up/gate 8192x2048 at N 2048 in bf16 (the
    ``[kernel]`` row's pattern), which must equal that row's
    ``bound_ms`` within 1 %."""
    from repro_torch import sparse
    from repro_torch.core import masks
    from repro_torch.core.bsr import BlockSparseMatrix

    dev = torch.device("cuda", 0)
    mask = masks.random_block_mask(8192, 2048, 16, 1 / 8,
                                   seed=args.seed + 1)
    bsr = BlockSparseMatrix.from_mask(mask, 16, values=torch.zeros(
        (int(mask.sum()), 16, 16), dtype=torch.bfloat16, device=dev))
    p = sparse.plan(bsr, 2048, device=dev, ctx=sparse.PlanContext(
        cache=False, differentiable=False))
    plan_ms = p.roofline()["routes"]["static_cuda"]["bound_us"] / 1e3
    row = next(r for r in rows if r["kernel"] == "bsmm"
               and r["shape"] == "up/gate 8192x2048" and r["n"] == 2048
               and r["dtype"] == "bfloat16")
    out = dict(bsmm_bound_plan_ms=plan_ms,
               bsmm_bound_kernel_row_ms=row["bound_ms"],
               bsmm_bound_rel=abs(plan_ms - row["bound_ms"])
               / row["bound_ms"],
               llama=dict(totals=serve["roofline_totals"],
                          plans={m["plan"]: dict(route=m["route"],
                                                 **m["roofline"])
                                 for m in serve["models"]}),
               gemma2=dict(totals=gemma["roofline_totals"],
                           plans={m["plan"]: dict(route=m["route"],
                                                  **m["roofline"])
                                  for m in gemma["models"]}))
    if not out["bsmm_bound_rel"] <= 0.01:
        raise RuntimeError(f"[roofline] the plan's bound for bsmm up/gate "
                           f"N 2048 differs from the kernel row's by more "
                           f"than 1 %: {out}")
    return out


def corpus_of(race, race_serve, rows):
    """The run's calibration corpus (``analysis.calibrate``): every
    raced candidate's measured ms with the raw model's inputs, by
    figure."""
    return {
        "race": ([c["corpus"] for c in race["cells"]]
                 + [d["corpus"] for d in race["dynamic"]]),
        "race_serve": [u["corpus"] for u in race_serve["upgrades"]],
        "grad": [g[side]["corpus"] for g in race["grads"]
                 for side in ("dx", "dvalues")],
        "skewed_patterns": [r["corpus"] for r in rows if "corpus" in r],
    }


def calibrate_phase(torch, race, corpus, serve, gemma):
    """[calibrate]: the committed calibration against the identity (the
    hand-tuned model) on this run's measurements: each Table 3 cell's
    analytic verdict beside the measured fastest (and whether the race's
    margin keeps it), model / measured per route family over the run's
    corpus, the llama and gemma2 bucket ladders and every served static
    plan's analytic route."""
    from repro_torch import configs
    from repro_torch.analysis import calibrate
    from repro_torch.core import dispatch
    from repro_torch.serve import engine

    import numpy as np

    coeffs = {"identity": dispatch.IDENTITY_COEFFS,
              "fitted": dispatch.load_cost_coeffs()}
    out = dict(digest=coeffs["fitted"].digest or None, cells=[])

    def pick(inputs, routes, c):
        est = calibrate.price(inputs, routes, c)
        return min(est, key=est.get), est

    for cell in race["cells"]:
        ms = cell["measured_ms"]
        row = dict(b=cell["b"], dtype=cell["dtype"],
                   fastest=min(ms, key=ms.get))
        for name, c in coeffs.items():
            route, est = pick(cell["corpus"]["model"], list(ms), c)
            row[name] = dict(
                route=route, model_ms=est[route] * 1e3,
                measured_ms=ms[route],
                kept=dispatch.measured_pick(
                    {r: v / 1e3 for r, v in ms.items()}, route) == route)
        out["cells"].append(row)
    ratios = {name: {} for name in coeffs}
    for fig, recs in corpus.items():
        for rec in recs:
            for name, c in coeffs.items():
                est = calibrate.price(rec["model"], list(rec["measured_ms"]),
                                      c)
                for r, v in rec["measured_ms"].items():
                    ratios[name].setdefault(dispatch.family(r), []).append(
                        est[r] * 1e3 / v)
    out["model_over_measured"] = {
        name: {f: dict(n=len(v), min=float(np.min(v)),
                       median=float(np.median(v)), max=float(np.max(v)))
               for f, v in sorted(per.items())}
        for name, per in ratios.items()}
    out["ladders"], out["served"] = {}, {}
    for label, arch, max_len, run in (
            ("llama3.2-1b", "llama3_2_1b", LLAMA_MAX_LEN, serve),
            ("gemma2-2b", "gemma2-2b", GEMMA2_MAX_LEN, gemma)):
        cfg = configs.sparsify_ffn(configs.get(arch), 1 / 8)
        shapes = engine._stack_shapes(cfg)
        out["ladders"][label] = {
            name: list(engine._auto_buckets(max_len - 1, shapes, 0.75,
                                            dtype=cfg.dtype, coeffs=c))
            for name, c in coeffs.items()}
        out["served"][label] = {
            m["plan"]: {name: pick(m["model"], m["routes"], c)[0]
                        for name, c in coeffs.items()}
            for m in run["models"]}
    return out


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
    from repro_torch.core.dispatch import family as sparse_family
    from repro_torch.core.sparse_layers import DynamicSparseLinear
    from repro_torch.kernels.dense_mm import ops as dmm_ops
    from repro_torch.kernels.dsmm import ops as dsmm_ops

    dev = torch.device("cuda", 0)
    d_model, d_ff, b, d_max = 2048, 8192, 16, 1 / 8
    batch, seq = 4, 512
    dt = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(args.seed + 17)
    # the dsmm slot walk named ("pallas": the dynamic_cuda route); one
    # step on the race's verdict ("auto") follows
    layers = {"up": DynamicSparseLinear(d_model, d_ff, b, d_max, dtype=dt,
                                        backend="pallas", device=dev),
              "gate": DynamicSparseLinear(d_model, d_ff, b, d_max, dtype=dt,
                                          backend="pallas", device=dev),
              "down": DynamicSparseLinear(d_ff, d_model, b, d_max, dtype=dt,
                                          backend="pallas", device=dev)}
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
    # what "auto" runs: the race's analytic verdict per layer shape, and
    # one step on it (step 0's masks) held against the same plain step
    auto = {}
    for name, layer in layers.items():
        p = sparse.plan(layer.encode(), batch * seq, device=dev)
        auto[name] = {"route": p.route, "source": p.source,
                      "est_ms": {r: v * 1e3 for r, v in
                                 p.est_seconds.items()}}
    plain = dict(y=y_plain.detach(), dx=x.grad.detach(),
                 dw={k_: v.weight.grad.detach().clone()
                     for k_, v in layers.items()})
    kernel_of = {"dense": dmm_ops.COUNTER}
    auto_counters = {sparse_family(a["route"]): kernel_of.get(
        sparse_family(a["route"]), dsmm_ops.COUNTER) for a in auto.values()}
    before = {f: c.launches for f, c in auto_counters.items()}
    for layer in layers.values():
        layer.backend = "auto"
        layer.weight.grad = None
    x = x0.clone().requires_grad_(True)
    y_auto = ffn(x, layers)
    y_auto.backward(gy)
    torch.cuda.synchronize()
    auto_launches = {f: c.launches - before[f]
                     for f, c in auto_counters.items()}
    errs_auto = {"y": rel_err(y_auto.detach(), plain["y"])[0],
                 "dx": rel_err(x.grad, plain["dx"])[0]}
    for k_, v in layers.items():
        errs_auto[f"dW_{k_}"] = rel_err(v.weight.grad, plain["dw"][k_])[0]
        v.backend = "pallas"
    # one extra pass at planned capacity on the grouped route
    sparse.reset_telemetry()
    with torch.no_grad():
        for layer in layers.values():
            layer.backend = "grouped"
        ffn(x0, layers)
        for layer in layers.values():
            layer.backend = "pallas"
    torch.cuda.synchronize()
    cap = sparse.capacity_report()["totals"]
    result = dict(
        d_model=d_model, d_ff=d_ff, b=b, d_max=d_max, tokens=batch * seq,
        steps=5, step_ms=step_ms, step_p50_ms=float(np.median(step_ms)),
        step_p50_after_first_ms=float(np.median(step_ms[1:])),
        dsmm_launches_per_step=launches, dsmm_launches=total_launches,
        plans_built=plans_after, masks_distinct=len(set(masks_seen)),
        forward_host_syncs=len(syncs),
        errs=errs, tol=KERNEL_TOL["bfloat16"], capacity_totals=cap,
        auto_routes=auto, auto_errs=errs_auto, auto_launches=auto_launches)
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
    bad = {k_: v for k_, v in errs_auto.items() if not v <= result["tol"]}
    if bad or not all(n_ > 0 for n_ in auto_launches.values()):
        raise RuntimeError(f"[dynamic] the step on the auto verdict "
                           f"{auto_launches} disagrees with the plain "
                           f"formulation or skipped its kernel: {bad}")
    return result


# qwen3-moe-30b-a3b serving: Engine(batch=4, max_len=1024), 6 seeded
# requests of 32..900 prompt tokens (the last one over the 256 bucket),
# 8 new tokens each
QWEN3_BATCH, QWEN3_MAX_LEN, QWEN3_NEW = 4, 1024, 8
# the fp32 end-to-end check: full width, depth cut to 4 layers (fp32 at
# full depth would need 122 GB)
QWEN3_FP32_LAYERS = 4
# [train-qwen3-moe]: qwen3-moe-30b-a3b at full width, depth cut to 4
# layers, trained as the llama train phase is (batch 4 x seq 512, 10
# AdamW steps, eagerly and then replaying the captured step)
QWEN3_TRAIN_LAYERS, QWEN3_TRAIN_BATCH, QWEN3_TRAIN_SEQ = 4, 4, 512


# [serve-deepseek]: deepseek-v2-lite-16b as published, served as qwen3
# is: Engine(batch=4, max_len=1024), 6 seeded requests of 32..900 prompt
# tokens (the last one over 600), 8 new tokens each
DEEPSEEK = "deepseek-v2-lite-16b"
DEEPSEEK_BATCH, DEEPSEEK_MAX_LEN, DEEPSEEK_NEW = 4, 1024, 8
# [train-deepseek]: full width, depth cut 27 -> 4 layers (its dense layer,
# then 3 MoE layers: 2.25 B parameters, ~36 GB of training state),
# trained as [train-qwen3-moe] is (batch 4 x seq 512, 10 AdamW steps,
# eagerly and then replaying the captured step)
DEEPSEEK_TRAIN_LAYERS, DEEPSEEK_TRAIN_BATCH, DEEPSEEK_TRAIN_SEQ = 4, 4, 512
# [serve-qwen2], [serve-glm4], [serve-internvl2] (text only, as the
# engine serves a VLM): every FFN block-sparse (d = 1/8, b = 16),
# Engine(batch=4, max_len=512), 4 seeded requests of 16..480 prompt
# tokens after 2 warm-up requests, 8 new tokens each
DENSE_ARCHS = (("qwen2-1.5b", "serve-qwen2", 41),
               ("glm4-9b", "serve-glm4", 43),
               ("internvl2-1b", "serve-internvl2", 47))
DENSE_BATCH, DENSE_MAX_LEN, DENSE_NEW = 4, 512, 8
DENSE_PROMPTS = ((16, 480),) * 4
DENSE_WARMUP = ((16, 64),) * 2


def deepseek_prompt_lens(args):
    """[serve-deepseek]'s prompt lengths: five seeded in 32..900, the
    sixth in 601..900."""
    import numpy as np
    rng = np.random.default_rng(args.seed + 31)
    lens = [int(n) for n in rng.integers(32, 901, size=5)]
    return lens + [int(rng.integers(601, 901))]


def deepseek_attn_shapes(args):
    """[attn] rows of MLA (16 heads of q.k 192 over 16 kv heads, causal,
    scale 1/sqrt(192); v padded from 128): the prefill lengths
    [serve-deepseek] runs on its engine's ladder and [train-deepseek]'s
    sequence."""
    from repro_torch import configs
    served = prefill_lens(configs.get(DEEPSEEK), DEEPSEEK_MAX_LEN,
                          deepseek_prompt_lens(args))
    scale = 1 / math.sqrt(192)
    return tuple([("deepseek served", s, 16, 16, 192, 0, None, scale)
                  for s in sorted(set(served))]
                 + [("deepseek train", DEEPSEEK_TRAIN_SEQ, 16, 16, 192, 0,
                     None, scale)])


def dense_prompt_lens(args, arch, seed_offset):
    """A [serve-qwen2] / [serve-glm4] / [serve-internvl2] run's prompt
    lengths."""
    from repro_torch import configs
    return replay_prompt_lens(args.seed + seed_offset,
                              configs.get(arch).vocab_size, DENSE_WARMUP,
                              DENSE_PROMPTS)


def dense_attn_shapes(args):
    """[attn] rows at the prefill lengths [serve-qwen2], [serve-glm4] and
    [serve-internvl2] run (their GQA groups 12 / 2 = 6, 32 / 2 = 16 and
    14 / 2 = 7; dh 128, 128 and 64; causal)."""
    from repro_torch import configs
    rows = []
    for arch, label, off in DENSE_ARCHS:
        cfg = configs.sparsify_ffn(configs.get(arch), 1 / 8)
        for s in sorted(set(prefill_lens(cfg, DENSE_MAX_LEN,
                                         dense_prompt_lens(args, arch,
                                                           off)))):
            rows.append((f"{label[6:]} served", s, cfg.num_heads,
                         cfg.num_kv_heads, cfg.head_dim, 0, None,
                         1 / math.sqrt(cfg.head_dim)))
    return tuple(rows)


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


def qwen3_train_capacity() -> int:
    """C of the train phase's MoE layers (batch 4 x seq 512 tokens)."""
    from repro_torch import configs
    from repro_torch.models import moe

    return moe._capacity(QWEN3_TRAIN_BATCH * QWEN3_TRAIN_SEQ,
                         configs.get("qwen3-moe-30b-a3b"))


def gmm_kernel_phase(torch, args):
    """gmm against its plain version at qwen3-moe's expert GEMMs (E 128;
    gate/up D 2048 -> F 768, down D 768 -> F 2048; bf16 and fp32) at the
    decode capacity C = 8 (tm 8), at the capacity of the largest
    prefill the serve run makes and at the train phase's (C 160, tm 80
    in 16-bit; its dL/da products on W^T have the same shapes, gate/up's
    on down's and down's on gate/up's), with the ids ``batched_matmul`` builds
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
    c_train = qwen3_train_capacity()
    e = 128
    rows = []

    def randn(shape, dt, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32) * scale).to(dt)

    cases = [(f"{name} C={c}", e, c, d, f, "batched")
             for name, d, f in (("gate/up", 2048, 768), ("down", 768, 2048))
             for c in (8, c_pre, c_train)]
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


def serve_moe_phase(torch, args, cfg, label, prompt_lens, *, seed,
                    counters, batch, max_len, new):
    """A full-width MoE model in bf16 from ``init(seed)`` on the card,
    through ``Engine(batch, max_len)``: seeded requests of
    ``prompt_lens`` prompt tokens, ``new`` new tokens each, eagerly and
    then through the engine's CUDA graphs (captured at startup; the main
    path).  ``counters`` are zeroed just before the graph run and read
    just after.  The routing drops are read once after each run from the
    ``"moe_dispatch"`` stream (one value an MoE layer a forward, in call
    order): mean and max over the layers for each prefill, and over
    every decode step; the graph run's equal the eager run's.  Returns
    ``(result, lm, engine)``."""
    import numpy as np

    from repro_torch import sparse
    from repro_torch.models.model import LM
    from repro_torch.models.transformer import layer_specs
    from repro_torch.serve import Engine, Request

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = LM(cfg, device="cuda", seed=args.seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in lm.parameters())

    rng = np.random.default_rng(seed)

    def request(uid, n, new):
        return Request(uid=uid, prompt=rng.integers(0, cfg.vocab_size,
                                                    size=n),
                       max_new_tokens=new)

    def noted(eng, calls):
        """Note which forward each group of drop values came from: the
        engine's admit (a prefill) and step (a decode step, if any slot
        is live); no device work, no read."""
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

    kw = dict(batch=batch, max_len=max_len, device="cuda")
    # warm-up (first launches, allocator; eager), then the same requests
    # eagerly and through the graphs
    Engine(lm, graphs=False, warm_plans=False, **kw).run(
        [request(i, 40, 2) for i in range(2)])
    prompts = [request(i, n, new).prompt for i, n in enumerate(prompt_lens)]
    eager_calls = []
    torch.cuda.reset_peak_memory_stats()
    eager_eng = noted(Engine(lm, graphs=False, **kw), eager_calls)
    sparse.reset_telemetry()
    eager_calls.clear()
    eager = serve_run(torch, eager_eng, prompts, new)
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
    run = serve_run(torch, eng, prompts, new)
    launches, walks = split_walks({k: c.launches
                                   for k, c in counters.items()})
    check_tensor_core_walks(label, walks)
    reqs, wall, peak = run["reqs"], run["wall_s"], run["peak_mem_gb"]
    hist = sparse.dropped_history("moe_dispatch")
    graphs = graphs_line(eager, run)
    graphs["drops_identical"] = (hist == eager_hist
                                 and calls == eager_calls)
    if not graphs["drops_identical"]:
        raise RuntimeError(f"[{label}] routing drops differ between the "
                           f"eager and the graph run: {len(eager_hist)} "
                           f"values for {eager_calls} against {len(hist)} "
                           f"for {calls}")

    if not all(0 <= t < cfg.vocab_size for r in reqs for t in r.output):
        raise RuntimeError("a generated token is outside the vocabulary")
    for name, count in launches.items():
        if count <= 0:
            raise RuntimeError(f"kernel {name} was not launched while "
                               f"serving {cfg.name}")
    nl = sum(spec.ffn == "moe" for spec in layer_specs(cfg))
    if len(hist) != nl * len(calls):
        raise RuntimeError(f"{len(hist)} routing drop values for "
                           f"{len(calls)} forwards of {nl} MoE layers")
    per_call = [hist[i * nl:(i + 1) * nl] for i in range(len(calls))]
    drops = [{"mean": float(np.mean(v)), "max": max(v)}
             for kind, v in zip(calls, per_call) if kind == "prefill"]
    dec = [f for kind, v in zip(calls, per_call) if kind == "decode"
           for f in v]
    # a decode step routes batch <= 8 tokens into capacity 8, and a
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
        dropped_frac_per_prefill=drops, moe_layers=nl,
        decode_dropped_frac={"layer_calls": len(dec),
                             "mean": float(np.mean(dec)), "max": max(dec)},
        buckets=list(eng.buckets), peak_mem_gb=peak, graphs=graphs,
        plans=served_plans(eng)), lm, eng


def serve_qwen3_phase(torch, args):
    """[serve-qwen3-moe]: full-width, full-depth qwen3-moe-30b-a3b (48
    layers, d_model 2048, GQA 32/4, head dim 128, QK-norm, 128 experts
    top-8 of d_ff 768, vocab 151936) through ``serve_moe_phase``:
    ``Engine(batch=4, max_len=1024)``, 6 seeded requests of 32..900
    prompt tokens, 8 new tokens each; the gmm, dense_mm and bs_attn
    counters read."""
    from repro_torch import configs
    from repro_torch.kernels import bs_attn, dense_mm, gmm

    cfg = configs.get("qwen3-moe-30b-a3b")
    assert cfg.dtype == "bfloat16" and cfg.num_layers == 48
    counters = with_walks({"gmm": gmm.COUNTER, "dense_mm": dense_mm.COUNTER,
                           "bs_attn": bs_attn.COUNTER})
    return serve_moe_phase(
        torch, args, cfg, "serve-qwen3-moe", qwen3_prompt_lens(args),
        seed=args.seed + 13, counters=counters, batch=QWEN3_BATCH,
        max_len=QWEN3_MAX_LEN, new=QWEN3_NEW)


def serve_deepseek_phase(torch, args):
    """[serve-deepseek]: deepseek-v2-lite-16b as published (27 layers,
    d_model 2048, MLA with 16 heads of q.k 192 / v 128 and a 512-wide
    latent, the first layer's dense FFN of 10944, then 64 experts top-6
    of d_ff 1408 with 2 shared, vocab 102400; 15.71 B parameters)
    through ``serve_moe_phase``: ``Engine(batch=4, max_len=1024)``, 6
    seeded requests of 32..900 prompt tokens, 8 new tokens each.  Fails
    unless every bs_attn launch of the graph run is at MLA's head dim
    192 (on the wgmma walk, as every 16-bit launch)."""
    from repro_torch import configs
    from repro_torch.kernels import bs_attn, dense_mm, gmm

    cfg = configs.get(DEEPSEEK)
    assert cfg.dtype == "bfloat16" and cfg.num_layers == 27
    counters = with_walks({"gmm": gmm.COUNTER, "dense_mm": dense_mm.COUNTER,
                           "bs_attn": bs_attn.COUNTER,
                           "bs_attn_dh192": bs_attn.HEAD_DIM_COUNTERS[192]})
    out, lm, eng = serve_moe_phase(
        torch, args, cfg, "serve-deepseek", deepseek_prompt_lens(args),
        seed=args.seed + 37, counters=counters, batch=DEEPSEEK_BATCH,
        max_len=DEEPSEEK_MAX_LEN, new=DEEPSEEK_NEW)
    if out["launches"]["bs_attn_dh192"] != out["launches"]["bs_attn"]:
        raise RuntimeError(f"[serve-deepseek] bs_attn launches off dh 192: "
                           f"{out['launches']}")
    if any(set(c) != {"latent", "k_rope"} for c in eng.caches):
        raise RuntimeError("[serve-deepseek] the engine's caches are not "
                           "MLA's latent and roped key")
    return out, lm, eng


def moe_layer_check(torch, lm, eng, n, seed):
    """One layer's ``moe_apply`` on a prefill hidden state (the FFN input
    of the first MoE layer from the middle of the stack on, during a
    prefill of the ``n``-token prompt in its bucket, or at its exact
    length): the gmm route against the plain route
    (``gmm_ref`` for the three expert products), both through the same
    fp32 routing, within the bf16 kernel budget.  Reports the layer's
    capacity C, the gmm row tile ``batched_matmul`` takes for it and the
    walk of each expert product."""
    import numpy as np

    from repro_torch import sparse
    from repro_torch.kernels import gmm
    from repro_torch.kernels.gmm import ops as gmm_ops
    from repro_torch.kernels.gmm.ref import gmm_ref
    from repro_torch.models import moe as moe_lib
    from repro_torch.sparse.plan import batched_row_tile

    bucket = eng.bucket_for(n)
    # the first MoE layer from the middle of the stack on (jamba's middle
    # layer has a dense FFN)
    li = next(i for i in range(len(lm.layers) // 2, len(lm.layers))
              if lm.layers[i].moe)
    layer = lm.layers[li]
    rng = np.random.default_rng(seed)
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
    cap = moe_lib._capacity(int(h.shape[1]), lm.cfg)
    tiles = {}
    for name, w in (("gate/up", layer.ffn.w_gate), ("down", layer.ffn.w_down)):
        _, d, f = w.shape
        tm = batched_row_tile(cap, gmm_ops.tma_ok(d, f, w.dtype))
        tiles[name] = dict(tm=tm, walk=gmm_ops.walk(tm, d, f, w.dtype).name,
                           row_tiles_per_expert=cap // tm)
    out = dict(layer=li, tokens=int(h.shape[1]), capacity=cap, tiles=tiles,
               rel_err=err, tol=KERNEL_TOL["bfloat16"],
               gmm_launches=launched, plain_route_gmm_launches=plain_launched,
               dropped_frac=float(m_kernel.dropped_frac),
               same_routing=float(m_kernel.dropped_frac)
               == float(m_plain.dropped_frac))
    if launched != 3 or plain_launched != 0 \
            or not err <= KERNEL_TOL["bfloat16"]:
        raise RuntimeError(f"{lm.cfg.name} MoE layer: gmm route vs plain "
                           f"{out}")
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


# the metrics an MoE train run reads each step
MOE_TRAIN_KEYS = ("loss", "grad_norm", "lr", "aux_loss", "z_loss",
                  "dropped_frac")


def eager_moe_train_run(torch, label, cfg, **kw):
    """``train_run`` eagerly on an MoE config, with gmm's launches split
    into the forward's (counted inside the MoE modules' forward calls)
    and the backward's, by walk.  Returns ``(run, split, one MoE module
    of the trained model)``."""
    from repro_torch.kernels import gmm
    from repro_torch.models.moe import MoE

    fwd = {w: 0 for w in gmm.WALK_COUNTERS}
    held, entry = {}, {}

    def pre(mod, inputs):
        if isinstance(mod, MoE):
            entry[id(mod)] = {w: c.launches
                              for w, c in gmm.WALK_COUNTERS.items()}

    def post(mod, inputs, out):
        if isinstance(mod, MoE):
            seen = entry.pop(id(mod))
            for w, c in gmm.WALK_COUNTERS.items():
                fwd[w] += c.launches - seen[w]
            held.setdefault("moe", mod)

    hooks = (torch.nn.modules.module.register_module_forward_pre_hook(pre),
             torch.nn.modules.module.register_module_forward_hook(post))
    try:
        eager = train_run(torch, label, cfg, graphs=False,
                          metric_keys=MOE_TRAIN_KEYS, **kw)
    finally:
        for h in hooks:
            h.remove()
    by_walk = eager["walks"]["gmm"]
    split = {"forward": {w: n for w, n in fwd.items() if n},
             "backward": {w: by_walk[w] - fwd[w] for w in by_walk
                          if by_walk[w] - fwd[w]}}
    return eager, split, held.pop("moe")


def train_qwen3_phase(torch, args):
    """[train-qwen3-moe]: ``launch.train.train_loop`` on qwen3-moe-30b-a3b
    at full width (d_model 2048, GQA 32/4, head dim 128, 128 experts
    top-8 of d_ff 768, vocab 151936, untied), bf16, from a seeded init,
    depth cut to ``QWEN3_TRAIN_LAYERS`` = 4 layers so the training state
    fits the card: a layer holds ~623 M parameters (the experts 128 x 3
    x 2048 x 768 = 604 M, attention ~19 M), the embedding and the
    unembed 2 x 151936 x 2048 = 622 M, so 4 layers are ~3.11 B
    parameters; at 16 B a parameter (bf16 weight and gradient, fp32
    master, mu and nu) ~50 GB (~46 GiB), plus the clipped gradients
    (6.2 GB), AdamW's fp32 temporaries of one group and the
    activations.  6 layers would need ~70 GB.  Batch 4 x seq 512 (C =
    160, row tile 80), 10 AdamW steps, no checkpoint, eagerly and then
    replaying the captured step (``eager_and_graphs``: losses and final
    parameters equal).

    In the eager run gmm launches are split into the forward's (counted
    inside the MoE modules' forward calls) and the backward's (dL/da on
    W^T), by walk; the graph run's are counted per replay.  It fails
    unless gmm, dense_mm and bs_attn launch, gmm launches in the forward
    and the backward, every gmm launch is on the wgmma walk, and one
    trained layer's ``batched_matmul`` backward (gate/up's and down's
    shapes, the step's C and row tile) equals ``torch.matmul``'s
    autograd in fp32 on the same bf16 inputs within the bf16 budget.
    Reports each run's step p50, tokens/s, peak GiB allocated and
    reserved, each step's ``aux_loss``, ``z_loss`` and
    ``dropped_frac`` and the host syncs of one step (reported, not
    failed)."""
    import dataclasses

    from repro_torch import configs, sparse
    from repro_torch.kernels import bs_attn, dense_mm, gmm

    base = configs.get("qwen3-moe-30b-a3b")
    cfg = dataclasses.replace(
        base, groups=((base.groups[0][0], QWEN3_TRAIN_LAYERS),))
    assert cfg.dtype == "bfloat16" and not cfg.tie_embeddings
    steps, batch, seq = TRAIN_STEPS, QWEN3_TRAIN_BATCH, QWEN3_TRAIN_SEQ
    cap = qwen3_train_capacity()
    counters = with_walks({"gmm": gmm.COUNTER, "dense_mm": dense_mm.COUNTER,
                           "bs_attn": bs_attn.COUNTER})
    eager, gmm_split, mod = eager_moe_train_run(
        torch, "train-qwen3-moe", cfg, counters=counters, args=args,
        steps=steps, batch=batch, seq=seq)

    # one trained layer's batched_matmul backward at the step's C
    dev = mod.w_gate.device
    gen = torch.Generator(device=dev).manual_seed(args.seed + 23)
    layer = []
    for name, w in (("gate/up", mod.w_gate), ("down", mod.w_down)):
        e, d, f = w.shape
        a = torch.randn((e, cap, d), generator=gen, device=dev).to(w.dtype)
        gy = torch.randn((e, cap, f), generator=gen, device=dev).to(w.dtype)
        ta = a.clone().requires_grad_(True)
        tw = w.detach().clone().requires_grad_(True)
        before = gmm.COUNTER.launches
        y = sparse.batched_matmul(ta, tw)
        y.backward(gy)
        torch.cuda.synchronize()
        launched = gmm.COUNTER.launches - before
        ra = a.float().requires_grad_(True)
        rw = w.detach().float().requires_grad_(True)
        want = torch.matmul(ra, rw)
        want.backward(gy.float())
        p = sparse.plan(sparse.OpSpec(kind="dense", m=cap, k=d, n=f,
                                      dtype=w.dtype, op="batched_matmul"),
                        device=dev)
        wt = w.detach()
        layer.append(dict(
            product=name, shape=f"[{e}, {cap}, {d}] @ [{e}, {d}, {f}]",
            row_tile=p.row_tile, gmm_launches=launched,
            grad=sparse.plan_report()["per_plan"][p.key]["grad"],
            y_rel_err=rel_err(y, want)[0],
            da_rel_err=rel_err(ta.grad, ra.grad)[0],
            dw_rel_err=rel_err(tw.grad, rw.grad)[0],
            tol=KERNEL_TOL["bfloat16"],
            wt_copy_ms=timed_ms(
                torch, lambda x: x.transpose(-1, -2).contiguous(),
                [(wt,)], 10)))
        del a, gy, ta, tw, ra, rw, y, want, wt, w
    del mod
    gc.collect()

    _, graph, check = eager_and_graphs(
        torch, "train-qwen3-moe", cfg, counters=counters, args=args,
        steps=steps, batch=batch, seq=seq, metric_keys=MOE_TRAIN_KEYS,
        eager=eager)
    for r in (eager, graph):
        check_tensor_core_walks("train-qwen3-moe", r["walks"])
    if (graph["captures"], graph["recaptures"]) != (1, 0):
        raise RuntimeError(f"[train-qwen3-moe] one capture expected: "
                           f"{graph['captures']}, re-captures "
                           f"{graph['recaptures']}")
    if not (gmm_split["forward"] and gmm_split["backward"]):
        raise RuntimeError(f"[train-qwen3-moe] gmm must launch in the "
                           f"forward and the backward: {gmm_split}")
    bad = [r for r in layer if r["gmm_launches"] != 2 or not max(
        r["y_rel_err"], r["da_rel_err"], r["dw_rel_err"]) <= r["tol"]]
    if bad:
        raise RuntimeError(f"[train-qwen3-moe] batched_matmul backward vs "
                           f"plain: {bad}")
    return dict(graph, eager=eager, check=check, layers=QWEN3_TRAIN_LAYERS,
                capacity=cap, gmm_launches=gmm_split, layer_backward=layer)


def train_deepseek_phase(torch, args):
    """[train-deepseek]: ``launch.train.train_loop`` on deepseek-v2-lite-16b
    at full width (d_model 2048, MLA 16 heads of q.k 192 / v 128 and a
    512-wide latent, vocab 102400, untied), bf16, from a seeded init,
    depth cut to ``DEEPSEEK_TRAIN_LAYERS`` = 4 (``profile_train.cut_depth``:
    its dense layer, d_ff 10944, then 3 MoE layers of 64 experts top-6 of
    d_ff 1408 with 2 shared): ~2.25 B parameters, ~36 GB of state at 16 B
    a parameter.  Batch 4 x seq 512 (C = 240), 10 AdamW steps, no
    checkpoint, eagerly and then replaying the captured step
    (``eager_and_graphs``: losses and final parameters bit-equal, the
    loss falls).  The attention backward is bs_attn's plain recompute,
    the MoE backward gmm on W^T.  Fails unless gmm launches in the
    forward and the backward, every gmm and bs_attn launch is on the
    wgmma walk, and every bs_attn launch is at dh 192."""
    from repro_torch import configs
    from repro_torch.kernels import bs_attn, dense_mm, gmm
    from repro_torch.launch.profile_train import cut_depth
    from repro_torch.models import moe as moe_lib

    cfg = cut_depth(configs.get(DEEPSEEK), DEEPSEEK_TRAIN_LAYERS)
    assert [(r, p[0].ffn) for p, r in cfg.groups] == [(1, "mlp"),
                                                      (3, "moe")]
    steps, batch, seq = (TRAIN_STEPS, DEEPSEEK_TRAIN_BATCH,
                         DEEPSEEK_TRAIN_SEQ)
    counters = with_walks({"gmm": gmm.COUNTER, "dense_mm": dense_mm.COUNTER,
                           "bs_attn": bs_attn.COUNTER,
                           "bs_attn_dh192": bs_attn.HEAD_DIM_COUNTERS[192]})
    kw = dict(counters=counters, args=args, steps=steps, batch=batch,
              seq=seq)
    eager, gmm_split, _ = eager_moe_train_run(torch, "train-deepseek", cfg,
                                              **kw)
    gc.collect()
    _, graph, check = eager_and_graphs(torch, "train-deepseek", cfg,
                                       metric_keys=MOE_TRAIN_KEYS,
                                       eager=eager, **kw)
    for r in (eager, graph):
        check_tensor_core_walks("train-deepseek", r["walks"])
        if r["launches"]["bs_attn_dh192"] != r["launches"]["bs_attn"]:
            raise RuntimeError(f"[train-deepseek] bs_attn launches off dh "
                               f"192: {r['launches']}")
    if (graph["captures"], graph["recaptures"]) != (1, 0):
        raise RuntimeError(f"[train-deepseek] one capture expected: "
                           f"{graph['captures']}, re-captures "
                           f"{graph['recaptures']}")
    if not (gmm_split["forward"] and gmm_split["backward"]):
        raise RuntimeError(f"[train-deepseek] gmm must launch in the "
                           f"forward and the backward: {gmm_split}")
    return dict(graph, eager=eager, check=check,
                layers=DEEPSEEK_TRAIN_LAYERS,
                capacity=moe_lib._capacity(batch * seq, cfg),
                gmm_launches=gmm_split)


def serve_dense_phase(torch, args, arch, label, seed_offset):
    """[serve-qwen2] / [serve-glm4] / [serve-internvl2] (as text): ``arch``
    at full width and depth with
    every FFN block-sparse (d = 1/8, b = 16; q/k/v biased), bf16 from
    ``init(seed)`` on the card, through ``Engine(batch=4, max_len=512)``:
    2 warm-up requests (eager), then 4 seeded requests of 16..480 prompt
    tokens, 8 new tokens each, eagerly and then through the engine's
    CUDA graphs (captured at startup; the main path, whose bsmm,
    bsmm_balanced, dense_mm and bs_attn counters are zeroed just before
    and read just after).  Fails unless the tokens are identical, dense_mm,
    bs_attn and a sparse FFN kernel (bsmm, or bsmm_balanced where the
    route race picked it) launched, each on its tensor-core (or, bsmm,
    decode) walk.  Returns ``(result, lm,
    engine)``."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.kernels import bs_attn, bsmm, dense_mm
    from repro_torch.models.model import LM
    from repro_torch.serve import Engine, Request

    cfg = configs.sparsify_ffn(configs.get(arch), 1 / 8)
    assert cfg.dtype == "bfloat16" and cfg.ffn_block_size == 16
    assert cfg.qkv_bias
    counters = with_walks({"bsmm": bsmm.COUNTER,
                           "bsmm_balanced": bsmm.BALANCED_COUNTER,
                           "dense_mm": dense_mm.COUNTER,
                           "bs_attn": bs_attn.COUNTER})
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = LM(cfg, device="cuda", seed=args.seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in lm.parameters())
    rng = np.random.default_rng(args.seed + seed_offset)

    def requests(bounds, new):
        return [Request(uid=i, prompt=rng.integers(
                    0, cfg.vocab_size, size=int(rng.integers(lo, hi + 1))),
                    max_new_tokens=new) for i, (lo, hi) in enumerate(bounds)]

    kw = dict(batch=DENSE_BATCH, max_len=DENSE_MAX_LEN, device="cuda")
    Engine(lm, graphs=False, warm_plans=False, **kw).run(
        requests(DENSE_WARMUP, 2))
    prompts = [r.prompt for r in requests(DENSE_PROMPTS, DENSE_NEW)]
    if [len(p) for p in prompts] != dense_prompt_lens(args, arch,
                                                      seed_offset):
        raise RuntimeError("dense_prompt_lens does not replay the run")
    torch.cuda.reset_peak_memory_stats()
    eager = serve_run(torch, Engine(lm, graphs=False, **kw), prompts,
                      DENSE_NEW)
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(lm, warm_compile=True, **kw)
    torch.cuda.synchronize()
    for c in counters.values():
        c.reset()
    run = serve_run(torch, eng, prompts, DENSE_NEW)
    launches, walks = split_walks({k: c.launches
                                   for k, c in counters.items()})
    check_tensor_core_walks(label, walks,
                            ("bs_attn", "bsmm", "bsmm_balanced"))
    graphs = graphs_line(eager, run)
    reqs, wall, st = run["reqs"], run["wall_s"], run["stats"]
    if not all(0 <= t < cfg.vocab_size for r in reqs for t in r.output):
        raise RuntimeError("a generated token is outside the vocabulary")
    # the FFN's plans race the uniform and the balanced walks: one of the
    # two sparse kernels runs each plan
    if min(launches["dense_mm"], launches["bs_attn"],
           launches["bsmm"] + launches["bsmm_balanced"]) <= 0:
        raise RuntimeError(f"a kernel was not launched while serving "
                           f"{cfg.name}: {launches}")
    tokens = sum(len(r.output) for r in reqs)
    return dict(
        params=n_params, init_s=init_s, requests=len(reqs),
        prompt_lens=[int(len(r.prompt)) for r in reqs],
        prefill_lens=[int(r.bucket or len(r.prompt)) for r in reqs],
        tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
        prefill_p50_ms=st["prefill_latency"]["p50_ms"],
        decode_step_p50_ms=st["step_latency"]["p50_ms"],
        decode_steps=st["steps"], launches=launches, walks=walks,
        buckets=list(eng.buckets), peak_mem_gb=run["peak_mem_gb"],
        graphs=graphs, plans=served_plans(eng)), lm, eng


# [serve-mamba2]: mamba2-130m at full width and depth (24 SSD layers,
# d_model 768, 24 heads of 64, d_state 128, vocab 50280, tied), bf16,
# Engine(batch=4, max_len=1024): 8 seeded requests of 16..900 prompt
# tokens (one a multiple of 256, one odd), 16 new tokens each.  The stack
# is pad-unsafe: every prompt is prefilled eagerly at its exact length
MAMBA2 = "mamba2-130m"
MAMBA2_BATCH, MAMBA2_MAX_LEN, MAMBA2_NEW = 4, 1024, 16
MAMBA2_CHECK_PROMPT = 300
# [train-mamba2]: batch 4 x seq 512 (SSD chunk 256: 2 chunks), 10 AdamW
# steps, eagerly and then replaying the captured step
MAMBA2_TRAIN_BATCH, MAMBA2_TRAIN_SEQ = 4, 512
# [train-mamba2]'s length and its "loss falls" check (the mean of the
# last MAMBA2_FALL_WINDOW losses below the first's): at random init the
# loss sits near log(vocab) and moves by ~0.02 from batch to batch, so
# over TRAIN_STEPS steps a fall is not told apart from the batches
# (falls of -0.0178..0.0114 over five init draws, `--margins`)
MAMBA2_TRAIN_STEPS, MAMBA2_FALL_WINDOW = 60, 5
# [serve-jamba]: jamba-v0.1-52b at published widths, depth cut 32 -> 16
# layers (2 of its 4 periods of 8: 14 mamba and 2 attention layers, 8
# MoE; 26.00 B parameters, ~48.4 GiB in bf16), served as qwen3 is:
# Engine(batch=4, max_len=1024), 6 seeded requests of 32..900 prompt
# tokens (the last one over 600), 8 new tokens each, each prefilled at
# its exact length
JAMBA = "jamba-v0.1-52b"
JAMBA_LAYERS = 16
JAMBA_BATCH, JAMBA_MAX_LEN, JAMBA_NEW = 4, 1024, 8


def mamba2_prompt_lens(args):
    """[serve-mamba2]'s prompt lengths: six seeded in 16..900, then 768
    (a multiple of 256: SSD chunks of 256) and a seeded odd one (chunks
    of 1)."""
    import numpy as np
    rng = np.random.default_rng(args.seed + 51)
    lens = [int(n) for n in rng.integers(16, 901, size=6)]
    return lens + [768, 2 * int(rng.integers(8, 450)) + 1]


def jamba_prompt_lens(args):
    """[serve-jamba]'s prompt lengths: five seeded in 32..900, the sixth
    in 601..900."""
    import numpy as np
    rng = np.random.default_rng(args.seed + 55)
    lens = [int(n) for n in rng.integers(32, 901, size=5)]
    return lens + [int(rng.integers(601, 901))]


def check_dense_mm_walks(label, walks):
    """Every dense_mm launch of a bf16 model on a 16-bit walk (wgmma, or
    decode at N <= 16), some on wgmma."""
    w = walks["dense_mm"]
    if w.get("ffma", 0) or not w.get("wgmma", 0):
        raise RuntimeError(f"[{label}] dense_mm launches off its 16-bit "
                           f"walks: {w}")


def decode_consistency(torch, lm, n, seed, tol, **inputs):
    """An ``n``-token seeded prompt prefilled at its exact length, then
    two decode steps, against ``forward`` on the same ``n + 2`` tokens
    (one row; ``inputs`` are that row's ``frontend`` / ``enc_frames``,
    and a frontend's rows offset the decode positions): rel-max error of
    each call's logits; fails beyond ``tol``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    toks = rng.integers(0, lm.cfg.vocab_size, size=n + 2)
    off = inputs["frontend"].shape[1] if "frontend" in inputs else 0
    full = lm.forward(toks[None, :], **inputs).float()
    if not bool(torch.isfinite(full).all()):
        raise RuntimeError("forward gave non-finite logits")
    logits, caches = lm.prefill(toks[None, :n], max_len=off + n + 8,
                                **inputs)
    errs = {"prefill": rel_err(logits[0], full[0, n - 1])[0]}
    for i in range(2):
        pos = n + i
        logits, caches = lm.decode_step(toks[None, pos:pos + 1], caches,
                                         np.asarray([off + pos]))
        errs[f"decode_{i}"] = rel_err(logits[0], full[0, pos])[0]
    bad = {k: v for k, v in errs.items() if not v <= tol}
    if bad:
        raise RuntimeError(f"{lm.cfg.name} ({lm.cfg.dtype}) decode after a "
                           f"{n}-token prompt vs forward beyond {tol}: "
                           f"{errs}")
    return errs


def ssm_layer_consistency(torch, lm, n, seed, tol):
    """Each mamba layer's mixer on the same inputs (its ``norm1`` output
    in a ``forward`` over ``n + 2`` seeded tokens): ``prefill`` of the
    first ``n`` rows and two ``decode`` steps against the full-sequence
    mixer at those rows.  Returns the rel-max error of each layer (the
    worse step); fails beyond ``tol``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    toks = rng.integers(0, lm.cfg.vocab_size, size=n + 2)
    xs = {}
    hooks = [layer.norm1.register_forward_hook(
        lambda m, a, out, i=i: xs.__setitem__(i, out))
        for i, layer in enumerate(lm.layers) if layer.ssm]
    try:
        lm.forward(toks[None, :])
    finally:
        for h in hooks:
            h.remove()
    errs = {}
    with torch.no_grad():
        for i, x in sorted(xs.items()):
            mix = lm.layers[i].mixer
            full = mix(x)
            _, cache = mix.prefill(x[:, :n])
            steps = []
            for j in range(2):
                y, cache = mix.decode(x[:, n + j:n + j + 1], cache)
                steps.append(rel_err(y, full[:, n + j:n + j + 1])[0])
            errs[i] = max(steps)
    if not max(errs.values()) <= tol:
        raise RuntimeError(f"{lm.cfg.name} ({lm.cfg.dtype}): a mamba "
                           f"layer's decode vs its forward on the same "
                           f"inputs beyond {tol}: {errs}")
    return errs


def timed_admits(eng, rows):
    """Note each prefill's prompt length and host ms (``admit`` ends in
    the host's read of the sampled token, and the decode step before it
    in its own)."""
    admit = eng.admit

    def timed(req):
        t0 = time.perf_counter()
        out = admit(req)
        rows.append((len(req.prompt), (time.perf_counter() - t0) * 1e3))
        return out

    eng.admit = timed
    return eng


def serve_mamba2_phase(torch, args):
    """[serve-mamba2]: mamba2-130m at full width and depth in bf16 from
    ``init(seed)``, through ``Engine(batch=4, max_len=1024)``: 2 warm-up
    requests (eager), then 8 seeded requests of 16..900 prompt tokens,
    16 new tokens each, eagerly and then through the engine's graphs
    (its decode step captured at startup; the main path, whose dense_mm
    counter is zeroed just before and read just after).  Fails unless
    the engine has no buckets and prefills every prompt at its exact
    length, dense_mm launches on its 16-bit walks, the tokens are
    identical, every cache is ``{state, conv}``, decode after a prompt
    matches ``forward`` in bf16 layer by layer (each mamba layer's
    decode against its forward on the same inputs, 6e-2) and end to end
    at the same seeded weights in fp32 (2e-4), and decode after 1- and
    2-token prompts matches ``forward`` in fp32.  The bf16 end-to-end
    gap is printed, not held: at random init 24 bf16 layers amplify
    their roundings (``tests/test_torch_hybrid.py``: the port's and the
    JAX package's bf16 forwards disagree by far more than the budget at
    that depth, while fp32 agrees).  Prints each prefill's SSD chunk
    length and chunk count beside its ms."""
    import dataclasses

    import numpy as np

    from repro_torch import configs
    from repro_torch.kernels import dense_mm
    from repro_torch.models.model import LM
    from repro_torch.models.ssm import chunk_len
    from repro_torch.serve import Engine, Request

    cfg = configs.get(MAMBA2)
    assert (cfg.dtype, cfg.num_layers, cfg.d_model) == ("bfloat16", 24, 768)
    counters = with_walks({"dense_mm": dense_mm.COUNTER})
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = LM(cfg, device="cuda", seed=args.seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(args.seed + 53)
    kw = dict(batch=MAMBA2_BATCH, max_len=MAMBA2_MAX_LEN, device="cuda")
    Engine(lm, graphs=False, warm_plans=False, **kw).run(
        [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, size=40),
                 max_new_tokens=2) for i in range(2)])
    lens = mamba2_prompt_lens(args)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in lens]
    eager_pre, graph_pre = [], []
    torch.cuda.reset_peak_memory_stats()
    eager_eng = timed_admits(Engine(lm, graphs=False, **kw), eager_pre)
    eager = serve_run(torch, eager_eng, prompts, MAMBA2_NEW)
    del eager_eng
    torch.cuda.reset_peak_memory_stats()
    eng = timed_admits(Engine(lm, warm_compile=True, **kw), graph_pre)
    torch.cuda.synchronize()
    for c in counters.values():
        c.reset()
    run = serve_run(torch, eng, prompts, MAMBA2_NEW)
    launches, walks = split_walks({k: c.launches
                                   for k, c in counters.items()})
    check_dense_mm_walks("serve-mamba2", walks)
    graphs = graphs_line(eager, run)
    reqs, wall, st = run["reqs"], run["wall_s"], run["stats"]
    exact = {"eager": eager["stats"]["admission"]["exact_prefills"],
             "graphs": st["admission"]["exact_prefills"]}
    if eng.buckets != () or set(exact.values()) != {len(prompts)}:
        raise RuntimeError(f"[serve-mamba2] buckets {eng.buckets}, exact "
                           f"prefills {exact} of {len(prompts)} requests")
    if any(set(c) != {"state", "conv"} for c in eng.caches):
        raise RuntimeError("[serve-mamba2] a cache is not {state, conv}")
    if not all(0 <= t < cfg.vocab_size for r in reqs for t in r.output):
        raise RuntimeError("a generated token is outside the vocabulary")
    prefills = [dict(tokens=n, chunk_len=chunk_len(n, cfg.ssm.chunk),
                     chunks=n // chunk_len(n, cfg.ssm.chunk),
                     ms_eager=e, ms_graphs=g)
                for (n, e), (_, g) in zip(eager_pre, graph_pre)]
    buckets, plans = list(eng.buckets), served_plans(eng)
    n_params = sum(p.numel() for p in lm.parameters())
    del eng
    gc.collect()
    cons = {"prompt": MAMBA2_CHECK_PROMPT,
            "bf16_layers": ssm_layer_consistency(
                torch, lm, MAMBA2_CHECK_PROMPT, args.seed + 59,
                CONSISTENCY_TOL),
            "bf16_end_to_end": decode_consistency(
                torch, lm, MAMBA2_CHECK_PROMPT, args.seed + 59,
                float("inf"))}
    del lm
    lm32 = LM(dataclasses.replace(cfg, dtype="float32"), device="cuda",
              seed=args.seed)
    cons["fp32"] = decode_consistency(torch, lm32, MAMBA2_CHECK_PROMPT,
                                      args.seed + 59, LOGITS_TOL_FP32)
    for n in (1, 2):
        cons[f"fp32_prompt_{n}"] = decode_consistency(
            torch, lm32, n, args.seed + 61, LOGITS_TOL_FP32)
    del lm32
    tokens = sum(len(r.output) for r in reqs)
    return dict(
        params=n_params, init_s=init_s, requests=len(reqs),
        prompt_lens=lens,
        prefill_lens=[int(r.bucket or len(r.prompt)) for r in reqs],
        tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
        prefill_p50_ms=st["prefill_latency"]["p50_ms"],
        decode_step_p50_ms=st["step_latency"]["p50_ms"],
        decode_steps=st["steps"], launches=launches, walks=walks,
        buckets=buckets, exact_prefills=exact,
        peak_mem_gb=run["peak_mem_gb"], graphs=graphs, prefills=prefills,
        consistency=cons, plans=plans)


def train_mamba2_phase(torch, args):
    """[train-mamba2]: ``launch.train.train_loop`` on mamba2-130m at full
    width and depth, bf16, from a seeded init, batch 4 x seq 512 (SSD
    chunk 256: 2 chunks a sequence), ``MAMBA2_TRAIN_STEPS`` AdamW steps
    (the cosine schedule over them), eagerly and then replaying the
    captured step (``eager_and_graphs``: every loss finite, the mean of
    the last ``MAMBA2_FALL_WINDOW`` losses below the first's, losses and
    final parameters bit-equal).  The SSD scan's backward is autograd over plain PyTorch,
    the projections' the planned dense backward.  Fails unless dense_mm
    launches on its 16-bit walks and the graph is captured once."""
    from repro_torch import configs
    from repro_torch.kernels import dense_mm
    from repro_torch.models.ssm import chunk_len

    cfg = configs.get(MAMBA2)
    counters = with_walks({"dense_mm": dense_mm.COUNTER})
    eager, graph, check = eager_and_graphs(
        torch, "train-mamba2", cfg, counters=counters, args=args,
        steps=MAMBA2_TRAIN_STEPS, total_steps=MAMBA2_TRAIN_STEPS,
        batch=MAMBA2_TRAIN_BATCH, seq=MAMBA2_TRAIN_SEQ,
        fall=lambda losses: loss_fell(losses, MAMBA2_TRAIN_STEPS,
                                      MAMBA2_FALL_WINDOW))
    for r in (eager, graph):
        check_dense_mm_walks("train-mamba2", r["walks"])
    if (graph["captures"], graph["recaptures"]) != (1, 0):
        raise RuntimeError(f"[train-mamba2] one capture expected: "
                           f"{graph['captures']}, re-captures "
                           f"{graph['recaptures']}")
    lc = chunk_len(MAMBA2_TRAIN_SEQ, cfg.ssm.chunk)
    return dict(graph, eager=eager, check=check, chunk_len=lc,
                chunks=MAMBA2_TRAIN_SEQ // lc)


def serve_jamba_phase(torch, args):
    """[serve-jamba]: jamba-v0.1-52b at published widths (d_model 4096,
    mamba layers of SSD d_state 16 with 128 heads of 64, attention GQA
    32/8 of head dim 128 without rope, d_ff 14336, 16 experts top-2 of
    d_ff 14336, vocab 65536), depth cut 32 -> 16 layers
    (``profile_train.cut_depth``: 2 of its 4 periods), bf16 from
    ``init(seed)``, through ``serve_moe_phase``: ``Engine(batch=4,
    max_len=1024)``, 6 seeded requests of 32..900 prompt tokens, 8 new
    tokens each, every prompt prefilled at its exact length.  Fails
    unless gmm, dense_mm and bs_attn launch in the graph run on their
    16-bit walks, tokens and routing drops equal the eager run's, the
    engine has no buckets, and the caches are ``{state, conv}`` on the
    14 mamba layers and ``{k, v}`` on the 2 attention layers."""
    from repro_torch import configs
    from repro_torch.kernels import bs_attn, dense_mm, gmm
    from repro_torch.launch.profile_train import cut_depth
    from repro_torch.models.transformer import layer_specs

    cfg = cut_depth(configs.get(JAMBA), JAMBA_LAYERS)
    specs = layer_specs(cfg)
    assert cfg.dtype == "bfloat16" and len(specs) == JAMBA_LAYERS
    counters = with_walks({"gmm": gmm.COUNTER, "dense_mm": dense_mm.COUNTER,
                           "bs_attn": bs_attn.COUNTER})
    out, lm, eng = serve_moe_phase(
        torch, args, cfg, "serve-jamba", jamba_prompt_lens(args),
        seed=args.seed + 57, counters=counters, batch=JAMBA_BATCH,
        max_len=JAMBA_MAX_LEN, new=JAMBA_NEW)
    check_dense_mm_walks("serve-jamba", out["walks"])
    exact = eng.stats()["admission"]["exact_prefills"]
    kinds = [("state", "conv") if s.mixer == "mamba" else ("k", "v")
             for s in specs]
    if eng.buckets != () or exact != out["requests"] or any(
            set(c) != set(k) for c, k in zip(eng.caches, kinds)):
        raise RuntimeError(f"[serve-jamba] buckets {eng.buckets}, exact "
                           f"prefills {exact}, caches "
                           f"{[sorted(c) for c in eng.caches]}")
    out.update(exact_prefills=exact, layers=JAMBA_LAYERS,
               mamba_layers=kinds.count(("state", "conv")),
               attention_layers=kinds.count(("k", "v")))
    return out, lm, eng


# [serve-seamless]: seamless-m4t-medium at full width and depth (12
# bidirectional encoder layers over 1024 frames, 12 decoder layers with
# cross attention; d_model 1024, 16 heads of 64, d_ff 4096, vocab
# 256206; 0.62 B parameters) in bf16 from init(seed): batch 4, four
# seeded frame sets of [1024, 1024], two prompts of 300 tokens and two of
# 237 (right-padded to 300, ``last_index``), 16 new tokens (the
# prefill's, then 15 greedy eager decode steps).  The engine takes no
# frames, as the reference's does not: this runs the LM's entry points
SEAMLESS = "seamless-m4t-medium"
SEAMLESS_PROMPTS = (300, 300, 237, 237)
SEAMLESS_NEW, SEAMLESS_MAX_LEN = 16, 320
# [train-seamless]: batch 4 x seq 512 with 4 x 1024 seeded frames
SEAMLESS_TRAIN_BATCH, SEAMLESS_TRAIN_SEQ = 4, 512
# bs_attn launches of a [train-seamless] step: the forward's 36 and their
# recompute in the backward (remat="full")
SEAMLESS_TRAIN_BS_ATTN = 2 * 36
# [vlm-internvl2]: internvl2-1b as published (dense FFNs), 4 rows of 256
# seeded patch rows and a 200-token prompt, 16 new tokens
INTERNVL2 = "internvl2-1b"
VLM_BATCH, VLM_PROMPT, VLM_NEW, VLM_MAX_LEN = 4, 200, 16, 512


def greedy_run(torch, lm, tokens, new, counters, *, max_len, lens,
               **inputs):
    """``lm.prefill(tokens, max_len=, last_index=lens - 1, **inputs)``
    (``lens`` count every position, a frontend's included), then ``new -
    1`` greedy ``decode_step``s from positions ``lens``: the tokens
    ``[B, new]``, each call's device-synchronised wall (ms) and its
    launches by counter, the prefill's and the last step's logits."""
    import numpy as np

    def launches():
        return {k: c.launches for k, c in counters.items()}

    def delta(before):
        return {k: v - before[k] for k, v in launches().items()}

    torch.cuda.synchronize()
    before, t0 = launches(), time.perf_counter()
    logits, caches = lm.prefill(tokens, max_len=max_len,
                                last_index=np.asarray(lens) - 1, **inputs)
    tok = logits.argmax(-1)
    torch.cuda.synchronize()
    prefill = dict(ms=(time.perf_counter() - t0) * 1e3,
                   launches=delta(before))
    first, out, steps = logits, [tok], []
    pos = torch.as_tensor(np.asarray(lens), device=lm.device)
    for i in range(new - 1):
        before, t1 = launches(), time.perf_counter()
        logits, caches = lm.decode_step(tok[:, None], caches, pos + i)
        tok = logits.argmax(-1)
        torch.cuda.synchronize()
        steps.append(dict(ms=(time.perf_counter() - t1) * 1e3,
                          launches=delta(before)))
        out.append(tok)
    wall = time.perf_counter() - t0
    return dict(tokens=torch.stack(out, 1).cpu().numpy(), prefill=prefill,
                steps=steps, wall_s=wall, first=first, last=logits)


def decode_vs_forward(torch, lm, prompts, lens, run, **inputs):
    """The prefill's and the last decode step's logits of ``run`` (a
    ``greedy_run``) against ``lm.forward`` on each row's prompt and the
    tokens it generated (rows of one length at a time): the rel-max
    errors of each."""
    import numpy as np

    errs = {"prefill": 0.0, "last_step": 0.0}
    gen = run["tokens"]
    new = gen.shape[1]
    for n in sorted(set(lens)):
        rows = [i for i, m in enumerate(lens) if m == n]
        seq = np.concatenate([prompts[rows, :n], gen[rows, :new - 1]], 1)
        kw = {k: v[rows] for k, v in inputs.items()}
        full = lm.forward(seq, **kw)
        errs["prefill"] = max(errs["prefill"], rel_err(
            run["first"][rows], full[:, n - 1])[0])
        errs["last_step"] = max(errs["last_step"], rel_err(
            run["last"][rows], full[:, -1])[0])
        del full
    return errs


def serve_seamless_phase(torch, args):
    """[serve-seamless]: seamless-m4t-medium at full width and depth in
    bf16 (see ``SEAMLESS``): the encoder alone over the frames (CUDA
    events), then a warm-up and the timed run of ``greedy_run`` through
    ``prefill(enc_frames=)`` and eager ``decode_step``.  Fails unless
    bs_attn launched 36 times in the prefill (12 encoder, 12 causal self,
    12 cross) and 12 times a decode step (cross at one query row; the
    self-attention decode is the plain ``attend_decode``), all on its
    wgmma walk, dense_mm launched on its 16-bit walks, every token is in
    the vocabulary, and decode matches ``forward``: bf16 at the prefill
    and at the last step within ``CONSISTENCY_TOL``, an fp32 copy at full
    depth (``decode_consistency`` on a seeded prompt of the odd length,
    over one row's frames) within ``LOGITS_TOL_FP32``."""
    import dataclasses

    import numpy as np

    from repro_torch import configs
    from repro_torch.kernels import bs_attn, dense_mm
    from repro_torch.models.model import LM
    from repro_torch.models.transformer import layer_specs

    cfg = configs.get(SEAMLESS)
    assert cfg.dtype == "bfloat16" and cfg.encoder_layers == 12
    counters = with_walks({"bs_attn": bs_attn.COUNTER,
                           "dense_mm": dense_mm.COUNTER})
    dev = torch.device("cuda", 0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = LM(cfg, device="cuda", seed=args.seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in lm.parameters())
    lens = list(SEAMLESS_PROMPTS)
    b_, s = len(lens), max(lens)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 71)
    frames = torch.randn((b_, cfg.frontend_len, cfg.d_model), generator=gen,
                         device=dev).to(lm.dtype)
    prompts = np.random.default_rng(args.seed + 73).integers(
        0, cfg.vocab_size, size=(b_, s))
    padded = prompts.copy()
    for i, n in enumerate(lens):
        padded[i, n:] = 0
    kw = dict(max_len=SEAMLESS_MAX_LEN, lens=lens, enc_frames=frames)
    greedy_run(torch, lm, padded, 2, counters, **kw)     # warm-up
    with torch.no_grad():
        enc = [lm._encode(frames) for _ in range(2)]
        del enc
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            lm._encode(frames)
        end.record()
    torch.cuda.synchronize()
    encoder_ms = start.elapsed_time(end) / 3
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.reset()
    run = greedy_run(torch, lm, padded, SEAMLESS_NEW, counters, **kw)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches, walks = split_walks({k: c.launches
                                   for k, c in counters.items()})
    check_tensor_core_walks("serve-seamless", walks, ("bs_attn",))
    check_dense_mm_walks("serve-seamless", walks)
    pre = run["prefill"]["launches"]
    per_step = sorted({st["launches"]["bs_attn"] for st in run["steps"]})
    if pre["bs_attn"] != 36 or per_step != [12] or pre["dense_mm"] <= 0:
        raise RuntimeError(f"[serve-seamless] bs_attn launches: prefill "
                           f"{pre['bs_attn']} (36 expected), per decode "
                           f"step {per_step} ([12] expected); dense_mm "
                           f"{pre['dense_mm']}")
    if not ((run["tokens"] >= 0) & (run["tokens"] < cfg.vocab_size)).all():
        raise RuntimeError("[serve-seamless] a token is outside the "
                           "vocabulary")
    cons = decode_vs_forward(torch, lm, prompts, lens, run,
                             enc_frames=frames)
    if max(cons.values()) > CONSISTENCY_TOL:
        raise RuntimeError(f"[serve-seamless] decode vs forward in bf16: "
                           f"{cons} (budget {CONSISTENCY_TOL})")
    frames_row = frames[2:3].clone()
    del lm, run["first"], run["last"]
    gc.collect()
    torch.cuda.empty_cache()
    # an fp32 copy at full depth from the same seed, on the odd-length
    # prompt's frames
    lm32 = LM(dataclasses.replace(cfg, dtype="float32"), device="cuda",
              seed=args.seed)
    fp32 = decode_consistency(torch, lm32, lens[2], args.seed + 75,
                              LOGITS_TOL_FP32, enc_frames=frames_row)
    del lm32
    gc.collect()
    torch.cuda.empty_cache()
    step_ms = [st["ms"] for st in run["steps"]]
    tokens = int(run["tokens"].size)
    return dict(params=n_params, init_s=init_s, batch=b_, prompt_lens=lens,
                prefill_len=s, frames=cfg.frontend_len,
                encoder_ms=encoder_ms, prefill_ms=run["prefill"]["ms"],
                decode_step_p50_ms=float(np.median(step_ms)),
                decode_step_ms=step_ms, tokens=tokens,
                wall_s=run["wall_s"], tokens_per_s=tokens / run["wall_s"],
                peak_mem_gb=peak, launches=launches, walks=walks,
                prefill_launches=pre, decode_step_bs_attn=per_step[0],
                consistency_bf16=cons, consistency_fp32=fp32,
                fp32_layers=cfg.encoder_layers + len(layer_specs(cfg)))


def train_seamless_phase(torch, args):
    """[train-seamless]: ``launch.train.train_loop`` on seamless-m4t-medium
    at full width and depth, bf16, from a seeded init, batch 4 x seq 512
    with 4 x 1024 seeded frames (``float_inputs``: two frame sets in
    turn, uploaded with the tokens into ``TrainProgram``'s float
    buffer), 10 AdamW steps eagerly and then replaying the captured step
    (``eager_and_graphs``: bit-equal, the loss falls; after each step
    the float buffer must equal that step's frames in bf16).  Fails unless
    every step launches bs_attn ``SEAMLESS_TRAIN_BS_ATTN`` times (the
    forward's 36 -- 12 encoder, 12 self, 12 cross -- and their recompute
    under ``remat="full"``; the attention backward is a plain recompute)
    on its wgmma walk, dense_mm on its 16-bit walks, and the graph is
    captured once."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.kernels import bs_attn, dense_mm

    cfg = configs.get(SEAMLESS)
    counters = with_walks({"bs_attn": bs_attn.COUNTER,
                           "dense_mm": dense_mm.COUNTER})
    rng = np.random.default_rng(args.seed + 77)
    shape = (SEAMLESS_TRAIN_BATCH, cfg.frontend_len, cfg.d_model)
    frames = [rng.standard_normal(shape, dtype=np.float32)
              for _ in range(2)]

    def float_inputs(step):
        return {"enc_frames": frames[step % 2]}

    def frames_landed(step, program):
        # the float buffer the step read holds the step's frames in the
        # model's dtype (on the card, after the step's own reads)
        fio = program.program.fio.view(shape)
        want = torch.as_tensor(frames[step % 2]).to(fio.device, fio.dtype)
        if not torch.equal(fio, want):
            raise RuntimeError(f"[train-seamless] step {step}: the float "
                               f"buffer does not hold the step's frames")

    eager, graph, check = eager_and_graphs(
        torch, "train-seamless", cfg, counters=counters, args=args,
        steps=TRAIN_STEPS, batch=SEAMLESS_TRAIN_BATCH,
        seq=SEAMLESS_TRAIN_SEQ, float_inputs=float_inputs,
        after_step=frames_landed)
    for r in (eager, graph):
        check_dense_mm_walks("train-seamless", r["walks"])
        check_tensor_core_walks("train-seamless", r["walks"], ("bs_attn",))
        per_step = sorted({st["bs_attn"] for st in r["launches_per_step"]})
        if per_step != [SEAMLESS_TRAIN_BS_ATTN]:
            raise RuntimeError(f"[train-seamless] bs_attn launches per "
                               f"step {per_step}: {SEAMLESS_TRAIN_BS_ATTN} "
                               f"expected")
    if (graph["captures"], graph["recaptures"]) != (1, 0):
        raise RuntimeError(f"[train-seamless] one capture expected: "
                           f"{graph['captures']}, re-captures "
                           f"{graph['recaptures']}")
    return dict(graph, eager=eager, check=check,
                frames=list(shape))


def vlm_internvl2_phase(torch, args):
    """[vlm-internvl2]: internvl2-1b as published (24 layers, d_model 896,
    GQA 14 / 2 of 64 with biased q/k/v, d_ff 4864, vocab 151655; dense
    FFNs) in bf16 from ``init(seed)``: 4 rows of 256 seeded patch
    embeddings and a 200-token prompt through ``prefill(frontend=)``
    (456 positions), then 15 greedy decode steps at positions offset by
    256 (16 new tokens), after a warm-up.  Fails unless bs_attn launched
    24 times in the prefill on its wgmma walk (none at decode: plain
    ``attend_decode``), dense_mm on its 16-bit walks, and decode matches
    ``forward``: bf16 at the prefill and at the last step within
    ``CONSISTENCY_TOL``, an fp32 copy at full depth (24 layers;
    ``decode_consistency`` on a seeded 200-token prompt after one row's
    patches) within ``LOGITS_TOL_FP32``."""
    import dataclasses

    import numpy as np

    from repro_torch import configs
    from repro_torch.kernels import bs_attn, dense_mm
    from repro_torch.models.model import LM
    from repro_torch.models.transformer import layer_specs

    cfg = configs.get(INTERNVL2)
    assert cfg.frontend == "vision" and cfg.dtype == "bfloat16"
    counters = with_walks({"bs_attn": bs_attn.COUNTER,
                           "dense_mm": dense_mm.COUNTER})
    dev = torch.device("cuda", 0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = LM(cfg, device="cuda", seed=args.seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    f = cfg.frontend_len
    gen = torch.Generator(device=dev).manual_seed(args.seed + 79)
    patches = torch.randn((VLM_BATCH, f, cfg.d_model), generator=gen,
                          device=dev).to(lm.dtype)
    prompts = np.random.default_rng(args.seed + 81).integers(
        0, cfg.vocab_size, size=(VLM_BATCH, VLM_PROMPT))
    lens = [f + VLM_PROMPT] * VLM_BATCH
    kw = dict(max_len=VLM_MAX_LEN, lens=lens, frontend=patches)
    greedy_run(torch, lm, prompts, 2, counters, **kw)    # warm-up
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.reset()
    run = greedy_run(torch, lm, prompts, VLM_NEW, counters, **kw)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches, walks = split_walks({k: c.launches
                                   for k, c in counters.items()})
    check_tensor_core_walks("vlm-internvl2", walks, ("bs_attn",))
    check_dense_mm_walks("vlm-internvl2", walks)
    pre = run["prefill"]["launches"]
    per_step = sorted({st["launches"]["bs_attn"] for st in run["steps"]})
    if pre["bs_attn"] != 24 or per_step != [0]:
        raise RuntimeError(f"[vlm-internvl2] bs_attn launches: prefill "
                           f"{pre['bs_attn']} (24 expected), per decode "
                           f"step {per_step} ([0] expected)")
    # forward's positions: the patch rows, then the text; its logits
    # cover the text, so the prefill's last position is the prompt's
    cons = decode_vs_forward(torch, lm, prompts, [VLM_PROMPT] * VLM_BATCH,
                             run, frontend=patches)
    if max(cons.values()) > CONSISTENCY_TOL:
        raise RuntimeError(f"[vlm-internvl2] decode vs forward in bf16: "
                           f"{cons} (budget {CONSISTENCY_TOL})")
    patches_row = patches[:1].clone()
    del lm, run["first"], run["last"]
    gc.collect()
    torch.cuda.empty_cache()
    lm32 = LM(dataclasses.replace(cfg, dtype="float32"), device="cuda",
              seed=args.seed)
    fp32 = decode_consistency(torch, lm32, VLM_PROMPT, args.seed + 83,
                              LOGITS_TOL_FP32, frontend=patches_row)
    del lm32
    gc.collect()
    torch.cuda.empty_cache()
    step_ms = [st["ms"] for st in run["steps"]]
    tokens = int(run["tokens"].size)
    return dict(init_s=init_s, batch=VLM_BATCH, patches=f,
                prompt=VLM_PROMPT, prefill_ms=run["prefill"]["ms"],
                decode_step_p50_ms=float(np.median(step_ms)),
                decode_step_ms=step_ms, tokens=tokens, wall_s=run["wall_s"],
                tokens_per_s=tokens / run["wall_s"], peak_mem_gb=peak,
                launches=launches, walks=walks, prefill_launches=pre,
                consistency_bf16=cons, consistency_fp32=fp32,
                fp32_layers=len(layer_specs(cfg)))


# [long]: the reference's long_500k cell (``configs.SHAPES``: decode,
# batch 1) through the retained ring cache: llama3.2-1b at full width
# and depth with every FFN block-sparse (d = 1/8, b = 16), bf16, the
# published retained_prefix 1024 + retained_window 4096 = 5120 slots; a
# seeded 5120-token prompt fills the ring, then LONG_STEPS greedy decode
# steps write slots 1024.. over the oldest window positions.  The fp32
# copy runs LONG_FP32_STEPS steps at LONG_FP32_LAYERS layers
LONG = "llama3.2-1b"
LONG_STEPS = 256
LONG_FP32_LAYERS, LONG_FP32_STEPS = 4, 32
# [serve-long]: gemma2-2b at full width (d = 1/8) through
# Engine(retained=True, batch=2, max_len=5120): 4 seeded requests of
# 3000..5100 prompt tokens, 16 new each, after 2 warm-up requests
SERVE_LONG = "gemma2-2b"
SERVE_LONG_BATCH, SERVE_LONG_MAX_LEN, SERVE_LONG_NEW = 2, 5120, 16
SERVE_LONG_PROMPTS = ((3000, 5100),) * 4
SERVE_LONG_WARMUP = ((64, 128),) * 2


def windowed_cfg(cfg):
    """``cfg`` with every attention layer local, window
    ``retained_window`` and prefix ``retained_prefix``: on a stack
    without local layers, the causal forward a ring decode equals (at
    position p the ring holds [0, g) and [p - w + 1, p], bs_attn's
    ``(r - c < w) | (c < g)``)."""
    import dataclasses
    groups = tuple((tuple(dataclasses.replace(s, mixer="attn_local")
                          for s in period), rep)
                   for period, rep in cfg.groups)
    return dataclasses.replace(cfg, groups=groups,
                               local_window=cfg.retained_window,
                               global_prefix=cfg.retained_prefix)


def ring_run(torch, lm, prompt, steps, *, graph, counters=None):
    """``prompt`` ``[B, g + w]`` prefilled into the ring, then ``steps``
    greedy ``decode_step(retained=True)``s through a
    ``serve/graphs.py`` ``Program`` (the engine's decode body: tokens and
    positions from its device buffer, the ring slot computed there),
    run eagerly or captured at its first call and replayed; each step
    loads its token and position and reads the sampled token back, as
    the engine's step does.  Returns the tokens ``[B, steps + 1]``, the
    prefill's and every step's logits (fp32, on the card), the prefill
    ms, each step's ms, the program's stats and, with ``counters``, the
    launches of the prefill and of the steps."""
    import numpy as np

    from repro_torch import sparse
    from repro_torch.serve.graphs import Program

    dev = lm.device
    b, ring = prompt.shape

    def reading():
        return {k: c.launches for k, c in (counters or {}).items()}

    torch.cuda.synchronize()
    before, t0 = reading(), time.perf_counter()
    logits, caches = lm.prefill(prompt, max_len=ring)
    tok = logits.argmax(-1)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_launches = {k: v - before[k] for k, v in reading().items()}
    out_logits = [logits.float()]

    def body(io):
        lg, _ = lm.decode_step(io[:b].view(b, 1), caches, io[b:],
                               retained=True)
        return torch.argmax(lg, -1), lg

    prog = Program("long decode", body, 2 * b, device=dev, graph=graph,
                   ctx=sparse.PlanContext(),
                   pool=torch.cuda.graph_pool_handle() if graph else None,
                   stream=torch.cuda.Stream(dev) if graph else None)
    cur = tok.cpu().numpy()
    toks, step_ms = [cur], []
    before = reading()
    for i in range(steps):
        t1 = time.perf_counter()
        prog.load(np.concatenate([cur, np.full(b, ring + i)]))
        nxt, lg = prog()
        cur = nxt.cpu().numpy()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        # the graph's logits are its own tensor: copied before the next
        # replay
        out_logits.append(lg.to(torch.float32, copy=True))
        toks.append(cur)
    torch.cuda.synchronize()
    step_launches = {k: v - before[k] for k, v in reading().items()}
    return dict(tokens=np.stack(toks, 1), logits=out_logits,
                prefill_ms=prefill_ms, step_ms=step_ms, stats=prog.stats(),
                prefill_launches=prefill_launches,
                step_launches=step_launches)


def ring_vs_windowed(torch, lm, prompt, run, seed):
    """Each logits row of ``run`` (a ``ring_run``) against
    ``windowed_cfg``'s forward over the prompt and the generated tokens,
    with the same weights (the same ``seed``ed init, checked equal): the
    rel-max error of the prefill and of every step, the forward's ms and
    its launches of bs_attn by walk."""
    import numpy as np

    from repro_torch.kernels.bs_attn import ops as bs_ops
    from repro_torch.models.model import LM

    wlm = LM(windowed_cfg(lm.cfg), device=lm.device, seed=seed)
    for a, b in zip(lm.parameters(), wlm.parameters()):
        if not torch.equal(a, b):
            raise RuntimeError("the windowed copy's weights differ")
    ring = prompt.shape[1]
    gen = run["tokens"]
    seq = np.concatenate([prompt, gen[:, :-1]], 1)
    before = {w: c.launches for w, c in bs_ops.WALK_COUNTERS.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full = wlm.forward(seq)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    walks = {w: c.launches - before[w]
             for w, c in bs_ops.WALK_COUNTERS.items()}
    errs = [rel_err(lg, full[:, ring - 1 + i])[0]
            for i, lg in enumerate(run["logits"])]
    del wlm, full
    return dict(errs=errs, forward_ms=fwd_ms, seq=int(seq.shape[1]),
                bs_attn_walks=walks)


def attend_decode_ms(torch, cfg, ring):
    """One ``attend_decode`` call at the ring's shape (batch 1, every
    slot visible), bf16 caches cast to fp32 inside (ROADMAP queue 2 item
    9), by CUDA events over rotated copies: its ms and the bytes its
    casts move against the bytes of reading the caches once in bf16."""
    from repro_torch.models.attention import attend_decode

    dev = torch.device("cuda", 0)
    h, kvh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(97)
    q = torch.randn((1, 1, h, dh), generator=gen, device=dev).bfloat16()
    k = torch.randn((1, ring, kvh, dh), generator=gen,
                    device=dev).bfloat16()
    v = torch.randn((1, ring, kvh, dh), generator=gen,
                    device=dev).bfloat16()
    lengths = torch.full((1,), ring, dtype=torch.long, device=dev)
    cache_bytes = 2 * k.numel() * 2
    sets = copies(lambda: (q.clone(), k.clone(), v.clone()), cache_bytes)
    ms = timed_ms(torch, lambda q_, k_, v_: attend_decode(
        q_, k_, v_, lengths=lengths), sets, 20)
    # each cast reads the bf16 cache and writes an fp32 copy that the
    # einsum reads back: 2 + 4 + 4 bytes an element, against 2
    return dict(ms=ms, cache_mb=cache_bytes / 1e6,
                cast_traffic_mb=5 * cache_bytes / 1e6,
                bound_ms=cache_bytes / 3.35e12 * 1e3)


def long_phase(torch, args):
    """[long]: the long_500k cell's batch (1) on llama3.2-1b at full width
    and depth, d = 1/8 FFNs, bf16, through the retained ring cache of
    the published 1024 + 4096 slots: a seeded 5120-token prompt, then
    ``LONG_STEPS`` greedy ``decode_step(retained=True)``s past the wrap,
    once eagerly and once replayed from a CUDA graph captured through
    ``serve/graphs.py``'s ``Program`` (the main path: its bs_attn, bsmm
    and dense_mm counters zeroed just before and read just after).  Fails
    unless the two runs' tokens are identical, bs_attn launched in the
    prefill (16, wgmma) and dense_mm and bsmm on their 16-bit walks, and
    every step's logits (and the prefill's) are within
    ``CONSISTENCY_TOL`` of the windowed forward over the prompt and the
    generated tokens (bs_attn with the global prefix at S = 5376); an
    fp32 copy at ``LONG_FP32_LAYERS`` layers, ``LONG_FP32_STEPS`` steps,
    within ``LOGITS_TOL_FP32``."""
    import dataclasses

    import numpy as np

    from repro_torch import configs
    from repro_torch.kernels import bs_attn, bsmm, dense_mm
    from repro_torch.launch.profile_train import cut_depth
    from repro_torch.models.model import LM

    shape = configs.SHAPES["long_500k"]
    cfg = configs.sparsify_ffn(configs.get(LONG), 1 / 8)
    assert cfg.dtype == "bfloat16" and not configs.is_native_long(cfg)
    g, w = cfg.retained_prefix, cfg.retained_window
    ring, b = g + w, shape["batch"]
    counters = with_walks({"bsmm": bsmm.COUNTER,
                           "dense_mm": dense_mm.COUNTER,
                           "bs_attn": bs_attn.COUNTER})
    t0 = time.perf_counter()
    lm = LM(cfg, device="cuda", seed=args.seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompt = np.random.default_rng(args.seed + 91).integers(
        0, cfg.vocab_size, size=(b, ring))
    ring_run(torch, lm, prompt, 2, graph=False)          # warm-up
    torch.cuda.reset_peak_memory_stats()
    eager = ring_run(torch, lm, prompt, LONG_STEPS, graph=False)
    for c in counters.values():
        c.reset()
    graph = ring_run(torch, lm, prompt, LONG_STEPS, graph=True,
                     counters=counters)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches, walks = split_walks({k: c.launches
                                   for k, c in counters.items()})
    check_tensor_core_walks("long", walks, ("bs_attn", "bsmm"))
    check_dense_mm_walks("long", walks)
    if not np.array_equal(eager["tokens"], graph["tokens"]):
        raise RuntimeError("[long] tokens differ between the eager and the "
                           "graph run")
    pre = graph["prefill_launches"]
    if pre["bs_attn"] != cfg.num_layers or graph["step_launches"][
            "bs_attn"] != 0 or min(launches["bsmm"],
                                   launches["dense_mm"]) <= 0:
        raise RuntimeError(f"[long] launches: prefill {pre}, steps "
                           f"{graph['step_launches']}")
    logits_equal = all(torch.equal(a, b_) for a, b_ in
                       zip(eager["logits"], graph["logits"]))
    del eager["logits"]
    cons = ring_vs_windowed(torch, lm, prompt, graph, args.seed)
    if not max(cons["errs"]) <= CONSISTENCY_TOL:
        raise RuntimeError(f"[long] ring decode vs the windowed forward "
                           f"in bf16: worst {max(cons['errs'])} (budget "
                           f"{CONSISTENCY_TOL})")
    decode_attn = attend_decode_ms(torch, cfg, ring)
    del lm, graph["logits"]
    gc.collect()
    torch.cuda.empty_cache()
    cfg32 = cut_depth(dataclasses.replace(cfg, dtype="float32"),
                      LONG_FP32_LAYERS)
    lm32 = LM(cfg32, device="cuda", seed=args.seed)
    run32 = ring_run(torch, lm32, prompt, LONG_FP32_STEPS, graph=False)
    cons32 = ring_vs_windowed(torch, lm32, prompt, run32, args.seed)
    del lm32, run32
    gc.collect()
    torch.cuda.empty_cache()
    if not max(cons32["errs"]) <= LOGITS_TOL_FP32:
        raise RuntimeError(f"[long] fp32 ring decode vs the windowed "
                           f"forward: worst {max(cons32['errs'])} (budget "
                           f"{LOGITS_TOL_FP32})")

    def p50(ms):
        return float(np.median(ms[1:]))
    tokens = int(graph["tokens"].size)
    return dict(
        init_s=init_s, batch=b, ring=ring, prefix=g, window=w,
        steps=LONG_STEPS, slots_written=[g, g + LONG_STEPS - 1],
        prefill_ms={"eager": eager["prefill_ms"],
                    "graphs": graph["prefill_ms"]},
        decode_step_p50_ms={"eager": p50(eager["step_ms"]),
                            "graphs": p50(graph["step_ms"])},
        tokens_per_s={"eager": tokens / (sum(eager["step_ms"])
                                         + eager["prefill_ms"]) * 1e3,
                      "graphs": tokens / (sum(graph["step_ms"])
                                          + graph["prefill_ms"]) * 1e3},
        program=graph["stats"], peak_mem_gb=peak, launches=launches,
        walks=walks, prefill_launches=pre,
        step_launches=graph["step_launches"], tokens_identical=True,
        logits_identical=logits_equal,
        consistency_bf16=dict(max=max(cons["errs"]),
                              prefill=cons["errs"][0],
                              last=cons["errs"][-1]),
        check_forward_ms=cons["forward_ms"], check_len=cons["seq"],
        check_bs_attn_walks=cons["bs_attn_walks"],
        consistency_fp32=dict(max=max(cons32["errs"]),
                              prefill=cons32["errs"][0],
                              last=cons32["errs"][-1]),
        fp32_layers=LONG_FP32_LAYERS, fp32_steps=LONG_FP32_STEPS,
        attend_decode=decode_attn)


def serve_long_prompt_lens(args):
    """The [serve-long] run's prompt lengths."""
    from repro_torch import configs
    return replay_prompt_lens(args.seed + 97,
                              configs.get(SERVE_LONG).vocab_size,
                              SERVE_LONG_WARMUP, SERVE_LONG_PROMPTS)


def serve_long_prefill_lens(args):
    """The length each [serve-long] prompt is prefilled at."""
    from repro_torch import configs
    cfg = configs.sparsify_ffn(configs.get(SERVE_LONG), 1 / 8)
    return prefill_lens(cfg, SERVE_LONG_MAX_LEN, serve_long_prompt_lens(args))


def record_calls(eng):
    """Record every program call of ``eng`` while it serves, in call
    order: the program's name, its inputs (``io``), the logits it
    sampled from (copied) and, for a decode step, the live slots.
    Returns the list and a function that stops the recording."""
    import numpy as np

    from repro_torch.serve import graphs

    calls = []
    load, read, step = graphs.Program.load, eng._read, eng.step

    def loading(prog, values, floats=()):
        calls.append(dict(name=prog.name,
                          io=np.array(values, np.int64), live=None))
        return load(prog, values, floats)

    def reading(out):
        calls[-1]["logits"] = out[1].float().clone()
        return read(out)

    def stepping():
        live = sorted(eng.live)
        done = step()
        if live:
            calls[-1]["live"] = live
        return done

    graphs.Program.load = loading
    eng._read, eng.step = reading, stepping

    def stop():
        graphs.Program.load = load
        eng._read, eng.step = read, step
    return calls, stop


def replay_calls(torch, lm, calls, *, batch, max_len, retained):
    """The recorded calls of an engine driven by hand: each prefill
    through ``LM.prefill`` (its padded tokens, ``last_index``) and its
    rows copied into its slot, each decode step through
    ``LM.decode_step(retained=)`` on the engine's tokens and positions,
    into caches of the engine's shape.  Returns the rel-max error of
    the engine's logits against the hand-driven ones (the live rows of
    a decode step) and whether every sampled token agrees."""
    caches = lm.init_cache(batch, max_len)
    worst, same = 0.0, True
    for c in calls:
        io = c["io"]
        if c["name"].startswith("prefill"):
            s = io.shape[0] - 2
            logits, rows = lm.prefill(io[None, :s], max_len=max_len,
                                      last_index=io[s:s + 1])
            slot = torch.as_tensor(io[s + 1:s + 2], device=lm.device)
            for cache, row in zip(caches, rows):
                for name in cache:
                    cache[name].index_copy_(0, slot, row[name])
            got, want = c["logits"], logits.float()
        else:
            logits, _ = lm.decode_step(io[:batch, None], caches,
                                       io[batch:], retained=retained)
            live = torch.as_tensor(c["live"], device=lm.device)
            got, want = c["logits"][live], logits.float()[live]
        worst = max(worst, rel_err(got, want)[0])
        same = same and torch.equal(got.argmax(-1), want.argmax(-1))
    return worst, same


def serve_long_phase(torch, args):
    """[serve-long]: gemma2-2b at full width and depth (26 layers, local
    and global, soft-caps) with every FFN block-sparse (d = 1/8, b = 16),
    bf16, through ``Engine(retained=True, batch=2, max_len=5120)`` (the
    ring of the published 1024 + 4096 slots; the engine stops a request
    at max_len - 1, so the ring does not wrap and ``retained`` turns the
    local layers' window filter off): 4 seeded requests of 3000..5100
    tokens, 16 new each, eagerly and through the engine's graphs
    (captured at startup; the main path, its counters zeroed just before
    and read just after).  Fails unless the tokens are identical,
    bs_attn, bsmm and dense_mm launched on their 16-bit walks, and the
    graph engine's calls, driven by hand through ``LM.prefill`` and
    ``LM.decode_step(retained=True)`` on the same inputs at the engine's
    batch (``replay_calls``), give logits within the bf16 kernel budget
    of the engine's and the same tokens.  (Driven at batch 1, gemma2's
    26 bf16 layers at random init amplify the other roundings of a batch
    of 1 past the bf16 model budget: a measurement of the batch, not of
    the ring.)  Returns ``(result, lm, engine)``."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.kernels import bs_attn, bsmm, dense_mm
    from repro_torch.models.model import LM
    from repro_torch.serve import Engine, Request

    cfg = configs.sparsify_ffn(configs.get(SERVE_LONG), 1 / 8)
    assert cfg.dtype == "bfloat16" and not configs.is_native_long(cfg)
    assert cfg.retained_prefix + cfg.retained_window == SERVE_LONG_MAX_LEN
    counters = with_walks({"bs_attn": bs_attn.COUNTER, "bsmm": bsmm.COUNTER,
                           "dense_mm": dense_mm.COUNTER})
    t0 = time.perf_counter()
    lm = LM(cfg, device="cuda", seed=args.seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in lm.parameters())
    rng = np.random.default_rng(args.seed + 97)

    def request(uid, lo, hi, n_new):
        return Request(uid=uid, prompt=rng.integers(
            0, cfg.vocab_size, size=int(rng.integers(lo, hi + 1))),
            max_new_tokens=n_new)

    kw = dict(batch=SERVE_LONG_BATCH, max_len=SERVE_LONG_MAX_LEN,
              retained=True, device="cuda")
    Engine(lm, graphs=False, warm_plans=False, **kw).run(
        [request(i, lo, hi, 2)
         for i, (lo, hi) in enumerate(SERVE_LONG_WARMUP)])
    prompts = [request(i, lo, hi, SERVE_LONG_NEW).prompt
               for i, (lo, hi) in enumerate(SERVE_LONG_PROMPTS)]
    if [len(p) for p in prompts] != serve_long_prompt_lens(args):
        raise RuntimeError("serve_long_prompt_lens does not replay the run")
    torch.cuda.reset_peak_memory_stats()
    eager = serve_run(torch, Engine(lm, graphs=False, **kw), prompts,
                      SERVE_LONG_NEW)
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(lm, warm_compile=True, **kw)
    assert eng.retained
    calls, stop = record_calls(eng)
    torch.cuda.synchronize()
    for c in counters.values():
        c.reset()
    try:
        run = serve_run(torch, eng, prompts, SERVE_LONG_NEW)
    finally:
        stop()
    launches, walks = split_walks({k: c.launches
                                   for k, c in counters.items()})
    check_tensor_core_walks("serve-long", walks, ("bs_attn", "bsmm"))
    check_dense_mm_walks("serve-long", walks)
    graphs = graphs_line(eager, run)
    reqs, wall, st = run["reqs"], run["wall_s"], run["stats"]
    for name, count in launches.items():
        if count <= 0:
            raise RuntimeError(f"kernel {name} was not launched in "
                               f"[serve-long]")
    # the engine's calls driven by hand through the LM's entry points
    hand_err, hand_tokens = replay_calls(
        torch, lm, calls, batch=SERVE_LONG_BATCH, max_len=SERVE_LONG_MAX_LEN,
        retained=True)
    n_calls = len(calls)
    del calls
    if not (hand_err <= KERNEL_TOL["bfloat16"] and hand_tokens):
        raise RuntimeError(f"[serve-long] the engine's logits vs "
                           f"decode_step(retained=True) by hand: {hand_err} "
                           f"(budget {KERNEL_TOL['bfloat16']}), tokens "
                           f"equal {hand_tokens}")
    tokens = sum(len(r.output) for r in reqs)
    return dict(
        params=n_params, init_s=init_s, requests=len(reqs),
        prompt_lens=[int(len(r.prompt)) for r in reqs],
        prefill_lens=[int(r.bucket or len(r.prompt)) for r in reqs],
        tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
        prefill_p50_ms=st["prefill_latency"]["p50_ms"],
        decode_step_p50_ms=st["step_latency"]["p50_ms"],
        decode_steps=st["steps"], launches=launches, walks=walks,
        buckets=list(eng.buckets), peak_mem_gb=run["peak_mem_gb"],
        graphs=graphs, plans=served_plans(eng),
        engine_vs_hand=dict(calls=n_calls, rel_err=hand_err,
                            tokens_equal=hand_tokens)), lm, eng


def long_attn_shapes(args):
    """[attn] rows at the long-context paths' bs_attn shapes, each with
    its window and global prefix: [long]'s plain check (llama's 32 / 8
    heads of 64, causal, window 4096, prefix 1024, S = 5120 + 256; the
    configs' tiles of 512 halve to 256 there) and [serve-long]'s gemma2
    local layers at its prefill lengths (window 4096, soft-cap 50).
    Each: name, the path whose launches it reads, S, heads, kv heads,
    head dim, window, prefix, soft-cap, scale."""
    from repro_torch import configs
    lc = configs.get(LONG)
    check_len = lc.retained_prefix + lc.retained_window + LONG_STEPS
    rows = [("llama long check", "long", check_len, lc.num_heads,
             lc.num_kv_heads, lc.head_dim, lc.retained_window,
             lc.retained_prefix, None, 1 / math.sqrt(lc.head_dim))]
    gc_ = configs.get(SERVE_LONG)
    for s in sorted(set(serve_long_prefill_lens(args))):
        rows.append(("gemma2 local long served", "serve_long", s,
                     gc_.num_heads, gc_.num_kv_heads, gc_.head_dim,
                     gc_.local_window, gc_.global_prefix, gc_.attn_softcap,
                     gc_.attn_scale))
    return tuple(rows)


def long_attn_rows(torch, args, gen):
    """bs_attn against its plain version at ``long_attn_shapes`` (the
    walk ``attend_train`` builds there, the window and the global prefix
    in its element mask), bf16 and fp32, each beside one library call
    with the same mask (``attn_library``: SDPA with the element mask as
    its boolean mask, or compiled ``flex_attention`` where a soft-cap
    rules SDPA out); the bound counts the visible element pairs."""
    from repro_torch.kernels.bs_attn import ops as bs_ops
    from repro_torch.kernels.bs_attn.ref import attend_plain
    from repro_torch.models import attention

    dev = torch.device("cuda", 0)
    rows = []
    for (name, path, s, h, kvh, dh, window, prefix, softcap,
         scale) in long_attn_shapes(args):
        spec = attention.attn_spec(s, s, dh, window=window,
                                   global_prefix=prefix, softcap=softcap,
                                   scale=scale)
        walk = spec.walk(dev)
        el = spec.element_mask(dev)
        pairs = int(el.sum().item())
        for dname, dt in (("bfloat16", torch.bfloat16),
                          ("float32", torch.float32)):
            es = torch.empty((), dtype=dt).element_size()
            q = torch.randn((1, s, h, dh), generator=gen, device=dev).to(dt)
            k = torch.randn((1, s, kvh, dh), generator=gen,
                            device=dev).to(dt)
            v = torch.randn((1, s, kvh, dh), generator=gen,
                            device=dev).to(dt)
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * es
            sets = copies(lambda: (q.clone(), k.clone(), v.clone()), nbytes)
            library, lib_name = attn_library(torch, s, window, prefix,
                                             softcap, spec.scale)

            def plain(q_, k_, v_):
                return attend_plain(q_, k_, v_, el, scale=spec.scale,
                                    softcap=softcap)
            lib_err = rel_err(library(q, k, v), plain(q, k, v))[0]

            def kernel(q_, k_, v_, plan=None):
                return bs_ops.bs_attn_cuda(q_, k_, v_, walk,
                                           scale=spec.scale,
                                           softcap=softcap, window=window,
                                           global_prefix=prefix, plan=plan)
            row = measured_row(torch, "bs_attn", name, s, dname, kernel,
                               plain, library, sets, sets, nbytes,
                               4.0 * pairs * dh * h)
            row["walk"] = bs_ops.kernel_walk(dt)
            row["before_ms"] = (timed_ms(
                torch, lambda *a: kernel(*a, plan="cuda_core"), sets, 4)
                if dt != torch.float32 else None)
            row.update(heads=h, kv_heads=kvh, head_dim=dh, window=window,
                       prefix=prefix, softcap=softcap, tile=spec.tile_q,
                       library=lib_name, library_rel_err=lib_err, path=path,
                       tiles_visited=int(spec.block_mask().sum()),
                       element_pairs=pairs, group=walk.group)
            rows.append(row)
            del sets, q, k, v
        del el, walk
    return rows


def print_ssm(label, name, r):
    """A served SSM model's summary, [graphs] and prefill lines."""
    print_serve(label, name, r)
    print(f"[{label}] exact-length prefills {json.dumps(r['exact_prefills'])}"
          f", prefill p50 eager / graphs run "
          f"{json.dumps(r['graphs']['prefill_p50_ms'])} ms; each prefill (tokens, SSD chunk length x chunks, ms eager / "
          f"graphs run): "
          + "; ".join(f"{p['tokens']} ({p['chunk_len']} x {p['chunks']}) "
                      f"{p['ms_eager']:.2f} / {p['ms_graphs']:.2f}"
                      for p in r["prefills"]))
    c = r["consistency"]
    print(f"[{label}] decode after a {c['prompt']}-token prompt vs forward: "
          f"bf16 every mamba layer on the same inputs, worst "
          f"{max(c['bf16_layers'].values()):.3e} (budget {CONSISTENCY_TOL}; "
          f"by layer {json.dumps(c['bf16_layers'])}); end to end fp32 at "
          f"the same seeded weights {json.dumps(c['fp32'])}, after a "
          f"1-token prompt {json.dumps(c['fp32_prompt_1'])}, a 2-token "
          f"prompt {json.dumps(c['fp32_prompt_2'])} (budget "
          f"{LOGITS_TOL_FP32}); end to end bf16 "
          f"{json.dumps(c['bf16_end_to_end'])} (not held: 24 bf16 layers "
          f"at random init amplify their roundings)")


def print_moe(label, r):
    """A served MoE model's routing drops and its one-layer gmm check."""
    print(f"[{label}] dropped_frac per prefill (mean, max over "
          f"{r['moe_layers']} MoE layers): "
          f"{json.dumps(r['dropped_frac_per_prefill'])}; decode steps: "
          f"{json.dumps(r['decode_dropped_frac'])}")
    ml = r["moe_layer"]
    print(f"[{label}] layer {ml['layer']} moe_apply on a {ml['tokens']}-"
          f"token prefill state (C={ml['capacity']}, dropped "
          f"{ml['dropped_frac']:.4f}; gmm tiles {json.dumps(ml['tiles'])}): "
          f"gmm route vs plain rel err {ml['rel_err']:.2e} (budget "
          f"{ml['tol']}), gmm launches {ml['gmm_launches']} (plain route "
          f"{ml['plain_route_gmm_launches']})")


def print_serve(label, name, r):
    """A served model's summary line, its [graphs] line and its plans."""
    print(f"[{label}] {r['params'] / 1e9:.2f} B parameters initialised on "
          f"the card in {r['init_s']:.2f}s; {r['requests']} requests "
          f"(prompts {r['prompt_lens']}, prefilled at {r['prefill_lens']}; "
          f"buckets {r['buckets']}), {r['tokens']} tokens in "
          f"{r['wall_s']:.3f}s = {r['tokens_per_s']:.2f} tok/s; prefill "
          f"p50 {r['prefill_p50_ms']} ms, decode step p50 "
          f"{r['decode_step_p50_ms']} ms; launches "
          f"{json.dumps(r['launches'])}; launches by walk "
          f"{json.dumps(r['walks'])}; peak memory {r['peak_mem_gb']:.2f} "
          f"GiB")
    print_graphs(name, r["graphs"])
    print(f"[{label}] plans {json.dumps(r['plans'])}")


# [evolve]: RigL topology steps on llama3.2-1b's sparse FFN at full width
# (up and gate 2048 -> 8192, down 8192 -> 2048, d = 1/8, b = 16, bf16):
# N = 2048 tokens (batch 4 x seq 512), MSE loss, AdamW, a topology step
# every EVOLVE_EVERY steps on all three projections at EVOLVE_FRACTION
# (1638 of 8192 blocks each, as the reference's loop test moves 20 %)
EVOLVE_STEPS, EVOLVE_WARMUP, EVOLVE_EVERY = 20, 2, 2
EVOLVE_FRACTION, EVOLVE_LR = 0.2, 1e-3


def evolve_phase(torch, args):
    """[evolve]: a ``SparseFFN`` at llama width trained ``EVOLVE_STEPS``
    AdamW steps (after ``EVOLVE_WARMUP`` untimed ones that build its
    plans), with a RigL topology step (``rigl_evolve`` on each
    projection's plan, then ``evolve_sparse_layer``: the values, the
    module's plans and AdamW's master copy and moments carried) after
    every ``EVOLVE_EVERY``-th.  Fails unless the loss is finite, nnz is
    constant, no route decision or measurement follows the warm-up, each
    plan is at generation 10, every 16-bit bsmm and sddmm launch is on
    its tensor-core walk, the steps between topology steps synchronise
    no more than the steps before the first one, and the last
    generation's forward, dL/dx and dL/dvalues on each projection equal
    the plain formulation (``core/static_sparse``) on its pattern.  The
    kernels' counters cover the timed steps and topology steps only."""
    import numpy as np

    from repro_torch import sparse
    from repro_torch.core import pruning, static_sparse
    from repro_torch.core.sparse_layers import SparseFFN
    from repro_torch.kernels import bsmm, dense_mm, sddmm
    from repro_torch.optim.adamw import adamw_init, adamw_update
    from repro_torch.train.step import (TrainState, evolve_sparse_layer,
                                        rigl_evolve)

    dev = torch.device("cuda", 0)
    dt = torch.bfloat16
    d_model, d_ff, b, density, n = 2048, 8192, 16, 1 / 8, 4 * 512
    sparse.reset()
    gen = torch.Generator(device=dev).manual_seed(args.seed + 23)
    ffn = SparseFFN(d_model, d_ff, b, density, dtype=dt, device=dev)
    lins = {"up": ffn.up, "gate": ffn.gate, "down": ffn.down}
    for lyr in lins.values():
        lyr.reset_parameters(gen)
    ffn.requires_grad_(True)
    params = {name: lyr.values for name, lyr in lins.items()}
    state = TrainState(0, params, adamw_init(params))
    nnz = {name: lyr.nnz_blocks for name, lyr in lins.items()}
    x = torch.randn((n, d_model), generator=gen, device=dev).to(dt)
    target = torch.randn((n, d_model), generator=gen, device=dev).to(dt)
    # each projection's input and output gradient of the step before a
    # topology step: RigL's dense gradient dy^T . x
    seen, keep = {}, [False]

    def hook(name):
        def fwd(mod, inp, out):
            if keep[0]:
                seen[name] = [inp[0].detach(), None]
                out.register_hook(
                    lambda g: seen[name].__setitem__(1, g.detach()))
        return fwd

    hooks = [lyr.register_forward_hook(hook(name))
             for name, lyr in lins.items()]

    def step():
        y = ffn(x)
        loss = ((y.float() - target.float()) ** 2).mean()
        grads = torch.autograd.grad(loss, list(params.values()))
        adamw_update(dict(zip(params, grads)), state.opt, state.params,
                     lr=EVOLVE_LR, weight_decay=0.0)
        return loss.detach()

    # the last warm-up step keeps its activations as a step before a
    # topology step does, so the allocator holds those blocks already
    for w in range(EVOLVE_WARMUP):
        keep[0] = w == EVOLVE_WARMUP - 1
        step()
    keep[0] = False
    seen.clear()
    torch.cuda.synchronize()
    counters = with_walks({"bsmm": bsmm.COUNTER, "sddmm": sddmm.COUNTER,
                           "dense_mm": dense_mm.COUNTER})
    for c in counters.values():
        c.reset()
    stats0 = sparse.cache_stats()
    losses, events, syncs = [], [], []
    topo, gib, moved = [], [], []
    for i in range(EVOLVE_STEPS):
        last = (i + 1) % EVOLVE_EVERY == 0
        keep[0] = last
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                ev[0].record()
                losses.append(step())
                ev[1].record()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs.append(sum(1 for w in caught if "synchroniz" in str(w.message)
                         and "prototype" not in str(w.message)))
        events.append(ev)
        keep[0] = False
        if not last:
            continue
        row = {}
        for name, lyr in lins.items():
            xin, dy = seen.pop(name)
            dense_grad = torch.matmul(dy.reshape(-1, dy.shape[-1]).t(),
                                      xin.reshape(-1, xin.shape[-1]))
            p = lyr.plan(n)
            vals = lyr.values.detach()
            # rigl_update alone on the same inputs (device time), the
            # part of the step that a captured train step would hold
            mask_dev = torch.zeros((lyr.out_features // b,
                                    lyr.in_features // b), dtype=torch.bool,
                                   device=dev)
            mask_dev[torch.as_tensor(lyr.row_idx, device=dev).long(),
                     torch.as_tensor(lyr.col_idx, device=dev).long()] = True
            e0, e1 = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            w_dense = lyr.as_bsr().to_dense().detach()
            torch.cuda.synchronize()
            e0.record()
            pruning.rigl_update(w_dense, dense_grad, mask_dev, block_size=b,
                                fraction=EVOLVE_FRACTION,
                                generator=torch.Generator(
                                    device=dev).manual_seed(i))
            e1.record()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p2, v2 = rigl_evolve(p, vals, dense_grad,
                                 fraction=EVOLVE_FRACTION, generator=gen)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            mask = np.zeros((lyr.out_features // b, lyr.in_features // b),
                            bool)
            mask[p2.pattern] = True
            ep = evolve_sparse_layer(state, name, lyr, mask)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if lyr.plan(n) is not p2 or not torch.equal(lyr.values.detach(),
                                                        v2):
                raise RuntimeError(f"[evolve] {name}: the module did not "
                                   f"take rigl_evolve's plan and values")
            moved.append((name, ep.dropped, ep.grown))
            row[name] = dict(rigl_update_ms=e0.elapsed_time(e1),
                             rigl_evolve_ms=(t1 - t0) * 1e3,
                             module_carry_ms=(t2 - t1) * 1e3)
            del p, p2, v2, dense_grad, w_dense, mask_dev
        topo.append(row)
        gib.append(torch.cuda.memory_allocated() / 2 ** 30)
    for h in hooks:
        h.remove()
    torch.cuda.synchronize()
    launches, walks = split_walks({k: c.launches
                                   for k, c in counters.items()})
    stats1 = sparse.cache_stats()
    step_ms = [a.elapsed_time(z) for a, z in events]
    loss_vals = torch.stack(losses).tolist()
    gens = {name: lyr.plan(n).explain()["evolution"]
            for name, lyr in lins.items()}
    # the last generation against the plain formulation on its pattern
    errs = {}
    g = torch.Generator(device=dev).manual_seed(args.seed + 29)
    for name, lyr in lins.items():
        xin = torch.randn((n, lyr.in_features), generator=g,
                          device=dev).to(dt).requires_grad_(True)
        gy = torch.randn((n, lyr.out_features), generator=g,
                         device=dev).to(dt)
        lyr.values.grad = None
        y = lyr(xin)
        y.backward(gy)
        f = static_sparse.make_spmm(lyr.row_idx, lyr.col_idx,
                                    (lyr.out_features // b,
                                     lyr.in_features // b), b)
        v = lyr.values.detach().clone().requires_grad_(True)
        xt = xin.detach().t().contiguous().requires_grad_(True)
        y_ref = f(v, xt)
        y_ref.backward(gy.t())
        errs[name] = {"y": rel_err(y.detach(), y_ref.detach().t())[0],
                      "dx": rel_err(xin.grad, xt.grad.t())[0],
                      "dvalues": rel_err(lyr.values.grad, v.grad)[0]}
    torch.cuda.synchronize()
    first = EVOLVE_EVERY           # the first step after a topology step
    per_proj = {name: {k: float(np.median([r[name][k] for r in topo]))
                       for k in topo[0][name]} for name in lins}
    result = dict(
        d_model=d_model, d_ff=d_ff, b=b, density=density, tokens=n,
        steps=EVOLVE_STEPS, every=EVOLVE_EVERY, fraction=EVOLVE_FRACTION,
        losses=loss_vals, step_ms=step_ms,
        step_p50_ms_before=float(np.median(step_ms[:first])),
        step_p50_ms_after=float(np.median(step_ms[first:])),
        topology_ms=topo, topology_ms_p50=per_proj,
        gib_per_generation=gib,
        gib_growth_per_generation=((gib[-1] - gib[0]) / (len(gib) - 1)
                                   if len(gib) > 1 else 0.0),
        moved=moved, generations={k: v["generation"]
                                  for k, v in gens.items()},
        reraces=sum(int(v["reraced"]) for v in gens.values()),
        decisions_after_warmup=stats1["decisions"] - stats0["decisions"],
        measurements_after_warmup=(stats1["measurements"]
                                   - stats0["measurements"]),
        plans_built_after_warmup=(stats1["plans_built"]
                                  - stats0["plans_built"]),
        syncs_per_step=syncs, launches=launches, walks=walks, errs=errs,
        tol=KERNEL_TOL["bfloat16"],
        evolution_totals=sparse.plan_report()["totals"]["evolution"])
    n_gen = EVOLVE_STEPS // EVOLVE_EVERY
    want_moved = int(np.float32(nnz["up"]) * np.float32(EVOLVE_FRACTION))
    if not all(math.isfinite(v) for v in loss_vals):
        raise RuntimeError(f"[evolve] non-finite loss: {loss_vals}")
    if any(lyr.nnz_blocks != nnz[name] or lyr.values.shape[0] != nnz[name]
           for name, lyr in lins.items()) \
            or any(d != want_moved or gr != want_moved
                   for _, d, gr in moved):
        raise RuntimeError(f"[evolve] nnz did not hold or the moves were "
                           f"not {want_moved}: {moved}")
    if result["decisions_after_warmup"] or \
            result["measurements_after_warmup"] or result["reraces"]:
        raise RuntimeError(f"[evolve] route decisions or measurements "
                           f"after the warm-up: {result}")
    if any(v != n_gen for v in result["generations"].values()):
        raise RuntimeError(f"[evolve] generations "
                           f"{result['generations']} != {n_gen}")
    check_tensor_core_walks("evolve", walks, ("sddmm", "bsmm"))
    if launches["bsmm"] <= 0 or launches["sddmm"] <= 0:
        raise RuntimeError(f"[evolve] bsmm or sddmm not launched: "
                           f"{launches}")
    if max(syncs[first:]) > max(syncs[:first]):
        raise RuntimeError(f"[evolve] a step after a topology step waited "
                           f"for the device more often than before: "
                           f"{syncs}")
    bad = {k: v for k, v in errs.items()
           if not all(e <= result["tol"] for e in v.values())}
    if bad:
        raise RuntimeError(f"[evolve] the last generation disagrees with "
                           f"the plain formulation: {bad}")
    del ffn, state, params, lins
    sparse.reset()
    return result


def evolve_serve_phase(torch, lm, args):
    """[evolve] serving guard: llama3.2-1b through the engine's CUDA
    graphs, then the up projection of all 16 layers evolved onto one new
    mask (a RigL step on layer 0's weights and a seeded dense gradient:
    the JAX LM shares one pattern across its layers), then the same
    requests again.  Fails unless every program that replays after the
    evolve was re-captured once first (its graph held the superseded
    plans), the evolve made no route decision, and the tokens equal a
    fresh engine's on the evolved model."""
    import numpy as np

    from repro_torch import sparse
    from repro_torch.core import pruning
    from repro_torch.core.sparse_layers import SparseFFN
    from repro_torch.serve import Engine

    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, lm.cfg.vocab_size,
                            size=int(rng.integers(lo, hi + 1)))
               for lo, hi in LLAMA_PROMPTS]
    kw = dict(batch=4, max_len=LLAMA_MAX_LEN, device="cuda",
              warm_compile=True)
    sparse.reset()
    eng = Engine(lm, **kw)
    g0 = eng.stats()["graphs"]
    first = serve_run(torch, eng, prompts, LLAMA_NEW)
    ffns = [m for m in lm.modules() if isinstance(m, SparseFFN)]
    up = ffns[0].up
    dev = up.values.device
    gen = torch.Generator(device=dev).manual_seed(args.seed + 31)
    b = up.block_size
    mask = torch.zeros((up.out_features // b, up.in_features // b),
                       dtype=torch.bool, device=dev)
    mask[torch.as_tensor(up.row_idx, device=dev).long(),
         torch.as_tensor(up.col_idx, device=dev).long()] = True
    new_mask = pruning.rigl_update(
        up.as_bsr().to_dense().detach(),
        torch.randn((up.out_features, up.in_features), generator=gen,
                    device=dev),
        mask, block_size=b, fraction=EVOLVE_FRACTION,
        generator=gen).cpu().numpy()
    s0 = sparse.cache_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eps = [f.up.evolve(new_mask) for f in ffns]
    torch.cuda.synchronize()
    evolve_s = time.perf_counter() - t0
    decisions = sparse.cache_stats()["decisions"] - s0["decisions"]
    stale = sorted(p.name for p in eng.programs() if p.superseded())
    replays = {p.name: p.replays for p in eng.programs()}
    second = serve_run(torch, eng, prompts, LLAMA_NEW)
    replayed = [p for p in eng.programs() if p.replays > replays[p.name]]
    g1 = eng.stats()["graphs"]
    fresh = serve_run(torch, Engine(lm, **kw), prompts, LLAMA_NEW)
    out = dict(
        layers=len(ffns), moved=[(e.dropped, e.grown) for e in eps[:1]],
        evolve_s=evolve_s, decisions=decisions, stale=stale,
        replayed=sorted(p.name for p in replayed),
        recaptured=sorted(p.name for p in replayed if p.recaptures == 1),
        recapture_s=g1["capture_s"] - g0["capture_s"],
        decode_p50_ms_before=first["stats"]["step_latency"]["p50_ms"],
        decode_p50_ms_after=second["stats"]["step_latency"]["p50_ms"],
        tokens_changed=[r.output for r in first["reqs"]]
        != [r.output for r in second["reqs"]],
        tokens_equal_fresh=[r.output for r in second["reqs"]]
        == [r.output for r in fresh["reqs"]])
    if decisions or not replayed \
            or any(p.recaptures != 1 for p in replayed) \
            or not {p.name for p in replayed} <= set(stale):
        raise RuntimeError(f"[evolve] a program replayed a superseded plan "
                           f"or was not re-captured once: {out}")
    if not out["tokens_equal_fresh"]:
        raise RuntimeError(f"[evolve] tokens after the evolve differ from "
                           f"a fresh engine on the evolved model: {out}")
    del eng
    sparse.reset()
    return out


def evolve_dynamic_row(torch, args):
    """[evolve] dynamic row: a ``DynamicSparseLinear`` at llama width
    (2048 -> 8192, d_max 1/8, b 16, bf16, the dsmm walk) whose mask comes
    from ``rigl_update`` (its weight, RigL's dense gradient dy^T . x of a
    seeded batch), its output against the plain formulation
    (``_dspmm``) on that mask."""
    from repro_torch.core import dynamic_sparse as dsp
    from repro_torch.core import pruning
    from repro_torch.core.sparse_layers import DynamicSparseLinear
    from repro_torch.kernels.dsmm import ops as dsmm_ops

    dev = torch.device("cuda", 0)
    dt, b, n = torch.bfloat16, 16, 2048
    gen = torch.Generator(device=dev).manual_seed(args.seed + 37)
    layer = DynamicSparseLinear(2048, 8192, b, 1 / 8, dtype=dt,
                                backend="pallas", device=dev)
    layer.reset_parameters(gen, mask_seed=args.seed + 41)
    x = torch.randn((n, 2048), generator=gen, device=dev).to(dt)
    gy = torch.randn((n, 8192), generator=gen, device=dev).to(dt)
    before = layer.mask.clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new = pruning.rigl_update(layer.weight.detach(),
                              torch.matmul(gy.t(), x), layer.mask,
                              block_size=b, fraction=EVOLVE_FRACTION,
                              generator=gen)
    layer.set_mask(new)
    torch.cuda.synchronize()
    update_ms = (time.perf_counter() - t0) * 1e3
    c0 = dsmm_ops.COUNTER.launches
    with torch.no_grad():
        y = layer(x)
        op = layer.encode()
        want = dsp._dspmm(op.values, op.row_idx, op.col_idx, x.t(),
                          8192 // b, b).t()
    torch.cuda.synchronize()
    out = dict(moved=int((new & ~before).sum().item()),
               nnz_same=int(new.sum().item()) == int(before.sum().item()),
               rel_err=rel_err(y, want)[0], tol=KERNEL_TOL["bfloat16"],
               dsmm_launches=dsmm_ops.COUNTER.launches - c0,
               update_ms=update_ms)
    if not (out["nnz_same"] and out["moved"] > 0
            and out["rel_err"] <= out["tol"] and out["dsmm_launches"] > 0):
        raise RuntimeError(f"[evolve] the RigL-driven dynamic layer "
                           f"failed: {out}")
    return out


# [tp]: tensor parallelism of llama3.2-1b's sparse FFN (d = 1/8, b = 16,
# bf16): its up/gate and down patterns at full width, at the decode and
# the training token counts, over q k-shards, balanced and even splits;
# the explicit route over 2 gloo ranks on this one card; and the engine
# with an abstract (1, 4) ("data", "model") mesh
TP_SHAPES = (("up/gate", 8192, 2048), ("down", 2048, 8192))
TP_NS = (4, 2048)
TP_QS = (2, 4)
TP_MESH = ((1, 4), ("data", "model"))
TP_RANKS = 2


def tp_problem(torch, m, k, n, seed):
    """One seeded FFN problem, made on the CPU so every process of the
    phase holds the same numbers: the bf16 BSR (d = 1/8, b = 16), x [n,
    k] and the output's gradient dy [n, m], on the card."""
    from repro_torch.core import masks
    from repro_torch.core.bsr import BlockSparseMatrix
    mask = masks.random_block_mask(m, k, 16, 1 / 8, seed=seed)
    g = torch.Generator().manual_seed(seed)
    vals = (torch.randn((int(mask.sum()), 16, 16), generator=g)
            / math.sqrt(k / 8)).to(torch.bfloat16).cuda()
    x = torch.randn((n, k), generator=g).to(torch.bfloat16).cuda()
    dy = torch.randn((n, m), generator=g).to(torch.bfloat16).cuda()
    return BlockSparseMatrix.from_mask(mask, 16, values=vals), x, dy


def tp_plain(torch, bsr, x, dy):
    """The plain version in fp32: y, dL/dx and dL/dvalues (the dense
    product's blocks at the pattern)."""
    w = bsr.to_dense().float()
    mb, kb = bsr.grid
    dw = (dy.float().t() @ x.float()).reshape(mb, 16, kb, 16).permute(
        0, 2, 1, 3)
    rows = torch.as_tensor(bsr.row_idx, dtype=torch.long, device="cuda")
    cols = torch.as_tensor(bsr.col_idx, dtype=torch.long, device="cuda")
    return x.float() @ w.t(), dy.float() @ w, dw[rows, cols]


def tp_counts(counters):
    return split_walks({k: c.launches for k, c in counters.items()})


def tp_call(torch, counters, fn):
    """``fn()`` with the launch counters zeroed just before it; its result
    and the launches (by kernel, by walk) it made."""
    torch.cuda.synchronize()
    for c in counters.values():
        c.reset()
    out = fn()
    torch.cuda.synchronize()
    return out, tp_counts(counters)


def tp_forward_backward(torch, counters, p, vals, x, dy):
    """One forward and one backward of plan ``p`` under autograd; each
    direction's launches counted apart."""
    v = vals.clone().requires_grad_(True)
    xx = x.clone().requires_grad_(True)
    y, fwd = tp_call(torch, counters, lambda: p.spmm_nt(v, xx))
    _, bwd = tp_call(torch, counters, lambda: y.backward(dy))
    return y.detach(), xx.grad, v.grad, fwd, bwd


def tp_check_walks(label, walks):
    off = {w: n for w, n in walks["bsmm"].items()
           if n and w not in ("mma", "decode")}
    off.update({f"sddmm:{w}": n for w, n in walks["sddmm"].items()
                if n and w != "mma"})
    if off:
        raise RuntimeError(f"[tp] {label}: launches off the tensor-core "
                           f"walks {off}")


def tp_plan_rows(torch, args):
    """``static_tp`` at llama's FFN shapes against the fp32 plain version
    and the unsharded plan (``mode="static"``): forward, dL/dx and
    dL/dvalues within bf16 2e-2; fails unless a forward call launches
    bsmm ``q`` times (mma or decode walk) and a backward ``q`` dL/dx
    walks and ``q`` SDDMMs.  Device ms by CUDA events beside the
    unsharded plan's (``q`` launches on one card against one: a record,
    not a speed claim)."""
    from repro_torch import sparse
    from repro_torch.kernels import bsmm, sddmm
    counters = with_walks({"bsmm": bsmm.COUNTER, "sddmm": sddmm.COUNTER})
    tol = KERNEL_TOL["bfloat16"]
    rows, total = [], {}
    for si, (name, m, k) in enumerate(TP_SHAPES):
        for n in TP_NS:
            bsr, x, dy = tp_problem(torch, m, k, n, args.seed + 91 + si)
            vals = bsr.values
            py, pdx, pdv = tp_plain(torch, bsr, x, dy)
            ref = sparse.plan(bsr, n, device="cuda",
                              ctx=sparse.PlanContext(mode="static"))
            ref_packed = ref.pack(vals)
            ry, rdx, rdv, _, _ = tp_forward_backward(torch, counters, ref,
                                                     vals, x, dy)
            sets = copies(lambda: (x.clone(),),
                          x.numel() * x.element_size())
            ref_ms = timed_ms(torch, lambda xx: ref.run_packed(ref_packed,
                                                               xx),
                              sets, 50 if n <= 256 else 20)
            for q in TP_QS:
                for balanced in (True, False):
                    p = sparse.plan(bsr, n, device="cuda",
                                    ctx=sparse.PlanContext(
                                        mode="static_tp", tp_q=q,
                                        tp_balanced=balanced))
                    if p.route != "static_tp":
                        raise RuntimeError(f"[tp] {p.route} planned")
                    y, dx, dv, fwd, bwd = tp_forward_backward(
                        torch, counters, p, vals, x, dy)
                    shards = int((p.tp.meta.real_counts > 0).sum())
                    label = (f"{name} n={n} q={q} "
                             f"{'balanced' if balanced else 'even'}")
                    if (fwd[0]["bsmm"] != q or shards != q
                            or bwd[0]["bsmm"] != q
                            or bwd[0]["sddmm"] != q):
                        raise RuntimeError(
                            f"[tp] {label}: launches forward {fwd[0]}, "
                            f"backward {bwd[0]} for {shards} shards")
                    tp_check_walks(label, fwd[1])
                    tp_check_walks(label, bwd[1])
                    for part in (fwd, bwd):
                        for key, v in part[0].items():
                            total[key] = total.get(key, 0) + v
                    errs = {"y_vs_plain": rel_err(y, py)[0],
                            "dx_vs_plain": rel_err(dx, pdx)[0],
                            "dvalues_vs_plain": rel_err(dv, pdv)[0],
                            "y_vs_unsharded": rel_err(y, ry)[0],
                            "dx_vs_unsharded": rel_err(dx, rdx)[0],
                            "dvalues_vs_unsharded": rel_err(dv, rdv)[0]}
                    bad = {e: v for e, v in errs.items() if not v <= tol}
                    if bad:
                        raise RuntimeError(f"[tp] {label} beyond {tol}: "
                                           f"{bad}")
                    packed = p.pack(vals)
                    ms = timed_ms(torch,
                                  lambda xx: p.run_packed(packed, xx),
                                  sets, 50 if n <= 256 else 20)
                    rows.append(dict(
                        shape=f"{name} {m}x{k}", n=n, q=q,
                        balanced=balanced, ms=ms, unsharded_ms=ref_ms,
                        imbalance=p.artifacts["tp_imbalance"],
                        slots=p.artifacts["tp_slots"],
                        boundaries=p.artifacts["tp_boundaries"],
                        errs=errs, forward=fwd[0], backward=bwd[0],
                        forward_walks=fwd[1]["bsmm"],
                        backward_walks={"bsmm": bwd[1]["bsmm"],
                                        "sddmm": bwd[1]["sddmm"]}))
            del ref, ref_packed
    return rows, total


def tp_rank_main(rank, world, init_file, out_dir, seed):
    """One rank of the explicit route on this card: gloo over
    ``init_file``, a ``DeviceMesh("cuda", (world,), ("model",))``, and
    ``static_tp_shardmap`` forward and backward at llama's FFN shapes;
    results to ``out_dir/rank<r>.pt``, an error to ``rank<r>.err``."""
    import traceback

    import torch
    import torch.distributed as dist
    try:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group("gloo", init_method=f"file://{init_file}",
                                rank=rank, world_size=world)
        from repro_torch import sparse
        from repro_torch.kernels import bsmm, sddmm
        from repro_torch.launch.mesh import make_device_mesh
        mesh = make_device_mesh("cuda", (world,), ("model",))
        counters = with_walks({"bsmm": bsmm.COUNTER,
                               "sddmm": sddmm.COUNTER})
        out = {"backend": dist.get_backend(mesh.get_group("model"))}
        for si, (name, m, k) in enumerate(TP_SHAPES):
            for n in TP_NS:
                bsr, x, dy = tp_problem(torch, m, k, n, seed + 91 + si)
                p = sparse.plan(bsr, n, device="cuda", ctx=sparse.PlanContext(
                    mode="static_tp_shardmap", mesh=mesh))
                y, dx, dv, fwd, bwd = tp_forward_backward(
                    torch, counters, p, bsr.values, x, dy)
                packed = p.pack(bsr.values)
                dist.barrier()
                iters = 20
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(iters):
                    p.run_packed(packed, x)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3 / iters
                out[f"{name} n={n}"] = dict(
                    route=p.route, shards=list(p.tp.shards), y=y.cpu(),
                    dx=dx.cpu(), dv=dv.cpu(), forward=fwd[0],
                    backward=bwd[0], forward_walks=fwd[1]["bsmm"],
                    wall_ms=wall_ms)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def tp_shardmap_rows(torch, args):
    """``static_tp_shardmap`` over ``TP_RANKS`` gloo ranks on this card
    (NCCL refuses two ranks on one device): both ranks' outputs and
    dL/dx identical and within bf16 2e-2 of ``static_tp``'s, the ranks'
    dL/dvalues summing to ``static_tp``'s, one bsmm launch a forward
    call on each rank.  A rank that fails fails the phase with its
    traceback."""
    from repro_torch import sparse
    outs = run_ranks(torch, "tp", tp_rank_main, TP_RANKS, args.seed)
    tol = KERNEL_TOL["bfloat16"]
    rows = []
    for si, (name, m, k) in enumerate(TP_SHAPES):
        for n in TP_NS:
            key = f"{name} n={n}"
            bsr, x, dy = tp_problem(torch, m, k, n, args.seed + 91 + si)
            ref = sparse.plan(bsr, n, device="cuda", ctx=sparse.PlanContext(
                mode="static_tp", tp_q=TP_RANKS))
            v = bsr.values.clone().requires_grad_(True)
            xx = x.clone().requires_grad_(True)
            y = ref.spmm_nt(v, xx)
            y.backward(dy)
            got = [o[key] for o in outs]
            same = all(torch.equal(g["y"], got[0]["y"])
                       and torch.equal(g["dx"], got[0]["dx"])
                       for g in got[1:])
            errs = {"y": rel_err(got[0]["y"].cuda(), y.detach())[0],
                    "dx": rel_err(got[0]["dx"].cuda(), xx.grad)[0],
                    "dvalues": rel_err(sum(g["dv"].float() for g in got)
                                       .cuda(), v.grad)[0]}
            label = f"{key} over {TP_RANKS} ranks"
            if not same:
                raise RuntimeError(f"[tp] {label}: the ranks differ")
            bad = {e: v for e, v in errs.items() if not v <= tol}
            if bad:
                raise RuntimeError(f"[tp] {label} beyond {tol} of "
                                   f"static_tp: {bad}")
            for r, g in enumerate(got):
                if g["route"] != "static_tp_shardmap" \
                        or g["shards"] != [r] or g["forward"]["bsmm"] != 1:
                    raise RuntimeError(f"[tp] {label} rank {r}: route "
                                       f"{g['route']}, shards {g['shards']},"
                                       f" launches {g['forward']}")
                tp_check_walks(label, {"bsmm": g["forward_walks"],
                                       "sddmm": {}})
            rows.append(dict(
                shape=f"{name} {m}x{k}", n=n, backend=outs[0]["backend"],
                ranks_identical=same, errs=errs,
                wall_ms=[g["wall_ms"] for g in got],
                forward=[g["forward"] for g in got],
                backward=[g["backward"] for g in got]))
    return {"rows": rows}


def tp_engine_run(torch, args, serve):
    """llama3.2-1b at full width and depth, every FFN block-sparse (d =
    1/8, b = 16, bf16), through ``Engine(mesh=<abstract (1, 4)>,
    batch=4, max_len=512)`` with [serve]'s 8 requests, eagerly and then
    through the engine's CUDA graphs (the main path, its counters zeroed
    just before and read just after).  Fails unless the tokens are
    identical, every static FFN plan carries a ``tp`` section, the
    decode plans chose ``static_tp`` on the analytic verdict, a decode
    replay launches bsmm q times for each sparse projection (once each in
    [serve]), and a prefill's logits
    are within bf16 6e-2 of the unsharded plans' on the same weights."""
    import numpy as np

    from repro_torch import configs, sparse
    from repro_torch.core.sparse_layers import SparseLinear
    from repro_torch.kernels import bs_attn, bsmm, dense_mm
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models.model import LM
    from repro_torch.serve import Engine, Request

    counters = with_walks({"bsmm": bsmm.COUNTER, "dense_mm": dense_mm.COUNTER,
                           "bs_attn": bs_attn.COUNTER})
    cfg = configs.sparsify_ffn(configs.get("llama3_2_1b"), 1 / 8)
    lm = LM(cfg, device="cuda", seed=args.seed)
    mesh = AbstractMesh(*TP_MESH)
    q = mesh.shape["model"]
    rng = np.random.default_rng(args.seed)

    def requests(bounds, new):
        return [Request(uid=i, prompt=rng.integers(
                    0, cfg.vocab_size, size=int(rng.integers(lo, hi + 1))),
                    max_new_tokens=new) for i, (lo, hi) in enumerate(bounds)]

    requests(LLAMA_WARMUP, 3)                 # [serve]'s rng sequence
    prompts = [r.prompt for r in requests(LLAMA_PROMPTS, LLAMA_NEW)]
    if [len(p) for p in prompts] != llama_prompt_lens(args):
        raise RuntimeError("[tp] the prompts are not [serve]'s")
    kw = dict(batch=4, max_len=LLAMA_MAX_LEN, device="cuda", mesh=mesh)
    torch.cuda.reset_peak_memory_stats()
    eager = serve_run(torch, Engine(lm, graphs=False, **kw), prompts,
                      LLAMA_NEW)
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(lm, warm_compile=True, **kw)
    torch.cuda.synchronize()
    for c in counters.values():
        c.reset()
    run = serve_run(torch, eng, prompts, LLAMA_NEW)
    launches, walks = tp_counts(counters)
    check_tensor_core_walks("tp", walks, ("bs_attn", "bsmm"))
    graphs = graphs_line(eager, run)
    static = [p for p in sparse.pool_plans(eng.pool) if p.kind == "static"]
    no_tp = [p.key for p in static if not p.artifacts.get("tp")]
    decode = [p for p in static if p.n == eng.batch]
    off = {f"{p.m}x{p.k}": (p.route, p.source) for p in decode
           if p.route != "static_tp" or p.source != "analytic"}
    if not static or no_tp or not decode or off:
        raise RuntimeError(f"[tp] static plans {len(static)}, without a tp "
                           f"section {no_tp}, decode plans off static_tp "
                           f"on the analytic verdict {off}")
    per_replay = replay_launches(eng, counter_names())["decode"]
    sparse_layers = sum(isinstance(m, SparseLinear) for m in lm.modules())
    if per_replay.get("bsmm") != q * sparse_layers:
        raise RuntimeError(f"[tp] bsmm launches per decode replay "
                           f"{per_replay}: not {q} for each of "
                           f"{sparse_layers} sparse projections")
    toks = rng.integers(0, cfg.vocab_size, size=(1, 64))
    with sparse.use_ctx(sparse.PlanContext(mesh=mesh)):
        lt, _ = lm.prefill(toks, max_len=LLAMA_MAX_LEN, last_index=[63])
    lu, _ = lm.prefill(toks, max_len=LLAMA_MAX_LEN, last_index=[63])
    prefill_err = rel_err(lt[0], lu[0])[0]
    if not prefill_err <= CONSISTENCY_TOL:
        raise RuntimeError(f"[tp] prefill logits {prefill_err} beyond "
                           f"{CONSISTENCY_TOL} of the unsharded plans'")
    rep = eng.plan_report()["tp"]
    out = dict(graphs=graphs, launches=launches, walks=walks,
               decode_replay_launches=per_replay,
               serve_decode_step_launches=serve["launches_per_call"][
                   "decode_step"],
               tp_totals=rep["totals"], prefill_rel_err=prefill_err,
               plans={f"{p.m}x{p.k} n={p.n}": f"{p.route} ({p.source})"
                      for p in static},
               decode_step_p50_ms=graphs["decode_step_p50_ms"],
               serve_decode_step_p50_ms=serve["graphs"][
                   "decode_step_p50_ms"],
               peak_mem_gb=run["peak_mem_gb"])
    del eng, lm
    return out


def tp_phase(torch, args, serve):
    """[tp]: the plan rows, the explicit route over gloo ranks, the
    engine with an abstract mesh."""
    t0 = time.perf_counter()
    rows, plan_launches = tp_plan_rows(torch, args)
    gc.collect()
    torch.cuda.empty_cache()
    shardmap = tp_shardmap_rows(torch, args)
    gc.collect()
    torch.cuda.empty_cache()
    engine = tp_engine_run(torch, args, serve)
    return dict(rows=rows, plan_launches=plan_launches, shardmap=shardmap,
                engine=engine, phase_s=time.perf_counter() - t0)


def print_tp(tp):
    for r in tp["rows"]:
        print(f"[tp] static_tp {r['shape']:20s} n={r['n']:<4d} q={r['q']} "
              f"{'balanced' if r['balanced'] else 'even':8s} ms="
              f"{r['ms']:.5f} unsharded_ms={r['unsharded_ms']:.5f} "
              f"tp_imbalance={r['imbalance']:.3f} tp_slots={r['slots']} "
              f"boundaries={r['boundaries']} forward {json.dumps(r['forward'])}"
              f" (bsmm walks {json.dumps(r['forward_walks'])}) backward "
              f"{json.dumps(r['backward'])} errs "
              f"{json.dumps({k: float(f'{v:.2e}') for k, v in r['errs'].items()})}")
    for r in tp["shardmap"]["rows"]:
        print(f"[tp] static_tp_shardmap {r['shape']:20s} n={r['n']:<4d} "
              f"{TP_RANKS} ranks ({r['backend']}): ranks identical "
              f"{r['ranks_identical']}; vs static_tp "
              f"{json.dumps({k: float(f'{v:.2e}') for k, v in r['errs'].items()})}"
              f"; wall ms per call with the reduction (host clock) "
              f"{[round(v, 4) for v in r['wall_ms']]}; launches a rank: "
              f"forward {json.dumps(r['forward'][0])} backward "
              f"{json.dumps(r['backward'][0])}")
    e = tp["engine"]
    print(f"[tp] engine llama3.2-1b mesh {TP_MESH}: decode step p50 eager "
          f"{e['decode_step_p50_ms']['eager']} / graphs "
          f"{e['decode_step_p50_ms']['graphs']} ms ([serve]: "
          f"{e['serve_decode_step_p50_ms']['eager']} / "
          f"{e['serve_decode_step_p50_ms']['graphs']}); bsmm per decode "
          f"replay {e['decode_replay_launches'].get('bsmm')} ([serve] "
          f"decode step {e['serve_decode_step_launches']['bsmm']}); "
          f"tp_report totals {json.dumps(e['tp_totals'])}; prefill logits "
          f"vs unsharded {e['prefill_rel_err']:.2e} (budget "
          f"{CONSISTENCY_TOL}); tokens identical eager / graphs "
          f"{e['graphs']['tokens_identical']}; peak "
          f"{e['peak_mem_gb']:.2f} GiB; launches "
          f"{json.dumps(e['launches'])}; phase {tp['phase_s']:.1f} s")
    print(f"[tp] engine plans {json.dumps(e['plans'])}")


# -- [dp] / [ep]: sharded training over gloo ranks of the one card --------------

# [dp]: llama3.2-1b (d = 1/8) at full width cut to DP_LAYERS of its 16
# layers (the time [mp]'s mixers take) on a (DP_RANKS, 1) mesh, the
# global batch [train]'s 4 x 512; a checkpoint at DP_SAVE_AT resumed on
# another mesh
DP_RANKS, DP_STEPS, DP_SAVE_AT = 2, 5, 3
DP_BATCH, DP_SEQ = 4, 512
DP_LAYERS = 8


def dp_cfg():
    from repro_torch import configs
    from repro_torch.launch.profile_train import cut_depth
    return cut_depth(configs.sparsify_ffn(configs.get("llama3_2_1b"), 1 / 8),
                     DP_LAYERS)

# [ep]: qwen3-moe-30b-a3b at full width, EP_LAYERS layers, on a (1, 2)
# mesh (64 of 128 experts a rank)
EP_LAYERS, EP_STEPS = 2, 3
EP_MESH = (1, 2)
# the mesh splits the attention over "model" too, so the first MoE
# layer's input differs from one process's by bf16 roundings and its
# router re-routes near-ties: at most EP_FIRST_REROUTED of the 2048
# tokens (70 and 93 read on an H100), its drop fraction within
# EP_FIRST_DROP_TOL of one process's (3e-4 read)
EP_FIRST_REROUTED, EP_FIRST_DROP_TOL = 256, 1e-2
# [ep] gspmd: the same cut under impl="gspmd" (every MoE config's
# default): (2, 1) routes over the global batch, (1, 2) holds 64 experts
EP_GSPMD_MESHES = ((2, 1), (1, 2))
# the first loss (before any update): two half-batch forwards against one
# whole-batch forward differ by bf16 roundings; read over five init draws
# at full depth, 16 layers (`--margins 0,1,2,3,4`, an H100): 6.42e-06,
# 1.15e-05, 1.22e-05, 1.78e-05, 5.64e-05 -- 3.5x above the largest, 100x
# under the losses' bf16 budget; `--margins` reads them at DP_LAYERS
FIRST_LOSS_TOL = 2e-4


def run_ranks(torch, label, target, world, *job):
    """``target(rank, world, init_file, out_dir, *job)`` on ``world``
    spawned processes (gloo ranks of this card); their results, each
    rank's ``rank<r>.pt``.  A rank that fails (or is still running after
    600 s) fails the phase with its traceback."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp
    out_dir = tempfile.mkdtemp(prefix=f"{label}_ranks_",
                               dir=os.path.join(HERE, "build"))
    try:
        ctx = mp.start_processes(
            target, args=(world, os.path.join(out_dir, "pg"), out_dir)
            + job, nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + 600
        try:
            while not ctx.join(timeout=1):
                if time.monotonic() > deadline:
                    raise TimeoutError("ranks still running after 600 s")
        except Exception as e:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
            errs = [open(os.path.join(out_dir, f)).read()
                    for f in sorted(os.listdir(out_dir))
                    if f.endswith(".err")]
            raise RuntimeError(f"[{label}] {world} gloo ranks: "
                               f"{(errs[0] if errs else repr(e))[-3000:]}")
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def shard_rank_main(rank, world, init_file, out_dir, kind, job):
    """One rank of [dp] or [ep] on this card: gloo over ``init_file``,
    then ``SHARD_JOBS[kind]``; results to ``out_dir/rank<r>.pt``, an
    error to ``rank<r>.err``."""
    import traceback

    import torch
    import torch.distributed as dist
    try:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group("gloo", init_method=f"file://{init_file}",
                                rank=rank, world_size=world)
        out = SHARD_JOBS[kind](torch, rank, world, job)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def timed_steps(torch):
    """Time every ``TrainProgram`` call of this process on the host clock
    between two device synchronisations, and turn on its state's
    collective timing (``ShardLayout.comm_ms``) and the FSDP gathers'
    (``core.tp.COMM_MS``: the forward's gathers, the recompute's under
    ``remat="full"`` among them, and the backward's reduce-scatters,
    each summed over the step into ``comm_ms``): the step times this
    harness reads, by wrapping the entry point from outside.  Returns
    the list the step times (ms) go to."""
    from repro_torch.core import tp
    from repro_torch.train import program as prog_mod
    times = []
    call = prog_mod.TrainProgram.__call__

    def timed(self):
        lay = self.state.layout
        if lay is not None and lay.comm_ms is None:
            lay.comm_ms = {}
        tp.COMM_MS = {} if lay is not None else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            out = call(self)
            torch.cuda.synchronize()
        finally:
            fsdp, tp.COMM_MS = tp.COMM_MS or {}, None
        times.append((time.perf_counter() - t0) * 1e3)
        for kind, ms in fsdp.items():
            lay.comm_ms.setdefault(kind, []).append(sum(ms))
            lay.comm_ms.setdefault(f"{kind}_calls", []).append(len(ms))
        return out
    prog_mod.TrainProgram.__call__ = timed
    return times


def state_gib(state) -> float:
    """GiB of a train state's fp32 tables (master, mu, nu, residuals) as
    this process holds them."""
    tabs = [state.opt.master, state.opt.mu, state.opt.nu]
    if state.ef is not None:
        tabs.append(state.ef.residual)
    return sum(t.numel() * t.element_size() for tab in tabs
               for t in tab.values()) / 2 ** 30


def blocks_gib(state, mesh) -> float:
    """GiB the sharding rules give this rank's fp32 tables: each
    parameter's block under its spec over the whole mesh, once per
    table."""
    from repro_torch.launch.mesh import block_shape
    lay = state.layout
    tables = 3 + (state.ef is not None)
    return tables * 4 * sum(
        math.prod(block_shape(lay.shapes[n], lay.specs[n], mesh))
        for n in lay.specs) / 2 ** 30


def master_err(torch, state, whole) -> dict:
    """This rank's master blocks against its blocks of ``whole`` (the
    one-process run's final masters; each master's place in its whole
    tensor is ``state.layout.place[name].state``): the relative L2 error
    of each parameter (``per``), the largest (``||d|| / ||w||``, the
    budget's measure) and the largest
    rel-max error (reported: Adam's normalised first steps move an
    element by about lr whatever its gradient's size, so an element
    whose bf16 gradient changes sign between the runs -- summed from two
    half-batch roundings here, one there -- differs by up to twice the
    summed lr, a few percent of a small-init table's largest value)."""
    lay = state.layout
    per, rmax = {}, 0.0
    for n, m in state.opt.master.items():
        w = lay.place[n].state.take(whole[n]).float()
        d = m.float() - w
        per[n] = (d.norm() / w.norm().clamp_min(1e-12)).item()
        rmax = max(rmax, rel_err(m, w)[0])
    return {"rel_l2": max(per.values()), "rel_max": rmax, "per": per}


def resume_run(torch, cfg, ckpt_dir, hp, mesh, args, batch, steps):
    """Restore the ``DP_SAVE_AT`` checkpoint under ``ckpt_dir`` onto
    ``mesh`` (the caller's block of every tensor: ``restore(mesh=,
    specs=)``) and run its next steps up to ``steps`` eagerly, no
    checkpoint written; their losses."""
    from repro_torch.checkpoint import restore
    from repro_torch.data import TokenPipeline
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.model import LM
    from repro_torch.sharding import rules
    from repro_torch.train.program import TrainProgram
    from repro_torch.train.step import (init_train_state, load_state_tree,
                                        state_tree)
    lm = LM(cfg, device="cuda", seed=args.seed, mesh=mesh)
    state = init_train_state(lm, hp=hp, mesh=mesh)
    specs = (None if state.layout is None else
             state.layout.storage_specs(state_tree(state)))
    tree, extra, _ = restore(ckpt_dir, state_tree(state), step=DP_SAVE_AT,
                             mesh=mesh, specs=specs)
    load_state_tree(state, tree)
    shard, shards = mesh_lib.axis_index(mesh, rules.batch_axes(mesh))
    pipe = TokenPipeline(cfg.vocab_size, batch, DP_SEQ, num_shards=shards,
                         shard_id=shard)
    program = TrainProgram(lm, state, hp, batch=batch, seq=DP_SEQ,
                           graph=False)
    losses = []
    with rules.activation_mesh(mesh):
        for step in range(TokenPipeline.resume_step(extra["data"]), steps):
            program.load(pipe.get_batch(step))
            losses.append(float(program()["loss"]))
    return losses


def dp_job(torch, rank, world, job):
    """[dp] on one rank: ``train_loop`` over the (world, 1) mesh with
    compression off (writing a checkpoint at ``DP_SAVE_AT``) and on
    (counters zeroed just before each run, read just after), its master
    blocks against the one-process run's (``job["masters"]``, shared
    from the parent), and the parent's one-process checkpoint
    resumed."""
    from repro_torch.kernels import bs_attn, bsmm, dense_mm, sddmm
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.launch.train import train_loop
    from repro_torch.train.step import TrainHParams
    mesh = make_device_mesh("cuda", (world, 1), ("data", "model"))
    counters = with_walks({"bsmm": bsmm.COUNTER, "sddmm": sddmm.COUNTER,
                           "dense_mm": dense_mm.COUNTER,
                           "bs_attn": bs_attn.COUNTER})
    times = timed_steps(torch)
    args = job["args"]
    out = {}
    for compress in (False, True):
        hp = TrainHParams(**TRAIN_HP, grad_compress=compress)
        del times[:]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.reset()
        state, losses = train_loop(
            job["cfg"], steps=DP_STEPS, batch_per_shard=DP_BATCH // world,
            seq=DP_SEQ, ckpt_dir=None if compress else job["dir_ranks"],
            ckpt_every=DP_SAVE_AT, hp=hp, device="cuda",
            log_every=10 ** 9, seed=args.seed, graphs=False, mesh=mesh)
        torch.cuda.synchronize()
        launches, walks = split_walks({k: c.launches
                                       for k, c in counters.items()})
        out[compress] = dict(
            losses=losses, launches=launches, walks=walks,
            step_ms=list(times), comm_ms=dict(state.layout.comm_ms),
            peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            params_gib=params_gib(state.params.values()),
            state_gib=state_gib(state), blocks_gib=blocks_gib(state, mesh),
            master_err=master_err(torch, state, job["masters"][compress]))
        del state
    gc.collect()
    torch.cuda.empty_cache()
    out["resumed"] = resume_run(torch, job["cfg"], job["dir_one"],
                                TrainHParams(**TRAIN_HP), mesh, args,
                                DP_BATCH // world, DP_STEPS)
    return out


def dp_phase(torch, args):
    """[dp]: data parallelism with the state sharded, llama3.2-1b at full
    width, ``DP_LAYERS`` layers deep (every FFN block-sparse, d = 1/8,
    b = 16, bf16),
    ``train_loop`` over a (2, 1) ``("data", "model")`` mesh of 2 gloo
    ranks on this card, 2 x 512 tokens a rank ([train]'s global batch
    4 x 512), ``DP_STEPS`` eager steps with ``grad_compress`` off and
    then on, against the one-process ``train_loop`` on the global batch
    in this process.  Fails unless the first loss is within
    ``FIRST_LOSS_TOL``,
    every loss within bf16 2e-2 and each rank's final master blocks
    within bf16 2e-2 in relative L2 (``master_err``),
    every rank launched bsmm, sddmm, dense_mm and bs_attn on their
    16-bit walks, each rank's fp32 state is exactly its blocks under the
    rules (``blocks_gib``: every table halved over "data" but the sparse
    FFN's values, whose rule splits them over "model" only, so ~0.6 of
    the one process's), and a checkpoint written at step ``DP_SAVE_AT``
    on the ranks and resumed on one process (and one written on one process and
    resumed on the ranks) continues to the unbroken run's losses within
    bf16 2e-2.  Prints step p50 per rank, the collectives' ms of a step,
    peak and state GiB per rank."""
    import shutil

    from repro_torch.launch.train import train_loop
    from repro_torch.train.step import TrainHParams

    t0 = time.perf_counter()
    cfg = dp_cfg()
    ck = os.path.join(HERE, "build", "dp_ckpt")
    shutil.rmtree(ck, ignore_errors=True)
    dirs = {k: os.path.join(ck, k) for k in ("one", "ranks")}
    ref, masters = {}, {}
    for compress in (False, True):
        hp = TrainHParams(**TRAIN_HP, grad_compress=compress)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        # the uncompressed runs (here and on the ranks) write the
        # checkpoint at DP_SAVE_AT that the other side resumes
        state, losses = train_loop(
            cfg, steps=DP_STEPS, batch_per_shard=DP_BATCH, seq=DP_SEQ,
            ckpt_dir=None if compress else dirs["one"],
            ckpt_every=DP_SAVE_AT, hp=hp, device="cuda", log_every=10 ** 9,
            seed=args.seed, graphs=False)
        ref[compress] = dict(
            losses=losses, state_gib=state_gib(state),
            params_gib=params_gib(state.params.values()),
            peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        # bf16 copies of the final masters, shared with the ranks (CUDA
        # IPC): the budget they are held to is bf16's
        masters[compress] = {n: m.to(torch.bfloat16)
                             for n, m in state.opt.master.items()}
        del state
    hp = TrainHParams(**TRAIN_HP)
    gc.collect()
    torch.cuda.empty_cache()
    try:
        outs = run_ranks(torch, "dp", shard_rank_main, DP_RANKS, "dp", dict(
            cfg=cfg, args=args, masters=masters, dir_one=dirs["one"],
            dir_ranks=dirs["ranks"]))
        del masters
        gc.collect()
        torch.cuda.empty_cache()
        from repro_torch.launch.mesh import make_host_mesh
        resumed_one = resume_run(torch, cfg, dirs["ranks"], hp,
                                 make_host_mesh(), args, DP_BATCH, DP_STEPS)
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    tol = KERNEL_TOL["bfloat16"]
    out = {"ranks": DP_RANKS, "one_process": ref, "per_rank": []}
    for r, o in enumerate(outs):
        rank_out = {}
        for compress in (False, True):
            g, want = o[compress], ref[compress]["losses"]
            first = abs(g["losses"][0] - want[0]) / abs(want[0])
            worst = max(abs(a - b) / abs(b) for a, b in zip(g["losses"],
                                                           want))
            label = f"rank {r} grad_compress={compress}"
            if not first <= FIRST_LOSS_TOL or not worst <= tol \
                    or not g["master_err"]["rel_l2"] <= tol:
                raise RuntimeError(
                    f"[dp] {label}: first loss {first:.3g} (budget "
                    f"{FIRST_LOSS_TOL}), losses {g['losses']} vs {want} "
                    f"({worst:.3g}), masters {g['master_err']} (budget "
                    f"{tol} on rel_l2)")
            for k in ("bsmm", "sddmm", "dense_mm", "bs_attn"):
                if g["launches"].get(k, 0) <= 0:
                    raise RuntimeError(f"[dp] {label}: {k} not launched "
                                       f"{g['launches']}")
            check_tensor_core_walks("dp", g["walks"],
                                    ("bs_attn", "sddmm", "bsmm"))
            check_dense_mm_walks("dp", g["walks"])
            share = g["state_gib"] / ref[compress]["state_gib"]
            if g["state_gib"] != g["blocks_gib"] or not share < 1:
                raise RuntimeError(f"[dp] {label}: fp32 state "
                                   f"{g['state_gib']:.3f} GiB ({share:.3f} "
                                   f"of one process's), its blocks under "
                                   f"the rules {g['blocks_gib']:.3f} GiB")
            # FSDP: every weight the rules split over "data" is held as
            # its block, so a rank holds less than one process
            held = g["params_gib"] / ref[compress]["params_gib"]
            if not held < 1 or not g["comm_ms"].get("fsdp_gather"):
                raise RuntimeError(f"[dp] {label}: parameters "
                                   f"{g['params_gib']:.3f} GiB ({held:.3f} "
                                   f"of one process's), FSDP gathers "
                                   f"{g['comm_ms'].get('fsdp_gather')}")
            rank_out[compress] = dict(g, first_loss_err=first,
                                      loss_err=worst, state_share=share,
                                      params_share=held)
        out["per_rank"].append(rank_out)
    unbroken = ref[False]["losses"][DP_SAVE_AT:]
    for label, got in (("ranks -> one process", resumed_one),
                       ("one process -> ranks", outs[0]["resumed"])):
        errs = [abs(a - b) / abs(b) for a, b in zip(got, unbroken)]
        if len(got) != len(unbroken) or not max(errs) <= tol:
            raise RuntimeError(f"[dp] checkpoint {label}: {got} vs the "
                               f"unbroken run's {unbroken}")
        out.setdefault("checkpoint", {})[label] = dict(losses=got,
                                                       errs=errs)
    if outs[1]["resumed"] != outs[0]["resumed"]:
        raise RuntimeError(f"[dp] the ranks' resumed losses differ: "
                           f"{[o['resumed'] for o in outs]}")
    out["phase_s"] = time.perf_counter() - t0
    return out


def ep_layer_check(torch, mesh, cfg, mod, x, y) -> dict:
    """One expert-parallel MoE layer against the gspmd formulation on the
    same input: the rank's held expert blocks gathered whole over the
    mesh (``Block.gather``), then ``_moe_gspmd``.  Returns the output's
    rel-max error and both routing drops."""
    import types

    from repro_torch.models.moe import _moe_gspmd
    whole = {name: h.block.gather(getattr(mod, name), mesh)
             for name, h in mod.held.items()}
    ref = types.SimpleNamespace(router=mod.router, shared=mod.shared,
                                **whole)
    with torch.no_grad():
        y_ref, m_ref = _moe_gspmd(ref, cfg, x)
    return dict(err=rel_err(y, y_ref)[0],
                gspmd_dropped=float(m_ref.dropped_frac))


def routing_keys(torch, mod, cfg, x):
    """Each token's routing in one MoE layer on its input ``x``: its
    top-k experts, then the experts that kept it in their capacity
    (``num_experts`` where dropped), each set sorted: ``[T, 2k]`` on the
    CPU.  Two runs' tokens with equal keys took the same experts with
    the same kept slots."""
    from repro_torch.models.moe import _capacity, _route_and_rank
    m = cfg.moe
    xf = x.reshape(-1, x.shape[-1])
    cap = _capacity(xf.shape[0], cfg)
    with torch.no_grad():
        *_, flat_slot = _route_and_rank(xf, mod.router.w, cfg, cap,
                                        ranking=m.ranking)
        top_e = torch.topk(torch.matmul(xf.float(), mod.router.w),
                           m.top_k, dim=-1).indices
    kept = torch.where(flat_slot < m.num_experts * cap,
                       torch.div(flat_slot, cap, rounding_mode="floor"),
                       m.num_experts)
    return torch.cat([top_e.sort(dim=1).values, kept.sort(dim=1).values],
                     dim=1).cpu()


def ep_job(torch, rank, world, job):
    """[ep] on one rank: the shard_map forward on the (1, 2) mesh against
    the one-process gspmd logits (``job["logits"]``, shared): over all
    tokens, and over the tokens routed as in the one-process run in
    every layer (``routing_keys`` against ``job["keys"]``), with the
    expert products' bucket sizes; then ``train_loop`` (counters zeroed
    just before, read just after)."""
    from repro_torch import sparse
    from repro_torch.kernels import bs_attn, dense_mm, gmm
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.launch.train import train_loop
    from repro_torch.models.model import LM
    from repro_torch.models.moe import MoE
    from repro_torch.sharding import rules
    from repro_torch.train.step import TrainHParams
    import numpy as np

    mesh = make_device_mesh("cuda", EP_MESH, ("data", "model"))
    counters = with_walks({"gmm": gmm.COUNTER, "dense_mm": dense_mm.COUNTER,
                           "bs_attn": bs_attn.COUNTER})
    args, cfg = job["args"], job["cfg"]
    buckets = []
    bmm = sparse.batched_matmul

    def recorded(a, b, **kw):
        buckets.append(tuple(a.shape))
        return bmm(a, b, **kw)
    lm = LM(cfg, device="cuda", seed=args.seed, mesh=mesh)
    held = {n: tuple(lm.get_parameter(n).shape)
            for n in lm.held_blocks()}
    tokens = np.random.default_rng(args.seed + 41).integers(
        0, cfg.vocab_size, size=(DP_BATCH, DP_SEQ))
    moes = [m for m in lm.modules() if isinstance(m, MoE)]
    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: seen.append((inp[0], out[0])))
        for m in moes]
    sparse.reset_telemetry()
    for c in counters.values():
        c.reset()
    sparse.batched_matmul = recorded
    try:
        with rules.activation_mesh(mesh):
            logits = lm(tokens)
        torch.cuda.synchronize()
    finally:
        sparse.batched_matmul = bmm
        for h in hooks:
            h.remove()
    fwd_launches, fwd_walks = split_walks({k: c.launches
                                           for k, c in counters.items()})
    same = torch.ones(DP_BATCH * DP_SEQ, dtype=torch.bool)
    rerouted = []
    for mod, (x, _), want in zip(moes, seen, job["keys"]):
        eq = (routing_keys(torch, mod, cfg, x) == want).all(dim=1)
        rerouted.append(int((~eq).sum()))
        same &= eq
    flat = logits.reshape(-1, logits.shape[-1])
    ref = job["logits"].reshape(-1, logits.shape[-1])
    idx = same.nonzero().squeeze(1).to(flat.device)
    out = dict(held=held, buckets=buckets, forward_launches=fwd_launches,
               rerouted=rerouted, same_tokens=int(same.sum()),
               same_logits_err=(rel_err(flat[idx], ref[idx])[0]
                                if len(idx) else float("inf")),
               forward_walks=fwd_walks,
               dropped=sparse.dropped_history("moe_dispatch"),
               logits_err=rel_err(logits, job["logits"])[0],
               logits_finite=bool(torch.isfinite(logits).all()),
               layers=[ep_layer_check(torch, mesh, cfg, mod, x, y)
                       for mod, (x, y) in zip(moes, seen)])
    del lm, logits, seen, flat, ref
    gc.collect()
    torch.cuda.empty_cache()
    times = timed_steps(torch)
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.reset()
    state, losses = train_loop(
        cfg, steps=EP_STEPS, batch_per_shard=DP_BATCH, seq=DP_SEQ,
        ckpt_dir=None, hp=TrainHParams(**TRAIN_HP), device="cuda",
        log_every=10 ** 9, seed=args.seed, graphs=False, mesh=mesh)
    torch.cuda.synchronize()
    launches, walks = split_walks({k: c.launches
                                   for k, c in counters.items()})
    out.update(losses=losses, launches=launches, walks=walks,
               step_ms=list(times), comm_ms=dict(state.layout.comm_ms),
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               state_gib=state_gib(state))
    return out


def ep_gspmd_job(torch, rank, world, job):
    """[ep] gspmd on one rank: for each of ``EP_GSPMD_MESHES``, the rank's
    data shard of the seeded global batch through ``LM(mesh=)`` under
    ``impl="gspmd"`` (the counters zeroed just before, read just
    after); then each MoE layer against one process's gspmd formulation
    on the global batch (the layer's input gathered over the data ranks,
    its experts gathered whole): the output's rows, the kept experts of
    the rank's tokens (``global_route``) and the drop fraction."""
    import types

    import numpy as np

    from repro_torch import sparse
    from repro_torch.kernels import gmm
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.model import LM
    from repro_torch.models.moe import (MoE, _capacity, _moe_gspmd,
                                        _route_and_rank, global_route)
    from repro_torch.sharding import rules
    args, cfg = job["args"], job["cfg"]
    e_n = cfg.moe.num_experts
    tokens = np.random.default_rng(args.seed + 41).integers(
        0, cfg.vocab_size, size=(DP_BATCH, DP_SEQ))
    counters = with_walks({"gmm": gmm.COUNTER})

    def kept_of(flat_slot, bucket):
        kept = torch.where(flat_slot < e_n * bucket,
                           torch.div(flat_slot, bucket,
                                     rounding_mode="floor"), e_n)
        return kept.sort(dim=1).values

    out = {}
    for shape in EP_GSPMD_MESHES:
        mesh = mesh_lib.make_device_mesh("cuda", shape, ("data", "model"))
        di, dp = mesh_lib.axis_index(mesh, ("data",))
        rows = slice(di * DP_BATCH // dp, (di + 1) * DP_BATCH // dp)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        lm = LM(cfg, device="cuda", seed=args.seed, mesh=mesh)
        moes = [m for m in lm.modules() if isinstance(m, MoE)]
        seen = []
        hooks = [m.register_forward_hook(
            lambda mod, inp, o: seen.append((inp[0], o[0]))) for m in moes]
        sparse.reset_telemetry()
        for c in counters.values():
            c.reset()
        t0 = time.perf_counter()
        with rules.activation_mesh(mesh):
            logits = lm(tokens[rows])
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
        for h in hooks:
            h.remove()
        launches, walks = split_walks({k: c.launches
                                       for k, c in counters.items()})
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        dropped = sparse.dropped_history("moe_dispatch")
        group = mesh_lib.axes_group(mesh, ("data",))
        layers = []
        for mod, (x, y) in zip(moes, seen):
            whole_x = x.new_zeros((DP_BATCH,) + tuple(x.shape[1:]))
            whole_x[rows] = x
            if group is not None:
                torch.distributed.all_reduce(whole_x, group=group)
            whole = {name: h.block.gather(getattr(mod, name), mesh)
                     for name, h in mod.held.items()}
            ref = types.SimpleNamespace(router=mod.router, shared=None,
                                        **whole)
            with torch.no_grad():
                y_ref, m_ref = _moe_gspmd(ref, cfg, whole_x)
                xf = whole_x.reshape(-1, x.shape[-1])
                cap = _capacity(xf.shape[0], cfg)
                *_, flat_ref = _route_and_rank(xf, mod.router.w, cfg, cap,
                                               ranking=cfg.moe.ranking)
                with rules.activation_mesh(mesh):
                    tfs, _, flat, *_ = global_route(
                        mod, cfg, x.reshape(-1, x.shape[-1]), mesh)
            tok = slice(rows.start * DP_SEQ, rows.stop * DP_SEQ)
            same = (kept_of(flat, tfs.shape[1])
                    == kept_of(flat_ref, cap)[tok]).all(dim=1)
            layers.append(dict(err=rel_err(y, y_ref[rows])[0],
                               kept_equal=int(same.sum()),
                               tokens=int(same.numel()),
                               gspmd_dropped=float(m_ref.dropped_frac),
                               bucket=int(tfs.shape[1]), cap=cap))
            del whole, ref, y_ref, whole_x
        experts = {n: tuple(lm.get_parameter(n).shape)
                   for n in lm.held_blocks()
                   if n.rpartition(".")[2] in ("w_gate", "w_up", "w_down")}
        out[shape] = dict(layers=layers, dropped=dropped, experts=experts,
                          launches=launches, walks=walks, peak_gib=peak,
                          forward_s=fwd_s,
                          finite=bool(torch.isfinite(logits).all()))
        del lm, moes, seen, logits
    return out


def ep_gspmd_check(torch, cfg, outs) -> None:
    """[ep] gspmd's holds on every rank and mesh: each MoE layer's output
    within bf16 ``KERNEL_TOL`` of one process's on the global batch, the
    kept experts of every token and the drop fraction equal, finite
    logits, gmm 3 a layer on the tensor-core walk, the experts held as
    the rules' blocks (E / m of them, the ``"data"`` share of D)."""
    e_n, d = cfg.moe.num_experts, cfg.d_model
    for r, o in enumerate(outs):
        for shape, g in o.items():
            label = f"[ep] gspmd rank {r} mesh {shape}"
            dp, m = shape
            bad = [(i, c) for i, c in enumerate(g["layers"])
                   if not c["err"] <= KERNEL_TOL["bfloat16"]
                   or c["kept_equal"] != c["tokens"]
                   or c["gspmd_dropped"] != g["dropped"][i]]
            if bad or not g["layers"] or not g["finite"]:
                raise RuntimeError(f"{label}: layers against one process "
                                   f"on the global batch {g['layers']} "
                                   f"(drops {g['dropped']}), finite logits "
                                   f"{g['finite']}")
            if g["launches"].get("gmm") != 3 * len(g["layers"]):
                raise RuntimeError(f"{label}: gmm launches {g['launches']} "
                                   f"(3 a layer expected)")
            check_tensor_core_walks("ep", g["walks"], kernels=("gmm",))
            if len(g["experts"]) != 3 * len(g["layers"]) or any(
                    s[0] != e_n // m
                    or s[1] * dp not in (d, cfg.moe.d_ff_expert)
                    for s in g["experts"].values()):
                raise RuntimeError(f"{label}: held expert blocks "
                                   f"{g['experts']}")


def ep_phase(torch, args):
    """[ep]: MoE expert parallelism, qwen3-moe-30b-a3b at full width
    (128 experts top-8, d_model 2048, vocab 151936), ``EP_LAYERS`` of its
    48 layers (``profile_train.cut_depth``), bf16, ``impl="shard_map"``,
    over a (1, 2) ``("data", "model")`` mesh of 2 gloo ranks on this
    card, each holding 64 experts of every layer.  Reckoned before the
    run: ~1.27 B parameters a rank (the embedding and the unembed whole,
    622 M; 2 x 64 experts, 604 M; attention 42 M), bf16 weights and
    gradients 5.1 GB, fp32 master, mu and nu of its blocks (the tables
    split over "model") ~11 GB, the fp32 gradient blocks 4 GB and one
    chunk of fp32 logits: ~24 GB a rank.  The forward of a 4 x 512 batch:
    every MoE layer's output within bf16 2e-2 of the gspmd formulation on
    the same input with the same routing drops (``ep_layer_check``),
    finite logits, and gmm launched 3 times a layer on
    64-expert buckets.  The logits over all tokens are reported, not
    held: the combine adds the two ranks' partials in another order, a
    few bf16 roundings of the first layer's output flip, and the second
    layer's router then picks another top-k for some tokens, which
    shifts the capacity queues behind them (13 % and 28 % of the
    assignments drop at this random init), so a token may keep another
    set of experts.  The (1, 2) mesh also splits the GQA heads and the
    vocabulary over "model" (model parallelism): the first MoE layer's
    input is then the split attention's, whose bf16 partials are summed
    over the ranks, so its router re-routes near-ties too (70 and 93 of
    2048 tokens read on an H100): held at most ``EP_FIRST_REROUTED``
    tokens re-routed there and its drop fraction within
    ``EP_FIRST_DROP_TOL`` of one process's.  Held too: at least half the
    tokens routed as in the one-process run in every layer
    (``routing_keys``: the same top-k and kept experts), and their
    logits within bf16 ``CONSISTENCY_TOL`` (6e-2).
    ``EP_STEPS`` eager ``train_loop`` steps within bf16 2e-2 of the
    one-process run's losses, with gmm launched in the backward (dL/da)
    of every rank.  Then ``impl="gspmd"`` on ``EP_GSPMD_MESHES``
    (``ep_gspmd_job``, ``ep_gspmd_check``): every MoE layer's kept
    experts and drop fraction equal to one process's on the global
    batch, its output within bf16 2e-2, the experts held as the rules'
    blocks; each rank's experts and peak GiB printed."""
    import dataclasses

    import numpy as np

    from repro_torch import configs, sparse
    from repro_torch.launch.profile_train import cut_depth
    from repro_torch.launch.train import train_loop
    from repro_torch.models.model import LM
    from repro_torch.models.moe import MoE
    from repro_torch.train.step import TrainHParams

    t0 = time.perf_counter()
    base = cut_depth(configs.get("qwen3-moe-30b-a3b"), EP_LAYERS)
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, impl="shard_map"))
    gspmd = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, impl="gspmd"))
    tokens = np.random.default_rng(args.seed + 41).integers(
        0, cfg.vocab_size, size=(DP_BATCH, DP_SEQ))
    gc.collect()
    torch.cuda.empty_cache()
    lm = LM(gspmd, device="cuda", seed=args.seed)
    moes = [m for m in lm.modules() if isinstance(m, MoE)]
    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: seen.append(inp[0])) for m in moes]
    sparse.reset_telemetry()
    logits = lm(tokens)
    for h in hooks:
        h.remove()
    dropped = sparse.dropped_history("moe_dispatch")
    keys = [routing_keys(torch, mod, gspmd, x) for mod, x in zip(moes, seen)]
    del lm, moes, seen
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state, losses = train_loop(
        gspmd, steps=EP_STEPS, batch_per_shard=DP_BATCH, seq=DP_SEQ,
        ckpt_dir=None, hp=TrainHParams(**TRAIN_HP), device="cuda",
        log_every=10 ** 9, seed=args.seed, graphs=False)
    one = dict(losses=losses, dropped=dropped, state_gib=state_gib(state),
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    outs = run_ranks(torch, "ep", shard_rank_main, int(np.prod(EP_MESH)),
                     "ep", dict(cfg=cfg, args=args, logits=logits, keys=keys))
    del logits
    t1 = time.perf_counter()
    gspmd_outs = run_ranks(torch, "ep_gspmd", shard_rank_main, 2,
                           "ep_gspmd", dict(cfg=gspmd, args=args))
    ep_gspmd_check(torch, gspmd, gspmd_outs)
    gspmd_s = time.perf_counter() - t1
    e_loc = cfg.moe.num_experts // EP_MESH[1]
    layers = len(cfg.groups[0][0]) * cfg.groups[0][1]
    for r, o in enumerate(outs):
        label = f"[ep] rank {r}"
        bad = [(i, c) for i, c in enumerate(o["layers"])
               if not c["err"] <= KERNEL_TOL["bfloat16"]
               or c["gspmd_dropped"] != o["dropped"][i]]
        if bad or len(o["layers"]) != layers or not o["logits_finite"]:
            raise RuntimeError(f"{label}: layers against gspmd on their "
                               f"inputs {o['layers']} (drops "
                               f"{o['dropped']}), finite logits "
                               f"{o['logits_finite']}")
        # the end-to-end witness: the logits of the tokens routed as in
        # the one-process run (at least half of them) within bf16
        # CONSISTENCY_TOL
        if 2 * o["same_tokens"] < DP_BATCH * DP_SEQ \
                or not o["same_logits_err"] <= CONSISTENCY_TOL:
            raise RuntimeError(f"{label}: tokens re-routed a layer "
                               f"{o['rerouted']}, logits of the "
                               f"{o['same_tokens']} tokens routed alike "
                               f"{o['same_logits_err']:.3g} (budget "
                               f"{CONSISTENCY_TOL})")
        if len(o["dropped"]) != len(dropped) \
                or not o["rerouted"][0] <= EP_FIRST_REROUTED \
                or not abs(o["dropped"][0] - dropped[0]) <= EP_FIRST_DROP_TOL:
            raise RuntimeError(f"{label}: routing drops {o['dropped']} vs "
                               f"one process {dropped} (first layer within "
                               f"{EP_FIRST_DROP_TOL}), first layer's tokens "
                               f"re-routed {o['rerouted'][0]} (at most "
                               f"{EP_FIRST_REROUTED})")
        if o["forward_launches"].get("gmm") != 3 * layers \
                or {b[0] for b in o["buckets"]} != {e_loc} \
                or len(o["buckets"]) != 3 * layers:
            raise RuntimeError(f"{label}: forward gmm launches "
                               f"{o['forward_launches']}, buckets "
                               f"{o['buckets']} (3 a layer of {e_loc} "
                               f"experts expected)")
        experts = {n: s for n, s in o["held"].items()
                   if n.rpartition(".")[2] in ("w_gate", "w_up", "w_down")}
        if len(experts) != 3 * layers \
                or any(s[0] != e_loc for s in experts.values()):
            raise RuntimeError(f"{label}: held expert blocks {experts}")
        errs = [abs(a - b) / abs(b) for a, b in zip(o["losses"], losses)]
        if not max(errs) <= KERNEL_TOL["bfloat16"]:
            raise RuntimeError(f"{label}: losses {o['losses']} vs one "
                               f"process {losses}")
        # forward 3 a layer, its recompute (remat="full") 3, backward
        # dL/da 3 a layer, every step
        if o["launches"].get("gmm") != 9 * layers * EP_STEPS:
            raise RuntimeError(f"{label}: gmm launches {o['launches']} "
                               f"in {EP_STEPS} steps (forward, recompute "
                               f"and backward: {9 * layers} a step "
                               f"expected)")
        for walks in (o["walks"], o["forward_walks"]):
            check_tensor_core_walks("ep", walks)
            check_dense_mm_walks("ep", walks)
        o["loss_errs"] = errs
    return dict(ranks=outs, one_process=one, experts_per_rank=e_loc,
                layers=layers, gspmd=gspmd_outs, gspmd_s=gspmd_s,
                phase_s=time.perf_counter() - t0)


def print_dp(dp):
    import numpy as np
    one = dp["one_process"]
    for compress in (False, True):
        o = one[compress]
        print(f"[dp] one process grad_compress={compress}: losses "
              f"{[round(v, 5) for v in o['losses']]}; parameters "
              f"{o['params_gib']:.3f} GiB; fp32 state "
              f"{o['state_gib']:.3f} GiB; peak {o['peak_gib']:.2f} GiB")
        for r, per in enumerate(dp["per_rank"]):
            g = per[compress]
            comm = {k: round(float(np.median(v)), 3)
                    for k, v in g["comm_ms"].items()}
            print(f"[dp] rank {r}/{dp['ranks']} grad_compress={compress}: "
                  f"losses {[round(v, 5) for v in g['losses']]} (first "
                  f"{g['first_loss_err']:.2e}, worst {g['loss_err']:.2e});"
                  f" masters vs one process rel L2 "
                  f"{g['master_err']['rel_l2']:.2e} (rel-max "
                  f"{g['master_err']['rel_max']:.2e}); step "
                  f"p50 {float(np.median(g['step_ms'])):.1f} ms (host "
                  f"clock, synchronised); collectives ms of a step "
                  f"(median) {json.dumps(comm)}; peak "
                  f"{g['peak_gib']:.2f} GiB; parameters held (FSDP) "
                  f"{g['params_gib']:.3f} GiB = {g['params_share']:.3f} of "
                  f"one process's; fp32 state "
                  f"{g['state_gib']:.3f} GiB = {g['state_share']:.3f} of "
                  f"one process's; launches {json.dumps(g['launches'])}; "
                  f"by walk {json.dumps(g['walks'])}")
            print(f"[dp] rank {r}/{dp['ranks']} grad_compress={compress}: "
                  f"FSDP forward gathers (recompute included) "
                  f"{comm.get('fsdp_gather', 0):.1f} ms a step "
                  f"({comm.get('fsdp_gather_calls', 0):.0f} calls), "
                  f"backward reduce-scatters "
                  f"{comm.get('fsdp_reduce_scatter', 0):.1f} ms a step "
                  f"({comm.get('fsdp_reduce_scatter_calls', 0):.0f} "
                  f"calls; gloo on card tensors: an all-reduce each)")
    for label, c in dp["checkpoint"].items():
        print(f"[dp] checkpoint at step {DP_SAVE_AT} {label}: losses "
              f"{[round(v, 5) for v in c['losses']]} vs unbroken, rel "
              f"{[float(f'{e:.2e}') for e in c['errs']]}")
    print(f"[dp] phase {dp['phase_s']:.1f} s")


def print_ep(ep):
    import numpy as np
    one = ep["one_process"]
    print(f"[ep] one process (gspmd, {ep['layers']} layers): losses "
          f"{[round(v, 5) for v in one['losses']]}; drops "
          f"{[round(v, 4) for v in one['dropped']]}; fp32 state "
          f"{one['state_gib']:.3f} GiB; peak {one['peak_gib']:.2f} GiB")
    for r, o in enumerate(ep["ranks"]):
        comm = {k: round(float(np.median(v)), 3)
                for k, v in o["comm_ms"].items()}
        layer_errs = [float(f"{c['err']:.2e}") for c in o["layers"]]
        print(f"[ep] rank {r} mesh {EP_MESH} ({ep['experts_per_rank']} "
              f"experts a layer): layers vs gspmd on the same input "
              f"{layer_errs} (budget {KERNEL_TOL['bfloat16']}), forward "
              f"logits vs one "
              f"process {o['logits_err']:.2e} (reported), over the "
              f"{o['same_tokens']} tokens routed alike "
              f"{o['same_logits_err']:.2e} (budget {CONSISTENCY_TOL}; "
              f"tokens re-routed a layer {o['rerouted']}); drops "
              f"{[round(v, 4) for v in o['dropped']]}; forward gmm "
              f"{o['forward_launches'].get('gmm')} on buckets "
              f"{sorted(set(o['buckets']))}; held "
              f"{json.dumps(o['held'])}; train losses "
              f"{[round(v, 5) for v in o['losses']]} (rel "
              f"{[float(f'{e:.2e}') for e in o['loss_errs']]}); step p50 "
              f"{float(np.median(o['step_ms'])):.1f} ms; collectives ms "
              f"of a step (median) {json.dumps(comm)}; peak "
              f"{o['peak_gib']:.2f} GiB; fp32 state {o['state_gib']:.3f} "
              f"GiB; launches {json.dumps(o['launches'])}; by walk "
              f"{json.dumps(o['walks'])}")
    for r, o in enumerate(ep["gspmd"]):
        for shape, g in o.items():
            errs = [float(f"{c['err']:.2e}") for c in g["layers"]]
            print(f"[ep] gspmd rank {r} mesh {shape}: layers vs one "
                  f"process on the global batch {errs} (budget "
                  f"{KERNEL_TOL['bfloat16']}), kept equal "
                  f"{[(c['kept_equal'], c['tokens']) for c in g['layers']]}"
                  f", drops {[round(v, 4) for v in g['dropped']]}, buckets "
                  f"{[(c['bucket'], c['cap']) for c in g['layers']]} (C, "
                  f"global capacity); experts held "
                  f"{sorted(set(g['experts'].values()))}; forward "
                  f"{g['forward_s']:.2f} s; peak {g['peak_gib']:.2f} GiB; "
                  f"gmm {g['launches'].get('gmm')} by walk "
                  f"{json.dumps(g['walks']['gmm'])}")
    print(f"[ep] gspmd {ep['gspmd_s']:.1f} s; phase {ep['phase_s']:.1f} s")


# -- [mp]: model parallelism over gloo ranks of the one card -------------------

# [mp]: llama3.2-1b (d = 1/8) split over a (1, MP_RANKS) mesh's "model"
# axis, MP_STEPS eager train steps of [train]'s global batch, and an
# eager engine serving MP_PROMPTS
MP_RANKS, MP_STEPS, MP_MAX_LEN = 2, 3, 256
MP_PROMPTS = (40, 77, 128, 200)
MP_NEW_TOKENS = 8
# the share of teacher-forced greedy ids equal to one process's (bf16
# partials summed over the ranks flip near-ties of the random-init
# logits: 0.9577 of 473 read on an H100, the engine's 0.9688 of 32)
MP_FORCED_EQUAL = 0.9
# a rank's master error over the steps' movement of that master, the
# largest over the masters (0.053 read on an H100; a rank that never
# updated a master reads 1)
MP_OF_MOVED = 0.5


def mp_kernel_rows(torch, args):
    """The kernels at the shapes a model-parallel rank gives them, each
    against its plain version (bf16, the device's budget): dense_mm at
    the projections' shard widths (llama3.2-1b at m = 2: q 2048 -> 1024,
    k/v 2048 -> 256, o 1024 -> 2048; glm4-9b at m = 4: q 4096 -> 1024,
    up / gate 4096 -> 3424, down 3424 -> 4096; at m = 2 mamba2-130m's
    in projection 768 -> 1816, deepseek's q 2048 -> 1536 and kv_b 512 ->
    2048, seamless's q 1024 -> 512) at decode N 4 and the train step's
    2048 tokens; bs_attn on a rank's heads (llama 16 of 32 query heads,
    4 KV, S 512, batch 4; glm4 8 query heads on 1 KV head, dh 128;
    deepseek's MLA 8 of 16 heads at dh 192 and seamless's 8 of 16 at dh
    64, [mp] mixers' batch 2 x 256); bsmm on one held k-shard of llama's
    up/gate (q 2) at N 4 and 2048.  Each row times one library call beside it (``torch.matmul``,
    on the k-shard's densified weight for bsmm; SDPA)."""
    import torch.nn.functional as F

    from repro_torch import sparse
    from repro_torch.kernels.bs_attn import ops as bs_ops
    from repro_torch.kernels.bs_attn.ref import attend_plain
    from repro_torch.kernels.bsmm import ops as bsmm_ops
    from repro_torch.kernels.dense_mm import ops as dmm_ops
    from repro_torch.models import attention

    gen = torch.Generator(device="cuda").manual_seed(args.seed + 301)
    dt = torch.bfloat16

    def randn(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dt)
    rows = []
    for name, k, d in (("llama q shard", 2048, 1024),
                       ("llama k/v shard", 2048, 256),
                       ("llama o shard", 1024, 2048),
                       ("glm4 q shard", 4096, 1024),
                       ("glm4 up shard", 4096, 3424),
                       ("glm4 down shard", 3424, 4096),
                       ("mamba2 in_proj shard", 768, 1816),
                       ("deepseek q shard", 2048, 1536),
                       ("deepseek kv_b shard", 512, 2048),
                       ("seamless q shard", 1024, 512)):
        w = randn((k, d), 1 / math.sqrt(k))
        for n in (4, 2048):
            x = randn((n, k))
            nbytes = (n * k + k * d + n * d) * 2
            sets = copies(lambda: (x.clone(), w.clone()), nbytes)
            row = measured_row(torch, "dense_mm", f"{name} {k}x{d}", n,
                               "bfloat16", dmm_ops.dense_mm_cuda,
                               dmm_ops.dense_mm_plain, torch.matmul, sets,
                               sets, nbytes, 2.0 * n * k * d)
            row["walk"] = dmm_ops.walk(n, k, d, dt).name
            rows.append(row)
            del sets
    for name, b_, s_, h, kvh, dh in (
            ("llama heads shard", 4, 512, 16, 4, 64),
            ("glm4 heads shard", 4, 512, 8, 1, 128),
            ("deepseek MLA heads shard", MP_MIXER_BATCH, MP_MIXER_SEQ, 8,
             8, 192),
            ("seamless heads shard", MP_MIXER_BATCH, MP_MIXER_SEQ, 8, 8,
             64)):
        spec = attention.attn_spec(s_, s_, dh, causal=True, tile_q=128,
                                   tile_kv=128)
        walk, el = spec.walk(torch.device("cuda", 0)), \
            spec.element_mask(torch.device("cuda", 0))
        q, kk, v = (randn((b_, s_, h, dh)), randn((b_, s_, kvh, dh)),
                    randn((b_, s_, kvh, dh)))
        nbytes = (2 * q.numel() + kk.numel() + v.numel()) * 2
        sets = copies(lambda: (q.clone(), kk.clone(), v.clone()), nbytes)
        pairs = b_ * int(el.sum().item())

        def kernel(q_, k_, v_, walk=walk, spec=spec):
            return bs_ops.bs_attn_cuda(q_, k_, v_, walk, scale=spec.scale,
                                       causal=True)

        def plain(q_, k_, v_, el=el, spec=spec):
            return attend_plain(q_, k_, v_, el, scale=spec.scale)

        def sdpa(q_, k_, v_, spec=spec, h=h, kvh=kvh):
            return F.scaled_dot_product_attention(
                q_.transpose(1, 2), k_.transpose(1, 2), v_.transpose(1, 2),
                is_causal=True, scale=spec.scale,
                enable_gqa=h != kvh).transpose(1, 2)
        row = measured_row(torch, "bs_attn", f"{name} H={h} KV={kvh} "
                           f"dh={dh} B={b_}", s_, "bfloat16", kernel, plain,
                           sdpa, sets, sets, nbytes, 4.0 * pairs * dh * h)
        row["walk"] = bs_ops.kernel_walk(dt)
        rows.append(row)
        del sets, walk, el
    for n in (4, 2048):
        bsr, x, _ = tp_problem(torch, 8192, 2048, n, args.seed + 303)
        p = sparse.plan(bsr, n, device="cuda", ctx=sparse.PlanContext(
            mode="static_tp", tp_q=MP_RANKS))
        shard, src = p.tp.plans[0], p.tp.src[0]
        held = bsr.values[src].contiguous()
        packed = shard.pack(held)
        rows_, cols_ = (torch.as_tensor(a, dtype=torch.long, device="cuda")
                        for a in p.tp.meta.shard_pattern(0))
        dense = torch.zeros((512, 128, 16, 16), device="cuda")
        dense[rows_, cols_] = held.float()
        dense = dense.permute(0, 2, 1, 3).reshape(8192, 2048)
        dense16 = dense.to(dt)
        nbytes = (held.numel() + n * 2048 + n * 8192) * 2
        sets = copies(lambda: (x.clone(),), nbytes)
        lib_sets = copies(lambda: (x.clone(), dense16.clone()),
                          (n * 2048 + dense16.numel()) * 2)
        row = measured_row(
            torch, "bsmm", f"llama up/gate k-shard 0 of {MP_RANKS} "
            f"8192x2048", n, "bfloat16",
            lambda xx: shard.run_packed(packed, xx),
            lambda xx: (xx.float() @ dense.t()).to(dt),
            lambda xx, ww: torch.matmul(xx, ww.t()), sets, lib_sets,
            nbytes, 2.0 * n * held.numel())
        row.update(walk=bsmm_ops.walk(16, dt, n), blocks=int(held.shape[0]),
                   whole_blocks=int(bsr.values.shape[0]))
        rows.append(row)
        del sets, lib_sets, dense, dense16, packed
    bad = [r for r in rows if not r["rel_err"] <= r["tol"]]
    if bad:
        raise RuntimeError(f"[mp] kernels at shard shapes disagree with "
                           f"their plain versions: {bad}")
    return rows


def all_reduce_timer(torch):
    """Time every ``torch.distributed.all_reduce`` of this process (host
    clock between two device synchronisations; gloo stages a card
    tensor through the host anyway): the list the ms go to."""
    import torch.distributed as dist
    times = []
    call = dist.all_reduce

    def timed(tensor, *a, **kw):
        if tensor.is_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = call(tensor, *a, **kw)
        if tensor.is_cuda:
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        return out
    dist.all_reduce = timed
    return times


def mp_requests(cfg, seed):
    import numpy as np

    from repro_torch.serve import Request
    rng = np.random.default_rng(seed + 211)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, size=n),
                    max_new_tokens=MP_NEW_TOKENS)
            for i, n in enumerate(MP_PROMPTS)]


def served_seqs(reqs):
    """Each served request's prompt and its tokens but the last: the
    sequence whose greedy next tokens (from position ``len(prompt) - 1``
    on) are the request's output."""
    import numpy as np
    return [np.concatenate([r.prompt, np.asarray(r.output[:-1],
                                                 dtype=r.prompt.dtype)])
            for r in reqs]


def forced_greedy(lm, seqs):
    """Teacher-forced greedy ids: the argmax of ``lm``'s forward logits
    at every position of each sequence (one row each), on the CPU."""
    return [lm(seq[None, :])[0].argmax(dim=-1).cpu() for seq in seqs]


def mp_job(torch, rank, world, job):
    """[mp] on one rank: ``train_loop`` over the (1, world) mesh (the
    model split over "model"; counters zeroed just before, read just
    after; every all-reduce timed), each held block's share of its whole
    tensor, then from the seed again the prefill logits of the first
    prompt, decode against forward, and an eager engine's tokens."""
    from repro_torch.kernels import bs_attn, bsmm, dense_mm, sddmm
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.launch.train import train_loop
    from repro_torch.models.model import LM
    from repro_torch.serve import Engine
    from repro_torch.train.step import TrainHParams
    mesh = make_device_mesh("cuda", (1, world), ("data", "model"))
    counters = with_walks({"bsmm": bsmm.COUNTER, "sddmm": sddmm.COUNTER,
                           "dense_mm": dense_mm.COUNTER,
                           "bs_attn": bs_attn.COUNTER})
    args, cfg = job["args"], job["cfg"]
    times = timed_steps(torch)
    ar_ms = all_reduce_timer(torch)
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.reset()
    state, losses = train_loop(
        cfg, steps=MP_STEPS, batch_per_shard=DP_BATCH, seq=DP_SEQ,
        ckpt_dir=None, hp=TrainHParams(**TRAIN_HP), device="cuda",
        log_every=10 ** 9, seed=args.seed, graphs=False, mesh=mesh)
    torch.cuda.synchronize()
    launches, walks = split_walks({k: c.launches
                                   for k, c in counters.items()})
    lay = state.layout
    shares = {n: state.params[n].numel() / math.prod(lay.place[n].block.shape)
              for n in lay.held}
    out = dict(losses=losses, launches=launches, walks=walks,
               step_ms=list(times), all_reduce_ms=sum(ar_ms) / MP_STEPS,
               all_reduces=len(ar_ms) / MP_STEPS,
               layout_ms=dict(lay.comm_ms), shares=shares,
               partial=sorted(lay.partial),
               held_gib=sum(state.params[n].numel() for n in lay.held)
               * 2 / 2 ** 30,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               state_gib=state_gib(state),
               master_err=master_err(torch, state, job["masters"]))
    del state, lay
    gc.collect()
    torch.cuda.empty_cache()
    lm = LM(cfg, device="cuda", seed=args.seed, mesh=mesh)
    reqs = mp_requests(cfg, args.seed)
    logits, _ = lm.prefill(reqs[0].prompt[None, :], max_len=MP_MAX_LEN)
    out["prefill_logits"] = logits.float().cpu()
    out["forced"] = forced_greedy(lm, job["seqs"])
    out["consistency"] = decode_consistency(torch, lm, 100, args.seed + 7,
                                            CONSISTENCY_TOL)
    for c in counters.values():
        c.reset()
    eng = Engine(lm, device="cuda", batch=len(reqs), max_len=MP_MAX_LEN,
                 mesh=mesh, graphs=False)
    eng.run(reqs)
    torch.cuda.synchronize()
    out["serve_launches"], out["serve_walks"] = split_walks(
        {k: c.launches for k, c in counters.items()})
    out["tokens"] = [r.output for r in reqs]
    out["cache_heads"] = int(eng.caches[0]["k"].shape[2])
    del eng
    gc.collect()
    out["forced_own"] = forced_greedy(lm, served_seqs(reqs))
    del lm
    gc.collect()
    return out


def mp_phase(torch, args):
    """[mp]: model parallelism, llama3.2-1b at full width and depth
    (every FFN block-sparse, d = 1/8, b = 16, bf16) split over a (1, 2)
    ``("data", "model")`` mesh of 2 gloo ranks on this card: 16 of 32
    query and 4 of 8 KV heads a rank, half the vocabulary, each sparse
    FFN's k-shard (``static_tp_shardmap``).  ``MP_STEPS`` eager
    ``train_loop`` steps of [train]'s global batch (4 x 512) against the
    one-process run in this process; an eager ``Engine(mesh=,
    graphs=False)`` serving ``MP_PROMPTS`` against one process's.  Fails
    unless every loss is within bf16 2e-2 of one process's, each rank's
    final master blocks within bf16 2e-2 of one process's fp32 masters
    in relative L2 (``master_err``, as [dp]) while the steps moved some
    master past that budget (the control: a rank that never updated
    would fail), and each master's error at most ``MP_OF_MOVED`` of the
    steps' movement of it,
    the first prompt's prefill logits within ``CONSISTENCY_TOL`` (6e-2,
    the bf16 budget of a whole model's outputs: 16 layers of bf16
    partials summed over the ranks), decode within ``CONSISTENCY_TOL``
    of ``forward`` (``decode_consistency``), at least
    ``MP_FORCED_EQUAL`` of the teacher-forced greedy ids on one
    process's served sequences equal to one process's, and of the rank
    engine's tokens equal to its own forward's on its sequences
    (``forced_greedy``), every dense projection, table and norm block is
    whole / 2 of its tensor (the k-shards' blocks sum to the whole),
    bsmm, sddmm, dense_mm and bs_attn launched on their 16-bit walks in
    the steps and bsmm, dense_mm and bs_attn in the engine, and the
    caches hold 4 KV heads.  The free-running engine's tokens are
    reported beside one process's (bf16: the ranks sum partial outputs,
    so a near-tie of the greedy argmax may flip, and the rest of that
    request differs).  Prints step p50 and all-reduce ms a rank and the
    peak GiB a
    rank against one process; the kernels at the shard shapes first
    (``mp_kernel_rows``)."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.launch.train import train_loop
    from repro_torch.models.model import LM
    from repro_torch.serve import Engine
    from repro_torch.train.step import TrainHParams

    t0 = time.perf_counter()
    krows = mp_kernel_rows(torch, args)
    cfg = configs.sparsify_ffn(configs.get("llama3_2_1b"), 1 / 8)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state, losses = train_loop(
        cfg, steps=MP_STEPS, batch_per_shard=DP_BATCH, seq=DP_SEQ,
        ckpt_dir=None, hp=TrainHParams(**TRAIN_HP), device="cuda",
        log_every=10 ** 9, seed=args.seed, graphs=False)
    one = dict(losses=losses, state_gib=state_gib(state),
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               params_gib=sum(p.numel() for p in state.params.values())
               * 2 / 2 ** 30)
    # the final fp32 masters, shared with the ranks (CUDA IPC): in bf16
    # a norm's scale near 1 would round its 3 steps' movement away
    masters = dict(state.opt.master)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    lm = LM(cfg, device="cuda", seed=args.seed)
    # the control: how far the steps moved each master from its init
    # (the error a rank that never updated would read)
    moved = {}
    for n, m in masters.items():
        w = m.float()
        moved[n] = ((w - lm.get_parameter(n).float()).norm()
                    / w.norm().clamp_min(1e-12)).item()
    reqs = mp_requests(cfg, args.seed)
    logits, _ = lm.prefill(reqs[0].prompt[None, :], max_len=MP_MAX_LEN)
    want_logits = logits.float().cpu()
    eng = Engine(lm, device="cuda", batch=len(reqs), max_len=MP_MAX_LEN,
                 graphs=False)
    eng.run(reqs)
    one["tokens"] = [r.output for r in reqs]
    del eng
    seqs = served_seqs(reqs)
    want_forced = forced_greedy(lm, seqs)
    del lm, logits
    gc.collect()
    torch.cuda.empty_cache()
    outs = run_ranks(torch, "mp", shard_rank_main, MP_RANKS, "mp",
                     dict(cfg=cfg, args=args, masters=masters, seqs=seqs))
    del masters
    gc.collect()
    torch.cuda.empty_cache()
    tol = KERNEL_TOL["bfloat16"]
    one["moved"] = max(moved.values())
    if not one["moved"] > tol:
        raise RuntimeError(f"[mp] the steps moved no master past the "
                           f"budget {tol} ({one['moved']:.3g}): the "
                           f"masters' check could not tell a rank that "
                           f"never updated")
    gen = [slice(len(r.prompt) - 1, None) for r in reqs]
    for r, o in enumerate(outs):
        label = f"[mp] rank {r}"
        o["loss_errs"] = [abs(a - b) / abs(b)
                          for a, b in zip(o["losses"], losses)]
        o["prefill_err"] = rel_err(o["prefill_logits"], want_logits)[0]
        del o["prefill_logits"]
        per = o["master_err"].pop("per")
        # a master the steps left where it was (no gradient reached it)
        # must read 0 as well
        o["master_err"]["of_moved"] = max(
            per[n] / moved[n] if moved[n] > 0 else
            (0.0 if per[n] == 0 else math.inf) for n in per)
        # teacher-forced greedy: the rank's ids on one process's served
        # sequences against one process's, at every position; and the
        # rank engine's tokens against its own forward on them
        n_pos = sum(len(w) for w in want_forced)
        o["forced_equal"] = sum(int((a == b).sum()) for a, b in
                                zip(o["forced"], want_forced)) / n_pos
        o["engine_forced_equal"] = sum(
            int((f[g] == torch.as_tensor(t)).sum())
            for f, g, t in zip(o["forced_own"], gen, o["tokens"])) \
            / sum(len(t) for t in o["tokens"])
        del o["forced"], o["forced_own"]
        if len(o["losses"]) != MP_STEPS or not max(o["loss_errs"]) <= tol \
                or not o["prefill_err"] <= CONSISTENCY_TOL \
                or not o["master_err"]["rel_l2"] <= tol \
                or not o["master_err"]["of_moved"] <= MP_OF_MOVED:
            raise RuntimeError(f"{label}: losses {o['losses']} vs one "
                               f"process {losses} (budget {tol}), prefill "
                               f"logits {o['prefill_err']:.3g} (budget "
                               f"{CONSISTENCY_TOL}), masters "
                               f"{o['master_err']} (budget {tol} on "
                               f"rel_l2, {MP_OF_MOVED} on of_moved)")
        if not o["forced_equal"] >= MP_FORCED_EQUAL \
                or not o["engine_forced_equal"] >= MP_FORCED_EQUAL:
            raise RuntimeError(f"{label}: teacher-forced greedy ids equal "
                               f"to one process's at "
                               f"{o['forced_equal']:.4f} of the positions, "
                               f"the engine's tokens to the rank's forward "
                               f"at {o['engine_forced_equal']:.4f} (at "
                               f"least {MP_FORCED_EQUAL})")
        for k in ("bsmm", "sddmm", "dense_mm", "bs_attn"):
            if o["launches"].get(k, 0) <= 0:
                raise RuntimeError(f"{label}: {k} not launched in the "
                                   f"steps: {o['launches']}")
        for k in ("bsmm", "dense_mm", "bs_attn"):
            if o["serve_launches"].get(k, 0) <= 0:
                raise RuntimeError(f"{label}: {k} not launched by the "
                                   f"engine: {o['serve_launches']}")
        for walks in (o["walks"], o["serve_walks"]):
            check_tensor_core_walks("mp", walks, ("bs_attn", "sddmm",
                                                  "bsmm"))
            check_dense_mm_walks("mp", walks)
        off = {n: v for n, v in o["shares"].items()
               if not n.endswith(".values") and not n.endswith("norm.scale")
               and v != 1 / MP_RANKS}
        if off or o["partial"] or o["cache_heads"] != \
                cfg.num_kv_heads // MP_RANKS:
            raise RuntimeError(f"{label}: held blocks not whole / "
                               f"{MP_RANKS}: {off}; partial {o['partial']};"
                               f" cache heads {o['cache_heads']}")
        o["tokens_equal"] = sum(a == b for t, u in zip(o["tokens"],
                                                       one["tokens"])
                                for a, b in zip(t, u))
    for n in (n for n in outs[0]["shares"] if n.endswith(".values")):
        total = sum(o["shares"][n] for o in outs)
        if abs(total - 1) > 1e-9:
            raise RuntimeError(f"[mp] the k-shards of {n} hold "
                               f"{total} of its blocks")
    if outs[1]["tokens"] != outs[0]["tokens"]:
        raise RuntimeError(f"[mp] the ranks' tokens differ: "
                           f"{[o['tokens'] for o in outs]}")
    return dict(ranks=outs, one_process=one, kernel_rows=krows,
                phase_s=time.perf_counter() - t0)


# [mp]'s mixers at full width on the (1, MP_RANKS) mesh: (label, arch,
# decoder layers or None for full depth (trained and served in bf16),
# encoder layers, and the dtype its prefill logits and teacher-forced ids
# are held to one process's in: mamba2's 24 bf16 SSD layers amplify
# one-ulp roundings past the bf16 budget (the ranks' bf16 partial sums
# are such roundings; `tests/test_torch_hybrid.py`
# `test_bf16_gap_at_mamba2_depth_is_the_dtype_s`), so its checks run on
# an fp32 copy at the same seed, within LOGITS_TOL_FP32
MP_MIXERS = (("deepseek-v2-lite", DEEPSEEK, 2, None, "bfloat16"),
             ("mamba2-130m", MAMBA2, None, None, "float32"),
             ("seamless-m4t-medium", SEAMLESS, 2, 2, "bfloat16"))
MP_MIXER_BATCH, MP_MIXER_SEQ, MP_MIXER_FRAMES = 2, 256, 256
MP_MIXER_PROMPTS = (40, 77, 128)


def mp_mixer_cfg(arch, layers, enc_layers):
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch.profile_train import cut_depth
    cfg = configs.get(arch)
    if layers is not None:
        cfg = cut_depth(cfg, layers)
    if enc_layers is not None:
        cfg = dataclasses.replace(cfg, encoder_layers=enc_layers)
    return cfg


def mp_mixer_frames(cfg, batch, seed):
    """Seeded encoder frames ``[batch, MP_MIXER_FRAMES, D]`` (numpy fp32)
    for a config with an encoder, else None."""
    import numpy as np
    if not cfg.encoder_layers:
        return None
    return np.random.default_rng(seed).standard_normal(
        (batch, MP_MIXER_FRAMES, cfg.d_model), dtype=np.float32)


def mp_mixer_serve(torch, lm, cfg, reqs, mesh, seed):
    """Greedy tokens of ``reqs``: the eager ``Engine`` (on ``mesh``), or
    for a cross stack, which the engine refuses, ``prefill(enc_frames=)``
    and ``decode_step`` a request at a time; and the first layer's cache
    shapes."""
    import numpy as np

    from repro_torch.serve import Engine
    from repro_torch.sharding import rules
    frames = mp_mixer_frames(cfg, 1, seed + 5)
    kw = {} if frames is None else {"enc_frames": frames}
    with rules.activation_mesh(mesh, batch_split=False):
        if frames is None:
            eng = Engine(lm, device="cuda", batch=len(reqs),
                         max_len=MP_MAX_LEN, mesh=mesh, graphs=False)
            eng.run(reqs)
            heads = {k: list(v.shape) for k, v in eng.caches[0].items()}
            del eng
            gc.collect()
            return [r.output for r in reqs], heads
        out = []
        for r in reqs:
            lg, caches = lm.prefill(r.prompt[None, :], max_len=MP_MAX_LEN,
                                    **kw)
            toks = []
            for i in range(MP_NEW_TOKENS):
                toks.append(int(torch.argmax(lg[0])))
                lg, caches = lm.decode_step(
                    np.asarray([[toks[-1]]]), caches,
                    np.asarray([len(r.prompt) + i]))
            r.output = toks
            out.append(toks)
        heads = {k: list(v.shape) for k, v in caches[0].items()}
        return out, heads


def mp_mixer_forced(torch, lm, cfg, seqs, mesh, seed):
    """``forced_greedy`` under ``mesh`` (the MoE layers read it), with a
    cross stack's frames."""
    from repro_torch.sharding import rules
    frames = mp_mixer_frames(cfg, 1, seed + 5)
    kw = {} if frames is None else {"enc_frames": frames}
    with rules.activation_mesh(mesh, batch_split=False):
        return [lm(seq[None, :], **kw)[0].argmax(dim=-1).cpu()
                for seq in seqs]


def mp_mixer_checked(torch, lm, cfg, check, prompt, seqs, mesh, seed):
    """What [mp]'s mixers hold against one process: ``prompt``'s prefill
    logits and the teacher-forced greedy ids on ``seqs``, from ``lm``,
    or from an fp32 copy at the same seed where ``check`` says so."""
    import dataclasses

    from repro_torch.models.model import LM
    from repro_torch.sharding import rules
    if check != cfg.dtype:
        cfg = dataclasses.replace(cfg, dtype=check)
        lm = LM(cfg, device="cuda", seed=seed, mesh=mesh)
    frames = mp_mixer_frames(cfg, 1, seed + 5)
    kw = {} if frames is None else {"enc_frames": frames}
    with rules.activation_mesh(mesh, batch_split=False):
        logits, _ = lm.prefill(prompt[None, :], max_len=MP_MAX_LEN, **kw)
    return (logits.float().cpu(),
            mp_mixer_forced(torch, lm, cfg, seqs, mesh, seed))


def mp_mixer_train(torch, cfg, args, mesh=None):
    """``MP_STEPS`` eager ``train_loop`` steps of ``cfg`` (a cross stack
    with seeded frames): ``(state, losses)``."""
    from repro_torch.launch.train import train_loop
    from repro_torch.train.step import TrainHParams
    frames = mp_mixer_frames(cfg, MP_MIXER_BATCH, args.seed + 9)
    return train_loop(
        cfg, steps=MP_STEPS, batch_per_shard=MP_MIXER_BATCH,
        seq=MP_MIXER_SEQ, ckpt_dir=None, hp=TrainHParams(**TRAIN_HP),
        device="cuda", log_every=10 ** 9, seed=args.seed, graphs=False,
        float_inputs=None if frames is None else
        (lambda step: {"enc_frames": frames}), mesh=mesh)


def params_gib(params) -> float:
    return sum(p.numel() * p.element_size() for p in params) / 2 ** 30


def mp_mixer_requests(cfg, seed):
    reqs = mp_requests(cfg, seed)[:len(MP_MIXER_PROMPTS)]
    for r, n in zip(reqs, MP_MIXER_PROMPTS):
        r.prompt = r.prompt[:n]
    return reqs


def mp_mixer_job(torch, rank, world, job):
    """[mp]'s mixers on one rank of the (1, world) mesh, model by model:
    ``MP_STEPS`` eager train steps (counters zeroed just before, read
    just after), the bytes the rank holds, then from the seed the served
    tokens (counters zeroed and read) and the caches' shapes, and the
    first prompt's prefill logits and teacher-forced greedy ids on one
    process's served sequences in the model's check dtype
    (``mp_mixer_checked``)."""
    from repro_torch.kernels import bs_attn, dense_mm, gmm
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models.model import LM
    mesh = make_device_mesh("cuda", (1, world), ("data", "model"))
    counters = with_walks({"dense_mm": dense_mm.COUNTER,
                           "bs_attn": bs_attn.COUNTER, "gmm": gmm.COUNTER})
    args, outs = job["args"], {}
    for (label, arch, layers, enc, check), seqs in zip(MP_MIXERS,
                                                       job["seqs"]):
        cfg = mp_mixer_cfg(arch, layers, enc)
        times = timed_steps(torch)
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.reset()
        t0 = time.perf_counter()
        state, losses = mp_mixer_train(torch, cfg, args, mesh)
        torch.cuda.synchronize()
        launches, walks = split_walks({k: c.launches
                                       for k, c in counters.items()})
        lay = state.layout
        out = dict(losses=losses, launches=launches, walks=walks,
                   train_s=time.perf_counter() - t0, step_ms=list(times),
                   params_gib=params_gib(state.params.values()),
                   held_gib=params_gib(state.params[n] for n in lay.held),
                   held=sorted(lay.held), partial=sorted(lay.partial),
                   shares={n: state.params[n].numel()
                           / math.prod(lay.place[n].block.shape)
                           for n in lay.held},
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        del state, lay
        gc.collect()
        torch.cuda.empty_cache()
        lm = LM(cfg, device="cuda", seed=args.seed, mesh=mesh)
        reqs = mp_mixer_requests(cfg, args.seed)
        for c in counters.values():
            c.reset()
        out["tokens"], out["cache"] = mp_mixer_serve(
            torch, lm, cfg, reqs, mesh, args.seed)
        torch.cuda.synchronize()
        out["serve_launches"], out["serve_walks"] = split_walks(
            {k: c.launches for k, c in counters.items()})
        out["forced_own"] = mp_mixer_forced(torch, lm, cfg,
                                            served_seqs(reqs), mesh,
                                            args.seed)
        out["prefill_logits"], out["forced"] = mp_mixer_checked(
            torch, lm, cfg, check, reqs[0].prompt, seqs, mesh, args.seed)
        outs[label] = out
        del lm
        gc.collect()
        torch.cuda.empty_cache()
    return outs


def mp_mixer_phase(torch, args):
    """[mp]'s mixers: deepseek-v2-lite at 2 layers (its dense layer and
    one MoE layer: MLA at 8 of 16 heads a rank, dh 192), mamba2-130m at
    full depth (12 of 24 SSD heads a rank; the in projection's block
    1816 of 3352 columns) and seamless-m4t-medium at 2 + 2 layers (the
    encoder's and the cross attention's 8 of 16 heads a rank), each at
    full width, bf16, split over the (1, 2) mesh of 2 gloo ranks of this
    card, against one process in this process: ``MP_STEPS`` eager
    ``train_loop`` steps of ``MP_MIXER_BATCH`` x ``MP_MIXER_SEQ`` (a
    cross stack with seeded frames), then the served requests
    (``MP_MIXER_PROMPTS``; ``Engine(mesh=, graphs=False)``, a cross
    stack by ``prefill`` / ``decode_step``).  Fails unless every loss is
    within bf16 2e-2 of one process's, the first prompt's prefill logits
    within ``CONSISTENCY_TOL`` (mamba2: an fp32 copy's within
    ``LOGITS_TOL_FP32``, its ids too, ``MP_MIXERS``), at least
    ``MP_FORCED_EQUAL`` of the
    teacher-forced greedy ids on one process's served sequences equal
    one process's and, without MoE (whose decode drops other
    assignments than its forward), of the rank's tokens its own
    forward's; the ranks' tokens equal each other's; every
    split mixer's parameters are held (MLA's q / kv_b / wo, Mamba-2's
    in / out projections, conv and heads, the cross and encoder
    projections), the caches hold the rank's heads (MLA's latent whole),
    dense_mm launched on its 16-bit walks, bs_attn (deepseek, seamless)
    and gmm (deepseek) on wgmma, in the steps and in serving.  Prints
    each rank's held and whole parameter GiB against one process's."""
    from repro_torch.models.model import LM
    t0 = time.perf_counter()
    ones, all_seqs = {}, []
    for label, arch, layers, enc, check in MP_MIXERS:
        cfg = mp_mixer_cfg(arch, layers, enc)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state, losses = mp_mixer_train(torch, cfg, args)
        one = dict(losses=losses, params_gib=params_gib(
            state.params.values()),
            peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        del state
        gc.collect()
        torch.cuda.empty_cache()
        lm = LM(cfg, device="cuda", seed=args.seed)
        reqs = mp_mixer_requests(cfg, args.seed)
        one["tokens"], one["cache"] = mp_mixer_serve(
            torch, lm, cfg, reqs, None, args.seed)
        seqs = served_seqs(reqs)
        one["prefill_logits"], one["forced"] = mp_mixer_checked(
            torch, lm, cfg, check, reqs[0].prompt, seqs, None, args.seed)
        ones[label] = one
        all_seqs.append(seqs)
        del lm
        gc.collect()
        torch.cuda.empty_cache()
    outs = run_ranks(torch, "mp-mixers", shard_rank_main, MP_RANKS,
                     "mp_mixers", dict(args=args, seqs=all_seqs))
    tol = KERNEL_TOL["bfloat16"]
    want_held = {"deepseek-v2-lite": ("attn.q.w.w", "attn.kv_b.w",
                                      "attn.wo.w"),
                 "mamba2-130m": ("mixer.in_proj.w", "mixer.out_proj.w",
                                 "mixer.conv_w", "mixer.conv_b",
                                 "mixer.dt_bias", "mixer.A_log",
                                 "mixer.D", "mixer.norm.scale"),
                 "seamless-m4t-medium": ("cross.wq.w", "cross.wk.w",
                                         "cross.wv.w", "cross.wo.w")}
    kernels = {"deepseek-v2-lite": ("dense_mm", "bs_attn", "gmm"),
               "mamba2-130m": ("dense_mm",),
               "seamless-m4t-medium": ("dense_mm", "bs_attn")}
    for label, arch, layers, enc, check in MP_MIXERS:
        cfg = mp_mixer_cfg(arch, layers, enc)
        one = ones[label]
        logits_tol = (LOGITS_TOL_FP32 if check == "float32"
                      else CONSISTENCY_TOL)
        gen = [slice(n - 1, None) for n in MP_MIXER_PROMPTS]
        for r, rank_outs in enumerate(outs):
            o = rank_outs[label]
            tag = f"[mp] {label} rank {r}"
            o["loss_errs"] = [abs(a - b) / abs(b)
                              for a, b in zip(o["losses"], one["losses"])]
            o["prefill_err"] = rel_err(o.pop("prefill_logits"),
                                       one["prefill_logits"])[0]
            n_pos = sum(len(w) for w in one["forced"])
            o["forced_equal"] = sum(
                int((a == b).sum()) for a, b in zip(o.pop("forced"),
                                                    one["forced"])) / n_pos
            o["engine_forced_equal"] = sum(
                int((f[g] == torch.as_tensor(t)).sum())
                for f, g, t in zip(o.pop("forced_own"), gen, o["tokens"])) \
                / sum(len(t) for t in o["tokens"])
            o["tokens_equal"] = sum(a == b for t, u in zip(o["tokens"],
                                                           one["tokens"])
                                    for a, b in zip(t, u))
            # an MoE's decode takes its capacity from the decode batch,
            # its forward from the sequence: they drop different
            # assignments, so its engine is not held to its forward; nor
            # is a bf16 stack whose checks run in fp32 (the depth
            # amplifies the decode's roundings as the ranks')
            own = (o["engine_forced_equal"]
                   if cfg.moe is None and check == cfg.dtype else 1.0)
            if len(o["losses"]) != MP_STEPS \
                    or not max(o["loss_errs"]) <= tol \
                    or not o["prefill_err"] <= logits_tol \
                    or not o["forced_equal"] >= MP_FORCED_EQUAL \
                    or not own >= MP_FORCED_EQUAL:
                raise RuntimeError(
                    f"{tag}: losses {o['losses']} vs one process "
                    f"{one['losses']} (budget {tol}), prefill logits "
                    f"{o['prefill_err']:.3g} in {check} (budget "
                    f"{logits_tol}), "
                    f"teacher-forced ids equal {o['forced_equal']:.4f}, "
                    f"engine tokens vs its forward "
                    f"{o['engine_forced_equal']:.4f} (at least "
                    f"{MP_FORCED_EQUAL})")
            missing = [k for k in want_held[label]
                       if not any(n.endswith(k) for n in o["held"])]
            if missing:
                raise RuntimeError(f"{tag}: split mixer parameters not "
                                   f"held: {missing}")
            for k in kernels[label]:
                for what, lc in (("steps", o["launches"]),
                                 ("serving", o["serve_launches"])):
                    if lc.get(k, 0) <= 0:
                        raise RuntimeError(f"{tag}: {k} not launched in "
                                           f"the {what}: {lc}")
            for walks in (o["walks"], o["serve_walks"]):
                check_dense_mm_walks("mp", walks)
                check_tensor_core_walks("mp", walks)
            cache = o["cache"]
            if "state" in cache and cache["state"][1] != \
                    cfg.ssm.num_heads(cfg.d_model) // MP_RANKS \
                    or "latent" in cache and \
                    cache["latent"] != one["cache"]["latent"] \
                    or "xk" in cache and \
                    cache["xk"][2] != cfg.num_kv_heads // MP_RANKS:
                raise RuntimeError(f"{tag}: caches {cache} do not hold the "
                                   f"rank's heads (one process "
                                   f"{one['cache']})")
            if not o["params_gib"] < one["params_gib"]:
                raise RuntimeError(f"{tag}: holds {o['params_gib']:.3f} "
                                   f"GiB of parameters, one process "
                                   f"{one['params_gib']:.3f}")
        if outs[1][label]["tokens"] != outs[0][label]["tokens"]:
            raise RuntimeError(f"[mp] {label}: the ranks' tokens differ")
        del one["prefill_logits"], one["forced"]
    return dict(one_process=ones, ranks=outs,
                phase_s=time.perf_counter() - t0)


def print_mp_mixers(mx):
    import numpy as np
    for label, one in mx["one_process"].items():
        print(f"[mp] {label} one process: losses "
              f"{[round(v, 5) for v in one['losses']]}; bf16 parameters "
              f"{one['params_gib']:.3f} GiB; peak {one['peak_gib']:.2f} GiB;"
              f" caches {json.dumps(one['cache'])}")
        n_tok = sum(len(t) for t in one["tokens"])
        for r, rank_outs in enumerate(mx["ranks"]):
            o = rank_outs[label]
            shares = sorted({round(v, 4) for v in o["shares"].values()})
            print(f"[mp] {label} rank {r} mesh (1, {MP_RANKS}): losses "
                  f"{[round(v, 5) for v in o['losses']]} (rel "
                  f"{[float(f'{e:.2e}') for e in o['loss_errs']]}); step "
                  f"p50 {float(np.median(o['step_ms'])):.1f} ms; "
                  f"parameters {o['params_gib']:.3f} GiB a rank against "
                  f"one process's {one['params_gib']:.3f} (held blocks "
                  f"{o['held_gib']:.3f} GiB, {len(o['held'])} tensors, "
                  f"shares {shares}; partial {len(o['partial'])}); peak "
                  f"{o['peak_gib']:.2f} GiB against one process's "
                  f"{one['peak_gib']:.2f}; prefill logits vs one process "
                  f"{o['prefill_err']:.2e}; teacher-forced ids equal "
                  f"{o['forced_equal']:.4f}, tokens vs the rank's forward "
                  f"{o['engine_forced_equal']:.4f}, equal to one process's "
                  f"{o['tokens_equal']} of {n_tok}; caches "
                  f"{json.dumps(o['cache'])}; launches "
                  f"{json.dumps(o['launches'])}; by walk "
                  f"{json.dumps(o['walks'])}; serving "
                  f"{json.dumps(o['serve_launches'])}")
    print(f"[mp] mixers phase {mx['phase_s']:.1f} s")


def print_mp(mp):
    import numpy as np
    for r in mp["kernel_rows"]:
        lib = (None if r["library_ms"] is None
               else round(r["library_ms"], 5))
        print(f"[mp] kernel {r['kernel']:9s} {r['shape']:44s} n={r['n']:<5d}"
              f" walk={r['walk']} rel_err={r['rel_err']:.2e} "
              f"ms={r['ms']:.5f} plain_ms={r['plain_ms']:.5f} "
              f"library_ms={lib} bound_ms={r['bound_ms']:.5f} "
              f"({r['bound_by']})")
    one = mp["one_process"]
    print(f"[mp] one process: losses {[round(v, 5) for v in one['losses']]};"
          f" masters moved by the steps (rel L2, largest) "
          f"{one['moved']:.3e};"
          f" peak {one['peak_gib']:.2f} GiB; bf16 parameters "
          f"{one['params_gib']:.3f} GiB; fp32 state {one['state_gib']:.3f} "
          f"GiB")
    n_tok = sum(len(t) for t in one["tokens"])
    for r, o in enumerate(mp["ranks"]):
        shares = sorted({round(v, 4) for v in o["shares"].values()})
        print(f"[mp] rank {r} mesh (1, {MP_RANKS}): losses "
              f"{[round(v, 5) for v in o['losses']]} (rel "
              f"{[float(f'{e:.2e}') for e in o['loss_errs']]}); step p50 "
              f"{float(np.median(o['step_ms'])):.1f} ms (host clock, every "
              f"all-reduce synchronised); all-reduces a step "
              f"{o['all_reduces']:.0f} taking {o['all_reduce_ms']:.1f} ms; "
              f"peak {o['peak_gib']:.2f} GiB against one process's "
              f"{one['peak_gib']:.2f}; held bf16 blocks {o['held_gib']:.3f}"
              f" GiB, shares of their tensors {shares}; fp32 state "
              f"{o['state_gib']:.3f} GiB; masters vs one process rel L2 "
              f"{o['master_err']['rel_l2']:.2e} (rel-max "
              f"{o['master_err']['rel_max']:.2e}, largest share of the "
              f"steps' movement {o['master_err']['of_moved']:.3f}); "
              f"teacher-forced greedy ids equal to one process's "
              f"{o['forced_equal']:.4f}, engine tokens equal to the "
              f"rank's forward {o['engine_forced_equal']:.4f}; prefill "
              f"logits vs one process "
              f"{o['prefill_err']:.2e}; decode vs forward "
              f"{json.dumps({k: float(f'{v:.2e}') for k, v in o['consistency'].items()})};"
              f" engine tokens equal to one process's {o['tokens_equal']} "
              f"of {n_tok}; launches {json.dumps(o['launches'])}; by walk "
              f"{json.dumps(o['walks'])}; engine launches "
              f"{json.dumps(o['serve_launches'])}")
    print(f"[mp] phase {mp['phase_s']:.1f} s")


def margin_job(torch, rank, world, job):
    """[margins] on one rank: the first loss of ``train_loop`` over the
    (world, 1) mesh ([dp]'s, uncompressed) from each seed of
    ``job["seeds"]``."""
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.launch.train import train_loop
    from repro_torch.train.step import TrainHParams
    mesh = make_device_mesh("cuda", (world, 1), ("data", "model"))
    out = {}
    for seed in job["seeds"]:
        gc.collect()
        torch.cuda.empty_cache()
        state, losses = train_loop(
            job["cfg"], steps=1, batch_per_shard=DP_BATCH // world,
            seq=DP_SEQ, ckpt_dir=None, hp=TrainHParams(**TRAIN_HP),
            device="cuda", log_every=10 ** 9, seed=seed, graphs=False,
            mesh=mesh)
        out[seed] = losses[0]
        del state
    return out


SHARD_JOBS = {"dp": dp_job, "ep": ep_job, "ep_gspmd": ep_gspmd_job,
              "mp": mp_job, "mp_mixers": mp_mixer_job,
              "margins": margin_job}


def margins_phase(torch, seeds):
    """[margins] (``--margins``, not part of the default run): the
    readings two random-init limits are set from, over the init draws of
    ``seeds``: [dp]'s first loss on ``DP_RANKS`` gloo ranks against the
    one-process run's (``FIRST_LOSS_TOL``), and [train-mamba2]'s eager
    losses over ``TRAIN_STEPS`` steps and over ``MAMBA2_TRAIN_STEPS`` (the
    schedule stretched to the run), the falls and whether the phase's
    check passes."""
    from repro_torch.launch.train import train_loop
    from repro_torch.train.step import TrainHParams

    cfg = dp_cfg()
    out = {"dp_first_loss": {}, "mamba2": {}}
    for seed in seeds:
        gc.collect()
        torch.cuda.empty_cache()
        state, losses = train_loop(
            cfg, steps=1, batch_per_shard=DP_BATCH, seq=DP_SEQ,
            ckpt_dir=None, hp=TrainHParams(**TRAIN_HP), device="cuda",
            log_every=10 ** 9, seed=seed, graphs=False)
        out["dp_first_loss"][seed] = dict(one_process=losses[0])
        del state
    gc.collect()
    torch.cuda.empty_cache()
    ranks = run_ranks(torch, "margins", shard_rank_main, DP_RANKS,
                      "margins", dict(cfg=cfg, seeds=list(seeds)))
    for seed in seeds:
        r = out["dp_first_loss"][seed]
        r["ranks"] = [o[seed] for o in ranks]
        r["rel"] = max(abs(x - r["one_process"]) / abs(r["one_process"])
                       for x in r["ranks"])
    mamba = configs.get(MAMBA2)
    for seed in seeds:
        runs = {}
        for steps in (TRAIN_STEPS, MAMBA2_TRAIN_STEPS):
            hp = TrainHParams(**dict(TRAIN_HP, total_steps=steps))
            gc.collect()
            torch.cuda.empty_cache()
            state, losses = train_loop(
                mamba, steps=steps,
                batch_per_shard=MAMBA2_TRAIN_BATCH, seq=MAMBA2_TRAIN_SEQ,
                ckpt_dir=None, hp=hp, device="cuda", log_every=10 ** 9,
                seed=seed, graphs=False)
            del state
            w = MAMBA2_FALL_WINDOW if steps == MAMBA2_TRAIN_STEPS else 1
            runs[steps] = dict(
                losses=losses, fall=losses[0] - losses[-1],
                mean_fall=(sum(losses[:w]) - sum(losses[-w:])) / w,
                passes=loss_fell(losses, steps, w))
        out["mamba2"][seed] = runs
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
    ap.add_argument("--margins", default=None,
                    help="only the [margins] readings, over these seeds "
                         "(e.g. 0,1,2,3,4)")
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

    t_run = time.perf_counter()
    card = card_line()
    print(f"[env] card: {card}")
    print(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"[env] kernels built in {time.perf_counter() - t0:.2f}s "
          f"(per source: {json.dumps(built)})")
    if args.margins:
        seeds = [int(v) for v in args.margins.split(",")]
        mg = margins_phase(torch, seeds)
        for seed, r in mg["dp_first_loss"].items():
            print(f"[margins] seed {seed}: [dp] first loss one process "
                  f"{r['one_process']!r}, ranks {r['ranks']!r}, rel "
                  f"{r['rel']:.3g} (FIRST_LOSS_TOL {FIRST_LOSS_TOL})")
        for seed, runs in mg["mamba2"].items():
            print(f"[margins] seed {seed}: [train-mamba2] "
                  + "; ".join(f"{n} steps: losses {json.dumps(r['losses'])}"
                              f", fall {r['fall']!r}, mean fall "
                              f"{r['mean_fall']!r}, passes {r['passes']}"
                              for n, r in runs.items()))
        if args.out:
            with open(args.out, "w") as f:
                json.dump(mg, f, indent=1)
        print(card)
        return 0

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
        cross = ("" if "skv" not in r else
                 f"Skv={r['skv']} B={r['batch']} causal={r['causal']} ")
        prefix = "" if "prefix" not in r else f" prefix={r['prefix']}"
        print(f"[attn] {r['shape']:14s} S={r['n']:<5d} {cross}H={r['heads']} "
              f"KV={r['kv_heads']} dh={r['head_dim']} window={r['window']}"
              f"{prefix} "
              f"softcap={r['softcap']} tile={r['tile']} "
              f"{r['dtype']:8s} walk={r['walk']} rel_err={r['rel_err']:.2e} "
              f"ms={r['ms']:.4f}{before} plain_ms={r['plain_ms']:.4f} "
              f"library_ms={lib} ({r['library']}, rel_err "
              f"{r['library_rel_err']:.2e}) bound_ms={r['bound_ms']:.4f} "
              f"({r['bound_by']}) tiles_visited={r['tiles_visited']} "
              f"element_pairs={r['element_pairs']}")
    torch.cuda.empty_cache()

    # the card memory still allocated as each phase starts (the peaks
    # the phases report include it)
    live_gib = {}
    live_gib["serve"] = torch.cuda.memory_allocated() / 2 ** 30
    serve, lm = serve_phase(torch, args)
    print(f"[serve] {serve['requests']} requests, {serve['tokens']} tokens "
          f"in {serve['wall_s']:.3f}s = {serve['tokens_per_s']:.1f} tok/s; "
          f"prefill p50 {serve['prefill_p50_ms']} ms, decode step p50 "
          f"{serve['decode_step_p50_ms']} ms; launches {serve['launches']}; "
          f"launches by walk {serve['walks']}")
    print(f"[serve] detail {json.dumps(serve)}")
    print_graphs("llama3.2-1b", serve["graphs"])

    print(f"[serve] plans {json.dumps(serve['plans'])}")

    errs = consistency_phase(torch, lm, args)
    print(f"[consistency] rel-max err vs forward: "
          f"{json.dumps(errs)} (budget {CONSISTENCY_TOL})")

    live_gib["race_serve"] = torch.cuda.memory_allocated() / 2 ** 30
    race_serve = race_serve_phase(torch, lm, args)
    print(f"[race] llama3.2-1b with plan_cache_dir: remeasure_plan on "
          f"{len(race_serve['upgrades'])} analytic plans in "
          f"{race_serve['remeasure_s']:.2f}s; routes analytic "
          f"{json.dumps(race_serve['routes_analytic'])}; measured "
          f"{json.dumps(race_serve['routes_measured'])}; restart startup "
          f"{json.dumps(race_serve['restart_startup'])}, "
          f"{race_serve['restart_from_disk']}/{race_serve['restart_plans']} "
          f"plans from disk; tokens equal (restart vs measured engine) "
          f"{race_serve['tokens_equal_restart']}, (restart vs first) "
          f"{race_serve['tokens_equal_first']}")
    for u in race_serve["upgrades"]:
        print(f"[race] remeasured {u['plan']}: {u['route_before']} -> "
              f"{u['route_after']}; measured ms "
              f"{json.dumps({r: round(v, 5) for r, v in u['measured_ms'].items()})}"
              f"; model ms "
              f"{json.dumps({r: round(v, 5) for r, v in u['model_ms'].items()})}")

    live_gib["replan"] = torch.cuda.memory_allocated() / 2 ** 30
    replan = replan_phase(torch, lm, args)
    print(f"[replan] llama3.2-1b graphs under a wrong calibration "
          f"({json.dumps(REPLAN_WRONG_SCALE)}): routes before "
          f"{json.dumps(static_routes(replan['routes_before']))}; "
          f"replan_once {replan['upgrades']} upgrades in "
          f"{replan['sweep_s']:.2f} s; stale {replan['stale']}; re-captured "
          f"{replan['recaptured']} ({replan['captures']} captures, "
          f"{replan['recapture_s']:.3f} s; startup "
          f"{replan['startup_capture_s']:.3f} s); routes after "
          f"{json.dumps(static_routes(replan['routes_after']))}; tokens "
          f"equal an engine on the measured verdicts "
          f"{replan['tokens_equal_fresh']}")
    print(f"[replan] launches per replay before "
          f"{json.dumps(replan['launches_per_replay_before'])}; after "
          f"{json.dumps(replan['launches_per_replay_after'])}")
    th = replan["thread"]
    print(f"[replan] thread (replanner=True): {th['rounds']} rounds of the "
          f"requests in {th['seconds']:.2f} s, {th['sweeps']} sweeps, "
          f"{th['upgrades']} upgrades, {th['recaptures']} re-captures, "
          f"analytic plans left {th['analytic_left']}, running after stop "
          f"{th['running_after_stop']}; decode step p99 "
          f"{replan['decode_p99_ms_no_sweep']} ms with no sweep (p50 "
          f"{replan['decode_p50_ms_no_sweep']}) / "
          f"{th['decode_p99_ms_sweeping']} ms while sweeping (p50 "
          f"{th['decode_p50_ms_sweeping']}, {th['decode_steps_sweeping']} "
          f"steps); tokens equal {th['tokens_equal_fresh']}")

    live_gib["evolve_serve"] = torch.cuda.memory_allocated() / 2 ** 30
    t_phase = time.perf_counter()
    evolve_serve = evolve_serve_phase(torch, lm, args)
    es = evolve_serve
    es["phase_s"] = time.perf_counter() - t_phase
    print(f"[evolve] serving guard: llama3.2-1b graphs, the up projection "
          f"of {es['layers']} layers evolved onto one RigL mask (dropped, "
          f"grown {es['moved'][0]}) in {es['evolve_s']:.3f} s with "
          f"{es['decisions']} route decisions; programs holding a "
          f"superseded plan {es['stale']}; replayed {es['replayed']}, "
          f"re-captured once first {es['recaptured']} "
          f"({es['recapture_s']:.3f} s); decode p50 "
          f"{es['decode_p50_ms_before']} -> {es['decode_p50_ms_after']} ms; "
          f"tokens changed {es['tokens_changed']}, equal a fresh engine on "
          f"the evolved model {es['tokens_equal_fresh']}; phase "
          f"{es['phase_s']:.2f} s")

    # the engines of the serve phases hold the model in reference cycles:
    # collect them before the next phases measure their peak memory
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    live_gib["grad"] = torch.cuda.memory_allocated() / 2 ** 30
    grads = grad_phase(torch, args)
    for r in grads:
        print(f"[grad] {r['layer']:4s} {r['dtype']:8s} n={r['n']} "
              f"dvalues rel_err={r['dvalues_rel_err']:.2e} "
              f"dx rel_err={r['dx_rel_err']:.2e} (budget {r['tol']})")

    live_gib["train"] = torch.cuda.memory_allocated() / 2 ** 30
    train = train_phase(torch, args)
    print_train("train", train)
    topo = train["topology"]
    print(f"[train] topology step after step {TRAIN_STEPS - 1}: layer 0's "
          f"up projection, {topo['graphs']['moved']} of "
          f"{topo['graphs']['nnz']} blocks moved (evolve_sparse_layer "
          f"{topo['eager']['evolve_s'] * 1e3:.1f} ms eager, "
          f"{topo['graphs']['evolve_s'] * 1e3:.1f} ms graphs); the next "
          f"{TOPOLOGY_AFTER} steps' losses "
          f"{json.dumps(train['losses'][TRAIN_STEPS:])} (eager "
          f"{json.dumps(train['eager']['losses'][TRAIN_STEPS:])}); graph "
          f"re-captures {train['recaptures']}")
    rm = train["remat"]
    print(f"[train] remat: 'full' (eager run) vs 'none' ({rm['none_steps']} "
          f"eager steps): peak {rm['peak_gib']['full']:.2f} / "
          f"{rm['peak_gib']['none']:.2f} GiB allocated; step p50 "
          f"{rm['step_p50_ms']['full']:.2f} / "
          f"{rm['step_p50_ms']['none']:.2f} ms; losses and parameters "
          f"bit-equal {rm['bit_equal']} (max abs: loss "
          f"{rm['loss_max_abs']:.3g}, parameters {rm['param_max_abs']:.3g}); "
          f"launches per step 'none' "
          f"{json.dumps(rm['none_launches_per_step'][-1])}")
    print(f"[train] detail {json.dumps(train)}")

    live_gib["dryrun"] = torch.cuda.memory_allocated() / 2 ** 30
    dry = dryrun_phase(torch, args)
    print_dryrun(dry)

    from repro_torch.kernels import (bsmm, dense_mm, dsmm,  # noqa: F401
                                     sddmm)
    counters = with_walks({"bsmm": bsmm.COUNTER,
                           "dense_mm": dense_mm.COUNTER,
                           "sddmm": sddmm.COUNTER, "dsmm": dsmm.COUNTER,
                           "bsmm_balanced": bsmm.BALANCED_COUNTER})
    for c in counters.values():
        c.reset()
    live_gib["table3"] = torch.cuda.memory_allocated() / 2 ** 30
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
    live_gib["race"] = torch.cuda.memory_allocated() / 2 ** 30
    race = race_phase(torch, args)
    race_launches, race_walks = split_walks(
        {k: c.launches for k, c in counters.items()})
    for c in race["cells"]:
        print(f"[race] b={c['b']:<2d} {c['dtype']:8s} measured "
              f"{json.dumps({r: round(v, 5) for r, v in sorted(c['measured_ms'].items(), key=lambda kv: kv[1])})}; "
              f"fastest {c['fastest']} {c['fastest_ms']:.5f} ms; verdict "
              f"{c['winner']} {c['winner_ms']:.5f} ms; analytic "
              f"{c['analytic']} (model "
              f"{c['analytic_est_ms'][c['analytic']]:.5f} ms, measured "
              f"{c['analytic_pick_measured_ms']:.5f} ms); race "
              f"{c['race_s']:.2f} s; restart {json.dumps(c['restart'])}")
    for g in race["grads"]:
        print(f"[race] backward {g['shape']} n={g['n']} bf16: forward "
              f"{json.dumps(g['forward'])}; "
              + "; ".join(
                  f"{side} measured {g[side]['measured']} "
                  f"{json.dumps({r: round(v, 5) for r, v in g[side]['measured_ms'].items()})}"
                  f", analytic {g[side]['analytic']} (model "
                  f"{json.dumps({r: round(v, 5) for r, v in g[side]['model_ms'].items()})})"
                  for side in ("dx", "dvalues")))
    for d in race["dynamic"]:
        print(f"[race] dynamic {d['shape']} n={d['n']} bf16 d_max 1/8: "
              f"measured "
              f"{json.dumps({r: round(v, 5) for r, v in sorted(d['measured_ms'].items(), key=lambda kv: kv[1])})}"
              f"; fastest {d['fastest']}; verdict {d['winner']}; analytic "
              f"{d['analytic']} (model "
              f"{d['analytic_est_ms'][d['analytic']]:.5f} ms, measured "
              f"{d['analytic_pick_measured_ms']:.5f} ms)")
    print(f"[race] counters after the races {json.dumps(race['first'])}; "
          f"after the restart {json.dumps(race['restart'])}; launches "
          f"{json.dumps(race_launches)}; launches by walk "
          f"{json.dumps(race_walks)}")

    torch.cuda.empty_cache()
    for c in counters.values():
        c.reset()
    live_gib["dynamic"] = torch.cuda.memory_allocated() / 2 ** 30
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
    print(f"[dynamic] the race's analytic verdict for these layers "
          f"(backend auto): "
          f"{json.dumps({k: v['route'] for k, v in dyn['auto_routes'].items()})}"
          f" (model ms {json.dumps(dyn['auto_routes'])})")
    print(f"[dynamic] one step on the auto verdict vs plain: "
          f"{json.dumps(dyn['auto_errs'])} (budget {dyn['tol']}); "
          f"launches by route family {json.dumps(dyn['auto_launches'])}")
    print(f"[dynamic] step 0 vs plain: {json.dumps(dyn['errs'])} (budget "
          f"{dyn['tol']}); grouped capacity pass totals "
          f"{json.dumps(dyn['capacity_totals'])}")

    gc.collect()
    torch.cuda.empty_cache()
    live_gib["evolve"] = torch.cuda.memory_allocated() / 2 ** 30
    t_phase = time.perf_counter()
    evo = evolve_phase(torch, args)
    evo["dynamic_row"] = evolve_dynamic_row(torch, args)
    evo["phase_s"] = time.perf_counter() - t_phase
    print(f"[evolve] SparseFFN {evo['d_model']}->{evo['d_ff']}->"
          f"{evo['d_model']} d={evo['density']} b={evo['b']} bf16, N "
          f"{evo['tokens']}, AdamW {evo['steps']} steps, rigl_evolve "
          f"fraction {evo['fraction']} every {evo['every']} on up, gate and "
          f"down: loss {evo['losses'][0]:.4f} -> {evo['losses'][-1]:.4f}; "
          f"generations {json.dumps(evo['generations'])}; blocks moved per "
          f"projection and step {sorted(set(m[1] for m in evo['moved']))}; "
          f"decisions / measurements / plans built after the warm-up "
          f"{evo['decisions_after_warmup']} / "
          f"{evo['measurements_after_warmup']} / "
          f"{evo['plans_built_after_warmup']}")
    print(f"[evolve] step p50 {evo['step_p50_ms_before']:.3f} ms before the "
          f"first topology step, {evo['step_p50_ms_after']:.3f} ms after "
          f"(steps {[round(t, 3) for t in evo['step_ms']]}); host syncs per "
          f"step {evo['syncs_per_step']}")
    print(f"[evolve] topology step ms per projection (p50 of "
          f"{len(evo['topology_ms'])}; the first: "
          f"{json.dumps(evo['topology_ms'][0])}): "
          + "; ".join(f"{k} rigl_update {v['rigl_update_ms']:.3f} (device), "
                      f"rigl_evolve {v['rigl_evolve_ms']:.3f} (host wall: "
                      f"rigl_update, the mask read, plan.evolve's rebuild, "
                      f"the values' gather), module carry "
                      f"{v['module_carry_ms']:.3f} (values, AdamW master "
                      f"and moments)"
                      for k, v in evo["topology_ms_p50"].items()))
    print(f"[evolve] GiB allocated after each topology step "
          f"{[round(v, 4) for v in evo['gib_per_generation']]} (growth "
          f"{evo['gib_growth_per_generation']:.6f} GiB per generation); "
          f"evolution totals {json.dumps(evo['evolution_totals'])}")
    print(f"[evolve] launches {json.dumps(evo['launches'])}; launches by "
          f"walk {json.dumps(evo['walks'])}; last generation vs plain "
          f"{json.dumps(evo['errs'])} (budget {evo['tol']})")
    dr = evo["dynamic_row"]
    print(f"[evolve] DynamicSparseLinear 2048->8192 d_max 1/8 b 16 bf16 N "
          f"2048 on a rigl_update mask ({dr['moved']} blocks moved in "
          f"{dr['update_ms']:.3f} ms, nnz held {dr['nnz_same']}): dsmm vs "
          f"plain rel_err {dr['rel_err']:.2e} (budget {dr['tol']}), dsmm "
          f"launches {dr['dsmm_launches']}; phase {evo['phase_s']:.2f} s")

    gc.collect()
    torch.cuda.empty_cache()
    live_gib["serve_gemma2"] = torch.cuda.memory_allocated() / 2 ** 30
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
    print(f"[serve-gemma2] plans {json.dumps(gemma['plans'])}")
    print(f"[serve-gemma2] visited pairs at S={gemma['prefill_lens']}'s "
          f"longest: {json.dumps(gemma['visited'])}")
    gemma["consistency"] = gemma2_consistency_phase(torch, lm, eng, args)
    del lm, eng
    roof = roofline_phase(torch, args, rows, serve, gemma)
    print(f"[roofline] H100 peaks (bf16 989e12, fp32 67e12 FLOP/s, "
          f"3.35e12 B/s): bsmm up/gate 8192x2048 N 2048 bf16 bound: plan "
          f"{roof['bsmm_bound_plan_ms']:.5f} ms, [kernel] row "
          f"{roof['bsmm_bound_kernel_row_ms']:.5f} ms (rel "
          f"{roof['bsmm_bound_rel']:.2e})")
    for model in ("llama", "gemma2"):
        print(f"[roofline] {model} roofline_report totals "
              f"{json.dumps(roof[model]['totals'])}")
        for name, r in roof[model]["plans"].items():
            print(f"[roofline] {model} {name}: {r['route']} efficiency "
                  f"{r['efficiency']} headroom {r['headroom']} dominant "
                  f"{r['dominant']} flagged {r['flagged']} (achieved "
                  f"{r['achieved_us']} us, bound {r['bound_us']} us)")
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
    live_gib["serve_qwen3"] = torch.cuda.memory_allocated() / 2 ** 30
    qwen, lm, eng = serve_qwen3_phase(torch, args)
    print_serve("serve-qwen3-moe", "qwen3-moe-30b-a3b", qwen)
    qwen["moe_layer"] = moe_layer_check(torch, lm, eng,
                                        max(qwen3_prompt_lens(args)),
                                        args.seed + 17)
    print_moe("serve-qwen3-moe", qwen)
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

    gc.collect()
    torch.cuda.empty_cache()
    live_gib["train_qwen3"] = torch.cuda.memory_allocated() / 2 ** 30
    tq = train_qwen3_phase(torch, args)
    print(f"[train-qwen3-moe] {tq['layers']} layers at full width "
          f"({tq['n_params'] / 1e9:.3f} B parameters), C {tq['capacity']}; "
          f"gmm launches of the eager run by walk "
          f"{json.dumps(tq['gmm_launches'])} (per step: forward "
          f"{sum(tq['gmm_launches']['forward'].values()) / tq['steps']:g}, "
          f"backward "
          f"{sum(tq['gmm_launches']['backward'].values()) / tq['steps']:g})")
    print_train("train-qwen3-moe", tq)
    for r in tq["layer_backward"]:
        print(f"[train-qwen3-moe] layer backward {r['product']} "
              f"{r['shape']} tm={r['row_tile']}: y rel_err "
              f"{r['y_rel_err']:.2e}, dA (gmm on W^T) {r['da_rel_err']:.2e}, "
              f"dW (torch.bmm) {r['dw_rel_err']:.2e} (budget {r['tol']}); "
              f"gmm launches {r['gmm_launches']}; W^T copy "
              f"{r['wt_copy_ms']:.4f} ms; grad {json.dumps(r['grad'])}")

    gc.collect()
    torch.cuda.empty_cache()
    live_gib["serve_deepseek"] = torch.cuda.memory_allocated() / 2 ** 30
    ds, lm, eng = serve_deepseek_phase(torch, args)
    print_serve("serve-deepseek", DEEPSEEK, ds)
    ds["moe_layer"] = moe_layer_check(torch, lm, eng,
                                      max(deepseek_prompt_lens(args)),
                                      args.seed + 39)
    print_moe("serve-deepseek", ds)
    del lm, eng
    gc.collect()
    torch.cuda.empty_cache()
    live_gib["train_deepseek"] = torch.cuda.memory_allocated() / 2 ** 30
    td = train_deepseek_phase(torch, args)
    print(f"[train-deepseek] {td['layers']} layers at full width "
          f"({td['n_params'] / 1e9:.3f} B parameters), C {td['capacity']}; "
          f"gmm launches of the eager run by walk "
          f"{json.dumps(td['gmm_launches'])}; bs_attn launches at dh 192 "
          f"{td['launches']['bs_attn_dh192']} of {td['launches']['bs_attn']}")
    print_train("train-deepseek", td)
    dense = {}
    for arch, label, off in DENSE_ARCHS:
        gc.collect()
        torch.cuda.empty_cache()
        live_gib[label.replace("-", "_")] = (torch.cuda.memory_allocated()
                                             / 2 ** 30)
        dense[label], lm, eng = serve_dense_phase(torch, args, arch, label,
                                                  off)
        print_serve(label, arch, dense[label])
        del lm, eng

    gc.collect()
    torch.cuda.empty_cache()
    live_gib["serve_mamba2"] = torch.cuda.memory_allocated() / 2 ** 30
    mamba = serve_mamba2_phase(torch, args)
    print_ssm("serve-mamba2", MAMBA2, mamba)
    gc.collect()
    torch.cuda.empty_cache()
    live_gib["train_mamba2"] = torch.cuda.memory_allocated() / 2 ** 30
    tm = train_mamba2_phase(torch, args)
    print(f"[train-mamba2] {tm['n_params'] / 1e6:.1f} M parameters, SSD "
          f"chunk {tm['chunk_len']} x {tm['chunks']} a sequence")
    print_train("train-mamba2", tm)
    gc.collect()
    torch.cuda.empty_cache()
    live_gib["serve_jamba"] = torch.cuda.memory_allocated() / 2 ** 30
    jamba, lm, eng = serve_jamba_phase(torch, args)
    print_serve("serve-jamba", f"{JAMBA} ({JAMBA_LAYERS} layers)", jamba)
    print(f"[serve-jamba] {jamba['mamba_layers']} mamba and "
          f"{jamba['attention_layers']} attention layers; exact-length "
          f"prefills {jamba['exact_prefills']}, prefill p50 eager / graphs "
          f"run {json.dumps(jamba['graphs']['prefill_p50_ms'])} ms")
    jamba["moe_layer"] = moe_layer_check(torch, lm, eng,
                                         max(jamba_prompt_lens(args)),
                                         args.seed + 63)
    print_moe("serve-jamba", jamba)
    del lm, eng

    gc.collect()
    torch.cuda.empty_cache()
    live_gib["vlm_internvl2"] = torch.cuda.memory_allocated() / 2 ** 30
    vlm = vlm_internvl2_phase(torch, args)
    print(f"[vlm-internvl2] {INTERNVL2} (dense FFNs, 24 layers), "
          f"{vlm['batch']} rows of {vlm['patches']} patch rows + a "
          f"{vlm['prompt']}-token prompt: prefill "
          f"{vlm['prefill_ms']:.3f} ms, decode step p50 "
          f"{vlm['decode_step_p50_ms']:.3f} ms, {vlm['tokens']} tokens in "
          f"{vlm['wall_s']:.3f}s = {vlm['tokens_per_s']:.2f} tok/s; peak "
          f"{vlm['peak_mem_gb']:.2f} GiB; launches "
          f"{json.dumps(vlm['launches'])} (prefill "
          f"{json.dumps(vlm['prefill_launches'])}); by walk "
          f"{json.dumps(vlm['walks'])}")
    print(f"[vlm-internvl2] decode vs forward: bf16 "
          f"{json.dumps(vlm['consistency_bf16'])} (budget "
          f"{CONSISTENCY_TOL}); fp32 copy, {vlm['fp32_layers']} layers, "
          f"prefill and 2 steps {json.dumps(vlm['consistency_fp32'])} "
          f"(budget {LOGITS_TOL_FP32})")
    gc.collect()
    torch.cuda.empty_cache()
    live_gib["serve_seamless"] = torch.cuda.memory_allocated() / 2 ** 30
    sea = serve_seamless_phase(torch, args)
    print(f"[serve-seamless] {SEAMLESS} {sea['params'] / 1e9:.3f} B "
          f"parameters initialised on the card in {sea['init_s']:.2f}s; "
          f"batch {sea['batch']}, {sea['frames']} frames a row, prompts "
          f"{sea['prompt_lens']} (prefilled at {sea['prefill_len']}): "
          f"encoder {sea['encoder_ms']:.3f} ms, prefill "
          f"{sea['prefill_ms']:.3f} ms, decode step p50 "
          f"{sea['decode_step_p50_ms']:.3f} ms, {sea['tokens']} tokens in "
          f"{sea['wall_s']:.3f}s = {sea['tokens_per_s']:.2f} tok/s; peak "
          f"{sea['peak_mem_gb']:.2f} GiB; bs_attn launches prefill "
          f"{sea['prefill_launches']['bs_attn']}, per decode step "
          f"{sea['decode_step_bs_attn']}; launches "
          f"{json.dumps(sea['launches'])}; by walk "
          f"{json.dumps(sea['walks'])}")
    print(f"[serve-seamless] decode vs forward: bf16 "
          f"{json.dumps(sea['consistency_bf16'])} (budget "
          f"{CONSISTENCY_TOL}); fp32 copy, {sea['fp32_layers']} layers, "
          f"prefill and 2 steps {json.dumps(sea['consistency_fp32'])} "
          f"(budget {LOGITS_TOL_FP32})")
    gc.collect()
    torch.cuda.empty_cache()
    live_gib["train_seamless"] = torch.cuda.memory_allocated() / 2 ** 30
    ts = train_seamless_phase(torch, args)
    print(f"[train-seamless] {ts['n_params'] / 1e9:.3f} B parameters, "
          f"frames {ts['frames']} a batch")
    print_train("train-seamless", ts)

    gc.collect()
    torch.cuda.empty_cache()
    live_gib["long"] = torch.cuda.memory_allocated() / 2 ** 30
    lg = long_phase(torch, args)
    print(f"[long] {LONG} d=1/8 bf16, long_500k's batch {lg['batch']}, ring "
          f"{lg['prefix']} + {lg['window']} = {lg['ring']} slots: a "
          f"{lg['ring']}-token prompt, then {lg['steps']} greedy "
          f"decode_step(retained=True) past the wrap (slots "
          f"{lg['slots_written'][0]}..{lg['slots_written'][1]}); prefill "
          f"ms eager {lg['prefill_ms']['eager']:.3f} / graphs run "
          f"{lg['prefill_ms']['graphs']:.3f}; decode step p50 eager "
          f"{lg['decode_step_p50_ms']['eager']:.4f} / graphs "
          f"{lg['decode_step_p50_ms']['graphs']:.4f} ms; tokens/s eager "
          f"{lg['tokens_per_s']['eager']:.2f} / graphs "
          f"{lg['tokens_per_s']['graphs']:.2f}; program "
          f"{json.dumps(lg['program'])}; peak {lg['peak_mem_gb']:.2f} GiB; "
          f"tokens identical {lg['tokens_identical']}, logits identical "
          f"{lg['logits_identical']}")
    print(f"[long] launches {json.dumps(lg['launches'])} (prefill "
          f"{json.dumps(lg['prefill_launches'])}, the {lg['steps']} steps "
          f"{json.dumps(lg['step_launches'])}); by walk "
          f"{json.dumps(lg['walks'])}")
    print(f"[long] decode vs the windowed forward (every layer local, "
          f"window {lg['window']}, prefix {lg['prefix']}; S "
          f"{lg['check_len']}, {lg['check_forward_ms']:.2f} ms, bs_attn by "
          f"walk {json.dumps(lg['check_bs_attn_walks'])}): bf16 "
          f"{json.dumps(lg['consistency_bf16'])} (budget "
          f"{CONSISTENCY_TOL}); fp32 copy, {lg['fp32_layers']} layers, "
          f"{lg['fp32_steps']} steps {json.dumps(lg['consistency_fp32'])} "
          f"(budget {LOGITS_TOL_FP32})")
    ad = lg["attend_decode"]
    print(f"[long] attend_decode at the ring (batch 1, 32 / 8 heads of 64, "
          f"{lg['ring']} slots, bf16 caches cast to fp32): "
          f"{ad['ms']:.4f} ms a layer; caches {ad['cache_mb']:.1f} MB "
          f"(read once in bf16: bound {ad['bound_ms']:.4f} ms), the casts "
          f"move ~{ad['cast_traffic_mb']:.1f} MB")
    gc.collect()
    torch.cuda.empty_cache()
    live_gib["serve_long"] = torch.cuda.memory_allocated() / 2 ** 30
    sl, lm, eng = serve_long_phase(torch, args)
    print_serve("serve-long", f"{SERVE_LONG} (retained)", sl)
    print(f"[serve-long] the graph engine's calls driven by hand through "
          f"prefill / decode_step(retained=True) at its batch: "
          f"{json.dumps(sl['engine_vs_hand'])} (budget "
          f"{KERNEL_TOL['bfloat16']})")
    del lm, eng

    gc.collect()
    torch.cuda.empty_cache()
    live_gib["tp"] = torch.cuda.memory_allocated() / 2 ** 30
    tp = tp_phase(torch, args, serve)
    print_tp(tp)

    gc.collect()
    torch.cuda.empty_cache()
    live_gib["dp"] = torch.cuda.memory_allocated() / 2 ** 30
    dp = dp_phase(torch, args)
    print_dp(dp)
    gc.collect()
    torch.cuda.empty_cache()
    live_gib["ep"] = torch.cuda.memory_allocated() / 2 ** 30
    ep = ep_phase(torch, args)
    print_ep(ep)
    gc.collect()
    torch.cuda.empty_cache()
    live_gib["mp"] = torch.cuda.memory_allocated() / 2 ** 30
    mp = mp_phase(torch, args)
    print_mp(mp)
    mx = mp_mixer_phase(torch, args)
    print_mp_mixers(mx)

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
               "table3": table3_launches, "race": race_launches,
               "dynamic": dyn_launches, "evolve": evo["launches"],
               "serve_gemma2": gemma["launches"],
               "serve_qwen3": qwen["launches"],
               "train_qwen3": tq["launches"],
               "serve_deepseek": ds["launches"],
               "train_deepseek": td["launches"],
               "serve_qwen2": dense["serve-qwen2"]["launches"],
               "serve_glm4": dense["serve-glm4"]["launches"],
               "serve_mamba2": mamba["launches"],
               "train_mamba2": tm["launches"],
               "serve_jamba": jamba["launches"],
               "serve_internvl2": dense["serve-internvl2"]["launches"],
               "vlm_internvl2": vlm["launches"],
               "serve_seamless": sea["launches"],
               "train_seamless": ts["launches"],
               "long": lg["launches"], "serve_long": sl["launches"],
               "tp": tp["engine"]["launches"],
               "tp_plan": tp["plan_launches"],
               "dp": dp["per_rank"][0][False]["launches"],
               "ep": ep["ranks"][0]["launches"],
               "mp": mp["ranks"][0]["launches"],
               "mp_serve": mp["ranks"][0]["serve_launches"]}
    for label, o in mx["ranks"][0].items():
        by_path[f"mp {label}"] = o["launches"]
        by_path[f"mp_serve {label}"] = o["serve_launches"]
    walks_by_path = {"serve": serve["walks"], "train": train["walks"],
                     "table3": table3_walks, "race": race_walks,
                     "dynamic": dyn_walks, "evolve": evo["walks"],
                     "serve_gemma2": gemma["walks"],
                     "serve_qwen3": qwen["walks"],
                     "train_qwen3": tq["walks"],
                     "serve_deepseek": ds["walks"],
                     "train_deepseek": td["walks"],
                     "serve_qwen2": dense["serve-qwen2"]["walks"],
                     "serve_glm4": dense["serve-glm4"]["walks"],
                     "serve_mamba2": mamba["walks"],
                     "train_mamba2": tm["walks"],
                     "serve_jamba": jamba["walks"],
                     "serve_internvl2": dense["serve-internvl2"]["walks"],
                     "vlm_internvl2": vlm["walks"],
                     "serve_seamless": sea["walks"],
                     "train_seamless": ts["walks"],
                     "long": lg["walks"], "serve_long": sl["walks"],
                     "tp": tp["engine"]["walks"],
                     "dp": dp["per_rank"][0][False]["walks"],
                     "ep": ep["ranks"][0]["walks"],
                     "mp": mp["ranks"][0]["walks"],
                     "mp_serve": mp["ranks"][0]["serve_walks"]}
    for label, o in mx["ranks"][0].items():
        walks_by_path[f"mp {label}"] = o["walks"]
        walks_by_path[f"mp_serve {label}"] = o["serve_walks"]
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
    # bs_attn at MLA's head dim 192 (deepseek-v2-lite's served prefill,
    # bf16); its main paths are the deepseek serve and train runs
    r = next(r for r in attn_rows if r["shape"] == "deepseek served"
             and r["dtype"] == "bfloat16")
    kernels[-1]["dh192"] = {
        "name": "bs_attn", "route": "cuda",
        "source": "src/repro_torch/kernels/bs_attn/csrc/bs_attn.cu",
        "replaces": "src/repro/kernels/bs_attn/bs_attn.py:73",
        "launches": ds["launches"]["bs_attn_dh192"],
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "at": f"{r['shape']} S={r['n']} dh=192 {r['dtype']}",
        "walk": r["walk"], "before_ms": r["before_ms"],
        "launches_by_path": {"serve_deepseek": ds["launches"]["bs_attn_dh192"],
                             "train_deepseek": td["launches"]["bs_attn_dh192"]}}
    # bs_attn at the encoder-decoder's and the VLM's shapes (bf16): the
    # encoder, the decoder's self and cross attention served, at decode
    # and trained, and the VLM's prefill; each reads the launches of the
    # run that gives it that shape
    encdec_launches = {"serve_seamless": sea["launches"]["bs_attn"],
                       "train_seamless": ts["launches"]["bs_attn"],
                       "vlm_internvl2": vlm["launches"]["bs_attn"]}
    kernels[-1]["encdec"] = [{
        "name": "bs_attn", "route": "cuda",
        "source": "src/repro_torch/kernels/bs_attn/csrc/bs_attn.cu",
        "replaces": "src/repro/kernels/bs_attn/bs_attn.py:73",
        "launches": encdec_launches[r["path"]],
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "at": f"{r['shape']} B={r['batch']} S={r['n']} Skv={r['skv']} "
              f"causal={r['causal']} {r['dtype']}", "walk": r["walk"],
        "before_ms": r["before_ms"]}
        for r in attn_rows if "skv" in r and r["dtype"] == "bfloat16"]
    # bs_attn with a window and a global prefix (bf16): [long]'s plain
    # check shape and [serve-long]'s local layers at its prefill lengths;
    # launches: the main path's of the phase (for [long] its prefill's,
    # at S 5120 without a window; the check forward's beside it)
    kernels[-1]["long"] = [{
        "name": "bs_attn", "route": "cuda",
        "source": "src/repro_torch/kernels/bs_attn/csrc/bs_attn.cu",
        "replaces": "src/repro/kernels/bs_attn/bs_attn.py:73",
        "launches": by_path[r["path"]]["bs_attn"],
        "check_forward_launches": (sum(lg["check_bs_attn_walks"].values())
                                   if r["path"] == "long" else None),
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "at": f"{r['shape']} S={r['n']} window={r['window']} "
              f"prefix={r['prefix']} tile={r['tile']} {r['dtype']}",
        "walk": r["walk"], "before_ms": r["before_ms"]}
        for r in attn_rows if "prefix" in r and r["dtype"] == "bfloat16"]

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
                             for p, w in walks_by_path.items()},
        # the graph run is the main path: its gmm launches per replay;
        # the forward / backward split is the eager run's (module hooks
        # see no replay), tied to the replay by eager_and_graphs' check
        # that both runs launch the same kernels on the same walks each
        # step
        "train_qwen3_launches_per_replay": {
            k: n for k, n in tq["launches_per_replay"].items()
            if k.split(":")[0] == "gmm"},
        "train_qwen3_eager_split": tq["gmm_launches"]})

    corpus = corpus_of(race, race_serve, rows)
    cal = calibrate_phase(torch, race, corpus, serve, gemma)
    print(f"[calibrate] committed coefficients digest {cal['digest']} "
          f"against the identity (the hand-tuned model):")
    for c in cal["cells"]:
        print(f"[calibrate] table3 b={c['b']:<2d} {c['dtype']:8s} measured "
              f"fastest {c['fastest']}; "
              + "; ".join(f"{name} {c[name]['route']} (model "
                          f"{c[name]['model_ms']:.5f} ms, measured "
                          f"{c[name]['measured_ms']:.5f} ms, kept by the "
                          f"race {c[name]['kept']})"
                          for name in ("identity", "fitted")))
    for name, per in cal["model_over_measured"].items():
        print(f"[calibrate] model/measured {name}: "
              + "; ".join(f"{f} {v['min']:.2f}-{v['max']:.2f} (median "
                          f"{v['median']:.2f}, n {v['n']})"
                          for f, v in per.items()))
    for label in cal["ladders"]:
        changed = {k: v for k, v in cal["served"][label].items()
                   if v["identity"] != v["fitted"]}
        print(f"[calibrate] {label} ladder identity "
              f"{cal['ladders'][label]['identity']} / fitted "
              f"{cal['ladders'][label]['fitted']}; served routes that "
              f"change {json.dumps(changed)} of "
              f"{len(cal['served'][label])}")

    gc.collect()
    live_gib["end"] = torch.cuda.memory_allocated() / 2 ** 30
    print(f"[mem] GiB allocated as each phase starts: "
          f"{json.dumps({k: round(v, 3) for k, v in live_gib.items()})}")
    streams = capture_stream_memory(torch)
    print("[mem] MiB still allocated per capture of a bf16 GEMM (4 "
          "captures, graphs dropped), by the streams it warms up and "
          "captures on: " + "; ".join(f"{k} {v:.2f}"
                                      for k, v in streams.items()))

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(jsonable({"card": card, "torch": torch.__version__,
                       "cuda": torch.version.cuda, "build_s": built,
                       "kernel_rows": rows, "serve": serve,
                       "consistency": errs, "grads": grads, "train": train,
                       "table3": table3, "race": race,
                       "race_serve": race_serve, "dynamic": dyn,
                       "attn": attn_rows, "serve_gemma2": gemma,
                       "serve_qwen3": qwen, "train_qwen3": tq,
                       "serve_deepseek": ds, "train_deepseek": td,
                       "serve_dense": dense, "serve_mamba2": mamba,
                       "train_mamba2": tm, "serve_jamba": jamba,
                       "vlm_internvl2": vlm, "serve_seamless": sea,
                       "train_seamless": ts, "long": lg,
                       "serve_long": sl, "tp": tp, "dp": dp, "ep": ep,
                       "mp": mp, "mp_mixers": mx, "dryrun": dry,
                       "kernels": kernels,
                       "replan": replan, "roofline": roof,
                       "evolve": evo, "evolve_serve": evolve_serve,
                       "calibrate": cal, "corpus": corpus,
                       "live_gib": live_gib,
                       "capture_stream_mib": streams}), f,
                      indent=1)

    print(f"[env] run {time.perf_counter() - t_run:.1f} s, kernel builds "
          f"included")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
