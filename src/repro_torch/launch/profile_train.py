"""Where training time goes on the card: AdamW steps of a full-width
model under ``torch.profiler`` (by default llama3.2-1b with a sparse
FFN).

    PYTHONPATH=src python -m repro_torch.launch.profile_train \
        [--arch llama3.2-1b] [--layers N] [--density 0.125] [--batch 4] \
        [--seq 512] [--steps 3] [--graphs] [--out profile.json]

    PYTHONPATH=src python -m repro_torch.launch.profile_train \
        --arch qwen3-moe-30b-a3b --layers 4

``--layers`` cuts the depth (``cut_depth``: the first layers, in whole
periods of each group) and keeps the width; ``--density`` makes the FFNs
block-sparse where they are all dense MLPs (not an MoE config, not
mamba2-130m).  Reports the host wall time of a train step
(clock around steps that end in a ``synchronize``), the device busy time
(sum of the kernels' own device times from the profiler), the device's
idle share, the device time by kernel family (bs_attn, bsmm, dense_mm,
gmm, sddmm, library GEMMs -- the dense backward, the unembed, the
attention products, the expert GEMMs' dL/dW --, everything else) with
the busiest kernels, the time of the optimizer update alone, and the
Python functions that take the host's time (``cProfile``).  Each step
uploads its batch through the train program's input buffer and reads
its loss (``train/program.py``, run eagerly).  ``--graphs`` adds the
same step replayed from its captured CUDA graph, on the same model and
state: capture seconds, the device time of a replay (CUDA events), its
host wall, busy and idle share under the profiler, and the peak GiB
allocated and reserved of each mode.  The graph's peak counts from an
emptied cache (what the eager phases left reserved is reported beside
it, under ``eager_left``; the capture itself collects the cycles that
may still hold their tensors), and its reserved GiB are split into the
allocator's default pool and the graph's private pool.  Needs a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from repro_torch import configs
from repro_torch.data import TokenPipeline
from repro_torch.launch.profile_serve import (_host_profile, _profile,
                                              _replay_ms, _wall_ms)
from repro_torch.models.model import LM
from repro_torch.optim.adamw import adamw_update
from repro_torch.train.program import TrainProgram
from repro_torch.train.step import TrainHParams, init_train_state


def cut_depth(cfg, layers: int):
    """``cfg`` with ``layers`` layers at full width: its groups in order,
    each keeping as many of its periods as still fit (whole periods, at
    least one period in all), so a model whose first layers differ
    keeps them (deepseek-v2-lite at 4: its dense layer, then 3 MoE
    layers)."""
    groups, left = [], layers
    for period, rep in cfg.groups:
        n = min(rep, left // len(period))
        if n:
            groups.append((period, n))
            left -= n * len(period)
    return dataclasses.replace(
        cfg, groups=tuple(groups) or ((cfg.groups[0][0], 1),))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (full width)")
    ap.add_argument("--density", type=float, default=0.125)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--graphs", action="store_true",
                    help="also profile the step replayed from its CUDA "
                         "graph")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False

    cfg = configs.get(args.arch)
    dense = configs.dense_ffns(cfg)
    if dense:
        cfg = configs.sparsify_ffn(cfg, args.density)
    if args.layers is not None:
        cfg = cut_depth(cfg, args.layers)
    lm = LM(cfg, device="cuda", seed=args.seed)
    hp = TrainHParams(peak_lr=1e-4, warmup_steps=0, total_steps=1000)
    state = init_train_state(lm, hp=hp)
    batch = TokenPipeline(cfg.vocab_size, args.batch, args.seq,
                          seed=args.seed).get_batch(0)
    eager = TrainProgram(lm, state, hp, batch=args.batch, seq=args.seq,
                         graph=False)

    def stepper(prog):
        def step():
            prog.load(batch)
            float(prog()["loss"])
        return step

    def update():
        grads = {n: torch.zeros_like(p) for n, p in state.params.items()}
        adamw_update(grads, state.opt, state.params, lr=0.0)

    def peaks():
        return {"peak_alloc_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                "peak_reserved_gib":
                    torch.cuda.max_memory_reserved() / 2 ** 30}

    def by_pool():
        """GiB reserved now: in all, in the allocator's default pool, and
        in the graphs' private pools."""
        gib = {"default": 0.0, "graph": 0.0}
        for seg in torch.cuda.memory_snapshot():
            pool = tuple(seg.get("segment_pool_id", (0, 0)))
            gib["default" if pool == (0, 0) else "graph"] += (
                seg["total_size"] / 2 ** 30)
        return {"reserved_gib": torch.cuda.memory_reserved() / 2 ** 30,
                "default_pool_gib": gib["default"],
                "graph_pool_gib": gib["graph"]}

    step = stepper(eager)
    for _ in range(2):                          # warm-up
        step()
    torch.cuda.reset_peak_memory_stats()
    out = {"card": torch.cuda.get_device_name(0), "arch": cfg.name,
           "layers": cfg.num_layers,
           "density": args.density if dense else None,
           "batch": args.batch, "seq": args.seq,
           "step_wall_ms": _wall_ms(step, args.steps)}
    out.update(peaks())
    out.update(step=_profile(step, args.steps, top_n=16),
               adamw_update=_profile(update, 2, top_n=4),
               step_host=_host_profile(step, 1, top=16))
    if args.graphs:
        graph = TrainProgram(lm, state, hp, batch=args.batch, seq=args.seq,
                             graph=True)
        gstep = stepper(graph)
        left = by_pool()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):                      # the capture, a replay
            gstep()
        out["graph_capture_s"] = graph.program.stats()["capture_s"]
        out["graph_step_wall_ms"] = _wall_ms(gstep, args.steps)
        out["graph"] = dict(peaks(), eager_left=left, after=by_pool())
        out.update(graph_step_device_ms=_replay_ms(graph, args.steps),
                   graph_step=_profile(gstep, args.steps, top_n=16),
                   graph_step_host=_host_profile(gstep, 1, top=16))
    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    return out


if __name__ == "__main__":
    main()
