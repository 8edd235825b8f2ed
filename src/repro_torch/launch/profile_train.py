"""Where training time goes on the card: AdamW steps of a full-width
model under ``torch.profiler`` (by default llama3.2-1b with a sparse
FFN).

    PYTHONPATH=src python -m repro_torch.launch.profile_train \
        [--arch llama3.2-1b] [--layers N] [--density 0.125] [--batch 4] \
        [--seq 512] [--steps 3] [--out profile.json]

    PYTHONPATH=src python -m repro_torch.launch.profile_train \
        --arch qwen3-moe-30b-a3b --layers 4

``--layers`` cuts the depth (the first period of layers, repeated) and
keeps the width; ``--density`` makes a dense FFN block-sparse and does
not apply to an MoE config.  Reports the host wall time of a train step
(clock around steps that end in a ``synchronize``), the device busy time
(sum of the kernels' own device times from the profiler), the device's
idle share, the device time by kernel family (bs_attn, bsmm, dense_mm,
gmm, sddmm, library GEMMs -- the dense backward, the unembed, the
attention products, the expert GEMMs' dL/dW --, everything else) with
the busiest kernels, the time of the optimizer update alone, and the
Python functions that take the host's time (``cProfile``).  Needs a
card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from repro_torch import configs
from repro_torch.data import TokenPipeline
from repro_torch.launch.profile_serve import _host_profile, _profile, _wall_ms
from repro_torch.models.model import LM
from repro_torch.optim.adamw import adamw_update
from repro_torch.train.step import (TrainHParams, init_train_state,
                                    make_train_step)


def cut_depth(cfg, layers: int):
    """``cfg`` with ``layers`` layers: its first period repeated (full
    width; a period of several layers keeps whole periods, at least
    one)."""
    period = cfg.groups[0][0]
    return dataclasses.replace(
        cfg, groups=((period, max(1, layers // len(period))),))


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
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False

    cfg = configs.get(args.arch)
    if cfg.moe is None:
        cfg = configs.sparsify_ffn(cfg, args.density)
    if args.layers is not None:
        cfg = cut_depth(cfg, args.layers)
    lm = LM(cfg, device="cuda", seed=args.seed)
    hp = TrainHParams(peak_lr=1e-4, warmup_steps=0, total_steps=1000)
    box = {"state": init_train_state(lm, hp=hp)}
    step_fn = make_train_step(lm, hp)
    batch = TokenPipeline(cfg.vocab_size, args.batch, args.seq,
                          seed=args.seed).get_batch(0)

    def step():
        box["state"], metrics = step_fn(box["state"], batch)
        float(metrics["loss"])

    def update():
        st = box["state"]
        grads = {n: torch.zeros_like(p) for n, p in st.params.items()}
        adamw_update(grads, st.opt, st.params, lr=0.0)

    for _ in range(2):                          # warm-up
        step()
    torch.cuda.reset_peak_memory_stats()
    out = {"card": torch.cuda.get_device_name(0), "arch": cfg.name,
           "layers": cfg.num_layers,
           "density": None if cfg.moe is not None else args.density,
           "batch": args.batch, "seq": args.seq,
           "step_wall_ms": _wall_ms(step, args.steps),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
           "step": _profile(step, args.steps, top_n=16),
           "adamw_update": _profile(update, 2, top_n=4),
           "step_host": _host_profile(step, 1, top=16)}
    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    return out


if __name__ == "__main__":
    main()
