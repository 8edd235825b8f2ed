"""Serving driver: continuous-batching engine over a selectable arch.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --density 0.125 --requests 8 --batch 4 --max-len 512
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen3-moe-30b-a3b

Architectures: every config of ``repro_torch.configs`` (llama3.2-1b,
gemma2-2b, qwen3-moe-30b-a3b with 128 experts top-8 on the gmm kernel,
qwen2-1.5b, glm4-9b, deepseek-v2-lite-16b, mamba2-130m and
jamba-v0.1-52b; the last two prefill each prompt at its exact length).
Runs on the card by default; ``--device cpu`` runs the kernels' plain
PyTorch versions on the CPU (use ``--smoke`` there).  ``--density``
makes every dense FFN block-sparse at that block density (block size
``ffn_block_size``), the paper's sparse FFN; a config whose FFNs are not
all dense MLPs (MoE, mamba2's none, jamba's mix) refuses it.
On the card the engine captures its decode step and each bucket's
prefill as CUDA graphs at their first use and replays them; ``--eager``
runs the same programs eagerly instead.  ``--plan-cache DIR`` persists
the engine's route verdicts in DIR: a restart from the same directory
replays them with zero decisions and zero measurements.  ``--retained``
decodes with the ring-buffer local + global KV cache of the reference's
long-context cell (``LM.decode_step(retained=True)``; through the engine
a request stops at ``max_len - 1`` as in the reference, so the ring
does not wrap and only the local layers' window filter is off).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import configs
from repro_torch.models.model import LM
from repro_torch.serve import Engine, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--retained", action="store_true",
                    help="decode with the ring-buffer local + global KV "
                         "cache")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain versions)")
    ap.add_argument("--density", type=float, default=None,
                    help="block density of a sparse FFN in every layer")
    ap.add_argument("--eager", action="store_true",
                    help="run the programs eagerly on the card (no CUDA "
                         "graphs)")
    ap.add_argument("--plan-cache", default=None, metavar="DIR",
                    help="persistent route-verdict cache dir "
                         "(repro_torch.sparse): restarts skip re-planning")
    args = ap.parse_args(argv)

    cfg = configs.smoke(args.arch) if args.smoke else configs.get(args.arch)
    if args.density is not None:
        if not configs.dense_ffns(cfg):
            raise SystemExit(f"--density: {cfg.name}'s FFNs are not all "
                             f"dense MLPs to sparsify")
        cfg = configs.sparsify_ffn(cfg, args.density)
    lm = LM(cfg, device=args.device, seed=args.seed)
    eng = Engine(lm, batch=args.batch, max_len=args.max_len,
                 retained=args.retained, device=lm.device, graphs=False if args.eager else None,
                 plan_cache_dir=args.plan_cache)
    print(f"[serve] {cfg.name} on {lm.device}, buckets {eng.buckets}, "
          f"graphs {eng.graphs}; startup plans {eng.plan_stats}")

    rng = np.random.default_rng(args.seed)
    reqs = [Request(uid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        size=int(rng.integers(4, 24))),
                    max_new_tokens=args.new_tokens)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    done = []
    eng.run(reqs, on_finish=lambda r: done.append(
        (r.uid, time.perf_counter() - t0)))
    total_toks = sum(len(r.output) for r in reqs)
    dt = time.perf_counter() - t0
    for uid, t in done:
        r = next(r for r in reqs if r.uid == uid)
        print(f"[serve] req {uid}: {len(r.prompt)} prompt -> "
              f"{len(r.output)} tokens @ {t:.2f}s: {r.output[:6]}...")
    print(f"[serve] {len(reqs)} requests, {total_toks} tokens, "
          f"{dt:.2f}s ({total_toks / dt:.1f} tok/s on {lm.device}, "
          f"batch={args.batch}, retained={args.retained})")
    st = eng.stats()
    g = st["graphs"]
    print(f"[serve] decode step p50 {st['step_latency']['p50_ms']} ms, "
          f"prefill p50 {st['prefill_latency']['p50_ms']} ms; graphs: "
          f"{g['captures']} captured in {g['capture_s']:.3f}s, "
          f"{g['replays']} replays")
    return eng


if __name__ == "__main__":
    main()
