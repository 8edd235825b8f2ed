"""Training launcher: AdamW steps of an LM on the synthetic token stream.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --density 0.125 --steps 10 --batch 4 --seq 512

Runs on the card by default (``--device cpu`` runs the kernels' plain
PyTorch versions; use ``--smoke`` there).  ``--density`` makes every FFN
block-sparse at that block density, so the step runs the sparse plan's
planned backward (bsmm on the transposed pattern, the SDDMM kernel).
An MoE config trains through its expert GEMMs' planned backward (gmm)
and adds the router losses:

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch qwen3-moe-30b-a3b --smoke --device cpu --steps 3

``train_loop`` takes any config, a depth-cut one included
(``dataclasses.replace`` of ``groups``).  On a card each step replays
one CUDA graph of the whole step (forward, backward, clip, AdamW;
``train/program.py``), the counterpart of the reference's ``jax.jit``
with the state donated; ``--eager`` (``graphs=False``) runs the same
step eagerly, as the CPU always does.

Counterpart of the JAX package's ``launch/train.py``: a deterministic
data pipeline with a checkpointable cursor, async atomic checkpoints
every ``--ckpt-every`` steps, automatic resume from the latest
checkpoint (rerun the same command after a crash), and a SIGTERM handler
that writes a final checkpoint and stops (on a mesh every rank reads the
flag's max over the mesh after each step, so all of them save that
checkpoint and stop together).

``train_loop(mesh=)`` trains on a mesh (the default is
``make_host_mesh()``, one process).  On a concrete ``DeviceMesh`` every
rank runs the loop: it reads its shard of the global batch (the batch
axes' share of ``train_batch_specs``; the global stream is the one
process's stream of ``dp x batch_per_shard`` rows), its state is sharded
(``train/step.py``), the mesh is installed for the step
(``sharding.activation_mesh``: the MoE layers' expert parallelism), and
a checkpoint holds whole tensors, so it resumes on any mesh.  Rank 0
prints and calls ``on_step``.  ``--mesh 2,1`` (``data, model``; three
sizes add ``pod`` in front; ``1x4`` is ``1,4``) spawns one process per
rank on this host (gloo on the CPU, NCCL on cards, one card a rank).
The LM is built on the mesh (``LM(mesh=)``): every weight is held as
its rule's block (FSDP: split over ``"data"`` beside ``"model"``,
gathered in the forward, its gradient reduce-scattered; no flag, the
rules decide), and a ``"model"`` axis past 1 splits the model itself
(heads, d_ff, the vocabulary and the sparse FFNs' k-shards), so a model
larger than one card trains on four (glm4-9b: ``--mesh 1x4`` or
``4x1``):

    PYTHONPATH=src python -m repro_torch.launch.train --smoke \
        --device cpu --density 0.25 --steps 5 --batch 2 --seq 32 \
        --mesh 2,1
"""
from __future__ import annotations

import argparse
import gc
import os
import signal
import sys
import threading
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.checkpoint import Checkpointer, latest_step, restore
from repro_torch.data import TokenPipeline
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.model import LM
from repro_torch.sharding import rules
from repro_torch.train.program import TrainProgram
from repro_torch.train.step import (TrainHParams, init_train_state,
                                    load_state_tree, state_tree)


def train_loop(cfg, *, steps: int, batch_per_shard: int, seq: int,
               ckpt_dir: str | None, ckpt_every: int = 20,
               hp: TrainHParams = TrainHParams(), device=None,
               log_every: int = 10, on_step=None, seed: int = 0,
               graphs: Optional[bool] = None, float_inputs=None,
               mesh=None):
    """Train ``cfg`` from a seeded init (or the latest checkpoint under
    ``ckpt_dir``) up to ``steps``.  Returns ``(state, losses)``.

    ``graphs`` (None: on a card) replays the step as one captured CUDA
    graph (``TrainProgram``); ``graphs=True`` on the CPU raises.  The
    loss is read once a step, after it ran.
    ``on_step(step, metrics, program)`` sees each step's metrics (device
    tensors, which the next step rewrites), with ``step_s``, the step's
    wall time on the host clock (the loss was read back, so the device
    has finished the step), and the ``TrainProgram`` (its ``state``,
    ``lm`` and ``program``).  It runs before the step's checkpoint: a
    topology step taken there is in that checkpoint, and the graph is
    captured again before its next replay.

    ``float_inputs(step)`` gives a step's float entries beside the
    pipeline's tokens (an encoder-decoder's ``enc_frames``, a VLM's
    ``frontend``: ``{name: [B, ...] array}``, the same shapes every
    step); the token pipeline makes none.

    ``mesh``: see the module docstring; on a concrete mesh every rank
    calls this with the same arguments, and each gets its own state
    (its held blocks of the parameters under the rules, ``"data"`` and
    ``"model"``; the optimizer's blocks) and the mean loss."""
    mesh = mesh or mesh_lib.make_host_mesh()
    lm = LM(cfg, device=device, seed=seed, mesh=mesh)
    state = init_train_state(lm, hp=hp, mesh=mesh)
    # this rank's shard of the global batch: the batch dim of
    # train_batch_specs over the batch axes
    shards = mesh_lib.axis_index(mesh, rules.batch_axes(mesh))[1]
    spec = rules.train_batch_specs(
        {"tokens": (batch_per_shard * shards, seq)}, mesh)["tokens"]
    shard_id, shards = mesh_lib.axis_index(mesh, mesh_lib.spec_axes(spec))
    pipe = TokenPipeline(cfg.vocab_size, batch_per_shard, seq,
                         num_shards=shards, shard_id=shard_id)
    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    specs = (None if state.layout is None else
             state.layout.storage_specs(state_tree(state)))
    lead = not mesh_lib.is_concrete(mesh) or dist.get_rank() == 0

    start = 0
    if ckpt_dir and latest_step(ckpt_dir) is not None:
        tree, extra, _ = restore(ckpt_dir, state_tree(state), mesh=mesh,
                                 specs=specs)
        state = load_state_tree(state, tree)
        start = TokenPipeline.resume_step(extra["data"])
        if lead:
            print(f"[train] resumed from step {start}")
    floats = ({} if float_inputs is None else
              {k: tuple(v.shape) for k, v in float_inputs(start).items()})
    program = TrainProgram(lm, state, hp, batch=batch_per_shard, seq=seq,
                           graph=graphs, floats=floats)

    stop = {"now": False}

    def on_sigterm(signum, frame):
        stop["now"] = True
    main_thread = threading.current_thread() is threading.main_thread()
    old = signal.signal(signal.SIGTERM, on_sigterm) if main_thread else None

    losses = []
    t0 = time.perf_counter()
    try:
        with rules.activation_mesh(mesh):
            for step in range(start, steps):
                ts = time.perf_counter()
                batch = pipe.get_batch(step)
                if float_inputs is not None:
                    batch = dict(batch, **float_inputs(step))
                program.load(batch)
                metrics = program()
                loss = float(metrics["loss"])
                metrics = dict(metrics, step_s=time.perf_counter() - ts)
                losses.append(loss)
                if on_step and lead:
                    on_step(step, metrics, program)
                if lead and (step % log_every == 0 or step == steps - 1):
                    print(f"[train] step {step} loss {loss:.4f} "
                          f"gnorm {float(metrics['grad_norm']):.3f} "
                          f"({time.perf_counter() - t0:.1f}s)")
                # read once a step: a signal that lands later waits for
                # the next step's agreement
                stop_now = _agreed(stop["now"], mesh, metrics["loss"].device)
                if ckpt and ((step + 1) % ckpt_every == 0 or stop_now
                             or step == steps - 1):
                    ckpt.save_async(state_tree(program.state),
                                    step=step + 1,
                                    extra={"data": pipe.state(step + 1)},
                                    mesh=mesh, specs=specs)
                if stop_now:
                    if lead:
                        print("[train] preemption signal: final "
                              "checkpoint + exit")
                    break
        if ckpt:
            ckpt.wait()
    finally:
        if main_thread:
            signal.signal(signal.SIGTERM, old)
    return program.state, losses


def _agreed(flag: bool, mesh, device) -> bool:
    """The preemption flag as every rank of a concrete mesh reads it: the
    max over the mesh.  SIGTERM reaches the ranks at different moments,
    and a rank that saved (the checkpoint's gathers are collectives over
    the mesh) and stopped alone would leave the others waiting in the
    next step's all-reduce."""
    if not mesh_lib.is_concrete(mesh):
        return flag
    group = mesh_lib.axes_group(mesh, mesh_lib.mesh_axes(mesh)[0])
    if group is None:
        return flag
    t = torch.tensor([float(flag)], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item())


def _mesh_shape(text: str):
    """``--mesh``: ``data,model`` or ``pod,data,model`` sizes (``,`` or
    ``x`` between them)."""
    sizes = tuple(int(v) for v in text.replace("x", ",").split(","))
    names = {2: ("data", "model"), 3: ("pod", "data", "model")}.get(
        len(sizes))
    if names is None or min(sizes) < 1:
        raise SystemExit(f"--mesh {text!r}: give data,model or "
                         f"pod,data,model sizes")
    return sizes, names


def _rank_main(rank, world, init_file, backend, args, cfg, hp):
    """One rank of ``--mesh``: the process group, its ``DeviceMesh`` and
    the loop; the losses on rank 0."""
    dev = args.device
    if dev.startswith("cuda"):
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = "cuda"
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        sizes, names = _mesh_shape(args.mesh)
        mesh = mesh_lib.make_device_mesh(
            "cuda" if dev == "cuda" else "cpu", sizes, names)
        _, losses = _run(args, cfg, hp, device=dev, mesh=mesh)
        if rank == 0:
            _report(losses)
    finally:
        # a captured step's graph (kept by its program's reference
        # cycle) holds the communicators it captured: drop it first
        gc.collect()
        dist.barrier()
        dist.destroy_process_group()


def _run(args, cfg, hp, **kw):
    return train_loop(cfg, steps=args.steps, batch_per_shard=args.batch,
                      seq=args.seq, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every, hp=hp,
                      log_every=args.log_every, seed=args.seed,
                      graphs=False if args.eager else None, **kw)


def _report(losses):
    if losses:
        print(f"[train] done: first loss {losses[0]:.4f} "
              f"last loss {losses[-1]:.4f}")
        if not (losses[-1] < losses[0]):
            print("[train] WARNING: loss did not improve", file=sys.stderr)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config of the same family")
    ap.add_argument("--density", type=float, default=None,
                    help="block density of a sparse FFN in every layer")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device ('cpu' runs the plain versions)")
    ap.add_argument("--eager", action="store_true",
                    help="run each step eagerly instead of replaying its "
                         "CUDA graph (the CPU is always eager)")
    ap.add_argument("--mesh", default=None,
                    help="data,model (or pod,data,model) sizes: one "
                         "process per rank on this host, the state "
                         "sharded, each rank --batch rows")
    args = ap.parse_args(argv)

    cfg = configs.smoke(args.arch) if args.smoke else configs.get(args.arch)
    if args.density is not None:
        if not configs.dense_ffns(cfg):
            raise SystemExit(f"--density: {cfg.name}'s FFNs are not all "
                             f"dense MLPs to sparsify")
        cfg = configs.sparsify_ffn(cfg, args.density)
    hp = TrainHParams(peak_lr=args.lr, warmup_steps=max(1, args.steps // 10),
                      total_steps=args.steps)
    if args.device.startswith("cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
    if args.mesh is None:
        _, losses = _run(args, cfg, hp, device=args.device)
        _report(losses)
        return losses
    import tempfile

    import torch.multiprocessing as mp
    sizes, _ = _mesh_shape(args.mesh)
    world = int(np.prod(sizes))
    backend = "gloo"
    if args.device.startswith("cuda"):
        backend = "nccl"
        if world > torch.cuda.device_count():
            raise SystemExit(f"--mesh {args.mesh}: {world} ranks, one card "
                             f"each, on {torch.cuda.device_count()} cards")
    with tempfile.TemporaryDirectory(prefix="train_mesh_") as tmp:
        mp.start_processes(_rank_main, args=(
            world, os.path.join(tmp, "pg"), backend, args, cfg, hp),
            nprocs=world, join=True, start_method="spawn")
    return None


if __name__ == "__main__":
    main()
