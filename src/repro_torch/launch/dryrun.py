"""Dry-run: each (architecture x shape) cell of the reference's production
meshes, traced one rank at a time on the meta device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \
        --shape train_4k --mesh pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Counterpart of the JAX package's ``launch/dryrun.py``.  The reference
lowers and compiles each cell's jitted entry point on 512 host devices
and reads the per-device memory, FLOPs and collective bytes out of the
compiled module.  The port has no compile step; what stands in for it
is one rank's own program, run eagerly on the meta device (shapes and
dtypes, no data, no card):

1. **The mesh.** A fake process group of the mesh's size (``"fake"``,
   ``torch.testing._internal.distributed.fake_pg``: every collective
   returns at once) with the traced rank placed on it, and the concrete
   ``DeviceMesh`` that ``launch.mesh.make_device_mesh`` builds over it
   (a mesh of one rank is the one-process program: no group, no mesh).
2. **The rank's model and state.** ``LM(cfg, device="meta", mesh=)`` at
   full size (the blocks that rank holds: every weight its rule's block
   over ``"data"`` and ``"model"``, FSDP, as the reference's dry-run
   passes ``train_state_specs`` and ``param_specs``), and for a train
   cell the train state through ``ShardLayout`` / ``init_train_state``.
   Every call gathers the ``"data"`` blocks where it uses them, so the
   gathers (and a train step's reduce-scatters) show in its collective
   bytes.
3. **The rank's entry point**, eagerly: ``make_train_step`` on its batch
   shard (``train_4k``), ``LM.prefill`` (``prefill_32k``) or
   ``LM.decode_step(retained=)`` (``decode_32k``, ``long_500k``).  Every
   plan routes and walks as on a card (``sparse/plan.py``
   ``route_device``) and every kernel takes its meta branch
   (``kernels/meta.py``), which allocates what its CUDA branch does and
   counts its FLOPs and bytes.
4. **The record**, in the reference's layout: the rank's argument,
   output and peak-transient bytes (``Tracker``: every live storage,
   rounded up to 512 B as the CUDA caching allocator rounds it), the
   FLOPs (``FlopCounterMode`` over the aten ops plus the kernels'), the
   HBM bytes (each aten op's inputs read and outputs written once, plus
   the kernels'), the collective bytes by mesh axis and op (the c10d
   ops' payloads), the roofline terms on the H100
   (``analysis/roofline.py``; collectives at NVLink's 900 GB/s, the
   per-axis bytes kept so links across nodes can be priced later) and
   ``fits``: argument + resident + peak-transient bytes against the
   card's memory (``torch.cuda.get_device_properties`` where a card is
   present, else the H100 SXM data sheet's 80 x 10^9 bytes).

The entry point runs twice: the first call builds the plans and the
metadata the kernels read (kept on the card after it, ``resident``),
the second is the step a running job repeats (``temp``).  The traced
rank is the one ``ShardLayout`` says holds the most bytes among the
ranks along each mesh axis through rank 0 (a rank's blocks are the
product of its coordinates' slices); the record gives those ranks'
largest and smallest argument bytes.  A cell fails when the rank's
program raises or does not fit; the CLI lists the failures and exits 1,
as the reference's does.  Records go to ``experiments/dryrun_torch/``
(ignored by git); ``analysis/report.py`` tabulates them.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch import configs
from repro_torch import sparse as sparse_api
from repro_torch.analysis.roofline import (H100, model_flops_forward,
                                           model_flops_train, roofline_terms)
from repro_torch.core import capture
from repro_torch.kernels import meta as kernel_meta
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.model import LM
from repro_torch.sharding import rules
from repro_torch.train.step import (TrainHParams, init_train_state,
                                    make_train_step)

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")
# the H100 SXM's memory by its data sheet (80 GB), where no card answers
DATASHEET_BYTES = 80 * 10 ** 9
# the CUDA caching allocator's rounding of every block
ALLOC_ROUND = 512
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def card_bytes() -> Tuple[int, str]:
    """The memory a rank's card has: the card's own where one is present,
    else the data sheet's 80 x 10^9 bytes."""
    if torch.cuda.is_available():
        return (int(torch.cuda.get_device_properties(0).total_memory),
                "torch.cuda.get_device_properties(0).total_memory")
    return DATASHEET_BYTES, "H100 SXM data sheet (80 GB)"


def rounded(nbytes: int) -> int:
    """``nbytes`` as the caching allocator holds them (512-byte blocks)."""
    return -(-int(nbytes) // ALLOC_ROUND) * ALLOC_ROUND if nbytes else 0


def tensor_bytes(tensors, *, round_up: bool = True) -> int:
    """Bytes of the distinct storages under ``tensors`` (any pytree)."""
    seen, total = set(), 0
    for t in tree_leaves(tensors):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            if st._cdata not in seen:
                seen.add(st._cdata)
                total += rounded(st.nbytes()) if round_up else st.nbytes()
    return total


# -- the fake mesh ---------------------------------------------------------------

def _fake_store():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    return FakeStore()


@contextlib.contextmanager
def fake_mesh(shape: Sequence[int], names: Sequence[str], rank: int):
    """A concrete ``DeviceMesh`` of ``shape`` over a fake process group in
    which this process is ``rank`` (every collective returns at once);
    the group is destroyed on exit.  One rank is the one-process program
    (no process group, no mesh): None."""
    import torch.distributed as dist
    world = int(np.prod(shape))
    if world == 1:
        yield None
        return
    dist.init_process_group("fake", store=_fake_store(), rank=rank,
                            world_size=world)
    try:
        yield mesh_lib.make_device_mesh("cpu", shape, names)
    finally:
        dist.destroy_process_group()


def _axis_ranks(shape: Sequence[int]) -> List[int]:
    """Rank 0 and the ranks along each axis through it."""
    ranks = {0}
    strides = np.cumprod((1,) + tuple(shape[::-1]))[::-1][1:]
    for ax, n in enumerate(shape):
        ranks.update(int(i * strides[ax]) for i in range(n))
    return sorted(ranks)


def state_tensors(lm, state=None) -> Dict[str, torch.Tensor]:
    """The rank's resident arguments: the parameters it holds and, with a
    train state, its optimizer (and compression) blocks and the step and
    count."""
    out = {f"params.{n}": p for n, p in lm.named_parameters()}
    if state is not None:
        out["step"] = state.step
        out["opt.count"] = state.opt.count
        for tab in ("master", "mu", "nu"):
            out.update({f"opt.{tab}.{n}": t
                        for n, t in getattr(state.opt, tab).items()})
        if state.ef is not None:
            out.update({f"ef.{n}": t for n, t in state.ef.residual.items()})
    return out


def argument_bytes_by_rank(cfg, shape: Sequence[int], names: Sequence[str],
                           train: bool,
                           hp: TrainHParams = TrainHParams()
                           ) -> Dict[int, int]:
    """Each rank's resident argument bytes (parameters, and for a train
    cell its state) as the layout places them, over ``_axis_ranks``."""
    out = {}
    for r in _axis_ranks(shape):
        with fake_mesh(shape, names, r) as mesh:
            lm = LM(cfg, device="meta", mesh=mesh)
            state = init_train_state(lm, hp=hp, mesh=mesh) if train else None
            out[r] = tensor_bytes(state_tensors(lm, state))
    return out


# -- the tracker -------------------------------------------------------------------

_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "detach", "alias",
               "_local_scalar_dense", "lift_fresh", "set_"}


class Tracker(TorchDispatchMode):
    """Every storage allocated under the mode while it lives (rounded to
    512 B), its peak; each aten op's bytes in and out (views and
    allocations move none); and each c10d collective's payload by the
    mesh axes its group spans."""

    def __init__(self, mesh=None):
        super().__init__()
        self.live = 0
        self.peak = 0
        self.hbm_bytes = 0.0
        self.collectives: Dict[str, Dict[str, float]] = {}
        self._sizes: Dict[int, int] = {}
        self._axes = _group_axes(mesh)

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key, 0)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._sizes:
            return
        n = rounded(st.nbytes())
        self._sizes[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns = func.namespace
        if ns == "c10d":
            self._collective(func, args)
            return out
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        # a view's or an in-place op's output lives in an input's storage
        had = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            if t.untyped_storage()._cdata not in had:
                self._track(t)
        name = func._schema.name.split("::")[-1]
        if ns == "aten" and not func.is_view and name not in _NO_TRAFFIC:
            self.hbm_bytes += sum(t.numel() * t.element_size()
                                  for t in ins + outs)
        return out

    def _collective(self, func, args) -> None:
        tensors = [t for t in tree_leaves(args) if isinstance(t, torch.Tensor)]
        groups = [a for a in tree_leaves(args)
                  if isinstance(a, torch.ScriptObject)]
        axes = self._axes(groups[0]) if groups else "?"
        op = func._schema.name.split("::")[-1]
        nbytes = float(sum(t.numel() * t.element_size() for t in tensors))
        self.collectives.setdefault(axes, {})
        self.collectives[axes][op] = self.collectives[axes].get(op, 0) \
            + nbytes


def _group_axes(mesh) -> Callable[[Any], str]:
    """A c10d process group -> the mesh axes it spans ("a+b")."""
    if mesh is None:
        return lambda g: "?"
    import torch.distributed as dist
    names, sizes = mesh_lib.mesh_axes(mesh)
    coords = np.array(np.unravel_index(np.arange(int(np.prod(sizes))),
                                       sizes)).T

    def axes(g) -> str:
        try:
            pg = dist.ProcessGroup.unbox(g)
            ranks = dist.get_process_group_ranks(pg)
        except Exception:  # noqa: BLE001 -- an unnamed group
            return "?"
        c = coords[ranks]
        spans = [n for i, n in enumerate(names) if len(set(c[:, i])) > 1]
        return "+".join(spans) or "none"
    return axes


def _flop_counter():
    from torch.utils.flop_counter import FlopCounterMode
    return FlopCounterMode(display=False)


def trace(fn: Callable[[], Any], *, mesh=None,
          count_flops: bool = False) -> dict:
    """Run ``fn`` (a rank's program on meta tensors) under the tracker,
    with the kernels' meta counters reset and the plans it calls
    recorded: its peak-transient and output bytes, HBM bytes (aten and
    kernels), collective bytes by axis and op, the kernels' calls by
    walk, and each plan's route, backward routes and walk; with
    ``count_flops`` also the aten FLOPs (``FlopCounterMode``, whose
    module hooks keep activations alive past their use: the memory of
    such a call is not the program's)."""
    kernel_meta.reset()
    flops = _flop_counter() if count_flops else contextlib.nullcontext()
    tr = Tracker(mesh)
    with capture.recording() as rec, flops, tr:
        out = fn()
    work = kernel_meta.totals()
    out_bytes = tensor_bytes([t for t in tree_leaves(out)
                              if isinstance(t, torch.Tensor)
                              and t.untyped_storage()._cdata in tr._sizes])
    plans = [plan_summary(p) for p in rec.held.values()
             if isinstance(p, sparse_api.MatmulPlan)]
    res = dict(
        peak_transient=tr.peak, output=out_bytes,
        left=tr.live,      # allocated by the call and still alive after it
        aten_flops=(float(flops.get_total_flops()) if count_flops
                    else None),
        kernel_flops=sum(w["flops"] for w in work.values()),
        aten_bytes=tr.hbm_bytes,
        kernel_bytes=sum(w["bytes"] for w in work.values()),
        collectives=tr.collectives, kernels=work,
        plans=sorted(plans, key=lambda p: p["problem"]))
    del out
    return res


def plan_summary(p) -> dict:
    """A plan's problem and what a card runs for it: route, backward
    routes, the walk shape and whether the bsmm walk has its tensor-core
    schedule."""
    return {"problem": f"{p.kind} {p.m}x{p.k} n={p.n} "
                       f"{str(p.dtype).replace('torch.', '')}",
            "route": p.route, "source": p.source,
            "grad": (p.grad_routes if p.grad is not None
                     or p.kind != "static" else None),
            "mma": p.mma is not None, "split": p.split,
            "walk_shape": list(p.walk_shape)}


# -- the cells -----------------------------------------------------------------------

def rank_batch(mesh, batch: int) -> int:
    """A rank's share of a global batch: split over the batch axes where
    they divide it (the reference's ``train_batch_specs``), else whole."""
    dp = mesh_lib.axis_index(mesh, rules.batch_axes(mesh))[1]
    return batch // dp if batch % dp == 0 else batch


@dataclasses.dataclass
class Cell:
    """One rank's program of a cell: ``run()`` calls its entry point;
    ``args``: its resident argument tensors; ``meta``: the record's
    identity fields."""

    run: Callable[[], Any]
    args: Dict[str, torch.Tensor]
    meta: dict


def build_cell(name: str, shape: str, mesh, *, cfg=None,
               hp: TrainHParams = TrainHParams(),
               sh: Optional[dict] = None) -> Cell:
    """The rank's program of one cell on ``mesh`` (``sh`` overrides the
    shape cell's ``batch`` / ``seq``)."""
    cfg = cfg or configs.get(name)
    sh = dict(configs.SHAPES[shape], **(sh or {}))
    b_, s = rank_batch(mesh, sh["batch"]), sh["seq"]
    kind = sh["kind"]
    meta = dict(arch=cfg.name, shape=shape, kind=kind, batch=sh["batch"],
                seq=s, rank_batch=b_)
    # the ranks hold shards of the batch where it split (else each the
    # whole): the MoE layers' global routing reads it
    split = b_ != sh["batch"]
    if cfg.moe is not None:
        meta["moe"] = moe_buckets(cfg, b_ * (1 if kind == "decode" else s),
                                  sh["batch"] // b_)

    def installed():
        return rules.activation_mesh(mesh, batch_split=split)
    lm = LM(cfg, device="meta", mesh=mesh)
    # the cell's inputs at the rank's batch, on meta (the caches the
    # rank's model holds)
    kw = configs.input_specs(name, shape, cfg=cfg, batch=b_, seq=s,
                             lm=lm)[1]
    if kind == "train":
        state = init_train_state(lm, hp=hp, mesh=mesh)
        step = make_train_step(lm, hp)
        batch = kw["batch"]
        meta["model_flops_device"] = model_flops_train(
            cfg.active_param_count(), sh["batch"] * s) / _size(mesh)

        def run():
            with installed():
                return step(state, batch)[1]
        return Cell(run, dict(state_tensors(lm, state), **{
            f"batch.{k}": v for k, v in batch.items()}), meta)
    lm.requires_grad_(False)
    if kind == "prefill":
        toks = kw.pop("tokens")
        max_len = s + (cfg.frontend_len if cfg.frontend == "vision" else 0)
        meta["model_flops_device"] = model_flops_forward(
            cfg.active_param_count(), sh["batch"] * s) / _size(mesh)

        def run():
            with installed():
                return lm.prefill(toks, max_len=max_len, **kw)
        return Cell(run, dict(state_tensors(lm), tokens=toks, **kw), meta)
    retained, caches = kw["retained"], kw["caches"]
    toks, pos = kw["tokens"], kw["positions"]
    meta["retained"] = retained
    meta["model_flops_device"] = model_flops_forward(
        cfg.active_param_count(), sh["batch"]) / _size(mesh)

    def run():
        with installed():
            return lm.decode_step(toks, caches, pos, retained=retained)[0]
    return Cell(run, dict(state_tensors(lm), tokens=toks, positions=pos,
                          caches=caches), meta)


def moe_buckets(cfg, tokens: int, shards: int) -> dict:
    """An MoE layer's expert work a rank against the reference's: each
    rank computes its experts on buckets of ``min(cap, tokens)`` rows
    (``models/moe.py`` ``global_route``) where the reference's GSPMD
    splits the global capacity ``cap`` over the ``shards`` batch shards
    (``work_factor``: the ratio, up to ``shards``)."""
    from repro_torch.models.moe import _capacity
    cap = _capacity(tokens * shards, cfg)
    bucket = min(cap, tokens)
    return dict(tokens=tokens, shards=shards, cap_global=cap, bucket=bucket,
                work_factor=bucket * shards / cap)


def _size(mesh) -> int:
    return int(np.prod(mesh_lib.mesh_axes(mesh)[1]))


def trace_cell(cell: Cell, mesh) -> dict:
    """The two calls of a cell's program (module docstring): the first
    with the FLOPs counted (its work and ``resident``), the second for
    the memory a repeated call takes."""
    first = trace(cell.run, mesh=mesh, count_flops=True)
    again = trace(cell.run, mesh=mesh)
    return dict(first=first, again=again,
                argument=tensor_bytes(cell.args),
                resident=first["left"] - first["output"])


def run_cell(name: str, shape: str, *, multi_pod: bool = False, cfg=None,
             save: bool = True, verbose: bool = True,
             hp: TrainHParams = TrainHParams(), tag: str = "",
             mesh_shape: Optional[Tuple[Sequence[int], Sequence[str]]] = None,
             sh: Optional[dict] = None, out_dir: Optional[str] = None
             ) -> dict:
    """Trace one cell on the production mesh (or ``mesh_shape`` =
    ``(sizes, names)``) and return its record (written under ``out_dir``,
    ``OUT_DIR`` by default, with ``save``).  Raises what the rank's
    program raises."""
    mesh_name = "2x16x16" if multi_pod else "16x16"
    sizes, names = mesh_shape or MESHES[mesh_name]
    if mesh_shape is not None:
        mesh_name = "x".join(str(s) for s in sizes)
    cfg = cfg or configs.get(name)
    kind = dict(configs.SHAPES[shape], **(sh or {}))["kind"]
    t0 = time.time()
    by_rank = argument_bytes_by_rank(cfg, sizes, names, kind == "train",
                                     hp)
    rank = max(by_rank, key=lambda r: (by_rank[r], -r))
    t_layout = time.time() - t0
    with fake_mesh(sizes, names, rank) as mesh:
        cell = build_cell(name, shape, mesh, cfg=cfg, hp=hp, sh=sh)
        res = trace_cell(cell, mesh)
    t_trace = time.time() - t0 - t_layout
    rec = record(cell.meta, res, mesh_name=mesh_name, devices=int(
        np.prod(sizes)), rank=rank, by_rank=by_rank,
        timing=dict(layout_s=round(t_layout, 1), trace_s=round(t_trace, 1)))
    if verbose:
        print_record(rec)
    if save:
        out_dir = out_dir or OUT_DIR
        os.makedirs(out_dir, exist_ok=True)
        mod = configs.ALIASES.get(name, name)
        fname = f"{mod}__{shape}__{mesh_name}{tag}.json"
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def record(meta: dict, res: dict, *, mesh_name: str, devices: int,
           rank: int, by_rank: Dict[int, int], timing: dict) -> dict:
    """A cell's record in the reference's layout (``memory``, ``cost``,
    ``roofline``), with the port's ``fits``, peak and per-axis
    collectives."""
    first, again = res["first"], res["again"]
    cap, cap_src = card_bytes()
    peak = res["argument"] + res["resident"] + again["peak_transient"]
    coll = first["collectives"]
    coll_bytes = sum(v for ops in coll.values() for v in ops.values())
    cost = dict(flops=first["aten_flops"] + first["kernel_flops"],
                bytes=first["aten_bytes"] + first["kernel_bytes"],
                collective_bytes=coll_bytes)
    roof = roofline_terms(cost, H100,
                          model_flops_per_device=meta["model_flops_device"])
    mib = 2 ** 20
    return dict(
        meta, mesh=mesh_name, devices=devices, rank=rank, **timing,
        memory=dict(argument_mb=res["argument"] / mib,
                    output_mb=again["output"] / mib,
                    temp_mb=again["peak_transient"] / mib,
                    resident_mb=res["resident"] / mib,
                    peak_bytes=peak, peak_gib=peak / 2 ** 30,
                    argument_bytes_by_rank=dict(
                        max=max(by_rank.values()), min=min(by_rank.values()),
                        ranks=len(by_rank))),
        card_bytes=cap, card_bytes_source=cap_src, fits=peak <= cap,
        cost=dict(cost, aten_flops=first["aten_flops"],
                  kernel_flops=first["kernel_flops"],
                  aten_bytes=first["aten_bytes"],
                  kernel_bytes=first["kernel_bytes"],
                  collectives=coll,
                  collective_bytes_by_axis={
                      a: sum(ops.values()) for a, ops in coll.items()}),
        kernels={k: w for k, w in again["kernels"].items() if w["calls"]},
        plans=again["plans"], roofline=roof)


def print_record(rec: dict) -> None:
    m, ro = rec["memory"], rec["roofline"]
    print(f"== {rec['arch']} x {rec['shape']} on {rec['mesh']} "
          f"({rec['devices']} ranks, rank {rec['rank']} traced) ==")
    print(f"  memory/rank: args {m['argument_mb']:.0f} MiB  resident "
          f"{m['resident_mb']:.0f} MiB  temp {m['temp_mb']:.0f} MiB  "
          f"output {m['output_mb']:.0f} MiB  peak {m['peak_gib']:.2f} GiB "
          f"({'fits' if rec['fits'] else 'does NOT fit'} "
          f"{rec['card_bytes'] / 2 ** 30:.1f} GiB)")
    print(f"  per-rank: {rec['cost']['flops']:.3e} FLOP, "
          f"{rec['cost']['bytes']:.3e} B HBM, "
          f"{rec['cost']['collective_bytes']:.3e} B collective "
          f"{json.dumps(rec['cost']['collective_bytes_by_axis'])}")
    print(f"  roofline: compute {ro['t_compute']*1e3:.2f} ms | "
          f"memory {ro['t_memory']*1e3:.2f} ms | "
          f"collective {ro['t_collective']*1e3:.2f} ms "
          f"-> {ro['dominant']}-bound"
          + (f", roofline frac {ro['roofline_frac']:.3f}"
             if "roofline_frac" in ro else ""))


def save_failure(arch: str, shape: str, multi_pod: bool, custom,
                 error: str, args) -> None:
    """The record of a cell whose rank's program raised: its identity
    and the error (``analysis/report.py`` lists it)."""
    sizes = custom[0] if custom else MESHES[
        "2x16x16" if multi_pod else "16x16"][0]
    mesh_name = "x".join(str(v) for v in sizes)
    out_dir = args.out or OUT_DIR
    os.makedirs(out_dir, exist_ok=True)
    mod = configs.ALIASES.get(arch, arch)
    with open(os.path.join(out_dir, f"{mod}__{shape}__{mesh_name}"
                                    f"{args.tag}.json"), "w") as f:
        json.dump(dict(arch=configs.get(arch).name, shape=shape,
                       mesh=mesh_name, devices=int(np.prod(sizes)),
                       error=error, fits=False), f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(configs.SHAPES) + [None])
    ap.add_argument("--mesh", default="pod",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--mesh-shape", default=None,
                    help="another mesh in place of --mesh: 'data,model' "
                         "sizes, or 'pod,data,model' (e.g. 1,1 or 1x4)")
    ap.add_argument("--out", default=None,
                    help=f"records directory (default {OUT_DIR})")
    ap.add_argument("--batch", type=int, default=None,
                    help="the global batch in place of the shape cell's")
    ap.add_argument("--seq", type=int, default=None,
                    help="the sequence length in place of the cell's")
    args = ap.parse_args(argv)
    over = {k: v for k, v in (("batch", args.batch), ("seq", args.seq))
            if v is not None}

    archs = configs.ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(configs.SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]
    custom = None
    if args.mesh_shape:
        sizes = tuple(int(v) for v in
                      args.mesh_shape.replace("x", ",").split(","))
        custom = (sizes, ("pod", "data", "model")[3 - len(sizes):])
        meshes = [False]

    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    rec = run_cell(arch, shape, multi_pod=mp, tag=args.tag,
                                   mesh_shape=custom, out_dir=args.out,
                                   sh=over or None)
                except Exception as e:  # noqa: BLE001 -- report, keep going
                    failures.append((arch, shape, mp, repr(e)))
                    save_failure(arch, shape, mp, custom, repr(e), args)
                    print(f"!! FAIL {arch} x {shape} multi_pod={mp}: {e}")
                    traceback.print_exc(limit=3)
                    continue
                if not rec["fits"]:
                    why = (f"peak {rec['memory']['peak_gib']:.2f} GiB > "
                           f"{rec['card_bytes'] / 2 ** 30:.2f} GiB")
                    failures.append((arch, shape, mp, why))
                    print(f"!! FAIL {arch} x {shape} multi_pod={mp}: {why}")
    print(f"\n{'='*60}\ncells: {len(archs)*len(shapes)*len(meshes)}, "
          f"failures: {len(failures)}")
    for f in failures:
        print("  FAIL:", f)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
