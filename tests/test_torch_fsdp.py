"""FSDP: every parameter held as its rule's whole block, over gloo ranks
on the CPU, against one process and the JAX package.

An ``LM`` built on a concrete mesh holds each weight as the block the
reference's ``param_specs`` gives it (the ``"data"`` split beside the
``"model"`` one), gathers it over ``"data"`` inside the forward
(``core.tp.gather_held``) and reduce-scatters its gradient.  fp32, the
port's budget 2e-4 rel-max (``FSDP_TOL``), unless a check says
otherwise:

* the gather / reduce-scatter pair (``core.tp.gather_dim``) over 2 gloo
  ranks against one process, on dims 0 and 1, through the collectives
  (``all_gather_into_tensor`` / ``reduce_scatter_tensor``, what gloo does
  for host tensors and NCCL for card tensors) and through the all-reduce
  that stands in for a card tensor over gloo; ``Block.gather`` of blocks
  that overlap in part and of uneven row sets, both routes, bit-exact;
* every parameter's held block, for the smoke configs of all ten
  architectures on fake (16, 16) and (2, 2) meshes (the dry-run's
  ``fake_mesh``; no spawn), equal to the block of the reference's
  ``rules.param_specs`` on every ``"data"`` dim, and on every other dim
  but where the port holds a block by design (whole heads, a sparse
  FFN's k-shard, a Mamba-2 rank's columns);
* 2 train steps on (2, 1) for llama (dense), deepseek (MLA), mamba2 and
  seamless, and on (2, 2) for llama: loss, grad norm and xent against
  the JAX step under ``jax.jit`` and the one-process port, each rank's
  master blocks against the JAX and one-process masters (on (2, 2) from
  the JAX train state, each leaf's block taken); a (2, 1) checkpoint
  resumed on (1, 2) within the budget of the unbroken run;
* fault 3.15 (bf16 across ranks at depth): on (1, 2), 2 gloo ranks run
  a bf16 llama and mamba2 (4 layers) layer by layer; a one-process
  emulation of the same split (the same held blocks, each rank's
  partial by the same module code, the partials summed in bf16 in rank
  order: two threads meeting at every all-reduce) gives every layer's
  output to the bit.  So the split adds nothing to bf16's rounding; the
  gap to one whole process is the dtype's (printed).

The ranks (spawned, ``file://`` init under ``tmp_path``, joined with a
timeout) import no JAX: the parent computes the references.
"""
import dataclasses
import functools
import os
import shutil
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402

FSDP_TOL = 2e-4
SPAWN_TIMEOUT = 240
HP = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
BATCH, SEQ, STEPS = 4, 16, 2
NAMES = ("data", "model")
ARCHS = {"llama": "llama3_2_1b", "deepseek": "deepseek_v2_lite_16b",
         "mamba2": "mamba2_130m", "seamless": "seamless_m4t_medium"}
DEPTH = 4


def _rel(got, want, whole=None):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    ref = want if whole is None else np.asarray(whole, np.float32)
    return float(np.abs(got - want).max()) / max(
        float(np.abs(ref).max()), 1e-6)


def _cfgs(arch, dtype="float32"):
    """``(jcfg, tcfg)``: ``arch``'s smoke config in ``dtype``."""
    from repro import configs as jconfigs
    out = [dataclasses.replace(mod.smoke(ARCHS[arch]), dtype=dtype)
           for mod in (jconfigs, tconfigs)]
    assert dataclasses.asdict(out[0]) == dataclasses.asdict(out[1])
    return tuple(out)


def _batch(cfg, step, shards=1, shard=0):
    """``test_torch_mp_mixers._batch``: step ``step``'s batch (with
    ``enc_frames`` for an encoder), or a data rank's shard of it."""
    from test_torch_mp_mixers import _batch as batch
    return batch(cfg, step, shards, shard)


# -- ranks ---------------------------------------------------------------------

def _rank_main(rank, world, init_file, case, in_path, out_dir):
    """One rank: gloo over ``init_file``, the case's runs; its results to
    ``out_dir/out<rank>.pt``.  Imports nothing of JAX."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        inp = torch.load(in_path, weights_only=False)
        out = _RANK_CASES[case](rank, world, inp)
        torch.save(out, os.path.join(out_dir, f"out{rank}.pt"))
    finally:
        dist.barrier()
        dist.destroy_process_group()


def _rank_pair(rank, world, inp):
    """``gather_dim`` forward and backward on dims 0 and 1, and
    ``Block.gather`` of a block with a ``write`` overlap and of uneven
    row sets, through the collectives and through the all-reduce."""
    import contextlib
    from unittest import mock

    from repro_torch.core import tp
    mesh = tmesh.make_device_mesh("cpu", (world, 1), NAMES)
    group = mesh.get_group("data")
    idx, n = tmesh.axis_index(mesh, ("data",))
    out = {}
    for route in ("collective", "all_reduce"):
        patch = (mock.patch.object(tmesh, "gathers", lambda g, t: False)
                 if route == "all_reduce" else contextlib.nullcontext())
        with patch:
            for dim in (0, 1):
                whole = torch.as_tensor(inp["x"])
                size = whole.shape[dim] // n
                x = whole.narrow(dim, idx * size, size).clone()
                x.requires_grad_(True)
                y = tp.gather_dim(x, group, dim, idx, n)
                (g,) = torch.autograd.grad(
                    (y * torch.as_tensor(inp["cot"][rank])).sum(), x)
                out[(route, dim)] = (y.detach(), g)
            whole = torch.as_tensor(inp["x"])
            # columns [2r, 2r + 4): rank 0 writes all, rank 1 its own two
            cols = np.arange(2 * rank, 2 * rank + 4)
            write = None if rank == 0 else (
                (slice(None), cols[2:]), (slice(None), np.arange(2, 4)))
            blk = tmesh.Block(tuple(whole.shape), (slice(None), cols),
                              True, ("data",), write)
            out[(route, "write")] = blk.gather(blk.take(whole), mesh)
            every3 = np.arange(0, whole.shape[0], 3)     # uneven sets
            rows = every3 if rank == 0 else np.setdiff1d(
                np.arange(whole.shape[0]), every3)
            blk = tmesh.Block(tuple(whole.shape), (rows, slice(None)), True,
                              ("data",))
            out[(route, "rows")] = blk.gather(blk.take(whole), mesh)
    return out


def _rank_train(rank, world, inp):
    """``STEPS`` train steps of an LM built on the mesh from the JAX
    weights: the metrics, the master blocks and where they sit, the held
    blocks; with ``ckpt``, a (2, 1) ``train_loop`` checkpoint at step 2
    resumed on (1, 2) for one step (its losses)."""
    import torch.distributed as dist

    from repro_torch.launch.train import train_loop
    from repro_torch.models.model import LM
    from repro_torch.sharding import rules
    from repro_torch.train import step as tstep
    cfg = inp["cfg"]
    mesh = tmesh.make_device_mesh("cpu", inp["mesh"], NAMES)
    shard, shards = tmesh.axis_index(mesh, rules.batch_axes(mesh))
    hp = tstep.TrainHParams(**HP)
    lm = LM(cfg, device="cpu", mesh=mesh)
    if "jstate" in inp:
        # the JAX state itself, each leaf's block taken
        state = lm.load_jax_train_state(inp["jstate"])
    else:
        lm.load_jax_params(inp["params"])
        state = tstep.init_train_state(lm, hp=hp, mesh=mesh)
    held = lm.held_blocks()
    fn = tstep.make_train_step(lm, hp)
    rec = []
    with rules.activation_mesh(mesh):
        for s in range(STEPS):
            state, m = fn(state, _batch(cfg, s, shards, shard))
            rec.append({k: float(m[k]) for k in ("loss", "grad_norm",
                                                 "xent")})
    out = {"metrics": rec,
           "master": {n: v.detach().clone()
                      for n, v in state.opt.master.items()},
           "state": {n: h.state for n, h in state.layout.place.items()},
           "held": {n: (h.block, h.data is not None)
                    for n, h in held.items()}}
    if inp.get("ckpt"):
        kw = dict(seq=SEQ, hp=hp, device="cpu", ckpt_every=2,
                  log_every=10 ** 9)
        d21, d12 = inp["ckpt"]
        m21 = tmesh.make_device_mesh("cpu", (2, 1), NAMES)
        _, first = train_loop(cfg, steps=2, batch_per_shard=BATCH // 2,
                              ckpt_dir=d21, mesh=m21, **kw)
        if rank == 0:
            shutil.copytree(d21, d12)
        dist.barrier()
        m12 = tmesh.make_device_mesh("cpu", (1, 2), NAMES)
        _, then = train_loop(cfg, steps=3, batch_per_shard=BATCH,
                             ckpt_dir=d12, mesh=m12, **kw)
        out["ckpt"] = first + then
    return out


def _layer_outputs(lm, tokens):
    """Every layer's output of ``lm`` over ``tokens`` (the embedding's
    first), in its dtype."""
    with torch.no_grad():
        h, positions, _, _ = lm._prepare(lm._tokens(tokens), None, None)
        outs = [h.clone()]
        for layer in lm.layers:
            h = layer(h, positions)
            outs.append(h.clone())
    return outs


def _rank_layers(rank, world, inp):
    """Each bf16 config's layer outputs on the (1, 2) mesh (seeded)."""
    from repro_torch.models.model import LM
    mesh = tmesh.make_device_mesh("cpu", (1, world), NAMES)
    return {arch: _layer_outputs(LM(cfg, device="cpu", seed=0, mesh=mesh),
                                 inp["tokens"])
            for arch, cfg in inp["cfgs"].items()}


_RANK_CASES = {"pair": _rank_pair, "train": _rank_train,
               "layers": _rank_layers}


def _spawn(tmp_path, world, case, inputs):
    """Run ``case`` on ``world`` gloo ranks; their results.  A rank that
    raises fails the test with its traceback; ranks still running after
    ``SPAWN_TIMEOUT`` seconds are killed and the test fails."""
    import torch.multiprocessing as mp
    in_path = str(tmp_path / "in.pt")
    torch.save(inputs, in_path)
    ctx = mp.start_processes(
        _rank_main, args=(world, str(tmp_path / "pg"), case, in_path,
                          str(tmp_path)),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            pytest.fail(f"{case}: {world} ranks still running after "
                        f"{SPAWN_TIMEOUT} s")
    return [torch.load(str(tmp_path / f"out{r}.pt"), weights_only=False)
            for r in range(world)]


# -- the gather / reduce-scatter pair ------------------------------------------

def test_gather_reduce_scatter_pair_matches_one_process(tmp_path):
    """Over 2 gloo ranks each holding half of ``X`` on dim 0 or 1: the
    gathered tensor is ``X`` and rank r's gradient of ``sum_r (Y *
    C_r)`` is its half of ``sum_r C_r`` (the reduce-scatter), through
    the collectives and through the all-reduce; ``Block.gather`` is the
    whole tensor on both routes, a ``write`` overlap written once."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 8)).astype(np.float32)
    cot = rng.standard_normal((2, 6, 8)).astype(np.float32)
    outs = _spawn(tmp_path, 2, "pair", {"x": x, "cot": cot})
    whole = torch.as_tensor(x)
    dx = torch.as_tensor(cot.sum(0))
    for r, o in enumerate(outs):
        for route in ("collective", "all_reduce"):
            for dim in (0, 1):
                y, g = o[(route, dim)]
                size = x.shape[dim] // 2
                assert torch.equal(y, whole), (r, route, dim)
                assert _rel(g, dx.narrow(dim, r * size, size)) <= 1e-6, \
                    (r, route, dim)
            assert torch.equal(o[(route, "write")][:, :6], whole[:, :6])
            assert not o[(route, "write")][:, 6:].any()
            assert torch.equal(o[(route, "rows")], whole), (r, route)


# -- the held blocks against the reference's param_specs -------------------------

MESH_RANKS = {(16, 16): 17, (2, 2): 3}   # data index 1, model index 1


def _by_design(name: str, dim: int, spec, blk) -> bool:
    """The port's own blocks (ROADMAP.md's mismatches by design): a
    mixer held whole over ``"model"`` where its heads do not split, a
    sparse FFN's k-shard, a Mamba-2 rank's columns and conv channels."""
    e = spec[dim]
    whole = blk.index[dim] == slice(None)
    if name.endswith(".values"):
        return True
    if name.endswith(("mixer.in_proj.w", "mixer.conv_w", "mixer.conv_b",
                      "mixer.dt_bias", "mixer.A_log", "mixer.D",
                      "mixer.norm.scale")):
        return e is None and dim == len(spec) - 1
    if e == "model" and (".wk." in name or ".wv." in name):
        return True          # KV heads several ranks' query heads read
    mixer = any(k in name for k in (".attn.", ".cross.", ".mixer."))
    return e == "model" and mixer and whole


@pytest.mark.parametrize("shape", list(MESH_RANKS), ids=["16x16", "2x2"])
@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_held_blocks_are_the_references_param_specs(arch, shape):
    """On a fake mesh of ``shape`` (rank at data 1, model 1), each
    parameter's held block against the block of the reference's spec
    for the same leaf: equal on every ``"data"`` dim without exception
    (FSDP's parity), and on every other dim but by design; every weight
    the reference splits over ``"data"`` is held split and gathers."""
    from repro import configs as jconfigs
    from repro.sharding import rules as jrules
    from test_torch_sharding import _jmesh, _keyed, _spec_dict, _unstacked

    from repro_torch.launch import dryrun
    from repro_torch.models.model import LM
    jcfg, tcfg = jconfigs.smoke(arch), tconfigs.smoke(arch)
    jsds = jconfigs.param_specs(arch, cfg=jcfg)
    want = _spec_dict(jrules.param_specs(jsds, _jmesh(shape, NAMES)))
    n_data = 0
    with dryrun.fake_mesh(shape, NAMES, MESH_RANKS[shape]) as mesh:
        lm = LM(tcfg, device="meta", mesh=mesh)
        keys = lm.jax_leaves(_keyed(jsds))
        held = lm.held_blocks()
        for name, p in lm.named_parameters():
            h = held.get(name)
            shp = tuple(p.shape) if h is None else h.block.shape
            spec = tuple(_unstacked(want[keys[name]], keys[name]))
            spec += (None,) * (len(shp) - len(spec))
            ref = tmesh.Block.of(shp, spec, mesh)
            blk = tmesh.Block.whole(shp, mesh) if h is None else h.block
            for d, e in enumerate(spec):
                same = str(blk.index[d]) == str(ref.index[d])
                if e == "data":
                    assert same, (name, d, blk.index, ref.index)
                else:
                    assert same or _by_design(name, d, spec, blk), \
                        (name, d, spec, blk.index, ref.index)
            if "data" in spec:
                n_data += 1
                assert h is not None and h.data is not None, name
                assert h.data.dim == spec.index("data"), name
                assert p.shape[h.data.dim] * shape[0] == shp[h.data.dim]
            else:
                assert h is None or h.data is None, name
    assert n_data > 0


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_state_owners_cover_every_element_once(arch):
    """On a fake (2, 2) mesh, over its four ranks: the parts of each
    parameter's state that their owners write back (what the clip's norm
    counts, ``ShardLayout.global_norm``, and what a checkpoint gathers)
    cover every element of the whole tensor exactly once."""
    from repro_torch.launch import dryrun
    from repro_torch.models.model import LM
    from repro_torch.train.step import ShardLayout
    cfg = tconfigs.smoke(arch)
    counts = {}
    for rank in range(4):
        with dryrun.fake_mesh((2, 2), NAMES, rank) as mesh:
            lm = LM(cfg, device="meta", mesh=mesh)
            lm.requires_grad_(True)
            lay = ShardLayout(lm, mesh)
            for n, h in lay.place.items():
                cnt = counts.setdefault(n, np.zeros(lay.shapes[n], np.int64))
                st = h.state
                if st.owner:
                    cnt[tuple(st.index if st.write is None
                              else st.write[0])] += 1
    for n, cnt in counts.items():
        assert cnt.min() == 1 and cnt.max() == 1, (n, cnt.min(), cnt.max())


# -- train steps against one process and the JAX step ----------------------------

@functools.lru_cache(maxsize=None)
def _references(arch):
    """From one JAX state: the JAX step's metrics and final masters under
    ``jax.jit`` and the one-process port's, ``STEPS`` steps on the global
    batch; the JAX weights as numpy."""
    import jax
    import jax.numpy as jnp
    from repro.models.model import LM as JLM
    from repro.train import step as jstep

    from repro_torch.models.model import LM
    from repro_torch.train import step as tstep
    jcfg, tcfg = _cfgs(arch)
    jlm = JLM(jcfg)
    tree = jax.tree.map(np.asarray, jlm.init(jax.random.PRNGKey(0)))
    params = jax.tree.map(jnp.asarray, tree)
    state = jstep.TrainState(jnp.zeros((), jnp.int32), params,
                             jstep.adamw_init(params), None)
    tlm = LM(tcfg, device="cpu")
    tstate = tlm.load_jax_train_state(jax.tree.map(np.asarray, state))
    jfn = jax.jit(jstep.make_train_step(jlm, jstep.TrainHParams(**HP)))
    tfn = tstep.make_train_step(tlm, tstep.TrainHParams(**HP))
    jrec, trec = [], []
    for s in range(STEPS):
        b = _batch(tcfg, s)
        state, jm = jfn(state, jax.tree.map(jnp.asarray, b))
        tstate, tm = tfn(tstate, b)
        jrec.append({k: float(jm[k]) for k in ("loss", "grad_norm", "xent")})
        trec.append({k: float(tm[k]) for k in ("loss", "grad_norm", "xent")})
    jstate0 = {"step": 0, "params": tree, "opt": {
        "count": 0, **{k: jax.tree.map(np.asarray, getattr(
            jstep.adamw_init(params), k)) for k in ("master", "mu", "nu")}}}
    return dict(cfg=tcfg, params=tree, jstate0=jstate0, jax=jrec, port=trec,
                jmaster=tlm.jax_leaves(jax.tree.map(np.asarray,
                                                    state.opt.master)),
                pmaster={n: v.detach().clone()
                         for n, v in tstate.opt.master.items()})


@functools.lru_cache(maxsize=None)
def _unbroken(arch):
    """The one-process ``train_loop``'s 3 losses (seeded)."""
    from repro_torch.launch.train import train_loop
    from repro_torch.train.step import TrainHParams
    _, losses = train_loop(_cfgs(arch)[1], steps=3, batch_per_shard=BATCH,
                           seq=SEQ, hp=TrainHParams(**HP), device="cpu",
                           ckpt_dir=None, log_every=10 ** 9)
    return losses


TRAIN_CASES = [("llama", (2, 1)), ("deepseek", (2, 1)), ("mamba2", (2, 1)),
               ("seamless", (2, 1)), ("llama", (2, 2))]


@pytest.mark.parametrize("arch, shape", TRAIN_CASES,
                         ids=[f"{a}-{s[0]}x{s[1]}" for a, s in TRAIN_CASES])
def test_fsdp_train_steps_match_one_process_and_jax(tmp_path, arch, shape):
    """``STEPS`` steps on ``shape``, every weight held as its rule's
    block: each rank's metrics within ``FSDP_TOL`` of the JAX step and of
    the one-process port, its master blocks within ``FSDP_TOL`` of
    theirs (over the whole tensor's max), every ``"data"``-split block
    half its tensor's rows or columns.  llama on (2, 1) also resumes a
    (2, 1) checkpoint on (1, 2) within ``FSDP_TOL`` of the unbroken
    one-process run; llama on (2, 2) starts from the JAX train state
    (``LM.load_jax_train_state``: each leaf's block)."""
    ref = _references(arch)
    inp = {"mesh": shape, "cfg": ref["cfg"], "params": ref["params"]}
    if shape == (2, 2):
        inp["jstate"] = ref["jstate0"]
    ckpt = arch == "llama" and shape == (2, 1)
    if ckpt:
        inp["ckpt"] = (str(tmp_path / "d21"), str(tmp_path / "d12"))
    run = tmp_path / "run"
    run.mkdir()
    outs = _spawn(run, shape[0] * shape[1], "train", inp)
    for r, o in enumerate(outs):
        for got, (what, want) in ((o["metrics"], w) for w in
                                  (("jax", ref["jax"]),
                                   ("port", ref["port"]))):
            for s, (g, w) in enumerate(zip(got, want)):
                for k in g:
                    assert abs(g[k] - w[k]) <= FSDP_TOL * abs(w[k]), \
                        (what, r, s, k, g[k], w[k])
        for n, v in o["master"].items():
            blk = o["state"][n]
            for whole in (np.asarray(ref["jmaster"][n]),
                          ref["pmaster"][n].numpy()):
                assert _rel(v, blk.take(whole), whole) <= FSDP_TOL, (r, n)
        split = {n for n, (_, data) in o["held"].items() if data}
        assert split and any(n.startswith("layers.0.") for n in split)
        for n in split:
            blk = o["held"][n][0]
            part = 2 * int(np.prod(blk.block_shape))
            whole = int(np.prod(blk.shape))
            assert part == whole if shape[1] == 1 else part <= whole, n
    if ckpt:
        want = _unbroken(arch)
        for o in outs:
            assert len(o["ckpt"]) == 3, o["ckpt"]
            for a, b in zip(o["ckpt"], want):
                assert abs(a - b) <= FSDP_TOL * abs(b), (o["ckpt"], want)


# -- fault 3.15: bf16 across ranks, layer by layer --------------------------------

class _EmulatedAllReduce:
    """``torch.distributed.all_reduce`` between threads, one a rank: each
    deposits its tensor, and every rank's result is the sum in rank
    order in the tensor's own dtype (bf16 partials summed in bf16)."""

    def __init__(self, world: int):
        self.world = world
        self.barrier = threading.Barrier(world)
        self.parts = [None] * world
        self.local = threading.local()

    def __call__(self, t, op=None, group=None, async_op=False):
        import torch.distributed as dist
        assert op in (None, dist.ReduceOp.SUM), op
        self.parts[self.local.rank] = t.clone()
        self.barrier.wait()
        total = self.parts[0].clone()
        for p in self.parts[1:]:
            total = total + p
        self.barrier.wait()
        t.copy_(total)


def _emulated_layers(cfgs, tokens, world=2):
    """The (1, world) split in one process: each rank's ``LM`` built on a
    fake mesh at its coordinate (the blocks it holds), run in a thread
    of its own, every all-reduce ``_EmulatedAllReduce``."""
    from unittest import mock

    from repro_torch.launch import dryrun
    from repro_torch.models.model import LM
    lms = {}
    for r in range(world):
        with dryrun.fake_mesh((1, world), NAMES, r) as mesh:
            lms[r] = {a: LM(c, device="cpu", seed=0, mesh=mesh)
                      for a, c in cfgs.items()}
    emu = _EmulatedAllReduce(world)
    outs, errors = [None] * world, []

    def run(r):
        try:
            emu.local.rank = r
            outs[r] = {a: _layer_outputs(lm, tokens)
                       for a, lm in lms[r].items()}
        except BaseException as e:  # noqa: BLE001 -- re-raised below
            errors.append(e)
            emu.barrier.abort()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with mock.patch("torch.distributed.all_reduce", emu):
            ts = [threading.Thread(target=run, args=(r,))
                  for r in range(world)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
    finally:
        torch.set_num_threads(threads)
    if errors:
        raise errors[0]
    return outs


def test_bf16_split_adds_nothing_to_the_dtype_layer_by_layer(tmp_path):
    """Fault 3.15: bf16 llama and mamba2 (4 layers, heads split over
    m = 2) on 2 gloo ranks, each layer's output on each rank against the
    one-process emulation of the same split: equal to the bit.  The gap
    to one whole process (printed) is then bf16's rounding of the
    row-parallel partials, which the reference carries too (its dense
    products return bf16 partials: ``sparse/plan.py``
    ``_promote_matmul``)."""
    from repro_torch.models.model import LM
    cfgs = {}
    for arch in ("llama", "mamba2"):
        cfg = _cfgs(arch, "bfloat16")[1]
        period = cfg.groups[0][0]
        cfgs[arch] = dataclasses.replace(
            cfg, groups=((period, DEPTH // len(period)),))
    tokens = np.random.default_rng(3).integers(0, 512, size=(2, 16))
    outs = _spawn(tmp_path, 2, "layers", {"cfgs": cfgs, "tokens": tokens})
    emu = _emulated_layers(cfgs, tokens)
    torch.set_num_threads(1)
    for arch, cfg in cfgs.items():
        whole = _layer_outputs(LM(cfg, device="cpu", seed=0), tokens)
        for r in range(2):
            got, want = outs[r][arch], emu[r][arch]
            assert len(got) == DEPTH + 1
            for i, (g, w) in enumerate(zip(got, want)):
                assert g.dtype == torch.bfloat16
                assert torch.equal(g, w), (arch, r, i, _rel(
                    g.float(), w.float()))
        gaps = [_rel(g.float(), w.float())
                for g, w in zip(outs[0][arch], whole)]
        print(f"[fsdp] {arch} bf16 (1, 2) against one process, layer by "
              f"layer: {['%.3g' % v for v in gaps]}")
