"""Data-parallel training with the state sharded, over gloo ranks on the
CPU, against the one-process port and the JAX package.

llama3.2-1b's smoke config with every FFN sparse (d = 1/4, b = 16) in
fp32, a global batch of 4 x 16.  The ranks (spawned, ``file://`` init
under ``tmp_path``, joined with a timeout) import no JAX: the parent
computes the reference and hands the ranks the JAX weights as numpy.

Budgets: loss, grad norm and xent, and the fp32 master weights after 3
steps, rel-max ``MODEL_TOL`` (1e-4) of the one-process port and of the
JAX ``make_train_step`` on the global batch (each rank's half-batch
gradients summed over the group reorder the fp32 sums); each rank's
master, mu and nu after one step within 1e-5 of its block of the
one-process tables (fp32 rounding of that sum).  With ``grad_compress``
an int8 code on a rounding boundary may flip (its residual then differs
by one grid step, its AdamW step by up to lr): the masters and the
residuals are held as ``tests/test_torch_compress.py`` holds them.
Checkpoints: the loss after a restore on another mesh within
``MODEL_TOL`` of the unbroken run's.
"""
import functools
import os
import shutil
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import mesh as tmesh  # noqa: E402

MODEL_TOL = 1e-4
STATE_TOL = 1e-5
SPAWN_TIMEOUT = 180
HP = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
BATCH, SEQ, STEPS = 4, 16, 3


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / max(
        float(np.abs(want).max()), 1e-6)


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


def _tables(state):
    t = {"master": state.opt.master, "mu": state.opt.mu,
         "nu": state.opt.nu}
    if state.ef is not None:
        t["residual"] = state.ef.residual
    return {k: {n: v.detach().clone() for n, v in tab.items()}
            for k, tab in t.items()}


def _rank_steps(rank, world, inp):
    """``STEPS`` steps of ``make_train_step`` on the rank's batch shard,
    compression off and on; the graph refusal over gloo."""
    from repro_torch.data import TokenPipeline
    from repro_torch.models.model import LM
    from repro_torch.sharding import rules
    from repro_torch.train import step as tstep
    from repro_torch.train.program import TrainProgram
    mesh = tmesh.make_device_mesh("cpu", inp["mesh"], ("data", "model"))
    shard, shards = tmesh.axis_index(mesh, rules.batch_axes(mesh))
    pipe = TokenPipeline(inp["cfg"].vocab_size, BATCH // shards, SEQ,
                         num_shards=shards, shard_id=shard)
    out = {}
    for compress in (False, True):
        hp = tstep.TrainHParams(**HP, grad_compress=compress)
        lm = LM(inp["cfg"], device="cpu").load_jax_params(inp["params"])
        state = tstep.init_train_state(lm, hp=hp, mesh=mesh)
        fn = tstep.make_train_step(lm, hp)
        rec, first = [], None
        with rules.activation_mesh(mesh):
            for s in range(STEPS):
                state, m = fn(state, pipe.get_batch(s))
                rec.append({k: float(m[k])
                            for k in ("loss", "grad_norm", "xent")})
                if s == 0:
                    first = _tables(state)
        lay = state.layout
        out[compress] = dict(
            metrics=rec, first=first, last=_tables(state),
            params={n: p.detach().clone() for n, p in lm.named_parameters()},
            slices={n: tmesh.block_slices(lay.shapes[n], lay.specs[n], mesh)
                    for n in lay.specs})
    try:
        TrainProgram(lm, state, hp, batch=BATCH // shards, seq=SEQ,
                     graph=True)
        out["refused"] = None
    except NotImplementedError as e:
        out["refused"] = str(e)
    return out


def _rank_ckpt(rank, world, inp):
    """Checkpoints across meshes through ``train_loop``: a (2, 1) run
    saving at step 2; a (2, 1) resume of the one-process checkpoint; a
    (1, 2) resume of the (2, 1) checkpoint."""
    import torch.distributed as dist

    from repro_torch.launch.train import train_loop
    from repro_torch.train.step import TrainHParams
    hp = TrainHParams(**HP)
    kw = dict(seq=SEQ, hp=hp, device="cpu", ckpt_every=2, log_every=10 ** 9)
    m21 = tmesh.make_device_mesh("cpu", (2, 1), ("data", "model"))
    _, saved = train_loop(inp["cfg"], steps=2, batch_per_shard=BATCH // 2,
                          ckpt_dir=inp["dir21"], mesh=m21, **kw)
    _, from1 = train_loop(inp["cfg"], steps=3, batch_per_shard=BATCH // 2,
                          ckpt_dir=inp["dir1"], mesh=m21, **kw)
    if rank == 0:
        shutil.copytree(inp["dir21"], inp["dir12"])
    dist.barrier()
    m12 = tmesh.make_device_mesh("cpu", (1, 2), ("data", "model"))
    _, from21 = train_loop(inp["cfg"], steps=3, batch_per_shard=BATCH,
                           ckpt_dir=inp["dir12"], mesh=m12, **kw)
    return {"saved": saved, "from1": from1, "from21": from21}


def _rank_preempt(rank, world, inp):
    """``train_loop`` on a (2, 1) mesh where only rank 1 gets SIGTERM,
    during its second step; the losses it ran and its latest
    checkpoint."""
    import signal

    from repro_torch.checkpoint import latest_step
    from repro_torch.launch.train import train_loop
    from repro_torch.train import program as prog_mod
    from repro_torch.train.step import TrainHParams
    call = prog_mod.TrainProgram.__call__
    calls = []

    def signalled(self):
        calls.append(None)
        if rank == 1 and len(calls) == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return call(self)
    prog_mod.TrainProgram.__call__ = signalled
    m21 = tmesh.make_device_mesh("cpu", (2, 1), ("data", "model"))
    _, losses = train_loop(inp["cfg"], steps=20, batch_per_shard=BATCH // 2,
                           seq=SEQ, ckpt_dir=inp["dir"], ckpt_every=100,
                           hp=TrainHParams(**HP), device="cpu",
                           log_every=10 ** 9, mesh=m21)
    return {"losses": losses, "latest": latest_step(inp["dir"])}


def _rank_race(rank, world, inp):
    """A measured route race on a concrete (world,) mesh whose ranks time
    the candidates apart (``measure_callable`` faked: each rank finds
    another route fastest); the verdict each rank installs."""
    from repro_torch import sparse
    from repro_torch.core import dispatch
    from repro_torch.core.bsr import BlockSparseMatrix
    sparse.reset()
    mesh = tmesh.make_device_mesh("cpu", (world,), ("model",))
    calls = []

    def fake(fn, *args, **kw):
        calls.append(len(calls))
        # rank r's call i: the fastest is the (i + r)-th candidate timed
        return 1e-3 * (1 + (len(calls) + rank) % 3)
    dispatch.measure_callable = fake
    mask = np.random.default_rng(0).random((8, 16)) < 0.4
    mask[0, 0] = True
    vals = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (int(mask.sum()), 16, 16)).astype(np.float32))
    tb = BlockSparseMatrix.from_mask(mask, 16, values=vals)
    x2 = torch.randn(32, 256, generator=torch.Generator().manual_seed(2))
    p = sparse.plan(tb, 32, x=x2, device="cpu",
                    ctx=sparse.PlanContext(mesh=mesh, measure=True))
    return {"route": p.route, "est": dict(p.est_seconds),
            "source": p.explain()["tp"]["source"]}


_RANK_CASES = {"steps": _rank_steps, "ckpt": _rank_ckpt, "race": _rank_race,
               "preempt": _rank_preempt}


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


# -- the parent's references ------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _references(compress):
    """The JAX step's and the one-process port step's runs from the same
    JAX state: per-step metrics, the port's tables after step 1 and
    after the last step, the JAX masters by port name; and the JAX
    weights as numpy."""
    import jax
    import jax.numpy as jnp
    from repro.train import step as jstep
    from test_torch_train_loop import JLM, JPipe, _cfgs, _prewarm

    from repro_torch.models.model import LM
    from repro_torch.train import step as tstep
    jcfg, tcfg = _cfgs()
    hp = jstep.TrainHParams(**HP, grad_compress=compress)
    jlm = JLM(jcfg)
    state = jstep.init_train_state(jlm, jax.random.PRNGKey(0), hp=hp)
    _prewarm(jcfg, state.params, BATCH * SEQ)
    params = jax.tree.map(np.asarray, state.params)
    tlm = LM(tcfg, device="cpu")
    tstate = tlm.load_jax_train_state(jax.tree.map(np.asarray, state))
    jfn = jax.jit(jstep.make_train_step(jlm, hp))
    tfn = tstep.make_train_step(tlm, tstep.TrainHParams(**hp._asdict()))
    pipe = JPipe(tcfg.vocab_size, BATCH, SEQ)
    jrec, trec, first = [], [], None
    for s in range(STEPS):
        batch = pipe.get_batch(s)
        state, jm = jfn(state, jax.tree.map(jnp.asarray, batch))
        tstate, tm = tfn(tstate, batch)
        jrec.append({k: float(jm[k]) for k in ("loss", "grad_norm", "xent")})
        trec.append({k: float(tm[k]) for k in ("loss", "grad_norm", "xent")})
        if s == 0:
            first = _tables(tstate)
    jmaster = tlm.jax_leaves(jax.tree.map(np.asarray, state.opt.master))
    return dict(cfg=tcfg, params=params, jax=jrec, port=trec, first=first,
                last=_tables(tstate), jmaster=jmaster)


def _close_metrics(got, want, what):
    for s, (g, w) in enumerate(zip(got, want)):
        for k in g:
            assert abs(g[k] - w[k]) <= MODEL_TOL * abs(w[k]), \
                (what, s, k, g[k], w[k])


def _masters_with_flips(got, want, lr):
    """The compressed run's masters: every element within 2 lr, all but
    1e-4 of them within ``MODEL_TOL`` (code flips on a rounding edge)."""
    total = flipped = 0
    for n, w in want.items():
        w = np.asarray(w, np.float32)
        d = np.abs(np.asarray(got[n], np.float32) - w)
        assert float(d.max()) <= 2 * lr, n
        total += d.size
        flipped += int((d > MODEL_TOL * max(float(np.abs(w).max()),
                                            1e-6)).sum())
    assert flipped <= 1e-4 * total, (flipped, total)


def _residuals_with_flips(got, want):
    """Residuals after a compressed step: an element whose code flipped
    differs by one grid step (at most twice the largest residual); all
    but 5 % within ``MODEL_TOL`` of that step."""
    total = off = 0
    for n, w in want.items():
        w = np.asarray(w, np.float32)
        d = np.abs(np.asarray(got[n], np.float32) - w)
        step = 2 * float(np.abs(w).max())
        assert float(d.max()) <= 1.01 * step + 1e-30, n
        total += d.size
        off += int((d > MODEL_TOL * step).sum())
    assert off <= 0.05 * total, (off, total)


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)], ids=["2x1", "1x2"])
def test_dp_steps_match_one_process_and_jax(tmp_path, shape):
    """Two ranks, ``STEPS`` steps of the sharded step against the
    one-process port and the JAX step on the global batch, compression
    off and on; each rank's fp32 state after one step is its block of
    the one-process state; the parameters are whole and equal on both
    ranks; ``graph=True`` over gloo is refused."""
    refs = {c: _references(c) for c in (False, True)}
    outs = _spawn(tmp_path, 2, "steps",
                  {"mesh": shape, "cfg": refs[False]["cfg"],
                   "params": refs[False]["params"]})
    for o in outs:
        assert o["refused"] is not None and "gloo" in o["refused"]
    for compress, ref in refs.items():
        for r, o in enumerate(outs):
            got = o[compress]
            _close_metrics(got["metrics"], ref["port"], ("port", r))
            _close_metrics(got["metrics"], ref["jax"], ("jax", r))
            sl = got["slices"]
            for table, blocks in got["first"].items():
                for n, b in blocks.items():
                    want = ref["first"][table][n][sl[n]]
                    assert tuple(b.shape) == tuple(want.shape), (table, n)
                    if not compress:
                        assert _rel(b, want) <= STATE_TOL, (table, n)
            if compress:
                _residuals_with_flips(got["first"]["residual"],
                                      {n: ref["first"]["residual"][n][sl[n]]
                                       for n in sl})
            last = {n: ref["last"]["master"][n][sl[n]]
                    for n in got["last"]["master"]}
            mine = got["last"]["master"]
            jlast = {n: ref["jmaster"][n][sl[n]] for n in mine}
            if compress:
                _masters_with_flips(mine, last, HP["peak_lr"])
                _masters_with_flips(mine, jlast, HP["peak_lr"])
            else:
                for n in mine:
                    assert _rel(mine[n], last[n]) <= MODEL_TOL, n
                    assert _rel(mine[n], jlast[n]) <= MODEL_TOL, n
        for n, p in outs[0][compress]["params"].items():
            assert torch.equal(p, outs[1][compress]["params"][n]), n
        # some state is split: the two ranks' blocks are halves
        split = [n for n, s in outs[0][compress]["slices"].items()
                 if any(x != slice(None) for x in s)]
        assert split
        n = split[0]
        assert outs[0][compress]["slices"][n] != \
            outs[1][compress]["slices"][n]


def test_checkpoint_reshards_across_meshes(tmp_path):
    """A checkpoint of a (2, 1) mesh resumes on one process and on a
    (1, 2) mesh, one of one process resumes on (2, 1): the next step's
    loss within ``MODEL_TOL`` of the unbroken one-process run's."""
    from test_torch_train_loop import _cfgs

    from repro_torch.launch.train import train_loop
    from repro_torch.train.step import TrainHParams
    _, tcfg = _cfgs()
    hp = TrainHParams(**HP)
    kw = dict(seq=SEQ, hp=hp, device="cpu", ckpt_every=2, log_every=10 ** 9,
              batch_per_shard=BATCH)
    _, unbroken = train_loop(tcfg, steps=3, ckpt_dir=None, **kw)
    dirs = {k: str(tmp_path / k) for k in ("dir1", "dir21", "dir12")}
    train_loop(tcfg, steps=2, ckpt_dir=dirs["dir1"], **kw)
    run = tmp_path / "run"
    run.mkdir()
    outs = _spawn(run, 2, "ckpt", dict(dirs, cfg=tcfg))
    shutil.copytree(dirs["dir21"], str(tmp_path / "to1"))
    _, to1 = train_loop(tcfg, steps=3, ckpt_dir=str(tmp_path / "to1"), **kw)
    for name, got in (("2->1", to1), ("1->2", outs[0]["from1"]),
                      ("(2,1)->(1,2)", outs[0]["from21"])):
        assert len(got) == 1, name
        assert abs(got[0] - unbroken[2]) <= MODEL_TOL * abs(unbroken[2]), \
            (name, got, unbroken)
    for a, b in zip(outs[0]["saved"], unbroken[:2]):
        assert abs(a - b) <= MODEL_TOL * abs(b)
    # every rank reads the same mean loss
    assert outs[0] == outs[1]


def test_preemption_of_one_rank_stops_every_rank(tmp_path):
    """SIGTERM to one rank of a (2, 1) mesh during step 1: every rank
    runs that step, writes the step-2 checkpoint with the others and
    stops (a rank acting on its own flag would enter the checkpoint's
    gathers while the other sat in step 2's gradient all-reduce); the
    checkpoint resumes on one process to the unbroken run's step-2
    loss."""
    from test_torch_train_loop import _cfgs

    from repro_torch.launch.train import train_loop
    from repro_torch.train.step import TrainHParams
    _, tcfg = _cfgs()
    kw = dict(seq=SEQ, hp=TrainHParams(**HP), device="cpu",
              log_every=10 ** 9, batch_per_shard=BATCH)
    _, unbroken = train_loop(tcfg, steps=3, ckpt_dir=None, **kw)
    ck = str(tmp_path / "ck")
    run = tmp_path / "run"
    run.mkdir()
    outs = _spawn(run, 2, "preempt", {"cfg": tcfg, "dir": ck})
    for o in outs:
        assert len(o["losses"]) == 2 and o["latest"] == 2, o
    assert outs[0]["losses"] == outs[1]["losses"]
    _, resumed = train_loop(tcfg, steps=3, ckpt_dir=ck, **kw)
    assert len(resumed) == 1
    assert abs(resumed[0] - unbroken[2]) <= MODEL_TOL * abs(unbroken[2]), \
        (resumed, unbroken)


def test_launcher_mesh_flag():
    """``launch.train --mesh 2,1`` on the CPU (in a subprocess with a
    timeout): two gloo ranks spawned, the mean loss printed by rank 0
    only."""
    import subprocess
    import sys

    from repro_torch.launch import train as ttrain
    assert ttrain._mesh_shape("2,1") == ((2, 1), ("data", "model"))
    assert ttrain._mesh_shape("1,2,2")[1] == ("pod", "data", "model")
    with pytest.raises(SystemExit):
        ttrain._mesh_shape("2")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src, os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--density", "0.25", "--steps", "2", "--batch",
         "1", "--seq", "16", "--log-every", "1", "--mesh", "2,1"],
        env=env, capture_output=True, text=True, check=True,
        timeout=SPAWN_TIMEOUT).stdout
    assert out.count("[train] done:") == 1, out
    assert out.count("[train] step 1 ") == 1, out


def test_measured_race_agrees_across_ranks(tmp_path):
    """A measured route race on a concrete mesh: ranks whose timings of
    the same candidates differ (each finds another one fastest) still
    install one verdict, on the slowest time each candidate took over
    the mesh, so their collectives stay in lockstep."""
    outs = _spawn(tmp_path, 2, "race", {})
    assert all(o["source"] == "measured" for o in outs)
    assert outs[0]["route"] == outs[1]["route"]
    assert outs[0]["est"] == outs[1]["est"]
