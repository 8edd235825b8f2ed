"""Model parallelism over gloo ranks on the CPU, against the JAX package
and the one-process port.

An ``LM`` built on a concrete mesh whose ``"model"`` axis has m > 1
ranks holds its rank's blocks of the GQA projections, the MLPs, the
embedding and unembedding tables and a sparse FFN's k-shard, and every
rank runs the same program.  Two smoke configs in fp32: llama3.2-1b with
every FFN sparse (d = 1/4, b = 16; 4 query and 2 KV heads, tied tables)
and glm4-9b (dense MLP, seeded non-zero q/k/v biases, untied tables),
on (1, 2), (1, 4) and (2, 2): at m = 4 each KV head is read by two
ranks' query heads, so both hold it and its gradient is summed over
them.  The ranks (spawned, ``file://`` init under ``tmp_path``, joined
with a timeout) import no JAX: the parent computes the references and
hands the ranks the JAX weights as numpy.

Budgets (``tests/conftest.py`` fp32, 1e-4 rel-max): the whole logits
gathered over the vocabulary, the loss, every state block of the
gradient reduced over the mesh, the loss, grad norm and xent of 3 train
steps and the fp32 masters after them, against the JAX package's eager
``LM.forward`` / ``LM.loss`` / ``jax.grad`` and jitted
``make_train_step`` on one device, and against the one-process port.
Greedy engine tokens over gloo equal the JAX engine's.  Held blocks: a
seeded init's blocks equal the one-process init's slices bit for bit,
and each is whole / m in bytes but for the KV heads several ranks read
(on (2, 2) a weight the rules split over ``"data"``, FSDP, holds half
of that).
Checkpoints re-shard (1, 4) -> (2, 2) -> one process within the budget
of the unbroken run.
"""
import dataclasses
import functools
import os
import shutil
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import mesh as tmesh  # noqa: E402

MODEL_TOL = 1e-4
SPAWN_TIMEOUT = 240
HP = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
BATCH, SEQ, STEPS = 4, 16, 3
BUCKETS = (8, 16)
SHAPES = [(1, 2), (1, 4), (2, 2)]


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / max(
        float(np.abs(want).max()), 1e-6)


def _cfgs(arch):
    """``(jcfg, tcfg)`` of ``arch`` ("llama": sparse FFNs; "glm4": dense;
    "glm4:H/KV": glm4 with H query and KV key/value heads) in fp32."""
    import dataclasses as dc

    from repro import configs as jconfigs
    from test_torch_train_loop import _cfgs as sparse_cfgs

    from repro_torch import configs as tconfigs
    if arch == "llama":
        return sparse_cfgs()
    heads = {}
    if ":" in arch:
        h, kv = arch.partition(":")[2].split("/")
        heads = dict(num_heads=int(h), num_kv_heads=int(kv))
    jcfg = dc.replace(jconfigs.smoke("glm4_9b"), dtype="float32", **heads)
    tcfg = dc.replace(tconfigs.smoke("glm4_9b"), dtype="float32", **heads)
    assert dc.asdict(jcfg) == dc.asdict(tcfg)
    return jcfg, tcfg


def _prompts():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 512, size=n).astype(np.int32)
            for n in (6, 7, 13)]


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


def _rank_mp(rank, world, inp):
    """On a model-parallel mesh: a seeded init's held blocks; from the
    JAX weights, the logits, the loss and the gradient's state blocks
    reduced over the mesh, ``STEPS`` train steps on the rank's batch
    shard, and the engine's greedy tokens."""
    from repro_torch.data import TokenPipeline
    from repro_torch.models.model import LM
    from repro_torch.serve import Engine, Request
    from repro_torch.sharding import rules
    from repro_torch.train import step as tstep
    cfg = inp["cfg"]
    mesh = tmesh.make_device_mesh("cpu", inp["mesh"], ("data", "model"))
    shard, shards = tmesh.axis_index(mesh, rules.batch_axes(mesh))
    pipe = TokenPipeline(cfg.vocab_size, BATCH // shards, SEQ,
                         num_shards=shards, shard_id=shard)
    seeded = LM(cfg, device="cpu", seed=0, mesh=mesh)
    held = seeded.held_blocks()
    out = {"held": {n: (h.block, h.partial) for n, h in held.items()},
           "seeded": {n: p.detach().clone()
                      for n, p in seeded.named_parameters() if n in held}}
    del seeded

    lm = LM(cfg, device="cpu", mesh=mesh).load_jax_params(inp["params"])
    out["loaded"] = {n: p.detach().clone()
                     for n, p in lm.named_parameters() if n in held}
    out["logits"] = lm.forward(inp["tokens"])
    lm.requires_grad_(True)
    lay = tstep.ShardLayout(lm, mesh)
    batch = pipe.get_batch(0)
    with rules.activation_mesh(mesh):
        loss, _ = lm.loss(batch["tokens"], batch["targets"])
    names = [n for n, _ in lm.named_parameters()]
    gs = torch.autograd.grad(loss, [dict(lm.named_parameters())[n]
                                    for n in names])
    out["grads"] = lay.reduce_grads(dict(zip(names, gs)))
    out["loss"] = float(lay.mean_metrics({"loss": loss.detach()})["loss"])
    out["state"] = {n: h.state for n, h in lay.place.items()}
    del lm, lay

    hp = tstep.TrainHParams(**HP)
    lm = LM(cfg, device="cpu", mesh=mesh).load_jax_params(inp["params"])
    state = tstep.init_train_state(lm, hp=hp, mesh=mesh)
    fn = tstep.make_train_step(lm, hp)
    rec = []
    with rules.activation_mesh(mesh):
        for s in range(STEPS):
            state, m = fn(state, pipe.get_batch(s))
            rec.append({k: float(m[k]) for k in ("loss", "grad_norm",
                                                 "xent")})
    out["metrics"] = rec
    out["master"] = {n: v.detach().clone()
                     for n, v in state.opt.master.items()}
    del lm, state

    lm = LM(cfg, device="cpu", mesh=mesh).load_jax_params(inp["params"])
    eng = Engine(lm, device="cpu", batch=2, max_len=32, buckets=BUCKETS,
                 mesh=mesh, graphs=False)
    reqs = [Request(uid=i, prompt=np.asarray(p), max_new_tokens=5)
            for i, p in enumerate(inp["prompts"])]
    eng.run(reqs)
    out["tokens"] = [r.output for r in reqs]
    out["cache_heads"] = int(eng.caches[0]["k"].shape[2])
    return out


def _rank_ckpt(rank, world, inp):
    """A (1, 4) ``train_loop`` saving at step 2, resumed on (2, 2) to
    step 3 (saved there): the losses of both."""
    import torch.distributed as dist

    from repro_torch.launch.train import train_loop
    from repro_torch.train.step import TrainHParams
    kw = dict(seq=SEQ, hp=TrainHParams(**HP), device="cpu", ckpt_every=2,
              log_every=10 ** 9)
    m14 = tmesh.make_device_mesh("cpu", (1, 4), ("data", "model"))
    _, first = train_loop(inp["cfg"], steps=2, batch_per_shard=BATCH,
                          ckpt_dir=inp["dir14"], mesh=m14, **kw)
    if rank == 0:
        shutil.copytree(inp["dir14"], inp["dir22"])
    dist.barrier()
    m22 = tmesh.make_device_mesh("cpu", (2, 2), ("data", "model"))
    _, then = train_loop(inp["cfg"], steps=3, batch_per_shard=BATCH // 2,
                         ckpt_dir=inp["dir22"], mesh=m22, **kw)
    return {"first": first, "then": then}


_RANK_CASES = {"mp": _rank_mp, "ckpt": _rank_ckpt}


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
def _references(arch):
    """From one JAX state: the JAX package's eager logits, loss and
    gradient (by port name) on the first batch, its jitted steps'
    metrics and final masters, the one-process port's steps' metrics and
    masters, the JAX engine's greedy tokens, the one-process seeded init;
    and the JAX weights as numpy."""
    import jax
    import jax.numpy as jnp
    from repro import sparse as jsparse
    from repro.data import TokenPipeline as JPipe
    from repro.models.model import LM as JLM
    from repro.serve import Engine as JEngine
    from repro.serve import Request as JRequest
    from repro.train import step as jstep
    from test_torch_dense_configs import _with_biases
    from test_torch_train_loop import _prewarm

    from repro_torch.models.model import LM
    from repro_torch.train import step as tstep
    jsparse.reset()
    jcfg, tcfg = _cfgs(arch)
    hp = jstep.TrainHParams(**HP)
    jlm = JLM(jcfg)
    tree = jax.tree.map(np.asarray, jlm.init(jax.random.PRNGKey(0)))
    if arch.startswith("glm4"):
        tree = _with_biases(tree, seed=7)
    params = jax.tree.map(jnp.asarray, tree)
    state = jstep.TrainState(jnp.zeros((), jnp.int32), params,
                             jstep.adamw_init(params), None)
    if arch == "llama":
        _prewarm(jcfg, params, BATCH * SEQ)
    pipe = JPipe(tcfg.vocab_size, BATCH, SEQ)
    batch = pipe.get_batch(0)
    jbatch = jax.tree.map(jnp.asarray, batch)
    logits, _ = jlm.forward(params, jbatch["tokens"])
    (loss, _), grads = jax.value_and_grad(jlm.loss, has_aux=True)(
        params, jbatch)
    tlm = LM(tcfg, device="cpu")
    grads = tlm.jax_leaves(jax.tree.map(np.asarray, grads))
    jeng = JEngine(jlm, params, batch=2, max_len=32, buckets=BUCKETS)
    jreqs = [JRequest(uid=i, prompt=p, max_new_tokens=5)
             for i, p in enumerate(_prompts())]
    jeng.run(jreqs)

    tstate = tlm.load_jax_train_state(jax.tree.map(np.asarray, state))
    jfn = jax.jit(jstep.make_train_step(jlm, hp))
    tfn = tstep.make_train_step(tlm, tstep.TrainHParams(**HP))
    jrec, trec = [], []
    for s in range(STEPS):
        b = pipe.get_batch(s)
        state, jm = jfn(state, jax.tree.map(jnp.asarray, b))
        tstate, tm = tfn(tstate, b)
        jrec.append({k: float(jm[k]) for k in ("loss", "grad_norm", "xent")})
        trec.append({k: float(tm[k]) for k in ("loss", "grad_norm", "xent")})
    jmaster = tlm.jax_leaves(jax.tree.map(np.asarray, state.opt.master))
    seeded = {n: p.detach().clone() for n, p in
              LM(tcfg, device="cpu", seed=0).named_parameters()}
    return dict(cfg=tcfg, params=tree, tokens=batch["tokens"],
                logits=np.asarray(logits), loss=float(loss), grads=grads,
                jtokens=[r.output for r in jreqs], jax=jrec, port=trec,
                jmaster=jmaster,
                pmaster={n: v.detach().clone()
                         for n, v in tstate.opt.master.items()},
                seeded=seeded)


def _close_metrics(got, want, what):
    for s, (g, w) in enumerate(zip(got, want)):
        for k in g:
            assert abs(g[k] - w[k]) <= MODEL_TOL * abs(w[k]), \
                (what, s, k, g[k], w[k])


def _expected_bytes(arch, name, m, dp, shape):
    """The held block's share of the whole: 1 / m, but for the KV heads
    two ranks read at m = 4 (glm4's and llama's 2 KV heads: 1 / 2) and
    the norms inside the split heads (whole); a weight whose rule splits
    it over ``"data"`` (FSDP) holds 1 / dp of that besides."""
    from repro_torch.sharding import rules
    share = 1 / 2 if m == 4 and any(
        k in name for k in ("attn.wk.", "attn.wv.")) else 1 / m
    spec = rules.param_spec(name, shape, tmesh.AbstractMesh(
        (dp, m), ("data", "model")))
    return share / dp if "data" in spec else share


@pytest.mark.parametrize("shape", SHAPES, ids=["1x2", "1x4", "2x2"])
@pytest.mark.parametrize("arch", ["llama", "glm4"])
def test_model_parallel_matches_jax_and_one_process(tmp_path, arch, shape):
    """Each rank of a model-parallel mesh: its held blocks (seeded and
    loaded) are the one-process tensors' slices at whole / m bytes; the
    logits, the loss and the reduced gradient's state blocks match the
    JAX package; 3 train steps' metrics and masters match the JAX step
    and the one-process port; engine tokens equal the JAX engine's."""
    ref = _references(arch)
    world = shape[0] * shape[1]
    m = shape[1]
    outs = _spawn(tmp_path, world, "mp",
                  {"mesh": shape, "cfg": ref["cfg"], "params": ref["params"],
                   "tokens": ref["tokens"],
                   "prompts": [torch.as_tensor(p) for p in _prompts()]})
    tleaves = {n: torch.as_tensor(np.array(v, np.float32))
               for n, v in _loaded_whole(ref).items()}
    for r, o in enumerate(outs):
        held = o["held"]
        split = {n for n, (blk, partial) in held.items() if not partial}
        want_split = [n for n in ref["seeded"]
                      if any(k in n for k in (
                          "attn.wq.", "attn.wo.", "attn.wk.", "attn.wv.",
                          "ffn.up.", "ffn.gate.", "ffn.down.",
                          "embed.table", "lm_head.table"))]
        assert set(want_split) <= set(held), (r, sorted(
            set(want_split) - set(held)))
        for n, (blk, partial) in held.items():
            whole = ref["seeded"][n]
            got = o["seeded"][n]
            assert torch.equal(got, blk.take(whole)), (r, n)
            assert torch.equal(o["loaded"][n].float(),
                               blk.take(tleaves[n]).float()), (r, n)
            share = got.numel() / whole.numel()
            if n.endswith("norm.scale"):
                assert partial and share == 1.0, (r, n)
            elif n.endswith(".values"):
                # the nnz-balanced k-shard: checked over the ranks below
                assert 0 < share < 1, (r, n)
            else:
                assert share == pytest.approx(_expected_bytes(
                    arch, n, m, shape[0], tuple(whole.shape))), \
                    (r, n, share)
        if m == 4:
            assert any(partial for _, partial in held.values()), r
        assert split
        assert _rel(o["logits"], ref["logits"]) <= MODEL_TOL, r
        assert abs(o["loss"] - ref["loss"]) <= MODEL_TOL * abs(ref["loss"])
        for n, g in o["grads"].items():
            want = o["state"][n].take(np.asarray(ref["grads"][n]))
            assert tuple(g.shape) == want.shape, (r, n)
            assert _rel(g, want) <= MODEL_TOL, (r, n, _rel(g, want))
        _close_metrics(o["metrics"], ref["jax"], ("jax", r))
        _close_metrics(o["metrics"], ref["port"], ("port", r))
        for n, v in o["master"].items():
            blk = o["state"][n]
            assert _rel(v, blk.take(np.asarray(ref["jmaster"][n]))) \
                <= MODEL_TOL, (r, n)
            assert _rel(v, blk.take(ref["pmaster"][n])) <= MODEL_TOL, (r, n)
        assert o["tokens"] == ref["jtokens"], r
        assert o["cache_heads"] == max(1, ref["cfg"].num_kv_heads // m)
    # the model ranks' k-shards hold every block of a sparse FFN once
    for n, (blk, _) in outs[0]["held"].items():
        if n.endswith(".values"):
            rows = np.concatenate([o["held"][n][0].index[0]
                                   for o in outs[:m]])
            assert sorted(rows.tolist()) == list(range(blk.shape[0])), n
    # the ranks of one model block hold different vocabulary rows
    if m > 1:
        b0 = outs[0]["held"]["embed.table"][0].index[0]
        b1 = outs[1]["held"]["embed.table"][0].index[0]
        assert b0 != b1


@pytest.mark.parametrize("heads, shape", [("6/2", (1, 4)), ("6/3", (1, 2))],
                         ids=["h6kv2-1x4", "h6kv3-1x2"])
def test_gqa_heads_that_do_not_split_run_whole(tmp_path, heads, shape):
    """glm4's smoke config with 6 query heads: on (1, 4) they do not
    divide, on (1, 2) a rank's 3 heads cut the groups of 2 (KV = 3)
    unevenly.  The GQA layers run whole on every rank (nothing of them
    held, every KV head cached) beside the split MLPs and vocabulary:
    the logits, the loss and the reduced gradient's state blocks against
    the JAX package's ``LM`` and ``jax.grad``, 3 train steps against the
    JAX step and the one-process port, engine tokens against the JAX
    engine."""
    from repro_torch.models.attention import head_split
    h, kv = (int(v) for v in heads.split("/"))
    assert head_split(h, kv, shape[1], 0) is None
    ref = _references(f"glm4:{heads}")
    outs = _spawn(tmp_path, shape[0] * shape[1], "mp",
                  {"mesh": shape, "cfg": ref["cfg"], "params": ref["params"],
                   "tokens": ref["tokens"],
                   "prompts": [torch.as_tensor(p) for p in _prompts()]})
    tleaves = {n: torch.as_tensor(np.array(v, np.float32))
               for n, v in _loaded_whole(ref).items()}
    for r, o in enumerate(outs):
        held = o["held"]
        assert not any(".attn." in n for n in held), (r, sorted(held))
        assert any(".ffn.up." in n for n in held) and "embed.table" in held
        for n, (blk, _) in held.items():
            assert torch.equal(o["seeded"][n], blk.take(ref["seeded"][n]))
            assert torch.equal(o["loaded"][n], blk.take(tleaves[n]))
        assert _rel(o["logits"], ref["logits"]) <= MODEL_TOL, r
        assert abs(o["loss"] - ref["loss"]) <= MODEL_TOL * abs(ref["loss"])
        for n, g in o["grads"].items():
            want = o["state"][n].take(np.asarray(ref["grads"][n]))
            assert tuple(g.shape) == want.shape, (r, n)
            assert _rel(g, want) <= MODEL_TOL, (r, n, _rel(g, want))
        _close_metrics(o["metrics"], ref["jax"], ("jax", r))
        _close_metrics(o["metrics"], ref["port"], ("port", r))
        for n, v in o["master"].items():
            blk = o["state"][n]
            assert _rel(v, blk.take(ref["pmaster"][n])) <= MODEL_TOL, (r, n)
        assert o["tokens"] == ref["jtokens"], r
        assert o["cache_heads"] == kv


def _loaded_whole(ref):
    """The JAX weights by port name (what ``load_jax_params`` slices)."""
    from repro_torch.models.model import LM
    return LM(ref["cfg"], device="meta").jax_leaves(ref["params"])


@pytest.mark.parametrize("arch", ["llama", "glm4"])
def test_checkpoint_reshards_model_parallel(tmp_path, arch):
    """A (1, 4) run's checkpoint (held blocks, k-shards and shared KV
    heads gathered whole) resumes on (2, 2), whose checkpoint resumes
    on one process: each resumed step's loss within ``MODEL_TOL`` of
    the unbroken one-process run's."""
    from repro_torch.launch.train import train_loop
    from repro_torch.train.step import TrainHParams
    _, tcfg = _cfgs(arch)
    kw = dict(seq=SEQ, hp=TrainHParams(**HP), device="cpu", ckpt_every=2,
              log_every=10 ** 9, batch_per_shard=BATCH)
    _, unbroken = train_loop(tcfg, steps=4, ckpt_dir=None, **kw)
    dirs = {k: str(tmp_path / k) for k in ("dir14", "dir22")}
    run = tmp_path / "run"
    run.mkdir()
    outs = _spawn(run, 4, "ckpt", dict(dirs, cfg=tcfg))
    _, last = train_loop(tcfg, steps=4, ckpt_dir=dirs["dir22"], **kw)
    got = outs[0]["first"] + outs[0]["then"] + last
    assert len(got) == 4, got
    for a, b in zip(got, unbroken):
        assert abs(a - b) <= MODEL_TOL * abs(b), (got, unbroken)
    assert all(o == outs[0] for o in outs)
