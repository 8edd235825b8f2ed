"""Model parallelism of MLA, Mamba-2, cross attention and the encoder over
gloo ranks on the CPU, against the JAX package and the one-process port.

An ``LM`` built on a concrete mesh whose ``"model"`` axis has m > 1
ranks computes ``H / m`` heads of every mixer whose heads divide m:
MLA (deepseek-v2-lite), Mamba-2 (mamba2-130m, jamba's Mamba layers),
cross attention and the encoder's bidirectional attention
(seamless-m4t-medium).  Smoke configs in fp32 on (1, 2), (1, 4) and
(2, 2), spawned as ``tests/test_torch_mp.py`` spawns its ranks (gloo,
``file://`` init under ``tmp_path``, joined with a timeout; the ranks
import no JAX, the parent hands them the JAX weights as numpy):

* each rank holds 1 / m of every split tensor in bytes (on (2, 2) a
  weight the rules split over ``"data"`` half of that: FSDP; a Mamba-2 in
  projection and conv: its heads' ``z`` / ``x`` columns beside every
  ``B`` / ``C`` / ``dt`` column; jamba's 2 KV heads at m = 4: 1 / 2),
  a seeded init's blocks equal to the one-process init's bit for bit;
* the logits, the loss and every state block of the gradient reduced
  over the mesh against the JAX package's eager ``LM.forward`` /
  ``LM.loss`` / ``jax.grad``; 3 train steps' loss, grad norm and xent
  and the fp32 masters after them against the JAX step under
  ``jax.jit`` and the one-process port;
* the first prompt's prefill logits against one process's, and greedy
  tokens equal to one process's (the ``Engine`` over the mesh; seamless,
  which the engine refuses, through ``prefill(enc_frames=)`` and
  ``decode_step``); the caches hold the rank's heads.

Here mamba2's cases; deepseek's, seamless's and jamba's (with a jamba
checkpoint written on (1, 4) resumed on (2, 2)) are in
``test_torch_mp_mixers_mla.py``, ``_encdec.py`` and ``_hybrid.py``,
through ``check_split``.  Besides: the gated norm of a split Mamba-2
sums every rank's squares (a norm that leaves them out of the
all-reduce misses one process's logits by far more than the budget); a
mixer whose heads do not divide m runs whole (mamba2 with 2 SSD heads
and deepseek with 6 MLA heads on (1, 4)).

Budgets (``tests/conftest.py`` fp32, 1e-4 rel-max).
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
SPAWN_TIMEOUT = 240
HP = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
BATCH, SEQ, STEPS = 4, 16, 3
FRAMES = 8
NEW = 4
SHAPES = [(1, 2), (1, 4), (2, 2)]
SHAPE_IDS = ["1x2", "1x4", "2x2"]
ARCHS = {"deepseek": "deepseek_v2_lite_16b", "mamba2": "mamba2_130m",
         "jamba": "jamba_v0_1_52b", "seamless": "seamless_m4t_medium"}
# variants whose mixer's heads do not divide m = 4
WHOLE = {"mamba2:nh2": ("mamba2_130m", "ssm_head_dim", 128),
         "deepseek:h6": ("deepseek_v2_lite_16b", "num_heads", 6)}


def _rel(got, want, whole=None):
    """Max error over the reference's max magnitude (``whole``'s: a
    rank's block of a tensor is held to the budget of the tensor, as a
    one-process gradient is)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    ref = want if whole is None else np.asarray(whole, np.float32)
    return float(np.abs(got - want).max()) / max(
        float(np.abs(ref).max()), 1e-6)


def _cfgs(arch):
    """``(jcfg, tcfg)`` of ``arch`` (a key of ``ARCHS`` or ``WHOLE``) in
    fp32."""
    import dataclasses as dc

    from repro import configs as jconfigs

    from repro_torch import configs as tconfigs
    name, field, value = WHOLE.get(arch, (ARCHS.get(arch), None, None))
    out = []
    for mod in (jconfigs, tconfigs):
        cfg = dc.replace(mod.smoke(name), dtype="float32")
        if field == "ssm_head_dim":
            cfg = dc.replace(cfg, ssm=dc.replace(cfg.ssm, head_dim=value))
        elif field is not None:
            cfg = dc.replace(cfg, **{field: value, "num_kv_heads": value})
        out.append(cfg)
    assert dc.asdict(out[0]) == dc.asdict(out[1])
    return tuple(out)


def _frames(b, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, FRAMES, 128)).astype(np.float32)


def _batch(cfg, step, shards=1, shard=0):
    """Step ``step``'s batch (``enc_frames`` with an encoder), or a data
    rank's shard of it."""
    from repro_torch.data import TokenPipeline
    pipe = TokenPipeline(cfg.vocab_size, BATCH // shards, SEQ,
                         num_shards=shards, shard_id=shard)
    batch = pipe.get_batch(step)
    if cfg.encoder_layers:
        rows = slice(shard * (BATCH // shards), (shard + 1)
                     * (BATCH // shards))
        batch = dict(batch, enc_frames=_frames(BATCH, 100 + step)[rows])
    return batch


def _prompts():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 512, size=n).astype(np.int32)
            for n in (6, 7, 13)]


def _inputs(batch):
    return {k: v for k, v in batch.items() if k == "enc_frames"}


def _serve(lm, prompts, mesh=None):
    """``(first prompt's prefill logits, greedy tokens)``: through the
    ``Engine`` (eager, on ``mesh``), or for a cross stack through
    ``prefill(enc_frames=)`` and ``decode_step`` a prompt at a time."""
    from repro_torch.serve import Engine, Request
    from repro_torch.sharding import rules
    with rules.activation_mesh(mesh, batch_split=False):
        kw = ({"enc_frames": _frames(1, 7)} if lm.cfg.encoder_layers
              else {})
        logits, _ = lm.prefill(prompts[0][None, :], max_len=32, **kw)
        if not lm.cfg.encoder_layers:
            eng = Engine(lm, device="cpu", batch=2, max_len=32, mesh=mesh,
                         graphs=False)
            reqs = [Request(uid=i, prompt=np.asarray(p), max_new_tokens=NEW)
                    for i, p in enumerate(prompts)]
            eng.run(reqs)
            return logits, [r.output for r in reqs]
        tokens = []
        for p in prompts:
            lg, caches = lm.prefill(p[None, :], max_len=32,
                                    enc_frames=_frames(1, 7))
            out = []
            for i in range(NEW):
                tok = int(torch.argmax(lg[0]))
                out.append(tok)
                lg, caches = lm.decode_step(
                    torch.tensor([[tok]]), caches,
                    torch.tensor([len(p) + i]))
            tokens.append(out)
        return logits, tokens


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
    shard, the prefill logits, greedy tokens and the caches' heads."""
    from repro_torch.models.model import LM
    from repro_torch.sharding import rules
    from repro_torch.train import step as tstep
    cfg = inp["cfg"]
    mesh = tmesh.make_device_mesh("cpu", inp["mesh"], ("data", "model"))
    shard, shards = tmesh.axis_index(mesh, rules.batch_axes(mesh))
    seeded = LM(cfg, device="cpu", seed=0, mesh=mesh)
    held = seeded.held_blocks()
    out = {"held": {n: (h.block, h.partial) for n, h in held.items()},
           "seeded": {n: p.detach().clone()
                      for n, p in seeded.named_parameters() if n in held}}
    del seeded

    lm = LM(cfg, device="cpu", mesh=mesh).load_jax_params(inp["params"])
    out["loaded"] = {n: p.detach().clone()
                     for n, p in lm.named_parameters() if n in held}
    with rules.activation_mesh(mesh, batch_split=False):
        out["logits"] = lm.forward(inp["tokens"], **_inputs(inp["batch"]))
    lm.requires_grad_(True)
    lay = tstep.ShardLayout(lm, mesh)
    batch = _batch(cfg, 0, shards, shard)
    with rules.activation_mesh(mesh):
        loss, _ = lm.loss(batch["tokens"], batch["targets"],
                          **_inputs(batch))
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
            state, m = fn(state, _batch(cfg, s, shards, shard))
            rec.append({k: float(m[k]) for k in ("loss", "grad_norm",
                                                 "xent")})
    out["metrics"] = rec
    out["master"] = {n: v.detach().clone()
                     for n, v in state.opt.master.items()}
    del lm, state

    lm = LM(cfg, device="cpu", mesh=mesh).load_jax_params(inp["params"])
    out["prefill"], out["tokens"] = _serve(lm, inp["prompts"], mesh)
    caches = lm.init_cache(1, 8, memory_len=FRAMES)
    out["cache_shapes"] = [{k: tuple(v.shape) for k, v in c.items()}
                           for c in caches]
    if cfg.ssm is not None and any(n.endswith("mixer.in_proj.w")
                                   for n in held):
        out["norm_alone"] = _logits_with_a_local_norm(lm, inp, mesh)
    return out


def _logits_with_a_local_norm(lm, inp, mesh):
    """The logits with every split Mamba-2 gated norm normalising its
    rank's channels alone (its sum of squares left out of the
    all-reduce): what a rank that skipped the sum would compute."""
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.ssm import Mamba2
    from repro_torch.sharding import rules
    mods = [m for m in lm.modules() if isinstance(m, Mamba2)]
    for m in mods:
        m.gated_norm = (lambda y, z, m=m: rms_norm(
            y * torch.nn.functional.silu(z), m.norm.scale))
    try:
        with rules.activation_mesh(mesh, batch_split=False):
            return lm.forward(inp["tokens"])
    finally:
        for m in mods:
            del m.gated_norm


def _rank_norm(rank, world, inp):
    """``core.tp.rms_norm_split`` on this rank's channels against
    ``rms_norm`` of the whole row, forward and backward: the rank's
    output and its input's gradient."""
    from repro_torch.core import tp
    from repro_torch.launch.mesh import make_device_mesh
    mesh = make_device_mesh("cpu", (1, world), ("data", "model"))
    group, r = tp.tp_group(mesh, "model")
    d = inp["x"].shape[-1]
    cols = slice(r * d // world, (r + 1) * d // world)
    x = inp["x"][..., cols].clone().requires_grad_(True)
    y = tp.rms_norm_split(x, inp["scale"][cols], d, group)
    (g,) = torch.autograd.grad((y * inp["cot"][..., cols]).sum(), x)
    return {"y": y.detach(), "dx": g}


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


_RANK_CASES = {"mp": _rank_mp, "norm": _rank_norm, "ckpt": _rank_ckpt}


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
def _references(arch, jax_ref=True):
    """From one JAX state: the JAX package's eager logits, loss and
    gradient (by port name) on the first batch and its jitted steps'
    metrics and final masters (with ``jax_ref``; else the logits, loss
    and gradient of the one-process port), the one-process port's
    steps' metrics and masters, prefill logits and greedy tokens, the
    one-process seeded init; and the JAX weights as numpy."""
    import jax
    import jax.numpy as jnp
    from repro.models.model import LM as JLM
    from repro.train import step as jstep

    from repro_torch.models.model import LM
    from repro_torch.train import step as tstep
    jcfg, tcfg = _cfgs(arch)
    hp = jstep.TrainHParams(**HP)
    jlm = JLM(jcfg)
    tree = jax.tree.map(np.asarray, jlm.init(jax.random.PRNGKey(0)))
    params = jax.tree.map(jnp.asarray, tree)
    state = jstep.TrainState(jnp.zeros((), jnp.int32), params,
                             jstep.adamw_init(params), None)
    batch = _batch(tcfg, 0)
    jbatch = jax.tree.map(jnp.asarray, batch)
    tlm = LM(tcfg, device="cpu")
    if jax_ref:
        fwd = ({"enc_frames": jbatch["enc_frames"]} if tcfg.encoder_layers
               else {})
        logits, _ = jlm.forward(params, jbatch["tokens"], **fwd)
        (loss, _), grads = jax.value_and_grad(jlm.loss, has_aux=True)(
            params, jbatch)
        grads = tlm.jax_leaves(jax.tree.map(np.asarray, grads))
    else:
        one = LM(tcfg, device="cpu").load_jax_params(tree)
        logits = one.forward(batch["tokens"], **_inputs(batch))
        one.requires_grad_(True)
        loss, _ = one.loss(batch["tokens"], batch["targets"],
                           **_inputs(batch))
        named = dict(one.named_parameters())
        grads = dict(zip(named, (g.numpy() for g in torch.autograd.grad(
            loss, list(named.values())))))
        loss = loss.detach()

    tstate = tlm.load_jax_train_state(jax.tree.map(np.asarray, state))
    jfn = jax.jit(jstep.make_train_step(jlm, hp))
    tfn = tstep.make_train_step(tlm, tstep.TrainHParams(**HP))
    jrec, trec = [], []
    for s in range(STEPS):
        b = _batch(tcfg, s)
        if jax_ref:
            state, jm = jfn(state, jax.tree.map(jnp.asarray, b))
            jrec.append({k: float(jm[k])
                         for k in ("loss", "grad_norm", "xent")})
        tstate, tm = tfn(tstate, b)
        trec.append({k: float(tm[k]) for k in ("loss", "grad_norm", "xent")})
    jmaster = (tlm.jax_leaves(jax.tree.map(np.asarray, state.opt.master))
               if jax_ref else None)
    served = LM(tcfg, device="cpu").load_jax_params(tree)
    prefill, tokens = _serve(served, _prompts())
    seeded = {n: p.detach().clone() for n, p in
              LM(tcfg, device="cpu", seed=0).named_parameters()}
    return dict(cfg=tcfg, params=tree, batch=batch, tokens=batch["tokens"],
                logits=np.asarray(logits), loss=float(loss), grads=grads,
                jax=jrec, port=trec, jmaster=jmaster,
                pmaster={n: v.detach().clone()
                         for n, v in tstate.opt.master.items()},
                prefill=prefill, served=tokens, seeded=seeded)


def _close_metrics(got, want, what):
    for s, (g, w) in enumerate(zip(got, want)):
        for k in g:
            assert abs(g[k] - w[k]) <= MODEL_TOL * abs(w[k]), \
                (what, s, k, g[k], w[k])


def _loaded_whole(ref):
    """The JAX weights by port name (what ``load_jax_params`` slices)."""
    from repro_torch.models.model import LM
    return LM(ref["cfg"], device="meta").jax_leaves(ref["params"])


def _expected_share(cfg, name, m, dp, shape):
    """A held block's bytes over its whole tensor's: 1 / m, but for a
    Mamba-2 in projection and conv (the rank's ``z`` / ``x`` beside
    every ``B`` / ``C`` / ``dt``) and KV heads several ranks read
    (jamba's 2 at m = 4); a weight whose rule splits it over ``"data"``
    (FSDP: the expert stacks' D among them) holds 1 / dp of that
    besides."""
    from repro_torch.sharding import rules
    spec = rules.param_spec(name, shape, tmesh.AbstractMesh(
        (dp, m), ("data", "model")))
    fsdp = 1 / dp if "data" in spec else 1.0
    if "data" in spec and "model" not in spec and not name.endswith(
            "mixer.in_proj.w"):
        return fsdp         # whole over "model" (MLA's q.a and kv_a)
    if name.endswith(("mixer.in_proj.w", "mixer.conv_w", "mixer.conv_b")):
        s = cfg.ssm
        di, gn, nh = s.d_inner(cfg.d_model), s.n_groups * s.d_state, \
            s.num_heads(cfg.d_model)
        if name.endswith("in_proj.w"):
            return fsdp * (2 * di // m + 2 * gn + nh) / (2 * di + 2 * gn
                                                         + nh)
        return (di // m + 2 * gn) / (di + 2 * gn)
    if any(k in name for k in ("attn.wk.", "attn.wv.")) \
            and cfg.num_kv_heads < m:
        return fsdp / cfg.num_kv_heads
    if name.endswith(("ffn.w_gate", "ffn.w_up", "ffn.w_down")):
        return 1 / (m * dp)
    return fsdp / m


# the parameters of the mixers this slice splits, by arch
SPLIT_MIXERS = {
    "deepseek": ("attn.q.w.w", "attn.kv_b.w", "attn.wo.w"),
    "mamba2": ("mixer.in_proj.w", "mixer.conv_w", "mixer.conv_b",
               "mixer.dt_bias", "mixer.A_log", "mixer.D",
               "mixer.norm.scale", "mixer.out_proj.w"),
    "jamba": ("mixer.in_proj.w", "mixer.out_proj.w", "mixer.norm.scale"),
    "seamless": ("cross.wq.w", "cross.wk.w", "cross.wv.w", "cross.wo.w"),
}


def _check_rank(ref, o, r, *, jax_ref=True):
    """One rank's numbers against the references."""
    tleaves = {n: torch.as_tensor(np.array(v, np.float32))
               for n, v in _loaded_whole(ref).items()}
    for n, (blk, _) in o["held"].items():
        assert torch.equal(o["seeded"][n], blk.take(ref["seeded"][n])), \
            (r, n)
        assert torch.equal(o["loaded"][n], blk.take(tleaves[n])), (r, n)
    assert _rel(o["logits"], ref["logits"]) <= MODEL_TOL, r
    assert abs(o["loss"] - ref["loss"]) <= MODEL_TOL * abs(ref["loss"])
    for n, g in o["grads"].items():
        whole = np.asarray(ref["grads"][n])
        want = o["state"][n].take(whole)
        assert tuple(g.shape) == want.shape, (r, n)
        assert _rel(g, want, whole) <= MODEL_TOL, (r, n, _rel(g, want))
    if jax_ref:
        _close_metrics(o["metrics"], ref["jax"], ("jax", r))
    _close_metrics(o["metrics"], ref["port"], ("port", r))
    for n, v in o["master"].items():
        blk = o["state"][n]
        if jax_ref:
            whole = np.asarray(ref["jmaster"][n])
            assert _rel(v, blk.take(whole), whole) <= MODEL_TOL, (r, n)
        whole = ref["pmaster"][n]
        assert _rel(v, blk.take(whole), whole) <= MODEL_TOL, (r, n)
    assert _rel(o["prefill"], ref["prefill"]) <= MODEL_TOL, r
    assert o["tokens"] == ref["served"], r


def check_split(tmp_path, arch, shape):
    """Each rank of a model-parallel mesh holds 1 / m of every split
    tensor (bytes), its mixers' blocks among them; the logits, the loss,
    the reduced gradient's state blocks, 3 train steps' metrics and
    masters match the JAX package and the one-process port; the prefill
    logits and greedy tokens match one process's; the caches hold the
    rank's heads (MLA's latent whole).  The MLA, hybrid and
    encoder-decoder cases run from files of their own
    (``test_torch_mp_mixers_*.py``), so that a run spread over workers
    file by file spreads them."""
    ref = _references(arch)
    cfg = ref["cfg"]
    world, m, dp = shape[0] * shape[1], shape[1], shape[0]
    outs = _spawn(tmp_path, world, "mp",
                  {"mesh": shape, "cfg": cfg, "params": ref["params"],
                   "tokens": ref["tokens"], "batch": ref["batch"],
                   "prompts": _prompts()})
    for r, o in enumerate(outs):
        held = o["held"]
        mixers = [n for n in ref["seeded"]
                  if n.endswith(SPLIT_MIXERS[arch])]
        assert mixers and set(mixers) <= set(held), (r, sorted(
            set(mixers) - set(held)))
        if arch == "seamless":
            assert any(n.startswith("encoder.") and ".attn.wq." in n
                       for n in held), r
        for n, (blk, partial) in held.items():
            whole, got = ref["seeded"][n], o["seeded"][n]
            share = (got.numel() * got.element_size()) / (
                whole.numel() * whole.element_size())
            if n.endswith("norm.scale") and partial:
                assert share == 1.0, (r, n)
            else:
                assert share == pytest.approx(
                    _expected_share(cfg, n, m, dp, tuple(whole.shape))), \
                    (r, n, share)
        _check_rank(ref, o, r)
        if arch == "mamba2":
            # a gated norm normalising its rank's channels alone
            assert _rel(o["norm_alone"], ref["logits"]) > 100 * MODEL_TOL
        for c in o["cache_shapes"]:
            if "state" in c:
                nh = cfg.ssm.num_heads(cfg.d_model)
                assert c["state"][1] == nh // m, c
            if "latent" in c:
                assert c["latent"][-1] == cfg.kv_lora_rank, c
            if "xk" in c:
                assert c["xk"][2] == cfg.num_kv_heads // m, c
    # the ranks of one data row hold different heads of each split mixer
    for n in (n for n in outs[0]["held"] if n.endswith("out_proj.w")
              or n.endswith("kv_b.w") or n.endswith("cross.wq.w")):
        idx = [o["held"][n][0].index for o in outs[:m]]
        assert all(str(a) != str(b) for a, b in zip(idx, idx[1:])), n


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_mixers_split_match_jax_and_one_process(tmp_path, shape):
    """mamba2's smoke config (8 SSD heads): ``check_split``."""
    check_split(tmp_path, "mamba2", shape)


def test_split_gated_norm_sums_every_rank_squares(tmp_path):
    """``rms_norm_split`` over 2 ranks equals ``rms_norm`` of the whole
    row, forward and its input's gradient, to fp32 rounding; and a split
    Mamba-2 whose gated norm left its sum of squares out of the
    all-reduce (each rank normalising its channels alone) misses one
    process's logits by far more than the budget, where the summed norm
    is within it (``check_split`` of mamba2, on each mesh)."""
    from repro_torch.models.layers import rms_norm
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.standard_normal((3, 5, 64)).astype(np.float32))
    x[..., :32] *= 4.0     # the two ranks' halves at different scales
    scale = torch.as_tensor(rng.uniform(0.5, 1.5, 64).astype(np.float32))
    cot = torch.as_tensor(rng.standard_normal((3, 5, 64)).astype(np.float32))
    outs = _spawn(tmp_path, 2, "norm", {"x": x, "scale": scale, "cot": cot})
    xw = x.clone().requires_grad_(True)
    y = rms_norm(xw, scale)
    (dx,) = torch.autograd.grad((y * cot).sum(), xw)
    for r, o in enumerate(outs):
        cols = slice(32 * r, 32 * (r + 1))
        assert _rel(o["y"], y.detach()[..., cols]) <= 1e-6, r
        assert _rel(o["dx"], dx[..., cols]) <= 1e-5, r
        alone = rms_norm(x[..., cols], scale[cols])
        assert _rel(alone, y.detach()[..., cols]) > 1e-2, r


@pytest.mark.parametrize("arch", sorted(WHOLE))
def test_mixer_heads_that_do_not_divide_run_whole(tmp_path, arch):
    """mamba2's smoke config with 2 SSD heads (head dim 128) and
    deepseek's with 6 MLA heads on (1, 4): the heads do not divide 4,
    so the mixer runs whole on every rank (nothing of it held, every
    head cached) beside the split vocabulary, MLPs and experts: the
    logits, loss, reduced gradient, 3 train steps, prefill logits and
    tokens against the one-process port (which the mixers' own tests
    hold against the JAX package)."""
    from repro_torch.models.attention import ssd_head_split
    ref = _references(arch, jax_ref=False)
    cfg = ref["cfg"]
    heads = (cfg.ssm.num_heads(cfg.d_model) if cfg.ssm is not None
             else cfg.num_heads)
    assert ssd_head_split(heads, 4, 0) is None
    outs = _spawn(tmp_path, 4, "mp",
                  {"mesh": (1, 4), "cfg": cfg, "params": ref["params"],
                   "tokens": ref["tokens"], "batch": ref["batch"],
                   "prompts": _prompts()})
    for r, o in enumerate(outs):
        held = o["held"]
        assert not any(".mixer." in n or ".attn." in n for n in held), \
            (r, sorted(held))
        assert "embed.table" in held
        _check_rank(ref, o, r, jax_ref=False)
        for c in o["cache_shapes"]:
            if "state" in c:
                assert c["state"][1] == heads, c


def test_loss_chunk_keeps_its_logits_under_the_byte_cap(monkeypatch):
    """A vocabulary the ``"model"`` axis does not split is whole on every
    rank (seamless's 256206 rows over 16), so ``LM.loss`` halves its
    sequence chunk until the chunk's fp32 logits fit
    ``LOSS_CHUNK_BYTES``: with the cap at 3 rows' logits the chunk is 2
    positions of the 4 rows (8 chunks of 16 positions), and the loss and
    its gradient are the one-chunk run's within fp32 rounding.  (The
    loss-chunk cap is not a mixer's: seamless's train_4k cell at (16,
    16) peaked on that chunk's logits.)"""
    from repro_torch.models import model as tmodel
    _, tcfg = _cfgs("seamless")
    batch = _batch(tcfg, 0)
    runs = []
    for cap in (tmodel.LOSS_CHUNK_BYTES, 3 * tcfg.vocab_size * 4 * BATCH):
        monkeypatch.setattr(tmodel, "LOSS_CHUNK_BYTES", cap)
        lm = tmodel.LM(tcfg, device="cpu", seed=0)
        lm.requires_grad_(True)
        calls = []
        chunk_nll = lm._chunk_nll

        def counted(hx, tx, table, chunk_nll=chunk_nll, calls=calls):
            calls.append(hx.shape[1])
            return chunk_nll(hx, tx, table)
        lm._chunk_nll = counted
        loss, _ = lm.loss(batch["tokens"], batch["targets"],
                          enc_frames=batch["enc_frames"])
        (g,) = torch.autograd.grad(loss, [lm.embed.table])
        runs.append((float(loss), g, calls))
    # each chunk's forward, then its recompute in the backward
    assert runs[0][2] == [SEQ] * 2
    assert runs[1][2] == [2] * (SEQ // 2) * 2
    assert abs(runs[1][0] - runs[0][0]) <= 1e-6 * abs(runs[0][0])
    assert _rel(runs[1][1], runs[0][1]) <= 1e-5
