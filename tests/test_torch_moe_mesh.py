"""MoE under ``impl="gspmd"`` on concrete meshes over gloo ranks on the
CPU, against the JAX package's ``_moe_gspmd`` on the global batch.

qwen3-moe's smoke config (8 experts, top-2) in fp32, x ``[4, 32, D]``
and the output cotangent from a seed, the router's column 0 shifted by
``ROUTER_SHIFT`` so that expert 0's queue overflows; both ``ranking``
values.  The ranks (spawned as ``tests/test_torch_moe_ep.py`` spawns
them) import no JAX: the parent computes the references.  Each rank
holds its data shard's rows of x (the global batch is the shards in
the order of their ``"data"`` index) and its rules' blocks of the expert
stacks (``MoE(mesh=)``):

* (2, 1): the batch split, every expert a rank (its ``"data"`` half of
  D, gathered in the forward); the routing is global (the capacity of
  the global token count, the global queue order).  A rank that routed
  its own tokens alone, as the gspmd formulation did on a mesh before,
  keeps another set (the drops of the two halves differ from the
  global one's).
* (1, 2): the experts split over ``"model"`` (4 a rank), no batch split.
* (2, 2): both; and deepseek-v2-lite's smoke config (4 experts top-2,
  a shared expert) there, its shared MLP split over ``"model"``.

Against the reference on the global batch: each rank's rows of the
output and the three metrics within ``FWD_TOL``; the gradients of the
reference's ``sum(y * cot) + aux + z`` within ``GRAD_TOL``
(``MODEL_TOL``).  A rank's loss is ``sum(y_r * cot_r) + (aux + z) / dp``
(the ranks' losses sum to the reference's): x's gradient is the
reference's rows, a held block's (its ``"data"`` gather sums the data
ranks' parts) the reference's block, the router's and the shared
experts' summed over the data ranks the reference's.

Training: three ``train_loop`` steps on (2, 2) against the one-process
run on the global batch (losses and every parameter within
``GRAD_TOL``), a (2, 2) checkpoint resumed on (1, 2) with the unbroken
run's loss.
"""
import dataclasses
import os
import shutil
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402

FWD_TOL = 1e-5
GRAD_TOL = 1e-4
SPAWN_TIMEOUT = 180
B, S = 4, 32
ROUTER_SHIFT = 0.5
RANKINGS = ("cumsum", "sort")
MESHES = [(2, 1), (1, 2), (2, 2)]
HP = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
TRAIN_B, TRAIN_S = 2, 16


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / max(
        float(np.abs(want).max()), 1e-6)


QWEN3, DEEPSEEK = "qwen3_moe_30b_a3b", "deepseek_v2_lite_16b"


def _cfg(ranking="cumsum", arch=QWEN3):
    cfg = dataclasses.replace(tconfigs.smoke(arch), dtype="float32")
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, ranking=ranking, impl="gspmd"))


def _inputs(arch=QWEN3):
    """Seeded fp32 expert weights (the reference's scales, the router's
    column 0 shifted; the shared experts' MLP where the config has one),
    x and the output cotangent, as numpy."""
    cfg = _cfg(arch=arch)
    m, d = cfg.moe, cfg.d_model
    rng = np.random.default_rng(0)

    def draw(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    router = draw((d, m.num_experts), 1 / np.sqrt(d))
    router[:, 0] += ROUTER_SHIFT
    params = {"router": {"w": router},
              "w_gate": draw((m.num_experts, d, m.d_ff_expert),
                             1 / np.sqrt(d)),
              "w_up": draw((m.num_experts, d, m.d_ff_expert),
                           1 / np.sqrt(d)),
              "w_down": draw((m.num_experts, m.d_ff_expert, d),
                             1 / np.sqrt(m.d_ff_expert))}
    if m.num_shared:
        f = m.num_shared * m.d_ff_shared
        shapes = (("up", (d, f)), ("gate", (d, f)), ("down", (f, d)))
        params["shared"] = {n: {"w": draw(shape, 1 / np.sqrt(shape[0]))}
                            for n, shape in shapes}
    return params, draw((B, S, d), 1.0), draw((B, S, d), 1.0)


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


def _rank_layer(rank, world, inp):
    """The gspmd route on this rank's data shard, forward and backward,
    for each ranking: the output, metrics and gradients, the held
    blocks' slices and the kept assignments of its tokens
    (``global_route``)."""
    from test_torch_moe_ep import _load

    from repro_torch.models.moe import MoE, global_route, moe_apply
    from repro_torch.sharding import rules
    mesh = tmesh.make_device_mesh("cpu", inp["mesh"], ("data", "model"))
    di, dp = tmesh.axis_index(mesh, ("data",))
    rows = slice(di * B // dp, (di + 1) * B // dp)
    out = {"rows": rows, "data": di,
           "model": tmesh.axis_index(mesh, ("model",))[0]}
    for ranking in RANKINGS:
        cfg = _cfg(ranking, inp["arch"])
        moe = _load(MoE(cfg, dtype=torch.float32, device="cpu", mesh=mesh),
                    inp["params"])
        shared = {} if moe.shared is None else {
            n: getattr(moe.shared, n) for n in ("up", "gate", "down")}
        with torch.no_grad():
            for n, dense in shared.items():
                w = torch.as_tensor(inp["params"]["shared"][n]["w"])
                dense.w.copy_(dense.held["w"].block.take(w))
        x = torch.as_tensor(inp["x"][rows]).requires_grad_(True)
        for p in moe.parameters():
            p.requires_grad_(True)
        with rules.activation_mesh(mesh):
            y, m = moe_apply(moe, cfg, x)
            with torch.no_grad():
                tfs, _, flat_slot, _, _, _ = global_route(
                    moe, cfg, x.reshape(-1, x.shape[-1]), mesh)
        loss = (y * torch.as_tensor(inp["cot"][rows])).sum() \
            + (m.aux_loss + m.z_loss) / dp
        loss.backward()
        bucket = tfs.shape[1]
        kept = torch.where(flat_slot < cfg.moe.num_experts * bucket,
                           torch.div(flat_slot, bucket,
                                     rounding_mode="floor"),
                           cfg.moe.num_experts)
        out[ranking] = dict(
            y=y.detach(), metrics=[float(v) for v in m], dx=x.grad,
            drouter=moe.router.w.grad.clone(), bucket=bucket,
            kept=kept.sort(dim=1).values,
            held={n: (getattr(moe, n).grad.clone(), h.block.index)
                  for n, h in moe.held.items()},
            shared={n: (dense.w.grad.clone(), dense.held["w"].block.index)
                    for n, dense in shared.items()})
    return out


def _rank_train(rank, world, inp):
    """``train_loop`` on (2, 2), a checkpoint at step 2: the losses, the
    final parameters and each held block's slices."""
    from repro_torch.launch.train import train_loop
    from repro_torch.train.step import TrainHParams
    mesh = tmesh.make_device_mesh("cpu", inp["mesh"], ("data", "model"))
    state, losses = train_loop(
        _cfg(), steps=3, batch_per_shard=TRAIN_B, seq=TRAIN_S,
        ckpt_dir=inp["dir"], ckpt_every=2, hp=TrainHParams(**HP),
        device="cpu", log_every=10 ** 9, mesh=mesh)
    lay = state.layout
    return {"losses": losses,
            "params": {n: p.detach().clone()
                       for n, p in state.params.items()},
            "held": {n: lay.place[n].block for n in lay.held}}


def _rank_resume(rank, world, inp):
    """The (2, 2) run's step-2 checkpoint resumed on (1, 2) for step 3."""
    from repro_torch.launch.train import train_loop
    from repro_torch.train.step import TrainHParams
    mesh = tmesh.make_device_mesh("cpu", inp["mesh"], ("data", "model"))
    _, losses = train_loop(
        _cfg(), steps=3, batch_per_shard=2 * TRAIN_B, seq=TRAIN_S,
        ckpt_dir=inp["dir"], ckpt_every=10, hp=TrainHParams(**HP),
        device="cpu", log_every=10 ** 9, mesh=mesh)
    return {"losses": losses}


_RANK_CASES = {"layer": _rank_layer, "train": _rank_train,
               "resume": _rank_resume}


def _spawn(tmp_path, world, inputs, case):
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


# -- the reference ---------------------------------------------------------------

def _jax_gspmd(ranking, params, x, cot, arch=QWEN3):
    """The reference's ``_moe_gspmd`` on the global batch (no mesh):
    output, metrics, the gradients of ``sum(y * cot) + aux + z`` by
    ``jax.grad``, and each token's kept experts (its routing core)."""
    import dataclasses as dc

    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.models import moe as jmoe
    cfg = dc.replace(jconfigs.smoke(arch), dtype="float32")
    cfg = dc.replace(cfg, moe=dc.replace(cfg.moe, ranking=ranking,
                                         impl="gspmd"))

    def loss(p, xx):
        y, m = jmoe._moe_gspmd(p, cfg, xx)
        return jnp.sum(y * cot) + m.aux_loss + m.z_loss, (y, m)
    (_, (y, m)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(
            jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    t = x.shape[0] * x.shape[1]
    tfs, w_slot, *_ = jmoe._route_and_rank(
        jnp.asarray(x.reshape(t, -1)), jnp.asarray(params["router"]["w"]),
        cfg, jmoe._capacity(t, cfg))
    # token -> its kept experts (E where fewer than k were kept)
    tfs, w_slot = np.asarray(tfs), np.asarray(w_slot)
    kept = [[] for _ in range(t)]
    for e, c in zip(*np.nonzero(w_slot)):
        kept[tfs[e, c]].append(e)
    k, e_n = cfg.moe.top_k, cfg.moe.num_experts
    kept = np.asarray([sorted(v) + [e_n] * (k - len(v)) for v in kept])
    return dict(y=np.asarray(y), metrics=[float(v) for v in m],
                dx=np.asarray(gx), grads=jax.tree.map(np.asarray, gp),
                kept=kept)


@pytest.fixture(scope="module")
def references():
    params, x, cot = _inputs()
    return params, x, cot, {r: _jax_gspmd(r, params, x, cot)
                            for r in RANKINGS}


# -- tests -----------------------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES, ids=["2x1", "1x2", "2x2"])
def test_gspmd_route_matches_reference_on_global_batch(tmp_path, shape,
                                                       references):
    """Each rank against the reference's ``_moe_gspmd`` on the global
    batch, both rankings: its rows of the output, the metrics, the kept
    experts of its tokens, the gradients; the held blocks are the rules'
    (E / m experts, the ``"data"`` half of D), the buckets ``min(cap,
    T_local)`` deep."""
    from repro_torch.models.moe import _capacity
    params, x, cot, refs = references
    outs = _spawn(tmp_path, int(np.prod(shape)),
                  {"mesh": shape, "params": params, "x": x, "cot": cot,
                   "arch": QWEN3}, "layer")
    dp, m = shape
    t_loc = B // dp * S
    e_n = _cfg().moe.num_experts
    for ranking in RANKINGS:
        want = refs[ranking]
        # the reference's queue overflows: the test routes under pressure
        assert want["metrics"][2] > 0.01, want["metrics"]
        drouter = {}
        for o in outs:
            g, rows = o[ranking], o["rows"]
            assert _rel(g["y"], want["y"][rows]) <= FWD_TOL, (ranking, rows)
            for a, b in zip(g["metrics"], want["metrics"]):
                assert abs(a - b) <= FWD_TOL * max(abs(b), 1e-6), \
                    (ranking, g["metrics"], want["metrics"])
            tok = slice(rows.start * S, rows.stop * S)
            assert np.array_equal(g["kept"].numpy(), want["kept"][tok]), \
                ranking
            assert g["bucket"] == min(_capacity(B * S, _cfg()), t_loc)
            assert _rel(g["dx"], want["dx"][rows]) <= GRAD_TOL, ranking
            drouter.setdefault(o["model"], []).append(g["drouter"])
            for name in ("w_gate", "w_up", "w_down"):
                grad, sl = g["held"][name]
                w = want["grads"][name][sl]
                assert tuple(grad.shape) == w.shape
                assert grad.shape[0] == e_n // m
                assert grad.shape[1] == w.shape[1] \
                    == params[name].shape[1] // dp
                assert _rel(grad, w) <= GRAD_TOL, (ranking, name)
        for parts in drouter.values():
            assert _rel(sum(parts), want["grads"]["router"]["w"]) \
                <= GRAD_TOL, ranking


def test_gspmd_route_with_shared_experts_on_two_by_two(tmp_path):
    """deepseek-v2-lite's smoke config (4 experts top-2, one shared
    expert of d_ff 64) on (2, 2): each rank holds 2 experts (half of D)
    and half the shared expert's d_ff (up / gate columns, down rows),
    and half its D (FSDP: the rule's ``"data"`` split); its rows, the
    metrics and every gradient against the reference's ``_moe_gspmd``
    on the global batch, each shared block's gradient already summed
    over the data ranks (the gather's reduce-scatter)."""
    params, x, cot = _inputs(DEEPSEEK)
    outs = _spawn(tmp_path, 4, {"mesh": (2, 2), "params": params, "x": x,
                                "cot": cot, "arch": DEEPSEEK}, "layer")
    f = _cfg(arch=DEEPSEEK).moe.d_ff_shared
    for ranking in RANKINGS:
        want = _jax_gspmd(ranking, params, x, cot, DEEPSEEK)
        seen = set()
        for o in outs:
            g, rows = o[ranking], o["rows"]
            assert _rel(g["y"], want["y"][rows]) <= FWD_TOL, ranking
            for a, b in zip(g["metrics"], want["metrics"]):
                assert abs(a - b) <= FWD_TOL * max(abs(b), 1e-6), ranking
            assert _rel(g["dx"], want["dx"][rows]) <= GRAD_TOL, ranking
            for name in ("w_gate", "w_up", "w_down"):
                grad, sl = g["held"][name]
                assert grad.shape[0] == 2
                assert _rel(grad, want["grads"][name][sl]) <= GRAD_TOL
            for n, (grad, sl) in g["shared"].items():
                assert f // 2 in tuple(grad.shape), (n, tuple(grad.shape))
                assert grad.numel() * 4 == want["grads"]["shared"][n][
                    "w"].size, (n, tuple(grad.shape))
                assert _rel(grad, want["grads"]["shared"][n]["w"][sl]) \
                    <= GRAD_TOL, (ranking, n)
                seen.add((o["model"], o["data"], n))
        assert len(seen) == 12


def test_gspmd_train_on_two_by_two_matches_one_process(tmp_path):
    """Three ``train_loop`` steps on (2, 2) (4 experts a rank, half of D,
    the routing global) against the one-process run on the global batch:
    the losses, every parameter (held blocks against their slices); the
    step-2 checkpoint resumed on (1, 2) gives the unbroken run's third
    loss."""
    from repro_torch.launch.train import train_loop
    from repro_torch.train.step import TrainHParams
    state, losses = train_loop(
        _cfg(), steps=3, batch_per_shard=2 * TRAIN_B, seq=TRAIN_S,
        ckpt_dir=None, hp=TrainHParams(**HP), device="cpu",
        log_every=10 ** 9)
    ckpt = str(tmp_path / "ck")
    run = tmp_path / "run22"
    run.mkdir()
    outs = _spawn(run, 4, {"mesh": (2, 2), "dir": ckpt}, "train")
    for o in outs:
        for a, b in zip(o["losses"], losses):
            assert abs(a - b) <= GRAD_TOL * abs(b), (o["losses"], losses)
        experts = [n for n in o["held"] if n.endswith("w_gate")]
        assert experts
        for n, p in o["params"].items():
            want = state.params[n].detach()
            if n in o["held"]:
                want = o["held"][n].take(want)
            assert tuple(p.shape) == tuple(want.shape), n
            assert _rel(p, want) <= GRAD_TOL, n
        for n in experts:
            assert o["params"][n].shape[0] == _cfg().moe.num_experts // 2
    shutil.rmtree(os.path.join(ckpt, "step_3"))
    run = tmp_path / "run12"
    run.mkdir()
    resumed = _spawn(run, 2, {"mesh": (1, 2), "dir": ckpt}, "resume")
    for o in resumed:
        assert len(o["losses"]) == 1
        assert abs(o["losses"][0] - losses[2]) <= GRAD_TOL * abs(losses[2])
