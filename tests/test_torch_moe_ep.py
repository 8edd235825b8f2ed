"""MoE expert parallelism (``impl="shard_map"``) over gloo ranks on the
CPU, against the JAX package.

qwen3-moe's smoke config (8 experts, top-2) in fp32, x ``[4, 8, D]``
from a seed, both ``ranking`` values.  The ranks (spawned, ``file://``
init under ``tmp_path``, joined with a timeout) import no JAX; each
holds its block of the expert stacks (``MoE(mesh=)``).

* On a ``(1, 2)`` mesh (local capacity = global capacity) the route
  against the reference's ``_moe_gspmd``: the output and the three
  metrics, and the gradients of ``sum(y * cot) + aux + z`` against
  ``jax.grad`` of the same loss (x, the router, each rank's experts).
* On ``(1, 2)`` and ``(2, 2)`` meshes against the reference's own
  ``_moe_shard_map``, run in a subprocess with
  ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (a test
  process has one host device; ``tests/test_sharding.py`` runs the
  reference's shard_map the same way), its outputs handed back as numpy:
  each rank's output is its data shard's rows, the metrics the
  reference's (averaged over the batch axes).
* Without a mesh, or on an abstract one, the gspmd route; a module that
  holds one rank's experts refuses to run without its mesh.

Budgets: fp32 rel-max 1e-5 on outputs and metrics (the combine sums the
two ranks' partials in another order), gradients 1e-4 (``MODEL_TOL``).
"""
import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402

FWD_TOL = 1e-5
GRAD_TOL = 1e-4
SPAWN_TIMEOUT = 180
B, S = 4, 8
RANKINGS = ("cumsum", "sort")
REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / max(
        float(np.abs(want).max()), 1e-6)


def _cfg(ranking="cumsum", impl="shard_map"):
    cfg = dataclasses.replace(tconfigs.smoke("qwen3_moe_30b_a3b"),
                              dtype="float32")
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, ranking=ranking, impl=impl))


def _inputs():
    """Seeded fp32 expert weights (the reference's scales), x and the
    output cotangent, as numpy."""
    cfg = _cfg()
    m, d = cfg.moe, cfg.d_model
    rng = np.random.default_rng(0)

    def draw(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    params = {"router": {"w": draw((d, m.num_experts), 1 / np.sqrt(d))},
              "w_gate": draw((m.num_experts, d, m.d_ff_expert),
                             1 / np.sqrt(d)),
              "w_up": draw((m.num_experts, d, m.d_ff_expert),
                           1 / np.sqrt(d)),
              "w_down": draw((m.num_experts, m.d_ff_expert, d),
                             1 / np.sqrt(m.d_ff_expert))}
    return params, draw((B, S, d), 1.0), draw((B, S, d), 1.0)


def _load(moe, params):
    """The numpy weights into ``moe`` (a held stack takes its block)."""
    with torch.no_grad():
        moe.router.w.copy_(torch.as_tensor(params["router"]["w"]))
        for name in ("w_gate", "w_up", "w_down"):
            w = torch.as_tensor(params[name])
            if name in moe.held:
                w = moe.held[name].block.take(w)
            getattr(moe, name).copy_(w)
    return moe


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


def _rank_ep(rank, world, inp):
    """The shard_map route on this rank's data shard, forward and
    backward, for each ranking; and the refusal without the mesh."""
    from repro_torch.models.moe import MoE, ep_route, moe_apply
    from repro_torch.sharding import rules
    mesh = tmesh.make_device_mesh("cpu", inp["mesh"], ("data", "model"))
    di, dp = tmesh.axis_index(mesh, ("data",))
    rows = slice(di * B // dp, (di + 1) * B // dp)
    out = {"rows": rows}
    for ranking in RANKINGS:
        cfg = _cfg(ranking)
        moe = _load(MoE(cfg, dtype=torch.float32, device="cpu", mesh=mesh),
                    inp["params"])
        x = torch.as_tensor(inp["x"][rows]).requires_grad_(True)
        for p in moe.parameters():
            p.requires_grad_(True)
        with rules.activation_mesh(mesh):
            assert ep_route(cfg, rules.current_mesh())
            y, m = moe_apply(moe, cfg, x)
        loss = (y * torch.as_tensor(inp["cot"][rows])).sum() \
            + m.aux_loss + m.z_loss
        loss.backward()
        out[ranking] = dict(
            y=y.detach(), metrics=[float(v) for v in m],
            dx=x.grad, drouter=moe.router.w.grad.clone(),
            held={n: (getattr(moe, n).grad.clone(), h.block.index)
                  for n, h in moe.held.items()})
        try:
            moe_apply(moe, cfg, x)
            out[ranking]["refused"] = None
        except ValueError as e:
            out[ranking]["refused"] = str(e)
    return out


def _rank_train(rank, world, inp):
    """``train_loop`` on a concrete mesh, the experts held by the model
    ranks: the losses and the final parameters with each held block's
    slices."""
    from repro_torch.launch.train import train_loop
    from repro_torch.train.step import TrainHParams
    mesh = tmesh.make_device_mesh("cpu", inp["mesh"], ("data", "model"))
    state, losses = train_loop(
        _cfg(), steps=3, batch_per_shard=B, seq=S, ckpt_dir=None,
        hp=TrainHParams(**inp["hp"]), device="cpu", log_every=10 ** 9,
        mesh=mesh)
    lay = state.layout
    return {"losses": losses,
            "params": {n: p.detach().clone()
                       for n, p in state.params.items()},
            "slices": {n: tmesh.block_slices(lay.shapes[n], lay.specs[n],
                                             mesh) for n in lay.held}}


_RANK_CASES = {"ep": _rank_ep, "train": _rank_train}


def _spawn(tmp_path, world, inputs, case="ep"):
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
            pytest.fail(f"{world} ranks still running after "
                        f"{SPAWN_TIMEOUT} s")
    return [torch.load(str(tmp_path / f"out{r}.pt"), weights_only=False)
            for r in range(world)]


# -- the reference ---------------------------------------------------------------

def _jax_cfg(ranking="cumsum", impl="shard_map"):
    from repro import configs as jconfigs
    cfg = dataclasses.replace(jconfigs.smoke("qwen3_moe_30b_a3b"),
                              dtype="float32")
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, ranking=ranking, impl=impl))


def _jax_gspmd(ranking, params, x, cot):
    """The reference's ``_moe_gspmd``: output, metrics, and the gradients
    of ``sum(y * cot) + aux + z`` by ``jax.grad``."""
    import jax
    import jax.numpy as jnp
    from repro.models import moe as jmoe
    cfg = _jax_cfg(ranking)

    def loss(p, xx):
        y, m = jmoe._moe_gspmd(p, cfg, xx)
        return jnp.sum(y * cot) + m.aux_loss + m.z_loss, (y, m)
    (_, (y, m)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(
            jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    return dict(y=np.asarray(y), metrics=[float(v) for v in m],
                dx=np.asarray(gx),
                grads=jax.tree.map(np.asarray, gp))


_SHARD_MAP_SCRIPT = r"""
import dataclasses, sys
import numpy as np
import jax, jax.numpy as jnp
from repro import configs
from repro.models import moe
from repro.sharding import rules
src, dst = sys.argv[1], sys.argv[2]
f = np.load(src)
params = {"router": {"w": jnp.asarray(f["router"])},
          "w_gate": jnp.asarray(f["w_gate"]), "w_up": jnp.asarray(f["w_up"]),
          "w_down": jnp.asarray(f["w_down"])}
cfg = dataclasses.replace(configs.smoke("qwen3_moe_30b_a3b"), dtype="float32")
cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                       impl="shard_map"))
out = {}
for shape in ((1, 2), (2, 2)):
    mesh = jax.make_mesh(shape, ("data", "model"))
    with mesh, rules.activation_mesh(mesh):
        y, m = jax.jit(lambda p, x: moe._moe_shard_map(
            p, cfg, x, mesh, rules.batch_axes(mesh)))(params,
                                                      jnp.asarray(f["x"]))
    key = "x".join(map(str, shape))
    out["y" + key] = np.asarray(y)
    out["m" + key] = np.asarray([float(v) for v in m])
np.savez(dst, **out)
"""


def _jax_shard_map(tmp_path, params, x):
    """The reference's ``_moe_shard_map`` on (1, 2) and (2, 2) meshes of 4
    host devices, in a subprocess."""
    src, dst = str(tmp_path / "moe_in.npz"), str(tmp_path / "moe_out.npz")
    np.savez(src, router=params["router"]["w"], w_gate=params["w_gate"],
             w_up=params["w_up"], w_down=params["w_down"], x=x)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(REPO, "src"),
                    os.environ.get("PYTHONPATH", "")]))
    subprocess.run([sys.executable, "-c", _SHARD_MAP_SCRIPT, src, dst],
                   env=env, check=True, timeout=SPAWN_TIMEOUT)
    return dict(np.load(dst))


# -- tests -----------------------------------------------------------------------

def test_shard_map_route_matches_reference_gspmd_and_grads(tmp_path):
    """(1, 2): each rank holds 4 of the 8 experts; output, metrics and
    gradients against the reference's gspmd formulation, for both
    rankings; the ranks agree; a held module refuses to run off its
    mesh."""
    params, x, cot = _inputs()
    outs = _spawn(tmp_path, 2, {"mesh": (1, 2), "params": params, "x": x,
                                "cot": cot})
    for ranking in RANKINGS:
        want = _jax_gspmd(ranking, params, x, cot)
        got = [o[ranking] for o in outs]
        for g in got:
            assert _rel(g["y"], want["y"]) <= FWD_TOL, ranking
            for a, b in zip(g["metrics"], want["metrics"]):
                assert abs(a - b) <= FWD_TOL * max(abs(b), 1e-6), \
                    (ranking, g["metrics"], want["metrics"])
            assert _rel(g["dx"], want["dx"]) <= GRAD_TOL, ranking
            assert _rel(g["drouter"], want["grads"]["router"]["w"]) \
                <= GRAD_TOL, ranking
            assert g["refused"] is not None and "mesh" in g["refused"]
        assert torch.equal(got[0]["y"], got[1]["y"])
        assert torch.equal(got[0]["drouter"], got[1]["drouter"])
        for name in ("w_gate", "w_up", "w_down"):
            parts = []
            for g in got:
                grad, sl = g["held"][name]
                w = want["grads"][name][sl]
                assert tuple(grad.shape) == w.shape
                assert tuple(grad.shape)[0] == 4
                assert _rel(grad, w) <= GRAD_TOL, (ranking, name)
                parts.append(sl[0].start)
            assert sorted(parts) == [0, 4]


@pytest.fixture(scope="module")
def reference_shard_map(tmp_path_factory):
    params, x, _ = _inputs()
    return _jax_shard_map(tmp_path_factory.mktemp("ref"), params, x)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_shard_map_route_matches_reference_shard_map(tmp_path, shape,
                                                     reference_shard_map):
    """The port's route on 2 or 4 gloo ranks against the reference's
    ``_moe_shard_map`` on the same mesh of host devices: each rank's rows
    and the batch-averaged metrics, both rankings (the reference's local
    route ranks by sort either way: the same slots)."""
    params, x, cot = _inputs()
    ref = reference_shard_map
    key = "x".join(map(str, shape))
    outs = _spawn(tmp_path, int(np.prod(shape)),
                  {"mesh": shape, "params": params, "x": x, "cot": cot})
    for o in outs:
        for ranking in RANKINGS:
            g = o[ranking]
            assert _rel(g["y"], ref["y" + key][o["rows"]]) <= FWD_TOL
            for a, b in zip(g["metrics"], ref["m" + key]):
                assert abs(a - b) <= FWD_TOL * max(abs(b), 1e-6), \
                    (key, ranking, g["metrics"], ref["m" + key])
    if shape == (2, 2):
        # the data shards' rows differ, the model ranks of one shard agree
        assert outs[0]["rows"] != outs[2]["rows"]
        assert torch.equal(outs[0]["cumsum"]["y"], outs[1]["cumsum"]["y"])


@pytest.mark.parametrize("ranking", RANKINGS)
def test_without_a_concrete_mesh_the_gspmd_route_runs(ranking):
    """``impl="shard_map"`` without a mesh, or with an abstract one
    installed, is the reference's gspmd formulation (the module holds
    every expert)."""
    from repro_torch.models.moe import MoE, ep_route, moe_apply
    from repro_torch.sharding import rules
    params, x, cot = _inputs()
    want = _jax_gspmd(ranking, params, x, cot)
    cfg = _cfg(ranking)
    moe = _load(MoE(cfg, dtype=torch.float32, device="cpu"), params)
    assert not moe.held
    mesh = tmesh.AbstractMesh((1, 2), ("data", "model"))
    assert not ep_route(cfg, mesh) and not ep_route(cfg, None)
    with torch.no_grad():
        y, m = moe_apply(moe, cfg, torch.as_tensor(x))
        with rules.activation_mesh(mesh):
            y2, _ = moe_apply(moe, cfg, torch.as_tensor(x))
    assert _rel(y, want["y"]) <= FWD_TOL
    assert torch.equal(y, y2)
    for a, b in zip(m, want["metrics"]):
        assert abs(float(a) - b) <= FWD_TOL * max(abs(b), 1e-6)


def test_train_loop_with_expert_parallelism_matches_one_process(tmp_path):
    """Three ``train_loop`` steps of the qwen3 smoke model on a (1, 2)
    mesh (each rank 4 of every layer's 8 experts, the state sharded)
    against the one-process gspmd run from the same seed: the losses
    and every parameter, the held blocks against their slices."""
    from repro_torch.launch.train import train_loop
    from repro_torch.train.step import TrainHParams
    hp = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    state, losses = train_loop(
        _cfg(impl="gspmd"), steps=3, batch_per_shard=B, seq=S,
        ckpt_dir=None, hp=TrainHParams(**hp), device="cpu",
        log_every=10 ** 9)
    outs = _spawn(tmp_path, 2, {"mesh": (1, 2), "hp": hp}, case="train")
    for o in outs:
        for a, b in zip(o["losses"], losses):
            assert abs(a - b) <= GRAD_TOL * abs(b), (o["losses"], losses)
        assert o["slices"]
        for n, p in o["params"].items():
            want = state.params[n].detach()
            if n in o["slices"]:
                want = want[o["slices"][n]]
            assert tuple(p.shape) == tuple(want.shape), n
            assert _rel(p, want) <= GRAD_TOL, n
