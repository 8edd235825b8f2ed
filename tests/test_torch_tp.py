"""Tensor parallelism of the port against the JAX package, on the CPU:
the k-shard half of the partitioner, ``core/tp.py``, the ``static_tp``
and ``static_tp_shardmap`` plan routes, the plan layer's TP race and
reports, the mesh factories and the engine with a mesh.

Inputs come from numpy with a seed and go to both packages.  The
explicit route runs over 2 and 4 gloo ranks spawned on the CPU (one
``DeviceMesh("cpu", ...)`` each; a ``(2, 2)`` ``("data", "model")``
mesh too).  The ranks never import JAX: the reference's values are
computed in the parent and handed to them as tensors, and this module
imports JAX only inside the functions the parent runs.

Budgets (the reference's, ``tests/test_sharding.py``): forward fp32
1e-5, bf16 / fp16 4e-2 (rtol, and atol on the output's scale), against
the JAX ``tp_spmm_gspmd`` and ten times that against the dense fp32
oracle; gradients the same against ``jax.grad`` of the reference, atol
on the gradient's largest magnitude.  The explicit route against
``static_tp`` in fp32: 1e-5.  The partitioner's metadata: exact.
"""
import dataclasses
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import sparse  # noqa: E402
from repro_torch.core import partitioner as tpart  # noqa: E402
from repro_torch.core import tp as ttp  # noqa: E402
from repro_torch.core.bsr import BlockSparseMatrix as TBSR  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.sparse import cache as cache_lib  # noqa: E402

B = 16
N = 32
TOLS = {"float32": 1e-5, "bfloat16": 4e-2, "float16": 4e-2}
SPAWN_TIMEOUT = 180


@pytest.fixture(autouse=True)
def _fresh():
    sparse.reset()
    sparse.configure(None)
    yield
    sparse.reset()
    sparse.configure(None)


# -- patterns ----------------------------------------------------------------

def _skewed_mask(m=128, k=256, b=B, seed=0):
    """The reference's ``_skewed_bsr`` pattern: the mass in the left
    block columns, so balanced splits land unevenly."""
    rng = np.random.default_rng(seed)
    col_p = np.linspace(1.0, 0.1, k // b)
    mask = rng.random((m // b, k // b)) < 0.6 * col_p[None, :]
    mask[0, 0] = True
    return mask


def _empty_cols_mask(mb=8, kb=16, seed=1):
    """Block columns 4..11 empty: a plateau the balanced splits slide on,
    and two shards without a block under even splits at q = 4."""
    rng = np.random.default_rng(seed)
    mask = rng.random((mb, kb)) < 0.5
    mask[:, 4:12] = False
    mask[0, 0] = True
    return mask


PATTERNS = {"skewed": _skewed_mask, "empty_cols": _empty_cols_mask}


def _values(mask, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (int(mask.sum()), B, B)).astype(np.float32)


def _x(k, n=N, seed=9):
    return np.random.default_rng(seed).standard_normal((k, n)).astype(
        np.float32)


def _cot(m, n=N, seed=11):
    return np.random.default_rng(seed).standard_normal((m, n)).astype(
        np.float32)


def _tbsr(mask, vals, dtype=torch.float32):
    return TBSR.from_mask(mask, B, values=torch.as_tensor(vals).to(dtype))


# -- the JAX side (parent process only) -----------------------------------

def _jax():
    import jax
    import jax.numpy as jnp
    from repro.core import partitioner as jpart
    from repro.core import tp as jtp
    from repro.core.bsr import BlockSparseMatrix as JBSR
    return jax, jnp, jpart, jtp, JBSR


def _jbsr(mask, vals, dtype="float32"):
    jax, jnp, _, _, JBSR = _jax()
    return JBSR.from_mask(mask, B).with_values(
        jnp.asarray(vals).astype(getattr(jnp, dtype)))


def _jax_gspmd(mask, vals, x, cot, q, balanced, dtype):
    """The reference's ``tp_spmm_gspmd`` forward and ``jax.grad`` of
    ``sum(Y * cot)`` in (values, x), as fp32 numpy."""
    jax, jnp, jpart, jtp, _ = _jax()
    jb = _jbsr(mask, vals, dtype)
    meta = jpart.plan_k_shards(jb, q, balanced=balanced)
    dt = getattr(jnp, dtype)

    def f(v, xx):
        return jtp.tp_spmm_gspmd(jpart.apply_k_shards(meta, v), xx,
                                 axis="model")

    xj = jnp.asarray(x).astype(dt)
    y = f(jb.values, xj)
    gv, gx = jax.grad(lambda v, xx: (f(v, xx).astype(jnp.float32)
                                     * jnp.asarray(cot)).sum(),
                      argnums=(0, 1))(jb.values, xj)
    return {k: np.asarray(v, np.float32)
            for k, v in (("y", y), ("dv", gv), ("dx", gx))}


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _close(got, want, tol, what=""):
    got, want = _np(got), _np(want)
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


# -- the partitioner ---------------------------------------------------------

@pytest.mark.parametrize("balanced", [True, False])
@pytest.mark.parametrize("q", [1, 2, 4])
@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_k_shards_equal_jax(pattern, q, balanced):
    """``plan_k_shards`` / ``apply_k_shards`` equal the JAX package's bit
    for bit: boundaries, stacked indices (padding included), slots, real
    counts, destinations and the stacked values."""
    _, _, jpart, _, _ = _jax()
    mask = PATTERNS[pattern]()
    vals = _values(mask)
    jmeta = jpart.plan_k_shards(_jbsr(mask, vals), q, balanced=balanced)
    tb = _tbsr(mask, vals)
    meta = tpart.plan_k_shards(tb, q, balanced=balanced)
    for f in ("boundaries", "row_idx", "col_idx", "real_counts", "dst_q",
              "dst_slot", "src_order"):
        assert np.array_equal(np.asarray(getattr(meta, f)),
                              np.asarray(getattr(jmeta, f))), f
    assert (meta.q, meta.slots, meta.balanced) == \
        (jmeta.q, jmeta.slots, jmeta.balanced)
    sb = tpart.apply_k_shards(meta, tb.values)
    jsb = jpart.apply_k_shards(jmeta, _jbsr(mask, vals).values)
    assert np.array_equal(sb.values.numpy(), np.asarray(jsb.values))
    assert (sb.q, sb.slots) == (jsb.q, jsb.slots)
    # each shard's own blocks are its first real_counts slots
    for j in range(q):
        rows, cols = meta.shard_pattern(j)
        src = meta.shard_source(j)
        assert np.array_equal(rows, tb.row_idx[src])
        assert np.array_equal(cols, tb.col_idx[src])
        lo, hi = meta.boundaries[j], meta.boundaries[j + 1]
        assert ((cols >= lo) & (cols < hi)).all()
    if pattern == "empty_cols" and q == 4 and not balanced:
        assert (meta.real_counts == 0).any()
    full = tpart.shard_blocks_by_k(tb, q, balanced=balanced)
    assert torch.equal(full.values, sb.values)


def test_balanced_splits_equal_jax_on_random_masks():
    """``balanced_k_splits`` and ``even_k_splits`` on masks with their mass
    at the start, the end and in the middle, q up to the column count
    (the plateau slide and the forced clamp)."""
    _, _, jpart, _, _ = _jax()
    rng = np.random.default_rng(4)
    for trial in range(40):
        mb, kb = rng.integers(1, 9), rng.integers(2, 20)
        mask = rng.random((mb, kb)) < rng.uniform(0.05, 0.9)
        where = trial % 3
        if where == 0:
            mask[:, kb // 2:] = False
        elif where == 1:
            mask[:, :kb // 2] = False
        for q in range(1, kb + 1):
            assert np.array_equal(tpart.balanced_k_splits(mask, q),
                                  jpart.balanced_k_splits(mask, q)), \
                (trial, q)
            assert np.array_equal(tpart.even_k_splits(kb, q),
                                  jpart.even_k_splits(kb, q))


def test_plan_k_shards_validates_q():
    _, _, jpart, _, _ = _jax()
    mask = _skewed_mask(m=64, k=64)
    tb = _tbsr(mask, _values(mask))
    for q in (0, 5):
        with pytest.raises(ValueError, match="k-shards outside"):
            tpart.plan_k_shards(tb, q)
        with pytest.raises(ValueError, match="k-shards outside"):
            jpart.plan_k_shards(_jbsr(mask, _values(mask)), q)
    with pytest.raises(ValueError, match="partitions > 4"):
        tpart.balanced_k_splits(mask, 5)


# -- core/tp.py and the static_tp route ---------------------------------------

@pytest.mark.parametrize("balanced", [True, False])
@pytest.mark.parametrize("dtype", sorted(TOLS))
def test_tp_spmm_gspmd_matches_jax(dtype, balanced):
    """``core.tp.tp_spmm_gspmd`` (plain partials) against the reference's
    forward and ``jax.grad``, and against the dense oracle."""
    mask = _skewed_mask()
    vals, x = _values(mask), _x(mask.shape[1] * B)
    cot = _cot(mask.shape[0] * B)
    want = _jax_gspmd(mask, vals, x, cot, 4, balanced, dtype)
    dt = getattr(torch, dtype)
    tb = _tbsr(mask, vals, dt)
    meta = tpart.plan_k_shards(tb, 4, balanced=balanced)
    v = tb.values.clone().requires_grad_(True)
    xx = torch.as_tensor(x).to(dt).requires_grad_(True)
    y = ttp.tp_spmm_gspmd(tpart.apply_k_shards(meta, v), xx)
    assert y.dtype == dt
    (y.float() * torch.as_tensor(cot)).sum().backward()
    tol = TOLS[dtype]
    _close(y.detach(), want["y"], tol, "y")
    oracle = _tbsr(mask, vals).to_dense().numpy() @ x
    _close(y.detach(), oracle, 10 * tol, "oracle")
    _close(v.grad, want["dv"], tol, "dvalues")
    _close(xx.grad, want["dx"], tol, "dx")


@pytest.mark.parametrize("q,balanced", [(2, True), (4, True), (4, False)])
@pytest.mark.parametrize("dtype", sorted(TOLS))
@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_static_tp_route_matches_jax(pattern, dtype, q, balanced):
    """The ``static_tp`` plan route (each shard's partial a static plan on
    bsmm's plain version, its backward bsmm on the transposed shard and
    the SDDMM) against the reference's ``tp_spmm_gspmd`` forward and
    ``jax.grad``; ``empty_cols`` at q = 4 with even splits has shards
    that own no block."""
    mask = PATTERNS[pattern]()
    m, k = mask.shape[0] * B, mask.shape[1] * B
    vals, x, cot = _values(mask), _x(k), _cot(m)
    want = _jax_gspmd(mask, vals, x, cot, q, balanced, dtype)
    dt = getattr(torch, dtype)
    tb = _tbsr(mask, vals, dt)
    p = sparse.plan(tb, N, device="cpu", ctx=sparse.PlanContext(
        mode="static_tp", tp_q=q, tp_balanced=balanced))
    assert p.route == "static_tp" and p.source == "forced"
    assert p.artifacts["tp_q"] == q and p.tp.shards == tuple(range(q))
    empty = [j for j, c in enumerate(p.tp.meta.real_counts) if c == 0]
    assert [j for j, sp in zip(p.tp.shards, p.tp.plans) if sp is None] == \
        empty
    v = tb.values.clone().requires_grad_(True)
    x2 = torch.as_tensor(x.T.copy()).to(dt).requires_grad_(True)
    y = p.spmm_nt(v, x2)
    assert y.dtype == dt and y.shape == (N, m)
    (y.float() * torch.as_tensor(cot.T)).sum().backward()
    tol = TOLS[dtype]
    _close(y.detach().T, want["y"], tol, "y")
    _close(v.grad, want["dv"], tol, "dvalues")
    _close(x2.grad.T, want["dx"], tol, "dx")
    # without autograd: the packed stack of every shard, one walk each
    with torch.no_grad():
        y2 = p.run_packed(p.pack(tb.values), x2.detach())
    assert torch.equal(y2, y.detach())


def test_static_tp_route_launches_bsmm_once_per_shard(monkeypatch):
    """A forward call runs the static walk once per shard that owns a
    block (``q`` for a pattern without an empty shard), a backward one
    dL/dx walk and one SDDMM per shard."""
    from repro_torch.kernels.bsmm import ops as bsmm_ops
    from repro_torch.kernels.sddmm import ops as sddmm_ops
    calls = {"bsmm": 0, "sddmm": 0}
    real_bsmm, real_sddmm = bsmm_ops.bsmm_nt, sddmm_ops.sddmm

    def bsmm(*a, **kw):
        calls["bsmm"] += 1
        return real_bsmm(*a, **kw)

    def sddmm(*a, **kw):
        calls["sddmm"] += 1
        return real_sddmm(*a, **kw)
    monkeypatch.setattr(bsmm_ops, "bsmm_nt", bsmm)
    monkeypatch.setattr(sddmm_ops, "sddmm", sddmm)
    mask = _skewed_mask()
    tb = _tbsr(mask, _values(mask))
    for q, empty in ((4, False), (2, False)):
        p = sparse.plan(tb, N, device="cpu",
                        ctx=sparse.PlanContext(mode="static_tp", tp_q=q))
        calls.update(bsmm=0, sddmm=0)
        v = tb.values.clone().requires_grad_(True)
        x2 = torch.randn(N, tb.shape[1], requires_grad=True)
        y = p.spmm_nt(v, x2)
        assert calls == {"bsmm": q, "sddmm": 0}
        y.sum().backward()
        assert calls == {"bsmm": 2 * q, "sddmm": q}
    mask = _empty_cols_mask()
    tb = _tbsr(mask, _values(mask))
    p = sparse.plan(tb, N, device="cpu", ctx=sparse.PlanContext(
        mode="static_tp", tp_q=4, tp_balanced=False))
    calls.update(bsmm=0, sddmm=0)
    with torch.no_grad():
        p.run_packed(p.pack(tb.values), torch.randn(N, tb.shape[1]))
    assert calls["bsmm"] == 2          # two of four shards own blocks


# -- the plan layer against the JAX package's ---------------------------------

def _api_problem(seed=0):
    """``tests/test_sparse_api.py``'s problem (128 x 256, b 16, d 1/4,
    N 64) in both packages."""
    jax, jnp, _, _, JBSR = _jax()
    jb = JBSR.random(jax.random.PRNGKey(seed), 128, 256, B, 0.25,
                     pattern_seed=seed)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(seed + 100),
                                     (256, 64)))
    tb = TBSR(torch.as_tensor(np.array(jb.values)),
              np.asarray(jb.row_idx), np.asarray(jb.col_idx), jb.shape, B)
    return jb, tb, x


def test_static_tp_plan_parity_with_jax():
    """``test_static_tp_plan_parity``: mode "static_tp" at tp_q 4, the
    route, its artifacts and the output, against the JAX plan."""
    from repro import sparse as jsparse
    jsparse.reset()
    jb, tb, x = _api_problem()
    jp = jsparse.plan(jb, 64, ctx=jsparse.PlanContext(mode="static_tp",
                                                      tp_q=4))
    p = sparse.plan(tb, 64, device="cpu",
                    ctx=sparse.PlanContext(mode="static_tp", tp_q=4))
    assert p.route == jp.route == "static_tp"
    for key in ("tp_q", "tp_axis", "tp_route", "tp_balanced", "tp_slots"):
        assert p.artifacts[key] == jp.artifacts[key], key
    assert p.artifacts["tp_imbalance"] == pytest.approx(
        jp.artifacts["tp_imbalance"], rel=1e-12)
    y = p.spmm_nt(tb.values, torch.as_tensor(x.T.copy()))
    _close(y.T, np.asarray(jp(jb.values, x)), 1e-5)
    jsparse.reset()


def test_shardmap_mode_requires_concrete_mesh():
    """tp_q alone, or an abstract mesh, runs only ``static_tp``: forcing
    the explicit route is an error, as in the reference; so is a mesh
    without the TP axis (naming it, or tp_q, fixes that)."""
    from repro import sparse as jsparse
    jb, tb, _ = _api_problem()
    for ctx in (sparse.PlanContext(mode="static_tp_shardmap", tp_q=4),
                sparse.PlanContext(mode="static_tp_shardmap",
                                   mesh=tmesh.make_production_mesh())):
        with pytest.raises(ValueError, match="static_tp_shardmap"):
            sparse.plan(tb, 64, device="cpu", ctx=ctx)
    with pytest.raises(ValueError, match="static_tp_shardmap"):
        jsparse.plan(jb, 64, ctx=jsparse.PlanContext(
            mode="static_tp_shardmap", tp_q=4))
    m = tmesh.AbstractMesh((1,), ("x",))
    with pytest.raises(ValueError, match=r"tp_axis 'model'"):
        sparse.plan(tb, 64, device="cpu", ctx=sparse.PlanContext(mesh=m))
    p = sparse.plan(tb, 64, device="cpu",
                    ctx=sparse.PlanContext(mesh=m, tp_axis="x"))
    assert p.explain()["tp"] is None           # q = 1: nothing to shard
    with pytest.raises(ValueError, match="static_tp"):
        sparse.plan(tb, 64, device="cpu",
                    ctx=sparse.PlanContext(grad_mode="static_tp"))


def test_tp_decision_surfaced_in_explain_and_report():
    """``test_tp_decision_surfaced_in_explain_and_report``: the
    ``explain()["tp"]`` keys and values, ``tp_report()`` totals and
    ``format_plan``'s ``tp:`` line, against the JAX plan's."""
    from repro import sparse as jsparse
    jsparse.reset()
    jb, tb, x = _api_problem()
    ctx = dict(mode="static_tp", tp_q=4, tp_balanced=False)
    jp = jsparse.plan(jb, 64, ctx=jsparse.PlanContext(**ctx))
    p = sparse.plan(tb, 64, device="cpu", ctx=sparse.PlanContext(**ctx))
    jtp, tp = jp.explain()["tp"], p.explain()["tp"]
    assert set(tp) == set(jtp)
    for key in ("q", "axis", "balanced", "mesh", "chosen", "best_tp_route",
                "best_unsharded_route", "source",
                "tp_speedup_vs_unsharded", "tp_wins"):
        assert tp[key] == jtp[key], key
    assert list(tp["candidates"]) == list(jtp["candidates"])
    assert p.artifacts["tp_balanced"] is False
    rep, jrep = sparse.tp_report(), jsparse.tp_report()
    assert rep["totals"] == jrep["totals"] == {
        "tp_planned": 1, "tp_chosen": 1, "measured": 0}
    assert set(next(iter(rep["per_plan"].values()))) == set(
        next(iter(jrep["per_plan"].values())))
    line = [ln for ln in sparse.format_plan(p).split("; ")
            if "tp:" in ln][0]
    jline = [ln for ln in jsparse.format_plan(jp).split("; ")
             if "tp:" in ln][0]
    assert line.split("tp:")[1] == jline.split("tp:")[1]
    # the roofline leaves the TP routes out, as the reference's does
    assert "static_tp" not in p.roofline()["routes"]
    jsparse.reset()


def test_auto_with_abstract_mesh_races_static_tp_only():
    """``test_abstract_mesh_plans_gspmd_only`` and the analytic race: an
    abstract mesh admits ``static_tp`` (not the explicit route) beside
    the unsharded routes; the report's crossover, its ``tp race`` line,
    and the output equal to the unsharded plan's."""
    from repro import sparse as jsparse
    jax, _, _, _, _ = _jax()
    from jax.sharding import AbstractMesh
    jsparse.reset()
    jb, tb, x = _api_problem()
    try:
        amesh = AbstractMesh((1, 4), ("data", "model"))
    except TypeError:
        amesh = AbstractMesh((("data", 1), ("model", 4)))
    jp = jsparse.plan(jb, 64, ctx=jsparse.PlanContext(mesh=amesh))
    mesh = tmesh.AbstractMesh((1, 4), ("data", "model"))
    ctx = sparse.PlanContext(mesh=mesh)
    assert not ctx.shardmap_executable()
    assert ctx.mesh_fingerprint() == (("data", "model"), (1, 4))
    p = sparse.plan(tb, 64, device="cpu", ctx=ctx)
    for plan_ in (p, jp):
        assert "static_tp_shardmap" not in plan_.est_seconds
        assert "static_tp" in plan_.est_seconds
    tp, jtp = p.explain()["tp"], jp.explain()["tp"]
    assert tp["mesh"] == jtp["mesh"] == {"data": 1, "model": 4}
    assert tp["source"] == jtp["source"] == "analytic"
    assert tp["tp_speedup_vs_unsharded"] is not None
    assert tp["tp_wins"] == (p.route == "static_tp")
    if tp["tp_wins"]:
        assert "tp race (analytic)" in sparse.format_plan(p)
    x2 = torch.as_tensor(x.T.copy())
    ref = sparse.plan(tb, 64, device="cpu").spmm_nt(tb.values, x2)
    _close(p.spmm_nt(tb.values, x2), ref.numpy(), 1e-5)
    jsparse.reset()


def test_tp_verdict_is_mesh_keyed(tmp_path):
    """A verdict stored for mesh (1, 4) replays after a restart with zero
    decisions, and is not replayed for (2, 2), for tp_q alone, or for
    another split rule; the fingerprints of tp_q alone and of a mesh of
    the same q differ."""
    _, tb, x = _api_problem()
    ctx = sparse.PlanContext(mesh=tmesh.AbstractMesh((1, 4),
                                                     ("data", "model")),
                             cache_dir=str(tmp_path))
    p1 = sparse.plan(tb, 64, device="cpu", ctx=ctx)
    assert p1.explain()["tp"] is not None
    sparse.reset()
    p2 = sparse.plan(tb, 64, device="cpu", ctx=ctx)
    assert p2.from_disk and p2.route == p1.route
    assert sparse.cache_stats()["decisions"] == 0
    assert p2.explain()["tp"]["mesh"] == {"data": 1, "model": 4}
    assert p2.explain()["tp"]["source"] == "analytic"
    for other in (dataclasses.replace(ctx, mesh=tmesh.AbstractMesh(
                      (2, 2), ("data", "model"))),
                  dataclasses.replace(ctx, mesh=None, tp_q=4),
                  dataclasses.replace(ctx, tp_balanced=False)):
        sparse.reset()
        p3 = sparse.plan(tb, 64, device="cpu", ctx=other)
        assert not p3.from_disk and p3.key != p1.key
    import importlib
    plan_mod = importlib.import_module("repro_torch.sparse.plan")
    spec = sparse.OpSpec.from_operand(tb, 64)
    dev = torch.device("cpu")
    fp_q = plan_mod._fingerprint(spec, sparse.PlanContext(tp_q=2), dev,
                                 (1.0, 0.0))
    fp_m = plan_mod._fingerprint(spec, sparse.PlanContext(
        tp_q=2, mesh=tmesh.AbstractMesh((2,), ("model",))), dev, (1.0, 0.0))
    assert fp_q != fp_m


def test_pre_tp_schema_cache_invalidated(tmp_path):
    """``test_pre_tp_schema_cache_invalidated``: a v2 file (keys without
    the mesh) is never read, at its own path or at v3's."""
    _, tb, _ = _api_problem()
    ctx = sparse.PlanContext(mode="static_tp", tp_q=4,
                             cache_dir=str(tmp_path))
    key = sparse.plan(tb, 64, device="cpu", ctx=ctx).key
    path = os.path.join(str(tmp_path), f"sparse-plans-torch-v"
                                       f"{cache_lib.SCHEMA_VERSION}.json")
    env = json.load(open(path))["env"]
    assert cache_lib.SCHEMA_VERSION == 3 and env["schema"] == 3
    os.remove(path)
    old = {"env": dict(env, schema=2),
           "entries": {key: {"route": "static_torch", "source": "measured",
                             "est_seconds": {}}}}
    for where in (os.path.join(str(tmp_path), "sparse-plans-torch-v2.json"),
                  path):
        with open(where, "w") as f:
            json.dump(old, f)
        sparse.reset()
        p = sparse.plan(tb, 64, device="cpu", ctx=ctx)
        assert not p.from_disk and p.route == "static_tp"


def test_evolve_keeps_the_tp_route_and_section():
    """A RigL topology step on a TP plan rebuilds its shards on the new
    pattern, keeps the route and the ``tp`` section, and computes the new
    pattern's product."""
    mask = _skewed_mask()
    tb = _tbsr(mask, _values(mask))
    p = sparse.plan(tb, N, device="cpu",
                    ctx=sparse.PlanContext(mode="static_tp", tp_q=4))
    new_mask = mask.copy()
    on = np.argwhere(mask)[:3]
    off = np.argwhere(~mask)[:3]
    new_mask[tuple(on.T)] = False
    new_mask[tuple(off.T)] = True
    child = p.evolve(new_mask)
    assert child.route == "static_tp" and child.tp is not None
    assert child.explain()["tp"] == p.explain()["tp"]
    vals = child.carry_values(tb.values)
    nb = TBSR.from_mask(new_mask, B, values=vals)
    x2 = torch.randn(N, tb.shape[1])
    _close(child.spmm_nt(vals, x2), (x2 @ nb.to_dense().t()).numpy(), 1e-5)


# -- the mesh factories ----------------------------------------------------------

def test_mesh_factories_match_jax():
    """The abstract meshes carry the reference's axis names and sizes, and
    touch no process group."""
    import torch.distributed as dist
    from repro.launch import mesh as jmesh
    jax, _, _, _, _ = _jax()
    host = tmesh.make_host_mesh()
    jhost = jmesh.make_host_mesh()
    assert host.axis_names == tuple(jhost.axis_names)
    assert host.shape == dict(jhost.shape)
    prod = tmesh.make_production_mesh()
    assert prod.shape == {"data": 16, "model": 16} and prod.size == 256
    pod = tmesh.make_production_mesh(multi_pod=True)
    assert pod.axis_names == ("pod", "data", "model")
    assert tmesh.mesh_axes(pod) == (("pod", "data", "model"), (2, 16, 16))
    assert not tmesh.is_concrete(pod) and not dist.is_initialized()
    assert sparse.PlanContext(mesh=prod).resolved_tp_q() == 16
    with pytest.raises(ValueError, match="differ in length"):
        tmesh.AbstractMesh((1, 2), ("model",))
    with pytest.raises(ValueError, match="initialised process group"):
        tmesh.make_device_mesh("cpu", (1,), ("model",))


# -- the engine -----------------------------------------------------------------

VOCAB = 512
BUCKETS = (8, 16)


def _engine_cfgs():
    from repro import configs as jconfigs
    from repro_torch import configs as tconfigs
    tcfg = dataclasses.replace(
        tconfigs.sparsify_ffn(tconfigs.smoke("llama3_2_1b"), 0.25),
        dtype="float32")
    jcfg = dataclasses.replace(jconfigs.smoke("llama3_2_1b"),
                               groups=tcfg.groups,
                               ffn_density=tcfg.ffn_density, dtype="float32")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _engine_prompts():
    rng = np.random.default_rng(5)
    return [rng.integers(0, VOCAB, size=n).astype(np.int32)
            for n in (6, 7, 13)]


def test_engine_with_abstract_mesh_matches_jax():
    """The llama smoke engine (sparse FFN d = 1/4, fp32) with an abstract
    (1, 4) ``("data", "model")`` mesh: its tokens equal the JAX engine's
    without a mesh, every static FFN plan carries a ``tp`` section in
    ``plan_report()["tp"]``, and ``not_ported`` is empty."""
    jax, _, _, _, _ = _jax()
    from repro import sparse as jsparse
    from repro.models.model import LM as JLM
    from repro.serve import Engine as JEngine
    from repro.serve import Request as JRequest
    from repro_torch.core.sparse_layers import SparseLinear
    from repro_torch.models.model import LM as TLM
    from repro_torch.serve import Engine, Request
    jcfg, tcfg = _engine_cfgs()
    jlm = JLM(jcfg)
    params = jlm.init(jax.random.PRNGKey(3))
    jsparse.reset()
    jeng = JEngine(jlm, params, batch=2, max_len=32, buckets=BUCKETS)
    jreqs = [JRequest(uid=i, prompt=p, max_new_tokens=5)
             for i, p in enumerate(_engine_prompts())]
    jeng.run(jreqs)
    tlm = TLM(tcfg, device="cpu").load_jax_params(
        jax.tree.map(np.asarray, params))
    eng = Engine(tlm, device="cpu", batch=2, max_len=32, buckets=BUCKETS,
                 mesh=tmesh.AbstractMesh((1, 4), ("data", "model")))
    reqs = [Request(uid=i, prompt=p, max_new_tokens=5)
            for i, p in enumerate(_engine_prompts())]
    eng.run(reqs)
    for j, t in zip(jreqs, reqs):
        assert t.output == j.output, t.uid
    rep = eng.plan_report()
    assert rep["not_ported"] == [] and "tp" in rep
    static = [p for m in tlm.modules() if isinstance(m, SparseLinear)
              for p in m._plans.values()]
    assert static
    per = rep["tp"]["per_plan"]
    assert {p.key for p in static} <= set(per)
    assert all(per[p.key]["mesh"] == {"data": 1, "model": 4}
               for p in static)
    assert rep["tp"]["totals"]["tp_planned"] >= len({p.key for p in static})
    jsparse.reset()


# -- the explicit route over gloo ranks --------------------------------------

def _rank_main(rank, world, init_file, case, in_path, out_dir):
    """One rank: gloo over ``init_file``, a ``DeviceMesh`` on the CPU, the
    case's runs; its results saved to ``out_dir/out<rank>.pt``.  Imports
    nothing of JAX."""
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


def _rank_tp(rank, world, inp):
    """The plain ``tp_spmm_shard_map`` and the ``static_tp_shardmap``
    route on a ``(q,)`` mesh (or ``(2, 2)`` with ``inp["two_axis"]``),
    forward and backward, for every problem of ``inp["problems"]``; and
    the auto race on the concrete mesh (both TP routes admissible)."""
    shape, names = ((2, 2), ("data", "model")) if inp["two_axis"] else \
        ((world,), ("model",))
    mesh = tmesh.make_device_mesh("cpu", shape, names)
    out = {"fp": sparse.PlanContext(mesh=mesh).mesh_fingerprint(),
           "concrete": tmesh.is_concrete(mesh)}
    for name, pr in inp["problems"].items():
        dt = getattr(torch, pr["dtype"])
        mask = pr["mask"].numpy()
        q = int(pr["q"])
        tb = TBSR.from_mask(mask, B, values=pr["vals"].to(dt))
        x = pr["x"].to(dt)
        cot = pr["cot"]
        # the plain formulation, [K, N]
        meta = tpart.plan_k_shards(tb, q, balanced=bool(pr["balanced"]))
        v = tb.values.clone().requires_grad_(True)
        xx = x.clone().requires_grad_(True)
        y = ttp.tp_spmm_shard_map(tpart.apply_k_shards(meta, v), xx,
                                  mesh=mesh, axis="model")
        (y.float() * cot).sum().backward()
        out[name + "/plain"] = {"y": y.detach().float(),
                                "dv": v.grad.float(), "dx": xx.grad.float()}
        # the plan route, [N, K]
        ctx = sparse.PlanContext(mode="static_tp_shardmap", mesh=mesh,
                                 tp_balanced=bool(pr["balanced"]))
        p = sparse.plan(tb, x.shape[1], device="cpu", ctx=ctx)
        v = tb.values.clone().requires_grad_(True)
        x2 = x.t().contiguous().requires_grad_(True)
        y = p.spmm_nt(v, x2)
        (y.float() * cot.t()).sum().backward()
        with torch.no_grad():
            y_eager = p.run_packed(p.pack(tb.values), x2.detach())
        out[name + "/plan"] = {
            "y": y.detach().t().float(), "dv": v.grad.float(),
            "dx": x2.grad.t().float(), "route": p.route,
            "shards": list(p.tp.shards),
            "same": bool(torch.equal(y_eager, y.detach()))}
    # the auto race on the concrete mesh, analytic then measured
    pr = inp["problems"][inp["race"]]
    tb = TBSR.from_mask(pr["mask"].numpy(), B, values=pr["vals"])
    x2 = pr["x"].t().contiguous()
    for measure in (False, True):
        p = sparse.plan(tb, x2.shape[0], x=x2, device="cpu",
                        ctx=sparse.PlanContext(mesh=mesh, measure=measure))
        out[f"race/{measure}"] = {
            "route": p.route, "est": sorted(p.est_seconds),
            "tp": p.explain()["tp"], "y": p.spmm_nt(tb.values, x2).t()}
    return out


def _rank_engine(rank, world, inp):
    """An eager engine on a concrete ``(world,)`` mesh serving the same
    requests on every rank; and the refusal of graphs over gloo."""
    from repro_torch.models.model import LM as TLM
    from repro_torch.serve import Engine, Request
    _, tcfg = inp["cfgs"]
    mesh = tmesh.make_device_mesh("cpu", (world,), ("model",))
    lm = TLM(tcfg, device="cpu", seed=0)
    refused = None
    try:
        Engine(lm, device="cpu", batch=2, max_len=32, buckets=BUCKETS,
               mesh=mesh, graphs=True)
    except NotImplementedError as e:
        refused = str(e)
    eng = Engine(lm, device="cpu", batch=2, max_len=32, buckets=BUCKETS,
                 mesh=mesh, graphs=False)
    reqs = [Request(uid=i, prompt=p.numpy(), max_new_tokens=5)
            for i, p in enumerate(inp["prompts"])]
    eng.run(reqs)
    rep = eng.plan_report()["tp"]
    return {"tokens": [r.output for r in reqs], "refused": refused,
            "routes": sorted({r["route"] for r in rep["per_plan"].values()}),
            "tp_planned": rep["totals"]["tp_planned"]}


_RANK_CASES = {"tp": _rank_tp, "engine": _rank_engine}


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


def _problem_inputs(pattern, q, balanced, dtype):
    mask = PATTERNS[pattern]()
    m, k = mask.shape[0] * B, mask.shape[1] * B
    vals, x, cot = _values(mask), _x(k), _cot(m)
    want = _jax_gspmd(mask, vals, x, cot, q, balanced, dtype)
    return ({"mask": torch.as_tensor(mask), "vals": torch.as_tensor(vals),
             "x": torch.as_tensor(x), "cot": torch.as_tensor(cot), "q": q,
             "balanced": balanced, "dtype": dtype}, want)


def _check_ranks(outs, inputs, wants, q):
    """Every rank's output equals the other ranks' and ``static_tp``'s,
    and the reference's; dL/dx the same; dL/dvalues of a rank is its own
    shard's blocks (zeros elsewhere), and the ranks' sum is the whole
    gradient."""
    for name, pr in inputs["problems"].items():
        dt = getattr(torch, pr["dtype"])
        tol = TOLS[pr["dtype"]]
        want = wants[name]
        tb = TBSR.from_mask(pr["mask"].numpy(), B, values=pr["vals"].to(dt))
        meta = tpart.plan_k_shards(tb, q, balanced=pr["balanced"])
        ref = sparse.plan(tb, N, device="cpu", ctx=sparse.PlanContext(
            mode="static_tp", tp_q=q, tp_balanced=pr["balanced"]))
        v = tb.values.clone().requires_grad_(True)
        x2 = pr["x"].to(dt).t().contiguous().requires_grad_(True)
        y_tp = ref.spmm_nt(v, x2)
        (y_tp.float() * pr["cot"].t()).sum().backward()
        for form in ("plain", "plan"):
            got = [o[f"{name}/{form}"] for o in outs]
            for o in got[1:]:
                assert torch.equal(o["y"], got[0]["y"]), (name, form)
                assert torch.equal(o["dx"], got[0]["dx"]), (name, form)
            _close(got[0]["y"], want["y"], tol, f"{name}/{form} y")
            _close(got[0]["dx"], want["dx"], tol, f"{name}/{form} dx")
            # one data replica's ranks: model coordinates 0 .. q - 1
            total = sum(o["dv"] for o in got[:q])
            _close(total, want["dv"], tol, f"{name}/{form} dvalues")
            # the mesh's model coordinate of each rank owns its shard
            for r, o in enumerate(got):
                j = r % q
                own = np.zeros(len(tb.row_idx), bool)
                own[meta.shard_source(j)] = True
                assert not o["dv"][~torch.as_tensor(own)].any(), (name, r)
            if pr["dtype"] == "float32":
                _close(got[0]["y"], y_tp.detach().t(), 1e-5, name)
                _close(got[0]["dx"], x2.grad.t(), 1e-5, name)
                _close(total, v.grad, 1e-5, name)
        for r, o in enumerate(outs):
            po = o[f"{name}/plan"]
            assert po["route"] == "static_tp_shardmap" and po["same"]
            assert po["shards"] == [r % q]


@pytest.mark.parametrize("q", [2, 4])
def test_shardmap_over_gloo_ranks(tmp_path, q):
    """``static_tp_shardmap`` and the plain ``tp_spmm_shard_map`` over q
    gloo ranks of a ``(q,)`` mesh: the skewed pattern in fp32 (balanced
    and even) and bf16; at q = 4 also fp16 and the pattern whose even
    splits leave two shards without a block.  Then the auto race on the
    concrete mesh: both TP routes priced, then timed, beside the
    unsharded routes."""
    jax, _, _, _, _ = _jax()
    cases = {"skewed_f32_bal": ("skewed", True, "float32"),
             "skewed_f32_even": ("skewed", False, "float32"),
             "skewed_bf16": ("skewed", True, "bfloat16")}
    if q == 4:
        cases.update({"skewed_f16": ("skewed", True, "float16"),
                      "empty_f32_even": ("empty_cols", False, "float32")})
    problems, wants = {}, {}
    for name, (pattern, balanced, dtype) in cases.items():
        problems[name], wants[name] = _problem_inputs(pattern, q, balanced,
                                                      dtype)
    inputs = {"problems": problems, "two_axis": False,
              "race": "skewed_f32_bal"}
    outs = _spawn(tmp_path, q, "tp", inputs)
    assert all(o["concrete"] for o in outs)
    assert all(o["fp"] == (("model",), (q,)) for o in outs)
    _check_ranks(outs, inputs, wants, q)
    if q == 4:
        meta = tpart.plan_k_shards(_tbsr(_empty_cols_mask(),
                                         _values(_empty_cols_mask())), 4,
                                   balanced=False)
        assert (meta.real_counts == 0).sum() == 2
    want = wants["skewed_f32_bal"]["y"]
    for o in outs:
        analytic, measured = o["race/False"], o["race/True"]
        assert {"static_tp", "static_tp_shardmap"} <= set(analytic["est"])
        assert analytic["tp"]["source"] == "analytic"
        assert analytic["tp"]["best_tp_route"] == "static_tp_shardmap"
        assert analytic["tp"]["mesh"] == {"model": q}
        assert measured["tp"]["source"] == "measured"
        assert {"static_tp", "static_tp_shardmap"} <= set(measured["est"])
        for r in (analytic, measured):
            _close(r["y"], want, 1e-5)
    assert len({o["race/True"]["route"] for o in outs}) == 1


def test_shardmap_on_two_axis_mesh(tmp_path):
    """``test_tp_shard_map_on_two_axis_mesh``: a ``(2, 2)`` ``("data",
    "model")`` mesh over 4 ranks shards over "model" only; both data
    replicas compute the same output and gradients."""
    jax, _, _, _, _ = _jax()
    problems, wants = {}, {}
    problems["skewed"], wants["skewed"] = _problem_inputs("skewed", 2, True,
                                                          "float32")
    inputs = {"problems": problems, "two_axis": True, "race": "skewed"}
    outs = _spawn(tmp_path, 4, "tp", inputs)
    assert all(o["fp"] == (("data", "model"), (2, 2)) for o in outs)
    _check_ranks(outs, inputs, wants, 2)


def test_engine_over_gloo_mesh(tmp_path):
    """Two ranks, each with an eager engine on a concrete ``(2,)`` mesh:
    identical tokens on both, equal to the unsharded engine's on the
    same weights, the FFN plans on ``static_tp_shardmap``; and
    ``graphs=True`` over gloo is refused at construction."""
    from repro_torch.models.model import LM as TLM
    from repro_torch.serve import Engine, Request
    jcfg, tcfg = _engine_cfgs()
    prompts = _engine_prompts()
    eng = Engine(TLM(tcfg, device="cpu", seed=0), device="cpu", batch=2,
                 max_len=32, buckets=BUCKETS)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=5)
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    outs = _spawn(tmp_path, 2, "engine",
                  {"cfgs": (None, tcfg),
                   "prompts": [torch.as_tensor(p) for p in prompts]})
    for o in outs:
        assert o["tokens"] == [r.output for r in reqs]
        assert o["refused"] is not None and "gloo" in o["refused"]
        assert "static_tp_shardmap" in o["routes"]
        assert o["tp_planned"] > 0
