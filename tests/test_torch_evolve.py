"""RigL topology updates on the port's static plans (``core/pruning.py``,
``partitioner.plan_evolution``/``apply_evolution``, ``MatmulPlan.evolve``,
``SparseLinear.evolve``, ``train.step.rigl_evolve``) against the JAX
package on the same numpy-seeded inputs, on the CPU.

Mirrors ``tests/test_evolve.py`` (the JAX ``jit`` case becomes autograd)
and the ``rigl_update`` tests of ``tests/test_dynamic.py``, and adds what
the port's mutable modules need: the optimizer's slots carried with the
values, an LM's layers that share a plan, and a graph program that holds
a superseded plan.  Budgets: ``tests/conftest.py``'s fp32 1e-4 (rel-max);
masks, slot maps and carried values are compared exactly.
"""
import gc
import json
import os
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import assert_close_for_dtype  # noqa: E402
from repro import sparse as jsparse  # noqa: E402
from repro.core import masks as jmasks  # noqa: E402
from repro.core import partitioner as jpart  # noqa: E402
from repro.core import pruning as jpruning  # noqa: E402
from repro.core import sparse_layers as jsl  # noqa: E402
from repro.core.bsr import BlockSparseMatrix as JBSR  # noqa: E402
from repro.train.step import rigl_evolve as jrigl_evolve  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import sparse  # noqa: E402
from repro_torch.core import capture  # noqa: E402
from repro_torch.core import partitioner, pruning  # noqa: E402
from repro_torch.core import sparse_layers as tsl  # noqa: E402
from repro_torch.core.bsr import BlockSparseMatrix as TBSR  # noqa: E402
from repro_torch.core.bsr import check_unique_blocks  # noqa: E402
from repro_torch.models.model import LM as TLM  # noqa: E402
from repro_torch.optim.adamw import adamw_init, adamw_update  # noqa: E402
from repro_torch.serve import Engine, Request  # noqa: E402
from repro_torch.serve.graphs import Program  # noqa: E402
from repro_torch.sparse import cache as cache_lib  # noqa: E402
from repro_torch.train.step import (TrainState,  # noqa: E402
                                    evolve_sparse_layer, rigl_evolve)

M = K = 256
B = 16
N = 32


@pytest.fixture(autouse=True)
def _fresh():
    sparse.reset()
    sparse.configure(None)
    jsparse.reset()
    yield
    sparse.reset()
    sparse.configure(None)
    jsparse.reset()


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _problem(density=0.25, seed=0):
    """The same pattern, values and ``x`` for both packages: the port's
    BSR, the JAX BSR and ``x`` as ``[N, K]`` numpy (the JAX plan takes
    its transpose)."""
    mask = jmasks.random_block_mask(M, K, B, density, seed=seed)
    rng = np.random.default_rng(seed)
    rows, cols = np.nonzero(mask)
    vals = rng.standard_normal((len(rows), B, B)).astype(np.float32)
    x = rng.standard_normal((N, K)).astype(np.float32)
    tb = TBSR.from_mask(mask, B, values=_t(vals))
    jb = JBSR(jnp.asarray(vals), tb.row_idx, tb.col_idx, (M, K), B)
    return mask, tb, jb, x


def _plan(tb, x, **ctx):
    return sparse.plan(tb, N, x=_t(x), device="cpu",
                       ctx=sparse.PlanContext(**ctx))


def _move_one(mask):
    """Constant-nnz single-block move (the minimal topology update)."""
    new = mask.copy()
    r, c = np.nonzero(new)
    zr, zc = np.nonzero(~new)
    new[r[0], c[0]] = False
    new[zr[0], zc[0]] = True
    return new


def _dense(values, pattern, shape=(M, K)):
    rows, cols = pattern
    return TBSR(values, rows, cols, shape, B).to_dense()


# -- verdict reuse ------------------------------------------------------------

def test_evolve_runs_zero_decisions_and_measurements():
    mask, tb, jb, x = _problem()
    p = _plan(tb, x)
    s0 = sparse.cache_stats()
    p2 = p.evolve(_move_one(mask))
    s1 = sparse.cache_stats()
    assert s1["decisions"] == s0["decisions"]
    assert s1["measurements"] == s0["measurements"]
    assert s1["plans_built"] == s0["plans_built"] + 1
    assert p2.route == p.route and p2.source == p.source
    ev = p2.explain()["evolution"]
    assert ev["generation"] == 1 and not ev["reraced"]
    assert ev["carried"] == len(tb.row_idx) - 1
    assert ev["dropped"] == 1 and ev["grown"] == 1
    # the lineage counts are the reference's
    jp = jsparse.plan(jb, N, x=jnp.asarray(x.T), ctx=jsparse.PlanContext())
    jev = jp.evolve(_move_one(mask)).explain()["evolution"]
    for k in ("generation", "carried", "dropped", "grown", "density"):
        assert ev[k] == jev[k], k
    assert "evolution: gen 1" in sparse.format_plan(p2)


def test_evolve_reuses_backward_verdicts():
    mask, tb, _, x = _problem()
    p = _plan(tb, x)
    g = p.explain()["grad"]
    assert g["mode"] == "planned"
    p2 = p.evolve(_move_one(mask))
    g2 = p2.explain()["grad"]
    assert g2["mode"] == "planned" and g2["evolved"]
    assert g2["dx"]["route"] == g["dx"]["route"]
    assert g2["dvalues"]["route"] == g["dvalues"]["route"]
    assert p2.grad_routes == p.grad_routes
    assert not g2["from_disk"]


def test_evolved_plan_registers_in_plan_cache():
    mask, tb, _, x = _problem()
    p = _plan(tb, x)
    new_mask = _move_one(mask)
    p2 = p.evolve(new_mask)
    vals = torch.randn((int(new_mask.sum()), B, B),
                       generator=torch.Generator().manual_seed(9))
    tb2 = TBSR.from_mask(new_mask, B, values=vals)
    s0 = sparse.cache_stats()
    y = sparse.spmm(tb2, _t(x).t())          # must be a plan-cache hit
    s1 = sparse.cache_stats()
    assert s1["decisions"] == s0["decisions"]
    assert s1["plan_hits"] == s0["plan_hits"] + 1
    assert sparse.plan(tb2, N, device="cpu",
                       ctx=sparse.PlanContext()) is p2
    assert_close_for_dtype(y, tb2.to_dense() @ _t(x).t(), "float32",
                           "spmm on the evolved pattern")


def test_evolve_plans_moves_every_cached_plan():
    """The module-level hook evolves every cached plan on the old
    pattern (each token count): the next plan of the new pattern at
    either count is a hit with no decision."""
    mask, tb, _, x = _problem()
    p32 = _plan(tb, x)
    p8 = sparse.plan(tb, 8, device="cpu", ctx=sparse.PlanContext())
    new_mask = _move_one(mask)
    tb2 = TBSR.from_mask(new_mask, B)
    assert sparse.evolve_plans(tb, tb2) == 2
    assert p32.superseded and p8.superseded
    s0 = sparse.cache_stats()
    for n in (N, 8):
        q = sparse.plan(tb2, n, device="cpu", ctx=sparse.PlanContext())
        assert q.explain()["evolution"]["generation"] == 1
    s1 = sparse.cache_stats()
    assert s1["decisions"] == s0["decisions"]
    assert s1["plan_hits"] == s0["plan_hits"] + 2
    assert sparse.evolve(p8, tb2) is sparse.plan(tb2, 8, device="cpu")


# -- value carry --------------------------------------------------------------

def test_carry_values_round_trip():
    """A grow-only superset and back hands every original value back bit
    for bit; the grown blocks start at zero, as the reference's."""
    mask, tb, jb, x = _problem(density=0.125)
    sup = mask.copy()
    zr, zc = np.nonzero(~sup)
    sup[zr[:5], zc[:5]] = True
    p = _plan(tb, x)
    p_up = p.evolve(sup)
    v_up = p_up.carry_values(tb.values)
    assert v_up.shape[0] == len(tb.row_idx) + 5
    v_back = p_up.evolve(mask).carry_values(v_up)
    assert torch.equal(v_back, tb.values)
    ep = p_up.artifacts["_evolve"]
    assert not v_up[torch.from_numpy(ep.src_slot < 0)].any()
    jp = jsparse.plan(jb, N, ctx=jsparse.PlanContext()).evolve(sup)
    assert np.array_equal(np.asarray(jp.carry_values(jb.values)),
                          v_up.numpy())


def test_evolved_plan_matches_dense_and_jax():
    mask, tb, jb, x = _problem()
    new_mask = _move_one(mask)
    p2 = _plan(tb, x).evolve(new_mask)
    vals = p2.carry_values(tb.values)
    y = p2.spmm_nt(vals, _t(x))
    assert_close_for_dtype(y, _t(x) @ _dense(vals, p2.pattern).t(),
                           "float32", "evolved plan vs dense")
    jp2 = jsparse.plan(jb, N, ctx=jsparse.PlanContext()).evolve(new_mask)
    jv = jp2.carry_values(jb.values)
    assert_close_for_dtype(y.t(), jp2(jv, jnp.asarray(x.T)), "float32",
                           "evolved plan vs the JAX evolved plan")


# -- drift guardrail ----------------------------------------------------------

def test_drift_trip_reraces():
    mask, tb, _, x = _problem(density=1 / 16)
    p = _plan(tb, x)
    dense_mask = jmasks.random_block_mask(M, K, B, 0.5, seed=3)
    s0 = sparse.cache_stats()
    p2 = p.evolve(dense_mask)          # 8x the density: past 0.25
    s1 = sparse.cache_stats()
    ev = p2.explain()["evolution"]
    assert ev["drift_tripped"] and ev["reraced"]
    assert ev["drift"] > 0.25
    assert s1["decisions"] > s0["decisions"]
    assert ev["ref_density"] == ev["density"]
    totals = sparse.plan_report()["totals"]["evolution"]
    assert totals["reraces"] == 1 and totals["drift_trips"] == 1


def test_rerace_flag_forces_rerace():
    mask, tb, _, x = _problem()
    p = _plan(tb, x)
    s0 = sparse.cache_stats()
    p2 = p.evolve(_move_one(mask), rerace=True)
    s1 = sparse.cache_stats()
    ev = p2.explain()["evolution"]
    assert ev["reraced"] and not ev["drift_tripped"]
    assert s1["decisions"] > s0["decisions"]


@pytest.mark.parametrize("thr, trips", [(0.0, True), (None, False)])
def test_evolve_drift_knob(thr, trips):
    """0.0 re-races on any change of the profile, None never."""
    mask, tb, _, x = _problem()
    p = _plan(tb, x, evolve_drift=thr)
    new = mask.copy()
    r, c = np.nonzero(new)
    new[r[0], c[0]] = False            # drop one block: density moves
    ev = p.evolve(new).explain()["evolution"]
    assert ev["drift_tripped"] is trips
    assert ev["reraced"] is trips


def test_evolve_drift_validated():
    with pytest.raises(ValueError, match="evolve_drift"):
        sparse.PlanContext(evolve_drift=-0.5)
    with pytest.raises(ValueError, match="evolve_drift"):
        jsparse.PlanContext(evolve_drift=-0.5)


def test_evolve_drift_in_mem_key():
    _, tb, _, _ = _problem()
    p1 = sparse.plan(tb, N, device="cpu",
                     ctx=sparse.PlanContext(evolve_drift=0.25))
    p2 = sparse.plan(tb, N, device="cpu",
                     ctx=sparse.PlanContext(evolve_drift=None))
    assert p1 is not p2 and p1.key == p2.key


def test_drift_profile_prices_what_the_walk_models_price():
    """b = 16 walks each block as its tile: occupancy is 1.0 whatever
    the pattern (the reference's 128-tile occupancy is not), so a
    constant-nnz move drifts only through the skew factor."""
    mask, tb, _, x = _problem()
    ev = _plan(tb, x).evolve(_move_one(mask)).explain()["evolution"]
    assert ev["occupancy"] == ev["ref_occupancy"] == 1.0
    assert ev["density"] == ev["ref_density"]
    assert ev["drift"] == pytest.approx(
        abs(ev["skew"] - ev["ref_skew"]) / ev["ref_skew"], abs=1e-6)


# -- autograd -----------------------------------------------------------------

def test_evolved_plan_grads_match_dense_and_jax():
    mask, tb, jb, x = _problem()
    new_mask = _move_one(mask)
    p2 = _plan(tb, x).evolve(new_mask)
    vals = p2.carry_values(tb.values).requires_grad_(True)
    xt = _t(x).requires_grad_(True)
    (p2.spmm_nt(vals, xt) ** 2).sum().backward()
    v_ref = vals.detach().clone().requires_grad_(True)
    x_ref = _t(x).requires_grad_(True)
    ((x_ref @ _dense(v_ref, p2.pattern).t()) ** 2).sum().backward()
    assert_close_for_dtype(vals.grad, v_ref.grad, "float32", "dvalues")
    assert_close_for_dtype(xt.grad, x_ref.grad, "float32", "dx")
    jp2 = jsparse.plan(jb, N, ctx=jsparse.PlanContext()).evolve(new_mask)
    jv = jp2.carry_values(jb.values)
    jg = jax.grad(lambda v: jnp.sum(jp2(v, jnp.asarray(x.T)) ** 2))(jv)
    assert_close_for_dtype(vals.grad, jg, "float32", "dvalues vs JAX")


# -- a dynamic-sparse-training loop -------------------------------------------

def test_rigl_training_loop_constant_nnz_zero_reraces():
    mask, tb, _, x = _problem(density=0.25)
    p = _plan(tb, x)
    vals = tb.values
    nnz = vals.shape[0]
    gen = torch.Generator().manual_seed(0)
    s0 = sparse.cache_stats()
    for step in range(20):
        xb = torch.randn((N, K), generator=gen)
        y = p.spmm_nt(vals, xb)                          # [N, M]
        p, vals = rigl_evolve(p, vals, y.t() @ xb, fraction=0.2,
                              generator=gen)
        assert vals.shape[0] == nnz
    s1 = sparse.cache_stats()
    assert s1["measurements"] == s0["measurements"]
    assert s1["decisions"] == s0["decisions"]
    totals = sparse.plan_report()["totals"]["evolution"]
    assert totals["evolves"] == 20 and totals["reraces"] == 0
    assert p.explain()["evolution"]["generation"] == 20
    # the superseded generations are freed: only the live plan is held
    assert totals["evolved_plans"] == 1
    assert_close_for_dtype(p.spmm_nt(vals, _t(x)),
                           _t(x) @ _dense(vals, p.pattern).t(), "float32",
                           "after 20 topology steps")


def test_rigl_evolve_chain_matches_jax():
    """Five topology steps in both packages on the same dense gradients:
    the same pattern and bit-equal carried values at every step (the
    grown blocks tie at zero from the second step: the stable drop order
    keeps both packages on the same blocks)."""
    mask, tb, jb, x = _problem(density=0.25, seed=4)
    p = _plan(tb, x)
    jp = jsparse.plan(jb, N, ctx=jsparse.PlanContext())
    vals, jvals = tb.values, jb.values
    rng = np.random.default_rng(7)
    gen = torch.Generator().manual_seed(1)
    key = jax.random.PRNGKey(1)
    for _ in range(5):
        dg = rng.standard_normal((M, K)).astype(np.float32)
        key, sub = jax.random.split(key)
        p, vals = rigl_evolve(p, vals, _t(dg), fraction=0.2, generator=gen)
        jp, jvals = jrigl_evolve(jp, jvals, jnp.asarray(dg), fraction=0.2,
                                 rng=sub)
        assert np.array_equal(p.pattern[0], np.asarray(jp.pattern[0]))
        assert np.array_equal(p.pattern[1], np.asarray(jp.pattern[1]))
        assert np.array_equal(vals.numpy(), np.asarray(jvals))


def test_sparse_linear_evolve_matches_jax():
    jl = jsl.SparseLinear.random_pattern(None, K, M, B, 0.25, seed=1)
    params = jl.init(jax.random.PRNGKey(3))
    x = np.random.default_rng(4).standard_normal((8, K)).astype(np.float32)
    tl = tsl.SparseLinear.random_pattern(K, M, B, 0.25, seed=1,
                                         device="cpu")
    with torch.no_grad():
        tl.values.copy_(_t(params["values"]))
    assert_close_for_dtype(tl(_t(x)), jl.apply(params, jnp.asarray(x)),
                           "float32", "before")
    new_mask = _move_one(tl.pattern)
    old_plan = tl.plan(8)
    s0 = sparse.cache_stats()
    ep = tl.evolve(new_mask)
    y = tl(_t(x))
    s1 = sparse.cache_stats()
    assert s1["decisions"] == s0["decisions"]          # evolved, not planned
    assert np.array_equal(tl.pattern, new_mask)
    assert (ep.carried, ep.dropped, ep.grown) == (tl.nnz_blocks - 1, 1, 1)
    assert tl.plan(8) is not old_plan and tl.plan(8).pattern[0] is not None
    assert tl.plan(8).explain()["evolution"]["generation"] == 1
    jl2, params2 = jl.evolve(new_mask, params)
    assert np.array_equal(tl.values.detach().numpy(),
                          np.asarray(params2["values"]))
    assert_close_for_dtype(y, jl2.apply(params2, jnp.asarray(x)), "float32",
                           "SparseLinear.evolve vs the JAX layer's")


def test_sparse_linear_evolve_changes_nnz():
    tl = tsl.SparseLinear.random_pattern(K, M, B, 0.25, seed=2,
                                         device="cpu")
    tl.reset_parameters(torch.Generator().manual_seed(0))
    tl.requires_grad_(True)
    x = torch.randn((5, K), generator=torch.Generator().manual_seed(1))
    tl(x).sum().backward()
    old_vals, old_grad = tl.values.detach().clone(), tl.values.grad.clone()
    grown = tl.pattern.copy()
    zr, zc = np.nonzero(~grown)
    grown[zr[:3], zc[:3]] = True
    ep = tl.evolve(grown)
    assert tl.values.shape[0] == old_vals.shape[0] + 3
    assert tl.values.requires_grad
    assert torch.equal(tl.values.detach(),
                       partitioner.apply_evolution(ep, old_vals))
    assert torch.equal(tl.values.grad,
                       partitioner.apply_evolution(ep, old_grad))
    with torch.no_grad():
        y = tl(x)
        want = x @ tl.as_bsr().to_dense().t()
    assert_close_for_dtype(y, want, "float32", "after a growing evolve")


# -- validation ---------------------------------------------------------------

def test_evolve_rejects_wrong_geometry():
    _, tb, _, x = _problem()
    p = _plan(tb, x)
    with pytest.raises(ValueError, match="grid"):
        p.evolve(np.ones((4, 4), bool))
    with pytest.raises(ValueError, match="duplicate"):
        p.evolve((np.array([0, 0], np.int32), np.array([0, 0], np.int32)))
    dyn = sparse.plan(sparse.OpSpec(kind="dynamic", m=M, k=K, n=N,
                                    block_size=B, density=0.25,
                                    dtype="float32"), device="cpu")
    with pytest.raises(ValueError, match="static spmm"):
        dyn.evolve(np.ones((M // B, K // B), bool))


def test_duplicate_blocks_rejected_everywhere():
    dup_r = np.array([0, 1, 0], np.int32)
    dup_c = np.array([2, 3, 2], np.int32)
    with pytest.raises(ValueError, match="duplicate"):
        partitioner.plan_packing(dup_r, dup_c, (64, 64), 16)
    with pytest.raises(ValueError, match="duplicate"):
        partitioner.plan_evolution(dup_r, dup_c, dup_r[:1], dup_c[:1],
                                   (4, 4))
    with pytest.raises(ValueError, match="duplicate"):
        check_unique_blocks(dup_r, dup_c, (4, 4))


def test_balance_report_empty_counts():
    empty = np.array([], np.int64)
    assert partitioner.balance_report(empty) == jpart.balance_report(empty)


# -- persistence --------------------------------------------------------------

def _path(d, version=cache_lib.SCHEMA_VERSION):
    return os.path.join(str(d), f"sparse-plans-torch-v{version}.json")


def test_evolution_lineage_persists_and_replays(tmp_path):
    mask, tb, _, x = _problem()
    ctx = dict(cache_dir=str(tmp_path))
    p = _plan(tb, x, **ctx)
    new_mask = _move_one(mask)
    p2 = p.evolve(new_mask)
    with open(_path(tmp_path)) as f:
        rec = json.load(f)["entries"][p2.key]
    assert rec["evolution"]["generation"] == 1
    assert rec["evolution"]["reraced"] is False
    assert rec["route"] == p2.route and "grad" in rec
    # a restart: the evolved pattern replays its forward and backward
    # verdicts from disk with zero measurements and zero decisions
    sparse.reset()
    tb2 = TBSR.from_mask(new_mask, B, values=torch.randn(
        (int(new_mask.sum()), B, B), generator=torch.Generator().manual_seed(5)))
    p3 = sparse.plan(tb2, N, device="cpu", ctx=sparse.PlanContext(**ctx))
    s = sparse.cache_stats()
    assert p3.from_disk and s["measurements"] == 0 and s["decisions"] == 0
    assert p3.route == p2.route
    assert p3.grad_routes == p2.grad_routes
    assert p3.explain()["grad"]["from_disk"]


def test_pre_evolution_v1_cache_file_invalidated(tmp_path):
    """A v1 file (no evolution lineage) is never read: its verdicts are
    not replayed, whether it keeps its own name or sits at the current
    schema's path with its v1 env."""
    _, tb, _, x = _problem()
    ctx = dict(cache_dir=str(tmp_path))
    key = _plan(tb, x, **ctx).key
    env = json.load(open(_path(tmp_path)))["env"]
    sparse.reset()
    os.remove(_path(tmp_path))
    old = {"env": dict(env, schema=1),
           "entries": {key: {"route": "static_balanced_torch",
                             "source": "measured", "est_seconds": {}}}}
    for path in (_path(tmp_path, 1), _path(tmp_path)):
        with open(path, "w") as f:
            json.dump(old, f)
        sparse.reset()
        p = _plan(tb, x, **ctx)
        assert not p.from_disk
        assert p.route != "static_balanced_torch" or p.source != "measured"
        os.remove(_path(tmp_path))
    assert cache_lib.SCHEMA_VERSION == 3


# -- rigl_update (tests/test_dynamic.py) ---------------------------------------

def _w_g_mask(density, seed=0, m=64, b=8, zero_grad=False):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((m, m)).astype(np.float32)
    g = (np.zeros((m, m), np.float32) if zero_grad
         else rng.standard_normal((m, m)).astype(np.float32))
    mask = jmasks.random_block_mask(m, m, b, density, seed=seed + 2)
    return w, g, mask


def _rigl(w, g, mask, b, fraction, seed):
    return pruning.rigl_update(_t(w), _t(g), torch.from_numpy(mask),
                               block_size=b, fraction=fraction,
                               generator=torch.Generator().manual_seed(seed))


def test_rigl_update_preserves_density():
    w, g, mask = _w_g_mask(0.5)
    new = _rigl(w, g, mask, 8, 0.3, 3)
    assert int(new.sum()) == int(mask.sum())
    assert bool((new.numpy() != mask).any())


@pytest.mark.parametrize("density, fraction", [(0.9, 1.0), (1.0, 1.0),
                                               (0.95, 0.7)])
def test_rigl_update_clamps_move_count_at_high_density(density, fraction):
    w, g, mask = _w_g_mask(density)
    new = _rigl(w, g, mask, 8, fraction, 3)
    assert int(new.sum()) == int(mask.sum())
    want = jpruning.rigl_update(jnp.asarray(w), jnp.asarray(g),
                                jnp.asarray(mask), block_size=8,
                                fraction=fraction, rng=jax.random.PRNGKey(3))
    assert int(np.asarray(want).sum()) == int(new.sum())


def test_rigl_update_generator_breaks_grow_ties():
    """An all-zero gradient makes every inactive block a grow tie: the
    regrowth follows the generator, not the block index."""
    w, g, mask = _w_g_mask(0.25, zero_grad=True)
    grown = set()
    for seed in range(4):
        new = _rigl(w, g, mask, 8, 0.5, seed).numpy()
        assert int(new.sum()) == int(mask.sum())
        grown.add(tuple(np.flatnonzero(new & ~mask).tolist()))
    assert len(grown) > 1, "regrowth ignored the generator on tied scores"


@pytest.mark.parametrize("density, fraction, seed, zero_blocks",
                         [(0.25, 0.2, 0, 0), (0.5, 0.3, 1, 0),
                          (0.125, 0.5, 2, 0), (0.25, 0.4, 3, 5)])
def test_rigl_update_mask_equals_jax(density, fraction, seed, zero_blocks):
    """Exact mask equality with the JAX step where the grow scores do
    not tie (a dense random gradient); ``zero_blocks`` active blocks of
    W are zero, so their drop scores tie and the stable order decides."""
    w, g, mask = _w_g_mask(density, seed=seed)
    r, c = np.nonzero(mask)
    for i in range(zero_blocks):
        w[r[i] * 8:(r[i] + 1) * 8, c[i] * 8:(c[i] + 1) * 8] = 0.0
    got = _rigl(w, g, mask, 8, fraction, seed).numpy()
    want = np.asarray(jpruning.rigl_update(
        jnp.asarray(w), jnp.asarray(g), jnp.asarray(mask), block_size=8,
        fraction=fraction, rng=jax.random.PRNGKey(seed)))
    assert np.array_equal(got, want)
    assert (got & ~mask).sum() == int(np.float32(mask.sum())
                                      * np.float32(fraction))


def test_magnitude_prune_mask_and_schedule_match_jax():
    w = np.random.default_rng(0).standard_normal((64, 96)).astype(np.float32)
    mask = pruning.magnitude_block_prune(w, 16, 0.25)
    assert np.array_equal(mask, jpruning.magnitude_block_prune(w, 16, 0.25))
    assert np.array_equal(
        pruning.apply_block_mask(_t(w), torch.from_numpy(mask), 16).numpy(),
        np.asarray(jpruning.apply_block_mask(jnp.asarray(w),
                                             jnp.asarray(mask), 16)))
    kw = dict(start_step=10, end_step=110, initial=1.0, final=0.1)
    for step in (0, 10, 35, 60, 109, 110, 500):
        assert pruning.density_schedule(step, **kw) == \
            jpruning.density_schedule(step, **kw)


def test_dynamic_sparse_linear_rigl_mask_matches_jax():
    """``rigl_update`` drives ``DynamicSparseLinear``'s mask
    (``tests/test_sparse_layers.py``): the same mask as the JAX step on
    the same weight and gradient, and the layer's output on it equal to
    the JAX layer's."""
    jl = jsl.DynamicSparseLinear(64, 64, 16, d_max=0.25)
    params = jl.init(jax.random.PRNGKey(0))
    x = np.random.default_rng(1).standard_normal((4, 64)).astype(np.float32)
    tl = tsl.DynamicSparseLinear(64, 64, 16, 0.25, device="cpu")
    tl.load_jax_params(jax.tree.map(np.asarray, params))
    y0 = tl(_t(x)).detach()
    # RigL's dense-position gradient of sum(y^2): dy^T . x at every
    # block (autograd through the encoder is zero off the mask, where
    # every grow score would tie)
    g = 2.0 * np.asarray(jl.apply(params, jnp.asarray(x))).T @ x
    jmask = jpruning.rigl_update(params["w"], jnp.asarray(g),
                                 params["mask"], block_size=16,
                                 fraction=0.5, rng=jax.random.PRNGKey(2))
    tmask = pruning.rigl_update(tl.weight.detach(), _t(g), tl.mask,
                                block_size=16, fraction=0.5,
                                generator=torch.Generator().manual_seed(2))
    assert np.array_equal(tmask.numpy(), np.asarray(jmask))
    tl.set_mask(tmask)
    y1 = tl(_t(x)).detach()
    assert (y1 - y0).abs().max() > 1e-6
    assert_close_for_dtype(y1, jl.apply({**params, "mask": jmask},
                                        jnp.asarray(x)), "float32",
                           "DynamicSparseLinear on the RigL mask")


# -- the evolution's two halves -----------------------------------------------

@pytest.mark.parametrize("case", ["move", "grow", "shrink", "from_empty",
                                  "shuffled"])
def test_plan_and_apply_evolution_match_jax(case):
    grid = (16, 12)
    rng = np.random.default_rng(3)
    old = rng.random(grid) < 0.3
    new = old.copy()
    if case == "move":
        new = _move_one(old)
    elif case == "grow":
        new |= rng.random(grid) < 0.2
    elif case == "shrink":
        new &= rng.random(grid) < 0.5
    elif case == "from_empty":
        old[:] = False
    else:
        new = rng.random(grid) < 0.3
    o_r, o_c = np.nonzero(old)
    n_r, n_c = np.nonzero(new)
    if case == "shuffled":             # neither pattern needs sorting
        perm = rng.permutation(len(n_r))
        n_r, n_c = n_r[perm], n_c[perm]
    ep = partitioner.plan_evolution(o_r, o_c, n_r, n_c, grid)
    jep = jpart.plan_evolution(o_r, o_c, n_r, n_c, grid)
    assert np.array_equal(ep.src_slot, jep.src_slot)
    assert (ep.carried, ep.dropped, ep.grown) == \
        (jep.carried, jep.dropped, jep.grown)
    vals = rng.standard_normal((len(o_r), 4, 4)).astype(np.float32)
    got = partitioner.apply_evolution(ep, torch.from_numpy(vals))
    assert np.array_equal(got.numpy(), np.asarray(
        jpart.apply_evolution(jep, jnp.asarray(vals))))
    # any per-slot tensor: an optimizer's [nnz, b, b] moments, or a
    # [nnz] vector
    vec = torch.arange(len(o_r), dtype=torch.float32) + 1
    got_v = partitioner.apply_evolution(ep, vec)
    assert torch.equal(got_v, torch.where(
        torch.from_numpy(ep.src_slot) >= 0,
        torch.from_numpy(ep.src_slot).float() + 1, torch.zeros(())))


# -- what the port's mutable modules need --------------------------------------

def test_adamw_slots_carried_with_the_values():
    """One AdamW step after an evolve equals a fresh ``adamw_init`` on
    the evolved layer with the moments carried by hand; without the
    carry the next step writes the old slot order back over the
    values."""
    def trained_layer():
        layer = tsl.SparseLinear.random_pattern(K, M, B, 0.25, seed=6,
                                                device="cpu")
        layer.reset_parameters(torch.Generator().manual_seed(6))
        layer.requires_grad_(True)
        params = {"values": layer.values}
        state = TrainState(0, params, adamw_init(params))
        gen = torch.Generator().manual_seed(7)
        for _ in range(3):
            g = {"values": torch.randn(layer.values.shape, generator=gen)}
            adamw_update(g, state.opt, state.params, lr=1e-2)
        state.opt.count = 3
        return layer, state

    layer, state = trained_layer()
    new_mask = jmasks.random_block_mask(M, K, B, 0.25, seed=8)
    mu, nu = state.opt.mu["values"].clone(), state.opt.nu["values"].clone()
    ep = evolve_sparse_layer(state, "values", layer, new_mask)
    assert state.params["values"] is layer.values
    g = {"values": torch.randn(layer.values.shape,
                               generator=torch.Generator().manual_seed(9))}
    ref_vals = layer.values.detach().clone()
    ref = adamw_init({"values": ref_vals})
    ref.count = 3
    ref.mu["values"] = partitioner.apply_evolution(ep, mu)
    ref.nu["values"] = partitioner.apply_evolution(ep, nu)
    adamw_update(g, state.opt, state.params, lr=1e-2)
    adamw_update(g, ref, {"values": ref_vals}, lr=1e-2)
    assert torch.equal(layer.values.detach(), ref_vals)
    grown = torch.from_numpy(ep.src_slot < 0)
    # the grown slots started at zero in the master and both moments
    assert torch.equal(state.opt.master["values"][grown],
                       ref.master["values"][grown])

    layer, state = trained_layer()            # the carry skipped
    layer.evolve(new_mask)
    adamw_update(g, state.opt, state.params, lr=1e-2)
    assert not torch.equal(layer.values.detach(), ref_vals)


def _sparse_lm():
    cfg = tconfigs.sparsify_ffn(tconfigs.smoke("llama3_2_1b"), 0.25)
    return TLM(cfg, device="cpu", seed=0)


def _ffns(lm):
    return [m for m in lm.modules() if isinstance(m, tsl.SparseFFN)]


def test_shared_plan_stays_live_for_the_other_layers():
    """An LM's layers share one plan per projection (one seed): the
    first layer's evolve leaves the others on the old plan, live, and
    their outputs unchanged; the next layer evolved onto the same mask
    shares the first one's evolved plan."""
    lm = _sparse_lm()
    ffns = _ffns(lm)
    assert len(ffns) >= 2
    x = torch.randn((6, ffns[0].up.in_features),
                    generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        before = [f(x) for f in ffns]
    old = ffns[0].up.plan(6)
    assert all(f.up.plan(6) is old for f in ffns)
    new_mask = _move_one(ffns[0].up.pattern)
    ffns[0].up.evolve(new_mask)
    assert sparse.is_live(old) and old.superseded
    assert all(f.up.plan(6) is old for f in ffns[1:])
    with torch.no_grad():
        after = [f(x) for f in ffns]
    for b4, af in zip(before[1:], after[1:]):
        assert torch.equal(b4, af)
    assert not torch.equal(before[0], after[0])
    s0 = sparse.cache_stats()
    ffns[1].up.evolve(new_mask)
    assert ffns[1].up.plan(6) is ffns[0].up.plan(6)
    assert sparse.cache_stats()["plans_built"] == s0["plans_built"]
    for f in ffns:
        f.up.evolve(new_mask)
    gone = weakref.ref(old)
    del old
    gc.collect()
    assert gone() is None          # nothing holds the old plan: freed


def test_program_holding_a_superseded_plan_is_stale():
    """A graph program's record holds the plans it ran; an evolve that
    moves a module off one of them marks the program stale (its graph is
    re-captured before the next replay).  The graph itself needs a card;
    here the program's record is the capture's bookkeeping alone."""
    layer = tsl.SparseLinear.random_pattern(K, M, B, 0.25, seed=1,
                                            device="cpu")
    x = torch.randn((4, K))
    prog = Program("p", lambda io: layer(x), 1, device=torch.device("cpu"),
                   graph=False, ctx=sparse.PlanContext())
    with capture.recording() as rec:
        prog.run_eager()
    prog._plans = tuple(o for o in rec.held.values()
                        if isinstance(o, sparse.MatmulPlan))
    prog._epoch = sparse.supersede_epoch()
    assert prog._plans and not prog.superseded()
    other = tsl.SparseLinear.random_pattern(K, M, B, 0.25, seed=2,
                                            device="cpu")
    other(x)
    other.evolve(_move_one(other.pattern))      # another plan moved
    assert not prog.superseded() and prog._epoch == sparse.supersede_epoch()
    layer.evolve(_move_one(layer.pattern))
    assert prog.superseded() and prog.stale


def test_eager_engine_after_evolve_equals_a_fresh_engine():
    """Serve, evolve the up projection of every layer onto one new mask
    (the JAX LM shares one pattern across its layers), serve again: the
    tokens equal a fresh engine's on the evolved model, and the evolve
    made no route decision."""
    lm = _sparse_lm()
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, lm.cfg.vocab_size, size=n).astype(np.int32)
               for n in (3, 9, 14)]

    def serve(eng):
        reqs = [Request(uid=i, prompt=p, max_new_tokens=3)
                for i, p in enumerate(prompts)]
        eng.run(reqs)
        return [r.output for r in reqs]

    kw = dict(batch=2, max_len=32, buckets=(8, 16), device="cpu")
    eng = Engine(lm, **kw)
    first = serve(eng)
    ffns = _ffns(lm)
    new_mask = jmasks.random_block_mask(ffns[0].up.out_features,
                                        ffns[0].up.in_features,
                                        ffns[0].up.block_size, 0.25, seed=11)
    s0 = sparse.cache_stats()
    for f in ffns:
        f.up.evolve(new_mask)
    assert sparse.cache_stats()["decisions"] == s0["decisions"]
    again = serve(eng)
    assert again == serve(Engine(lm, **kw))
    assert again != first
