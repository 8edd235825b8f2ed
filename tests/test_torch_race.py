"""The port's route race (``core.dispatch`` + ``sparse.plan``) against
the JAX package's.

The decision pieces are held against the reference on seeded masks (the
density bucket, the skew signal and factor, the candidate sets); the race
itself against its contract: an analytic verdict is the H100 model's
minimum over the admissible routes, a measured one the fastest timing,
memoized per problem, and a built plan makes no decision.  Every route
the race can pick, forward and backward, is held on the CPU against the
JAX package's output within ``tests/conftest.py``'s budgets.  The H100
model's constants are the card's (``PERF.md``); the reference's TPU model
does not port, so the port's verdicts are compared with its own model,
not with the reference's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import assert_close_for_dtype  # noqa: E402
from repro import sparse as jsparse  # noqa: E402
from repro.core import dispatch as jdispatch  # noqa: E402
from repro.core import dynamic_sparse as jdsp  # noqa: E402
from repro.core import masks as jmasks  # noqa: E402
from repro.core import partitioner as jpart  # noqa: E402
from repro.core.bsr import BlockSparseMatrix as JBSR  # noqa: E402
from repro_torch import sparse as tsparse  # noqa: E402
from repro_torch.core import dispatch as tdispatch  # noqa: E402
from repro_torch.core import dynamic_sparse as tdsp  # noqa: E402
from repro_torch.core.bsr import BlockSparseMatrix as TBSR  # noqa: E402
from repro_torch.core.sparse_layers import SparseLinear  # noqa: E402
from repro_torch.kernels.bsmm import balanced as tbal  # noqa: E402
from repro_torch.kernels.bsmm import ops as tbsmm_ops  # noqa: E402
from repro_torch.kernels.dense_mm import ops as tdmm_ops  # noqa: E402
from repro_torch.kernels.dsmm import ops as tdsmm_ops  # noqa: E402
from repro_torch.sparse import spec as tspec  # noqa: E402

TDTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
GENS = {"uniform": jmasks.random_block_mask,
        "power_law": jmasks.power_law_block_mask,
        "dlmc": jmasks.dlmc_block_mask}
CPU_ROUTES = tsparse.PLAN_ROUTES["cpu"]


def _np(t):
    return t.detach().float().numpy()


def _problem(m=128, k=192, n=24, b=16, density=0.3, seed=3,
             dtype="float32", kind="uniform"):
    mask = GENS[kind](m, k, b, density, seed=seed)
    mask[0, 0] = True
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((int(mask.sum()), b, b)).astype(np.float32)
    x = rng.standard_normal((n, k)).astype(np.float32)
    tb = TBSR.from_mask(mask, b, values=torch.as_tensor(vals).to(
        TDTYPE[dtype]))
    jb = JBSR.from_mask(mask, b).with_values(jnp.asarray(vals,
                                                         JDTYPE[dtype]))
    return mask, vals, x, tb, jb


# -- the decision pieces, held against the reference ------------------------

@pytest.mark.parametrize("density", [0.0, 1e-4, 0.03, 1 / 16, 0.1, 0.3,
                                     0.49, 0.75, 1.0, 1.5])
def test_density_bucket_matches_reference(density):
    assert tdispatch._density_bucket(density) == \
        jdispatch._density_bucket(density)


@pytest.fixture
def identity_model():
    """The hand-tuned H100 model (the identity calibration) while a test
    holds its constants; the active calibration after it."""
    prev = tdispatch.cost_coeffs()
    tdispatch.set_cost_coeffs(tdispatch.IDENTITY_COEFFS)
    try:
        yield
    finally:
        tdispatch.set_cost_coeffs(prev)


def _ref_knees():
    """The reference's active skew constants (its hand-tuned defaults,
    which its fitted ``cost_coeffs.json`` keeps)."""
    c = jdispatch.cost_coeffs()
    return {"imb_knee": c.skew_imb_knee, "imb_slope": c.skew_imb_slope,
            "cv_knee": c.skew_cv_knee, "cv_slope": c.skew_cv_slope,
            "cap": c.skew_cap}


@pytest.mark.parametrize("kind", list(GENS))
@pytest.mark.parametrize("b", [8, 16, 32])
def test_skew_factor_matches_reference(kind, b, monkeypatch,
                                      identity_model):
    """The port's ``_skew_factor`` is the reference's form: at the
    reference's constants it gives the reference's factor on the skew of
    seeded masks (the power-law masks of ``tests/test_skew.py``)."""
    monkeypatch.setattr(tdispatch, "SKEW_KNEES", _ref_knees())
    mask = GENS[kind](1024, 1024, b, 1 / 16, seed=b)
    imb, cv = jdispatch.pattern_balance(JBSR.from_mask(mask, b))
    got = tdispatch._skew_factor(imb, cv)
    assert got == pytest.approx(jdispatch._skew_factor(imb, cv), rel=1e-12)
    for imb_, cv_ in ((1.0, 0.0), (1.2, 0.1), (2.0, 0.0), (100.0, 10.0)):
        assert tdispatch._skew_factor(imb_, cv_) == \
            pytest.approx(jdispatch._skew_factor(imb_, cv_))


def test_card_skew_factor_dead_zone_and_cap(identity_model):
    """The card's knees: a uniform mask's row noise (imbalance <= 2)
    prices flat, the power-law grid's (32) at the measured ~1.4x, and
    the factor is capped."""
    assert tdispatch._skew_factor(1.0, 0.0) == 1.0
    assert tdispatch._skew_factor(2.0, 0.4) == 1.0
    assert tdispatch._skew_factor(32.0, 3.0) == pytest.approx(1.45)
    assert tdispatch._skew_factor(1e4, 10.0) == tdispatch.SKEW_KNEES["cap"]


@pytest.mark.parametrize("kind", list(GENS))
@pytest.mark.parametrize("m,b", [(1024, 16), (1024, 32), (512, 8),
                                 (64, 64), (1024, 128)])
def test_pattern_balance_matches_reference(kind, m, b, monkeypatch):
    """At the reference's row tile (128 rows, or m below it) the port's
    signal is the reference's; at the port's own tile-row (one tile of
    ``kernel_tile(b)`` rows, the serial unit of the bsmm walks) it is
    the reference's ``balance_report`` over those counts.  b = 128 (walked
    as 64-row tiles) and m = 64 agree at both."""
    mask = GENS[kind](m, m, b, 0.2, seed=m + b)
    mask[0, 0] = True
    jb = JBSR.from_mask(mask, b)
    tb = TBSR.from_mask(mask, b)
    want = jdispatch.pattern_balance(jb)
    tm = m if m < 128 else 128
    with monkeypatch.context() as mp:
        # tile-rows of the reference's height, blocks walked whole
        mp.setattr(tdispatch, "kernel_tile", lambda b_: (tm, 1))
        assert tdispatch.pattern_balance(tb) == \
            pytest.approx(want, rel=1e-12)
    t, split = tdispatch.kernel_tile(b)
    assert t == b // split
    # each block-row walked as ``split`` tile-rows of ``split`` sub-blocks
    # a block
    per_row = np.bincount(np.nonzero(mask)[0], minlength=m // b)
    rep = jpart.balance_report(np.repeat(per_row * split, split))
    assert tdispatch.pattern_balance(tb) == pytest.approx(
        (rep["imbalance"], rep["cv"]), rel=1e-12)
    if b == 128 or m == 64:
        assert tdispatch.pattern_balance(tb) == pytest.approx(want)


def test_pattern_balance_of_runtime_operands_is_flat():
    op = tdsp.encode(torch.randn(64, 64), torch.ones(4, 4, dtype=torch.bool),
                     block_size=16, nnz_max=16)
    assert tdispatch.pattern_balance(op) == (1.0, 0.0)
    assert tdispatch.pattern_balance(torch.zeros(8, 8)) == (1.0, 0.0)


def _mapped(routes):
    return {tspec._FAMILY[r] for r in routes}


@pytest.mark.parametrize("kind", ["static", "dynamic", "dense"])
@pytest.mark.parametrize("device_type", ["cuda", "cpu"])
def test_candidates_map_onto_reference(kind, device_type):
    """``_candidates(kind)`` is the reference's ``_candidates(kind,
    allow_pallas=True)`` mapped onto port families, as the card's kernels
    (``*_cuda``) or the CPU's plain versions (``*_torch``), never mixed.
    A static pattern also races the dynamic walks (the reference admits
    them for a static kind as a mode, ``_ADMISSIBLE``)."""
    ref = jdispatch._candidates(kind, jdispatch.DispatchContext(
        allow_pallas=True, differentiable=False))
    got = tdispatch._candidates(kind, "auto", device_type)
    sfx = tspec.SUFFIX[device_type]
    assert all(r.endswith(sfx) for r in got)
    fams = {tdispatch.family(r) for r in got}
    extra = {"dynamic", "dynamic_grouped", "dynamic_grouped_balanced"} \
        if kind == "static" else set()
    assert fams == _mapped(ref) | extra
    assert set(jdispatch._ADMISSIBLE[kind]) >= {
        f.split("_")[0] for f in fams}


@pytest.mark.parametrize("mode", ["static", "static_pallas", "static_xla",
                                  "static_balanced", "dense_xla",
                                  "dynamic_grouped"])
def test_family_or_route_mode_is_one_forced_candidate(mode):
    got = tdispatch._candidates("static", mode, "cuda")
    assert got == (tspec.port_route("static", mode, "cuda"),)
    with pytest.raises(ValueError, match="races"):
        tspec.port_route("static", "auto", "cuda")


@pytest.mark.parametrize("device_type", ["cuda", "cpu"])
def test_sddmm_candidates_map_onto_reference(device_type):
    ref = jdispatch.sddmm_candidates(jdispatch.DispatchContext(
        allow_pallas=True))
    got = tdispatch.sddmm_candidates(device_type)
    assert {tspec._SDDMM_FAMILY[r] for r in ref} == {
        tdispatch.family(r) for r in got}
    assert all(r.endswith(tspec.SUFFIX[device_type]) for r in got)


# -- the H100 model ----------------------------------------------------------

def test_estimate_prices_the_walk_each_route_launches(identity_model):
    """Each static route is priced by the time model of the walk its
    kernel takes, on the pattern's counts, times the skew factor; a
    ``*_torch`` route as its card counterpart."""
    _, _, _, tb, _ = _problem(m=512, k=256, b=16, dtype="bfloat16")
    rows, cols = tb.row_idx, tb.col_idx
    c = tdispatch.static_counts(rows, cols, 512, 256, 16)
    imb, cv = tdispatch.pattern_balance(tb)
    s = tdispatch._skew_factor(imb, cv)
    dt = torch.bfloat16
    for n in (4, 300):
        uni = tbsmm_ops.walk_seconds(tbsmm_ops.walk(16, dt, n), n, 512, 256,
                                     16, c.tiles, c.stages, dt)
        bal = tbal.walk_seconds("mma", n, 512, 256, 16, c.tiles, c.stages,
                                dt)
        dyn = tdsmm_ops.encode_seconds(c.slots) + tdsmm_ops.walk_seconds(
            "mma", n, 512, 256, 16, c.slots, c.row_slots, dt)
        dense = tdmm_ops.walk_seconds(tdmm_ops.walk(n, 256, 512, dt).name,
                                      n, 256, 512, dt)
        for route, want in (("static", uni * s), ("static_balanced",
                                                  bal * s),
                            ("dynamic", dyn * s), ("dense", dense)):
            for sfx in ("_cuda", "_torch"):
                assert tdispatch._estimate(
                    route + sfx, 512, 256, n, 16, 0.3, "bfloat16",
                    imbalance=imb, cv=cv, counts=c) == pytest.approx(want)
    assert c.stages == tbsmm_ops.packing_schedule(
        tsparse.plan(tb, 8, device="cpu", ctx=tsparse.PlanContext(
            mode="static")).packing).stages


def test_walk_counts_match_the_plans_built():
    """The counts the race prices are what the built plans walk: the
    static packing's tiles, the grouped routes' exact tile capacity."""
    for b, m, k in ((1, 64, 96), (4, 256, 384), (12, 192, 288),
                    (16, 256, 384), (128, 1024, 1536)):
        mask = jmasks.random_block_mask(m, k, b, 0.2, seed=b)
        mask[0, 0] = True
        tb = TBSR.from_mask(mask, b)
        c = tdispatch.static_counts(tb.row_idx, tb.col_idx, m, k, b)
        p = tsparse.plan(tb, 8, device="cpu",
                         ctx=tsparse.PlanContext(mode="static"))
        assert c.tiles == p.packing.num_tiles and c.tile == p.packing.tm
        g = tsparse.plan(tb, 8, device="cpu", ctx=tsparse.PlanContext(
            mode="dynamic_grouped"))
        assert c.grouped_tiles == g.tiles_cap
        assert c.grouped_tile == g.tile


# -- the race ------------------------------------------------------------------

def _race_bsr(kind, b=16, m=4096, density=1 / 32):
    gen = {"power_law": jmasks.power_law_block_mask,
           "uniform": jmasks.random_block_mask}[kind]
    return TBSR.from_mask(gen(m, m, b, density, seed=0), b)


@pytest.mark.parametrize("kind", ["uniform", "power_law"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_analytic_race_is_the_models_minimum(kind, dtype):
    """On the skew grid (4096^2, b 16, d = 1/32) the verdict is the
    model's minimum over every admissible route.  On the card the
    balanced walks pay a pattern's skew as the uniform ones do (PERF.md),
    so the model keeps the uniform walk on power-law patterns too, where
    the reference's TPU model flips to the balanced one; the uniform
    walk on uniform patterns, as in the reference."""
    tsparse.reset()
    tb = _race_bsr(kind)
    tb = dataclasses.replace(tb, values=torch.empty(
        (0,), dtype=TDTYPE[dtype]))
    p = tsparse.plan(tb, 4096, device="cpu", ctx=tsparse.PlanContext(
        differentiable=False))
    assert p.source == "analytic"
    assert p.route == min(p.est_seconds, key=p.est_seconds.get)
    assert set(p.est_seconds) == set(CPU_ROUTES)
    assert p.route == "static_torch"
    est = p.est_seconds
    assert est["static_balanced_torch"] > est["static_torch"]


def test_race_picks_balanced_only_where_its_model_says_so(monkeypatch):
    """Under a model whose balanced walk is flat in the skew (the
    reference's premise: it pays a fixed overhead, the uniform walk the
    skew factor), the race flips to the balanced walk on the power-law
    grid, whose skew factor (1.45) passes that overhead, and keeps the
    uniform walk on the uniform grid (factor 1): the reference's
    ``test_race_picks_balanced_on_skewed_pattern`` and
    ``test_race_keeps_uniform_walk_on_uniform_pattern``."""
    monkeypatch.setattr(tbal, "OVERHEAD", {"mma": 1.2, "ffma": 1.2})
    monkeypatch.setattr(tdispatch, "_SKEW_SENSITIVE", ("static",))
    tsparse.reset()
    ctx = tsparse.PlanContext(differentiable=False)
    skewed = tsparse.plan(_race_bsr("power_law"), 4096, device="cpu",
                          ctx=ctx)
    assert skewed.route == "static_balanced_torch"
    uniform = tsparse.plan(_race_bsr("uniform"), 4096, device="cpu",
                           ctx=ctx)
    assert uniform.route == "static_torch"
    assert "static_balanced_torch" in uniform.est_seconds


def test_skew_is_part_of_the_plan_key():
    tsparse.reset()
    ctx = tsparse.PlanContext(differentiable=False)
    a = tsparse.plan(_race_bsr("power_law", m=1024), 64, device="cpu",
                     ctx=ctx)
    b = tsparse.plan(_race_bsr("uniform", m=1024), 64, device="cpu",
                     ctx=ctx)
    assert a.key != b.key
    for p, kind in ((a, "power_law"), (b, "uniform")):
        imb, cv = tdispatch.pattern_balance(_race_bsr(kind, m=1024))
        assert f"|skew|{round(imb, 1)}|{round(cv, 1)}" in p.key


def test_measured_race_picks_minimum_and_memoizes(monkeypatch):
    """``measure=True`` with concrete inputs times every candidate once
    and picks the fastest; a second plan of the same problem (another
    pattern of the same shape and density bucket) replays the memoized
    decision (the reference's ``test_dispatch.py`` measured race)."""
    fake = {"static_torch": 9e-3, "static_balanced_torch": 8e-3,
            "dense_torch": 7e-3, "dynamic_torch": 2e-3,
            "dynamic_grouped_torch": 5e-3,
            "dynamic_grouped_balanced_torch": 6e-3}
    calls = []

    def timed(fn, *args, **kw):
        fn(*args)
        calls.append(1)
        return fake[current[0]]
    current = [None]
    real_runner = tsparse.plan.__globals__["_race_runner"]

    def runner(spec, operand, x, dev, ctx, key):
        run = real_runner(spec, operand, x, dev, ctx, key)

        def named(route):
            current[0] = route
            return run(route)
        return named
    monkeypatch.setattr(tdispatch, "measure_callable", timed)
    monkeypatch.setitem(tsparse.plan.__globals__, "_race_runner", runner)
    tsparse.reset()
    _, _, x, tb, _ = _problem()
    ctx = tsparse.PlanContext(measure=True, differentiable=False)
    p = tsparse.plan(tb, 24, x=torch.as_tensor(x), device="cpu", ctx=ctx)
    assert p.source == "measured" and p.route == "dynamic_torch"
    assert p.est_seconds == fake and len(calls) == len(fake)
    assert tsparse.cache_stats()["measurements"] == 1
    assert tdispatch.cache_stats()["entries"] == 1
    # the decision is memoized per problem: another pattern with the same
    # row counts (its columns permuted: same density bucket and skew) is
    # another plan, on the memoized verdict, with no measurement
    mask = GENS["uniform"](128, 192, 16, 0.3, seed=3)
    mask[0, 0] = True
    mask2 = mask[:, np.random.default_rng(1).permutation(mask.shape[1])]
    tb2 = TBSR.from_mask(mask2, 16)
    q = tsparse.plan(tb2, 24, x=torch.as_tensor(x), device="cpu", ctx=ctx)
    assert q.route == "dynamic_torch" and len(calls) == len(fake)
    assert tsparse.cache_stats()["measurements"] == 1
    y = p.spmm_nt(tb.values, torch.as_tensor(x))
    torch.testing.assert_close(y, torch.as_tensor(x) @ tb.to_dense().t(),
                               rtol=1e-4, atol=1e-4)


def test_measure_without_inputs_or_under_capture_is_analytic(monkeypatch):
    """No ``x``, or a CUDA graph being captured: the verdict is analytic
    and nothing is timed (the reference's ``_is_concrete`` rule)."""
    def never(*a, **k):
        raise AssertionError("measured")
    monkeypatch.setattr(tdispatch, "measure_callable", never)
    tsparse.reset()
    _, _, x, tb, _ = _problem()
    ctx = tsparse.PlanContext(measure=True)
    assert tsparse.plan(tb, 24, device="cpu", ctx=ctx).source == "analytic"
    monkeypatch.setattr(tdispatch, "capturing", lambda: True)
    tsparse.reset()
    p = tsparse.plan(tb, 24, x=torch.as_tensor(x), device="cpu", ctx=ctx)
    assert p.source == "analytic"
    assert p.artifacts["grad"]["dx"]["source"] == "analytic"
    assert tsparse.cache_stats()["measurements"] == 0


def test_failing_candidate_propagates(monkeypatch):
    """A candidate that fails to launch in a race raises: no candidate is
    dropped quietly."""
    def boom(*a, **k):
        raise RuntimeError("launch failed")
    monkeypatch.setattr(tdispatch, "measure_callable", boom)
    tsparse.reset()
    _, _, x, tb, _ = _problem()
    with pytest.raises(RuntimeError, match="launch failed"):
        tsparse.plan(tb, 24, x=torch.as_tensor(x), device="cpu",
                     ctx=tsparse.PlanContext(measure=True))


def test_built_plan_makes_zero_decisions():
    """After the first plan, repeated calls make no new decisions (the
    reference's ``test_steady_state_is_decision_free``)."""
    tsparse.reset()
    _, _, x, tb, _ = _problem()
    xt = torch.as_tensor(x)
    tsparse.spmm_nt(tb, xt)
    base = tsparse.cache_stats()
    for _ in range(5):
        tsparse.spmm_nt(tb, xt)
    now = tsparse.cache_stats()
    assert now["decisions"] == base["decisions"]
    assert now["plans_built"] == base["plans_built"]
    assert now["plan_hits"] == base["plan_hits"] + 5


def test_contracts_filter_the_candidates(monkeypatch):
    """A route whose kernel contract refuses the problem is not raced;
    forced onto it, the plan raises with the contract's reason."""
    tsparse.reset()
    _, _, _, tb, _ = _problem()
    real = tsparse.plan.__globals__["_check_contract"]

    def no_dsmm(route, spec, block):
        if tdispatch.family(route).startswith("dynamic"):
            raise ValueError("refused for the test")
        return real(route, spec, block)
    monkeypatch.setitem(tsparse.plan.__globals__, "_check_contract", no_dsmm)
    p = tsparse.plan(tb, 24, device="cpu", ctx=tsparse.PlanContext(
        differentiable=False))
    assert not any(r.startswith("dynamic") for r in p.est_seconds)
    with pytest.raises(ValueError, match="refused"):
        tsparse.plan(tb, 24, device="cpu",
                     ctx=tsparse.PlanContext(mode="dynamic"))


# -- every route the race can pick, against the JAX package --------------------

def _jax_forward(jb, x, dtype):
    jp = jsparse.plan(jb, x.shape[0], ctx=jsparse.PlanContext(
        mode="static_xla"))
    return np.asarray(jp(jb.values, jnp.asarray(x.T, JDTYPE[dtype])).T
                      .astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b", [4, 16])
@pytest.mark.parametrize("route", CPU_ROUTES)
def test_every_static_route_matches_jax(route, b, dtype):
    _, _, x, tb, jb = _problem(b=b, dtype=dtype)
    want = _jax_forward(jb, x, dtype)
    mode = tdispatch.family(route)
    p = tsparse.plan(tb, x.shape[0], device="cpu",
                     ctx=tsparse.PlanContext(mode=mode))
    assert p.route == route and p.source == "forced"
    got = p.spmm_nt(tb.values, torch.as_tensor(x).to(TDTYPE[dtype]))
    assert_close_for_dtype(_np(got), want, dtype, route)


@pytest.mark.parametrize("route", ["dynamic_torch", "dynamic_grouped_torch",
                                   "dynamic_grouped_balanced_torch",
                                   "dense_torch"])
def test_every_dynamic_route_matches_jax(route):
    mask, vals, x, tb, jb = _problem(b=16)
    cap = int(mask.sum()) + 3
    jop = jdsp.encode_from_bsr(jb, nnz_max=cap)
    want = np.asarray(jsparse.plan(jop, x.shape[0], ctx=jsparse.PlanContext(
        mode="dynamic_xla"))(jop, jnp.asarray(x.T)).T)
    w = tb.to_dense()
    op = tdsp.encode(w, torch.as_tensor(mask), block_size=16, nnz_max=cap)
    p = tsparse.plan(op, x.shape[0], device="cpu", ctx=tsparse.PlanContext(
        mode=tdispatch.family(route), capacity_policy="worst"))
    assert p.route == route
    got = p.spmm_nt(op, torch.as_tensor(x))
    assert_close_for_dtype(_np(got), want, "float32", route)


def _jax_grads(jb, vals, x, gy, dtype):
    jp = jsparse.plan(jb, x.shape[0], ctx=jsparse.PlanContext(
        mode="static_xla", grad_mode="static_xla", sddmm_mode="sddmm_xla"))

    def loss(v, xt):
        return jnp.sum(jp(v, xt).astype(jnp.float32) * gy.T)
    return jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(vals, JDTYPE[dtype]), jnp.asarray(x.T, JDTYPE[dtype]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dv_mode", ["sddmm_grouped", "sddmm_dense"])
@pytest.mark.parametrize("dx_mode", ["static", "static_balanced", "dense",
                                     "dynamic", "dynamic_grouped",
                                     "dynamic_grouped_balanced"])
def test_every_backward_route_matches_jax_grad(dx_mode, dv_mode, dtype):
    """The dL/dx routes (the static candidates on the transposed
    problem) and the dL/dvalues routes (the SDDMM, the dense product and
    a gather) against ``jax.grad`` of the reference's plan."""
    _, vals, x, tb, jb = _problem(b=16, dtype=dtype)
    gy = np.random.default_rng(9).standard_normal(
        (x.shape[0], 128)).astype(np.float32)
    jdv, jdx = _jax_grads(jb, vals, x, gy, dtype)
    p = tsparse.plan(tb, x.shape[0], device="cpu", ctx=tsparse.PlanContext(
        mode="static", grad_mode=dx_mode, sddmm_mode=dv_mode))
    assert p.grad_routes == {"dx": dx_mode + "_torch",
                             "dvalues": tspec._SDDMM_FAMILY[dv_mode]
                             + "_torch"}
    assert p.artifacts["grad"]["dx"]["source"] == "forced"
    tv = tb.values.clone().requires_grad_(True)
    tx = torch.as_tensor(x).to(TDTYPE[dtype]).requires_grad_(True)
    (p.spmm_nt(tv, tx).float() * torch.as_tensor(gy)).sum().backward()
    assert_close_for_dtype(_np(tv.grad), jdv, dtype, "dL/dvalues")
    assert_close_for_dtype(_np(tx.grad), np.asarray(jdx).T, dtype, "dL/dx")


def test_analytic_backward_race_is_the_models_minimum():
    tsparse.reset()
    _, _, x, tb, _ = _problem(m=512, k=256, b=16)
    p = tsparse.plan(tb, 300, device="cpu")
    g = p.artifacts["grad"]
    assert g["mode"] == "planned" and not g["from_disk"]
    for side in ("dx", "dvalues"):
        est = g[side]["est_seconds"]
        assert g[side]["source"] == "analytic"
        assert g[side]["route"] == min(est, key=est.get)
    assert set(g["dx"]["est_seconds"]) == set(CPU_ROUTES)
    assert set(g["dvalues"]["est_seconds"]) == {"sddmm_torch",
                                                "sddmm_dense_torch"}
    assert p.grad_routes == {"dx": g["dx"]["route"],
                             "dvalues": g["dvalues"]["route"]}


# -- explain / format_plan -----------------------------------------------------

def test_explain_keys_match_reference():
    _, _, x, tb, jb = _problem()
    want = jsparse.plan(jb, 24).explain()
    got = tsparse.plan(tb, 24, device="cpu").explain()
    assert set(got) == set(want)
    assert set(got["problem"]) == set(want["problem"])
    assert got["tp"] is None
    # the roofline section: the reference's keys, one entry per candidate
    assert set(want["roofline"]) <= set(got["roofline"])
    assert set(got["roofline"]["routes"]) == set(got["candidates"])
    assert got["roofline"]["chosen"] == \
        got["roofline"]["routes"][got["chosen"]]
    assert got["evolution"] is None
    assert got["chosen"] in got["candidates"]
    assert list(got["candidates"].values()) == sorted(
        got["candidates"].values())
    assert got["source"] == "analytic" and got["from_disk"] is False
    assert tsparse.explain(tb, 24, device="cpu")["cache_key"] == \
        got["cache_key"]


@pytest.mark.parametrize("route", CPU_ROUTES)
def test_format_plan_runs_for_every_route(route):
    _, _, x, tb, _ = _problem()
    p = tsparse.plan(tb, 24, device="cpu", ctx=tsparse.PlanContext(
        mode=tdispatch.family(route)))
    text = tsparse.format_plan(p)
    assert f"-> {route}" in text and "(forced)" in text
    assert "grad: dx=" in text


def test_format_plan_dynamic_grouped_reports_capacity():
    mask, _, x, tb, _ = _problem()
    op = tdsp.encode(tb.to_dense(), torch.as_tensor(mask), block_size=16,
                     nnz_max=int(mask.sum()) + 4)
    p = tsparse.plan(op, 24, device="cpu", ctx=tsparse.PlanContext(
        mode="dynamic_grouped"))
    text = tsparse.format_plan(p)
    assert "capacity: planned cap" in text and "grouped:" in text


# -- SparseLinear ----------------------------------------------------------------

def test_sparse_linear_plans_per_token_count_one_stack_per_route():
    """Two token counts give two plans; the packed operand is kept per
    route, so two plans on one route share one stack."""
    tsparse.reset()
    lin = SparseLinear.random_pattern(256, 512, 16, 0.25, seed=2,
                                      device="cpu")
    lin.reset_parameters(torch.Generator().manual_seed(0))
    with tsparse.use_ctx(tsparse.PlanContext(mode="static")), \
            torch.no_grad():
        y4 = lin(torch.randn(4, 256))
        y8 = lin(torch.randn(8, 256))
    assert len(lin._plans) == 2
    p4, p8 = lin._plans.values()
    assert p4.n == 4 and p8.n == 8 and p4 is not p8
    assert list(lin._packed) == ["static_torch"]
    assert y4.shape == (4, 512) and y8.shape == (8, 512)
    with torch.no_grad():
        x = torch.randn(300, 256)
        y = lin(x)                                  # the race's verdict
    torch.testing.assert_close(
        y, x @ lin.as_bsr().to_dense().t(), rtol=1e-4, atol=1e-4)
    assert len(lin._plans) == 3
    # a plan dropped from the cache (a restart, a re-planned verdict) is
    # planned again, not reused
    tsparse.reset()
    with tsparse.use_ctx(tsparse.PlanContext(mode="static")), \
            torch.no_grad():
        lin(torch.randn(4, 256))
    assert tsparse.cache_stats()["plans_built"] == 1
    # the plans the cache dropped are dropped by the module too
    assert len(lin._plans) == 1


def test_sparse_linear_shares_plans_across_pools_and_frees_lost_routes():
    """The pool label is runtime-only: two engines' pools share one plan
    of the module (each pool lists it).  Building a plan drops the plans
    the cache no longer holds and the packed operands of routes no kept
    plan runs, so a route that lost keeps no stack."""
    tsparse.reset()
    lin = SparseLinear.random_pattern(256, 512, 16, 0.25, seed=2,
                                      device="cpu")
    lin.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(4, 256)
    with torch.no_grad():
        for pool in ("engine:a:1", "engine:b:2"):
            with tsparse.use_ctx(tsparse.PlanContext(mode="static",
                                                     pool=pool)):
                lin(x)
    assert len(lin._plans) == 1
    (p,) = lin._plans.values()
    assert tsparse.pool_plans("engine:a:1") == [p]
    assert tsparse.pool_plans("engine:b:2") == [p]
    assert list(lin._packed) == ["static_torch"]
    tsparse.reset()                        # the static plan is dropped
    with torch.no_grad(), tsparse.use_ctx(tsparse.PlanContext(
            mode="dense")):
        y = lin(x)
    assert [q.route for q in lin._plans.values()] == ["dense_torch"]
    assert list(lin._packed) == ["dense_torch"]
    torch.testing.assert_close(y, x @ lin.as_bsr().to_dense().t(),
                               rtol=1e-4, atol=1e-4)


# -- the measured race's noise rule ---------------------------------------------

def test_measured_pick_keeps_the_models_pick_within_the_noise():
    """A measured winner displaces the model's pick only when it is
    faster by more than ``MEASURE_MARGIN``."""
    margin = tdispatch.MEASURE_MARGIN
    t = {"static_cuda": 1.0, "static_balanced_cuda": 1.0 - margin / 2,
         "dense_cuda": 3.0}
    assert tdispatch.measured_pick(t, "static_cuda") == "static_cuda"
    t["static_balanced_cuda"] = 1.0 - 2 * margin
    assert tdispatch.measured_pick(t, "static_cuda") == \
        "static_balanced_cuda"
    # a pick the race did not time (forced elsewhere) yields to the fastest
    assert tdispatch.measured_pick({"dense_cuda": 2.0, "static_cuda": 1.0},
                                   "dynamic_cuda") == "static_cuda"


def test_measured_race_within_the_noise_keeps_the_analytic_route(
        monkeypatch):
    """Timings within the margin of the analytic pick's leave the verdict
    on the analytic route (a restart replays the same route); the
    verdict is still the measured one."""
    tsparse.reset()
    _, _, x, tb, _ = _problem()
    ana = tsparse.plan(tb, 24, device="cpu", ctx=tsparse.PlanContext(
        differentiable=False))
    tsparse.reset()
    current = [None]
    real_runner = tsparse.plan.__globals__["_race_runner"]

    def runner(spec, operand, x_, dev, ctx, key):
        run = real_runner(spec, operand, x_, dev, ctx, key)

        def named(route):
            current[0] = route
            return run(route)
        return named

    def timed(fn, *args):
        # every other route 1 % faster than the analytic pick
        return 1.0 if current[0] == ana.route else 0.99
    monkeypatch.setattr(tdispatch, "measure_callable", timed)
    monkeypatch.setitem(tsparse.plan.__globals__, "_race_runner", runner)
    p = tsparse.plan(tb, 24, x=torch.as_tensor(x), device="cpu",
                     ctx=tsparse.PlanContext(measure=True,
                                             differentiable=False))
    assert p.source == "measured" and p.route == ana.route


def test_measure_copies_fill_past_l2():
    """The timed launches rotate through input copies holding
    ``ROTATE_BYTES`` (at least two sets, so the first timed launch does
    not reuse the warm-up's; at most ``MAX_COPIES``)."""
    mib = 2 ** 20
    for nbytes, want in ((mib, tdispatch.MAX_COPIES),
                         (4 * mib, 40), (100 * mib, 2), (400 * mib, 2)):
        a = torch.empty(nbytes, dtype=torch.uint8)
        sets = tdispatch._copies((a, 3))
        assert len(sets) == want
        assert sets[0][0] is a and sets[1][0] is not a
        assert all(s[1] == 3 for s in sets)
    assert tdispatch.measure_callable(lambda t: t + 1, torch.ones(4)) > 0


def test_forced_and_replayed_dx_routes_pass_the_transposed_contracts(
        tmp_path, monkeypatch):
    """dL/dx runs a forward plan of W^T: a forced ``grad_mode`` and a
    dL/dx verdict read back from disk are held to the kernels'
    contracts on the transposed problem, as a raced one is."""
    tsparse.reset()
    _, _, _, tb, _ = _problem()            # [128, 192]: W^T is [192, 128]
    ctx = tsparse.PlanContext(mode="static", grad_mode="dynamic",
                              cache_dir=str(tmp_path))
    p = tsparse.plan(tb, 24, device="cpu", ctx=ctx)
    assert p.grad_routes["dx"] == "dynamic_torch"
    real = tsparse.plan.__globals__["_check_contract"]

    def no_dsmm_transposed(route, spec, block):
        if tdispatch.family(route) == "dynamic" and spec.m == 192:
            raise ValueError("refused for the test")
        return real(route, spec, block)
    monkeypatch.setitem(tsparse.plan.__globals__, "_check_contract",
                        no_dsmm_transposed)
    tsparse.reset()                        # replayed from disk
    with pytest.raises(ValueError, match="refused"):
        tsparse.plan(tb, 24, device="cpu", ctx=ctx)
    tsparse.reset()                        # forced, no disk
    with pytest.raises(ValueError, match="refused"):
        tsparse.plan(tb, 24, device="cpu", ctx=tsparse.PlanContext(
            mode="static", grad_mode="dynamic"))
    # raced: the refused route is not a candidate
    tsparse.reset()
    q = tsparse.plan(tb, 24, device="cpu",
                     ctx=tsparse.PlanContext(mode="static"))
    assert "dynamic_torch" not in q.artifacts["grad"]["dx"]["est_seconds"]
