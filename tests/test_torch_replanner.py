"""The port's serving engine's re-planner against the JAX engine's
(``tests/test_serve.py``, the plan pools and background re-planner
section), on the port's eager engine at the llama smoke config with a
sparse FFN on the CPU: ``stats()["replanner"]``, ``replan_once``
upgrading every analytic verdict of the pool with no decision in the
foreground after it, the thread's lifecycle; the capture record's plan
keys and the stale-program bookkeeping that re-captures a graph whose
routes changed (the graphs themselves run only on a card:
``tests/test_torch_cuda.py``); tokens after an upgrade equal to the JAX
engine's on the same weights.

Route timings are replaced by fixed seconds (``measure_callable`` by
call order), so each race picks what the table says, not the host
clock.
"""
import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import sparse as jsparse  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import sparse  # noqa: E402
from repro_torch.core import capture  # noqa: E402
from repro_torch.core import dispatch  # noqa: E402
from repro_torch.core.sparse_layers import SparseLinear  # noqa: E402
from repro_torch.models.model import LM as TLM  # noqa: E402
from repro_torch.serve import Engine, Request  # noqa: E402
from repro_torch.serve.graphs import Program  # noqa: E402

VOCAB = 512
BUCKETS = (8, 16)
# the static kind's candidates, in the order every race times them
STATIC = tuple(f + "_torch" for f in sparse.spec.ADMISSIBLE["static"])


def _tcfg():
    cfg = tconfigs.sparsify_ffn(tconfigs.smoke("llama3_2_1b"), 0.25)
    return dataclasses.replace(cfg, dtype="float32")


@pytest.fixture(scope="module")
def pair():
    """The llama smoke LM with a sparse FFN (d = 1/4) in both packages,
    the port's carrying the JAX weights."""
    tcfg = _tcfg()
    jcfg = dataclasses.replace(jconfigs.smoke("llama3_2_1b"),
                               groups=tcfg.groups,
                               ffn_density=tcfg.ffn_density, dtype="float32")
    jlm = JLM(jcfg)
    params = jlm.init(jax.random.PRNGKey(3))
    tlm = TLM(tcfg, device="cpu").load_jax_params(
        jax.tree.map(np.asarray, params))
    return jlm, params, tlm


def _lm():
    sparse.reset()
    return TLM(_tcfg(), device="cpu", seed=0)


def _engine(lm, **kw):
    kw.setdefault("batch", 2)
    kw.setdefault("max_len", 32)
    kw.setdefault("buckets", BUCKETS)
    return Engine(lm, device="cpu", **kw)


def _prompts(lengths, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, size=n).astype(np.int32)
            for n in lengths]


def _serve(eng, lengths=(3, 9, 14), new=3):
    reqs = [Request(uid=i, prompt=p, max_new_tokens=new)
            for i, p in enumerate(_prompts(lengths))]
    eng.run(reqs)
    return [r.output for r in reqs]


class _Times:
    """``measure_callable`` replaced by fixed seconds: the i-th candidate
    of a race (in ``STATIC`` order) takes ``table(n, k)[i]``, ``[n, k]``
    the race's activations; each call still runs ``fn`` once (it builds
    the candidate's walk)."""

    def __init__(self, monkeypatch, table):
        self.table = table
        self.calls = 0
        self.windows = []
        monkeypatch.setattr(dispatch, "measure_callable", self)

    def __call__(self, fn, *args, windows=None, lock=None, build_lock=None):
        fn(*args)
        self.windows.append(windows)
        i = self.calls % len(STATIC)
        self.calls += 1
        return self.table(*args[0].shape)[i]


def _fastest(route):
    """A table where ``route`` is fastest by far everywhere."""
    return lambda n, k: [1e-3 if r == route else 9e-3 for r in STATIC]


# -- stats and reports --------------------------------------------------------

def test_stats_and_plan_report_fields():
    eng = _engine(_lm())
    _serve(eng)
    st = eng.stats()
    # the reference's section, plus the programs re-captured
    assert st["replanner"] == {"running": False, "sweeps": 0,
                               "upgrades": 0, "recaptures": 0}
    assert st["graphs"]["recaptures"] == 0
    rep = eng.plan_report()
    for key in ("startup", "now", "capacity", "plans", "roofline",
                "engine", "tp"):
        assert key in rep
    assert rep["not_ported"] == []
    assert rep["tp"]["totals"] == {"tp_planned": 0, "tp_chosen": 0,
                                   "measured": 0}


# -- the capture record's plan keys -----------------------------------------

def test_capture_record_notes_the_plans_called():
    lm = _lm()
    layer = next(m for m in lm.modules() if isinstance(m, SparseLinear))
    x = torch.randn(5, layer.in_features)
    with capture.recording() as rec:
        layer(x)
    p = layer.plan(5)
    assert list(rec.plans) == [p.key]
    assert rec.held[id(p)] is p
    # a plan hit and a plan built both note their key
    with capture.recording() as rec:
        q = sparse.plan(layer.as_bsr(), 7, device="cpu")
        assert sparse.plan(layer.as_bsr(), 7, device="cpu") is q
    assert list(rec.plans) == [q.key]
    # outside a record nothing is kept
    capture.hold_plan(q)
    assert capture.active() is None


def test_programs_note_the_plans_they_run():
    lm = _lm()
    eng = _engine(lm)
    static = [p for p in sparse.pool_plans(eng.pool) if p.kind == "static"]
    assert static
    for prog in eng.programs():
        n = eng.batch if prog.name == "decode" else \
            int(prog.name.split("[")[1][:-1])
        keys = {p.key for p in static if p.n == n}
        assert keys and keys <= prog.plan_keys, prog.name
    # one plan per token count: no two programs share a static plan key
    owners = [k for prog in eng.programs() for k in prog.plan_keys
              if k in {p.key for p in static}]
    assert len(owners) == len(set(owners))


# -- replan_once --------------------------------------------------------------

def test_replan_once_upgrades_every_analytic_verdict(monkeypatch):
    """The reference's ``test_replanner_upgrades_analytic_verdicts``: one
    sweep upgrades every analytic verdict of the pool, counted in
    ``stats()``; serving afterwards makes no decision and no
    measurement; a rebuild of the same problem replays the measured
    verdict."""
    eng = _engine(_lm())
    analytic = sparse.analytic_plans(eng.pool)
    assert analytic, "the sparse FFN leaves analytic verdicts to upgrade"
    p = analytic[0]
    layer = next(m for m in eng.lm.modules() if isinstance(m, SparseLinear)
                 and any(q is p for q in m._plans.values()))
    before = sparse.cache_stats()
    _Times(monkeypatch, _fastest("dynamic_grouped_torch"))
    n = eng.replan_once(reps=1)
    # one race a key (plans of the same problem share their verdict)
    assert n == len({q.key for q in analytic})
    assert sparse.analytic_plans(eng.pool) == []
    st = eng.stats()["replanner"]
    assert st["sweeps"] == 1 and st["upgrades"] == n
    fore = sparse.cache_stats()
    _serve(eng)
    after = sparse.cache_stats()
    assert after["decisions"] == fore["decisions"]
    assert after["measurements"] == fore["measurements"]
    assert after["measurements"] > before["measurements"]
    q = sparse.plan(layer.as_bsr(), p.n, device="cpu", ctx=eng.plan_ctx)
    assert q.source == "measured" and q.from_disk
    assert q.route == "dynamic_grouped_torch"


def test_replan_reps_are_the_timing_windows(monkeypatch):
    """``reps`` is the number of windows a candidate's median time is
    taken over (``measure_callable(windows=)``); None is the engine's
    ``replanner_reps``."""
    times = _Times(monkeypatch, _fastest("static_torch"))
    eng = _engine(_lm(), replanner_reps=2)
    eng.replan_once()
    assert set(times.windows) == {2}
    times.windows.clear()
    sparse.reset()
    eng = _engine(eng.lm)
    eng.replan_once(reps=5)
    assert set(times.windows) == {5}


class _HeldLock:
    """A lock that says whether it is held."""

    def __init__(self, lock):
        self.lock, self.depth = lock, 0

    def __enter__(self):
        self.lock.__enter__()
        self.depth += 1

    def __exit__(self, *exc):
        self.depth -= 1
        return self.lock.__exit__(*exc)


def test_replan_builds_under_the_capture_lock_and_times_under_the_device_lock(
        monkeypatch):
    """A candidate's build and pack hold the capture lock alone (serving
    replays go on beside them; no capture sees them), its timing holds
    the device lock alone."""
    import sys
    plan_mod = sys.modules["repro_torch.sparse.plan"]
    eng = _engine(_lm())
    eng._device_lock = _HeldLock(eng._device_lock)
    eng._capture_lock = _HeldLock(eng._capture_lock)
    builds, timed = [], []
    runner_of = plan_mod._race_runner

    def spied(*a, **kw):
        run = runner_of(*a, **kw)

        def build(route):
            builds.append((eng._capture_lock.depth, eng._device_lock.depth))
            return run(route)
        return build

    def times(fn, *args, windows=None, lock=None, build_lock=None):
        timed.append((lock is eng._device_lock,
                      build_lock is eng._capture_lock))
        with lock:
            fn(*args)
        return 1e-3
    monkeypatch.setattr(plan_mod, "_race_runner", spied)
    monkeypatch.setattr(dispatch, "measure_callable", times)
    assert eng.replan_once(reps=1) > 0
    assert builds and set(builds) == {(1, 0)}
    assert timed and set(timed) == {(True, True)}


def test_graph_program_needs_its_capture_stream():
    """A graph program is given the one stream it warms up and captures
    on (a stream made per capture would pin a cuBLAS workspace each)."""
    with pytest.raises(ValueError, match="stream"):
        Program("p", lambda io: io, 4, device=torch.device("cpu"),
                graph=True, ctx=sparse.PlanContext())


def test_remeasure_keeps_a_held_route_live(monkeypatch):
    """A verdict the measurement keeps leaves the plan live: it takes the
    measured times in place (a graph holding it holds the live plan); a
    changed verdict drops the plan for its holder to re-plan."""
    eng = _engine(_lm())
    analytic = sparse.analytic_plans(eng.pool)
    p = analytic[0]
    _Times(monkeypatch, _fastest(p.route))
    out = sparse.remeasure_plan(p)
    assert out["route_before"] == out["route_after"] == p.route
    assert sparse.is_live(p) and p.source == "measured" and p.from_disk
    assert p.est_seconds == out["measured"]
    q = next(x for x in analytic if x.key != p.key)
    _Times(monkeypatch, _fastest(next(r for r in STATIC if r != q.route)))
    out = sparse.remeasure_plan(q)
    assert out["route_after"] != q.route and not sparse.is_live(q)
    assert q.source == "analytic"
    assert sparse.remeasure_plan(q) is None           # done once


def test_replan_marks_the_programs_whose_routes_changed(monkeypatch):
    """Routes change at the prefill token counts and hold at the decode
    batch: exactly the programs running a changed plan are marked stale
    (a graph would be re-captured before its next replay); an eager
    program clears the mark at its next call, re-planning by itself."""
    eng = _engine(_lm())
    prior = {(p.n, p.k): p.route for p in sparse.analytic_plans(eng.pool)}

    def table(n, k):
        route = prior[(n, k)]
        if n != eng.batch:
            route = next(r for r in STATIC if r != route)
        return _fastest(route)(n, k)

    _Times(monkeypatch, table)
    eng.replan_once()
    stale = {p.name for p in eng.programs() if p.stale}
    assert stale == {f"prefill[{L}]" for L in eng.buckets}
    assert not eng._decode.stale
    _serve(eng, lengths=(3, 5), new=2)          # bucket 8 and decode
    assert not eng._prefills[8].stale
    assert eng._prefills[16].stale and eng._prefills[31].stale
    assert eng.stats()["replanner"]["recaptures"] == 0      # eager
    routes = {(p.n, p.k): p.route for p in sparse.pool_plans(eng.pool)
              if p.kind == "static"}
    for (n, k), r in routes.items():
        assert (r == prior[(n, k)]) == (n == eng.batch), (n, k)


def test_tokens_after_an_upgrade_equal_the_jax_engine(pair, monkeypatch):
    """Serving after the sweep moved every sparse FFN plan to another
    route gives the JAX engine's greedy tokens on the same weights."""
    jlm, params, tlm = pair
    jsparse.reset()
    jeng = JEngine(jlm, params, batch=2, max_len=32, buckets=BUCKETS)
    prompts = _prompts((3, 9, 14))
    jreqs = [JRequest(uid=i, prompt=p, max_new_tokens=4)
             for i, p in enumerate(prompts)]
    jeng.run(jreqs)
    sparse.reset()
    eng = _engine(tlm)
    _Times(monkeypatch, _fastest("dynamic_torch"))
    assert eng.replan_once() > 0
    reqs = [Request(uid=i, prompt=p, max_new_tokens=4)
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    assert {p.route for p in sparse.pool_plans(eng.pool)
            if p.kind == "static"} == {"dynamic_torch"}
    for j, t in zip(jreqs, reqs):
        assert t.output == j.output, t.uid


# -- the thread ---------------------------------------------------------------

def test_replanner_thread_lifecycle(monkeypatch):
    """The reference's ``test_replanner_thread_lifecycle``: the thread
    empties the pool's analytic verdicts; ``start_replanner`` is
    idempotent; ``stop_replanner`` joins it."""
    _Times(monkeypatch, _fastest("dense_torch"))
    eng = _engine(_lm(), replanner=True, replanner_interval=0.01,
                  replanner_reps=1)
    deadline = 500
    while sparse.analytic_plans(eng.pool) and deadline:
        time.sleep(0.01)
        deadline -= 1
    assert sparse.analytic_plans(eng.pool) == []
    assert eng.stats()["replanner"]["running"]
    thread = eng._replan_thread
    eng.start_replanner()
    assert eng._replan_thread is thread
    _serve(eng)                          # serving beside the thread
    eng.stop_replanner()
    st = eng.stats()["replanner"]
    assert not st["running"] and st["sweeps"] >= 1
    assert st["upgrades"] > 0
    assert not thread.is_alive()


def test_stop_replanner_raises_what_a_sweep_raised(monkeypatch):
    def broken(p, **kw):
        raise ValueError("no card")

    monkeypatch.setattr(sparse, "remeasure_plan", broken)
    eng = _engine(_lm())
    eng.start_replanner(interval=0.01)
    eng._replan_thread.join(5.0)
    with pytest.raises(RuntimeError, match="no card"):
        eng.stop_replanner()
    assert not eng.stats()["replanner"]["running"]


# -- one program: its stale mark and re-capture on the CPU -------------------

def test_program_recapture_needs_a_card():
    prog = Program("p", lambda io: io + 1, 4, device=torch.device("cpu"),
                   graph=False, ctx=sparse.PlanContext())
    prog.stale = True
    assert torch.equal(prog(), torch.ones(4, dtype=torch.long))
    assert not prog.stale and prog.recaptures == 0
    with pytest.raises(RuntimeError, match="needs a card"):
        prog.recapture()
