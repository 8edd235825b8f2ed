"""The port's persistent verdict cache (``repro_torch.sparse.cache``)
against the reference's behaviour (``tests/test_sparse_api.py`` and
``tests/test_grad_plan.py``'s disk tests): a round trip, a restart that
makes zero decisions and zero measurements and gets every route and
backward route back, stale and corrupt files, ``persist=True`` without a
directory, the capacity and backward sections on disk, the re-planner's
upgrade, and the serving engine's ``plan_cache_dir``.  "A restart" is
``sparse.reset()``: every in-memory plan, decision and counter goes, the
disk files stay.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import masks as jmasks  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import sparse  # noqa: E402
from repro_torch.core import dispatch as tdispatch  # noqa: E402
from repro_torch.core import dynamic_sparse as tdsp  # noqa: E402
from repro_torch.core.bsr import BlockSparseMatrix as TBSR  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.serve import Engine, Request  # noqa: E402
from repro_torch.sparse import cache as cache_lib  # noqa: E402

N = 24


def _problem(seed=3, m=128, k=192, b=16):
    mask = jmasks.random_block_mask(m, k, b, 0.3, seed=seed)
    mask[0, 0] = True
    g = torch.Generator().manual_seed(seed)
    tb = TBSR.from_mask(mask, b, values=torch.randn(
        (int(mask.sum()), b, b), generator=g))
    x = torch.randn((N, k), generator=g)
    return mask, tb, x


def _path(d):
    return os.path.join(str(d), f"sparse-plans-torch-v"
                                f"{cache_lib.SCHEMA_VERSION}.json")


@pytest.fixture(autouse=True)
def _fresh():
    sparse.reset()
    sparse.configure(None)
    yield
    sparse.reset()
    sparse.configure(None)


class _FakeTimes:
    """``measure_callable`` replaced by fixed seconds per call order: the
    race picks what the table says, not what the host clock says."""

    def __init__(self, monkeypatch, seconds):
        self.seconds = list(seconds)
        self.calls = 0
        monkeypatch.setattr(tdispatch, "measure_callable", self)

    def __call__(self, fn, *args, **kw):
        fn(*args)
        self.calls += 1
        return self.seconds[(self.calls - 1) % len(self.seconds)]


def test_disk_cache_round_trip(tmp_path, monkeypatch):
    """Write in 'process 1', reset every in-memory state, re-plan in
    'process 2' with zero decisions and zero measurements."""
    _, tb, x = _problem()
    # the forward race times 6 candidates (the dynamic walk fastest),
    # then the backward race 6 dx and 2 dvalues candidates
    _FakeTimes(monkeypatch, [9, 8, 7, 1, 5, 6] + [3, 2, 4, 5, 6, 7]
               + [2, 1])
    ctx = sparse.PlanContext(measure=True, cache_dir=str(tmp_path))
    p1 = sparse.plan(tb, N, x=x, device="cpu", ctx=ctx)
    s1 = sparse.cache_stats()
    assert s1["measurements"] == 2 and s1["disk_writes"] >= 1
    assert p1.source == "measured" and not p1.from_disk
    assert p1.route == "dynamic_torch"
    assert p1.grad_routes == {"dx": "static_balanced_torch",
                              "dvalues": "sddmm_dense_torch"}

    sparse.reset()                          # a fresh process
    p2 = sparse.plan(tb, N, x=x, device="cpu", ctx=ctx)
    s2 = sparse.cache_stats()
    assert s2["measurements"] == 0 and s2["decisions"] == 0
    assert s2["disk_hits"] == 1
    assert p2.from_disk and p2.source == "measured"
    assert p2.route == p1.route and p2.grad_routes == p1.grad_routes
    assert p2.est_seconds == p1.est_seconds
    assert p2.artifacts["grad"]["from_disk"] is True
    torch.testing.assert_close(p2.spmm_nt(tb.values, x),
                               p1.spmm_nt(tb.values, x))
    rep = sparse.plan_report()["per_plan"][p2.key]
    assert rep["from_disk"] is True and rep["source"] == "measured"
    assert sparse.plan_report()["totals"]["grad_from_disk"] == 1


def test_restart_replays_every_route_with_zero_decisions(tmp_path):
    """Analytic verdicts of several problems (static, dynamic, dense)
    persist and a restart replays each one, forward and backward."""
    ctx = sparse.PlanContext(cache_dir=str(tmp_path))
    mask, tb, x = _problem()
    op = tdsp.encode(tb.to_dense(), torch.as_tensor(mask), block_size=16,
                     nnz_max=int(mask.sum()) + 4)
    w = torch.randn(192, 64)
    first = [sparse.plan(tb, n, device="cpu", ctx=ctx) for n in (4, N, 300)]
    first += [sparse.plan(op, N, device="cpu", ctx=ctx),
              sparse.plan(w, N, device="cpu", ctx=ctx)]
    routes = [(p.route, p.source, p.grad_routes) for p in first]
    assert sparse.cache_stats()["decisions"] == 5 + 3
    sparse.reset()
    again = [sparse.plan(tb, n, device="cpu", ctx=ctx) for n in (4, N, 300)]
    again += [sparse.plan(op, N, device="cpu", ctx=ctx),
              sparse.plan(w, N, device="cpu", ctx=ctx)]
    s = sparse.cache_stats()
    assert s["decisions"] == 0 and s["measurements"] == 0
    assert s["disk_hits"] == 5 and s["disk_misses"] == 0
    assert [(p.route, p.source, p.grad_routes) for p in again] == routes
    assert all(p.from_disk for p in again)


def test_disk_cache_stale_env_invalidated(tmp_path):
    """A file written by another toolchain or card is stale: ignored,
    counted, re-decided and overwritten."""
    _, tb, x = _problem()
    ctx = sparse.PlanContext(cache_dir=str(tmp_path))
    sparse.plan(tb, N, device="cpu", ctx=ctx)
    blob = json.load(open(_path(tmp_path)))
    assert set(blob["env"]) == {"schema", "torch", "cuda", "device", "gpu"}
    assert blob["env"]["schema"] == cache_lib.SCHEMA_VERSION
    blob["env"]["gpu"] = "another card"
    json.dump(blob, open(_path(tmp_path), "w"))
    sparse.reset()
    p = sparse.plan(tb, N, device="cpu", ctx=ctx)
    s = sparse.cache_stats()
    assert not p.from_disk and s["stale_drops"] == 1
    assert s["decisions"] == 2 and s["disk_writes"] == 1
    assert json.load(open(_path(tmp_path)))["env"]["gpu"] != "another card"


def test_disk_cache_other_schema_is_another_file(tmp_path, monkeypatch):
    """A schema bump reads another file name: an old record never answers
    (the reference's pre-capacity invalidation)."""
    _, tb, x = _problem()
    ctx = sparse.PlanContext(cache_dir=str(tmp_path))
    key = sparse.plan(tb, N, device="cpu", ctx=ctx).key
    sparse.reset()
    monkeypatch.setattr(cache_lib, "SCHEMA_VERSION",
                        cache_lib.SCHEMA_VERSION + 1)
    p = sparse.plan(tb, N, device="cpu", ctx=ctx)
    assert p.key == key and not p.from_disk
    assert sparse.cache_stats()["disk_misses"] == 1
    assert len(os.listdir(str(tmp_path))) == 2


def test_disk_cache_corrupt_file_ignored(tmp_path):
    _, tb, _ = _problem()
    with open(_path(tmp_path), "w") as f:
        f.write("{not json")
    p = sparse.plan(tb, N, device="cpu",
                    ctx=sparse.PlanContext(cache_dir=str(tmp_path)))
    assert not p.from_disk
    assert sparse.cache_stats()["stale_drops"] == 1
    # the next store replaces it with a whole file (no temporary left)
    assert json.load(open(_path(tmp_path)))["entries"]
    assert os.listdir(str(tmp_path)) == [os.path.basename(_path(tmp_path))]


def test_explicit_persist_without_dir_raises(monkeypatch):
    monkeypatch.delenv("REPRO_CACHE_DIR", raising=False)
    _, tb, _ = _problem()
    with pytest.raises(ValueError, match="no cache directory"):
        sparse.plan(tb, N, device="cpu",
                    ctx=sparse.PlanContext(persist=True))


def test_no_persistence_without_cache_dir(monkeypatch):
    monkeypatch.delenv("REPRO_CACHE_DIR", raising=False)
    _, tb, x = _problem()
    sparse.plan(tb, N, device="cpu")
    s = sparse.cache_stats()
    assert s["disk_writes"] == 0 and s["disk_hits"] == 0


def test_configure_and_env_set_the_default_dir(tmp_path, monkeypatch):
    _, tb, _ = _problem()
    sparse.configure(str(tmp_path / "a"))
    sparse.plan(tb, N, device="cpu")
    assert os.path.exists(_path(tmp_path / "a"))
    sparse.configure(None)
    sparse.reset()
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "b"))
    sparse.plan(tb, N, device="cpu")
    assert os.path.exists(_path(tmp_path / "b"))
    # persist=False overrides a configured directory
    sparse.reset()
    sparse.plan(tb, N, device="cpu", ctx=sparse.PlanContext(persist=False))
    assert sparse.cache_stats()["disk_hits"] == 0


def test_disk_cache_carries_capacity_fields(tmp_path):
    """A grouped dynamic plan's planned capacity rides in its record and
    a restart re-plans the identical bucket."""
    mask, tb, x = _problem()
    op = tdsp.encode(tb.to_dense(), torch.as_tensor(mask), block_size=16,
                     nnz_max=int(mask.sum()) + 4)
    ctx = sparse.PlanContext(mode="dynamic_grouped", cache_dir=str(tmp_path))
    p1 = sparse.plan(op, N, device="cpu", ctx=ctx)
    rec = json.load(open(_path(tmp_path)))["entries"][p1.key]
    assert rec["route"] == "dynamic_grouped_torch"
    assert rec["source"] == "forced"
    cap = rec["capacity"]
    assert cap["tiles_cap"] == p1.artifacts["grouped_tiles_cap"]
    assert cap["headroom"] == ctx.resolved_headroom()
    assert {"tile", "expected_tiles", "worst_tiles", "overflow_p",
            "policy"} <= set(cap) and "escalated" not in cap
    sparse.reset()
    p2 = sparse.plan(op, N, device="cpu", ctx=ctx)
    assert p2.from_disk and p2.tiles_cap == cap["tiles_cap"]
    torch.testing.assert_close(p2.spmm_nt(op, x), p1.spmm_nt(op, x),
                               rtol=0, atol=0)


def test_escalation_persists_worst_capacity(tmp_path):
    """A tripped overflow guardrail writes the escalated verdict at once:
    the restart plans at worst-case capacity."""
    mask, tb, x = _problem()
    op = tdsp.encode(tb.to_dense(), torch.as_tensor(mask), block_size=16,
                     nnz_max=int(mask.sum()) + 4)
    ctx = sparse.PlanContext(mode="dynamic_grouped", cache_dir=str(tmp_path),
                             headroom=0.05, overflow_threshold=0.1)
    p = sparse.plan(op, N, device="cpu", ctx=ctx)
    worst = p.artifacts["capacity"]["worst_tiles"]
    assert p.tiles_cap < worst
    for _ in range(6):
        p.spmm_nt(op, x)
    assert p.capacity_stats.escalated
    rec = json.load(open(_path(tmp_path)))["entries"][p.key]
    assert rec["capacity"]["policy"] == "worst"
    sparse.reset()
    q = sparse.plan(op, N, device="cpu", ctx=ctx)
    assert q.from_disk and q.capacity_stats.escalated
    assert q.artifacts["capacity"]["policy"] == "worst"
    assert sparse.cache_stats()["decisions"] == 0


def test_backward_verdicts_on_disk_and_in_the_key(tmp_path):
    """The backward verdicts ride in the forward record; the backward
    knobs are part of the key (a forced dL/dx never answers for a raced
    one)."""
    _, tb, x = _problem()
    auto = sparse.PlanContext(cache_dir=str(tmp_path))
    forced = sparse.PlanContext(cache_dir=str(tmp_path), grad_mode="dense",
                                sddmm_mode="sddmm_dense")
    pa = sparse.plan(tb, N, device="cpu", ctx=auto)
    pf = sparse.plan(tb, N, device="cpu", ctx=forced)
    assert pa.key != pf.key
    entries = json.load(open(_path(tmp_path)))["entries"]
    for p in (pa, pf):
        g = entries[p.key]["grad"]
        assert set(g) == {"dx", "dvalues"}
        assert {g[s]["route"] for s in g} == set(p.grad_routes.values())
        assert set(g["dx"]) == {"route", "source", "est_seconds"}
    assert entries[pf.key]["grad"]["dx"]["source"] == "forced"
    sparse.reset()
    again = sparse.plan(tb, N, device="cpu", ctx=forced)
    assert again.grad_routes == {"dx": "dense_torch",
                                 "dvalues": "sddmm_dense_torch"}
    assert sparse.cache_stats()["decisions"] == 0
    v = tb.values.clone().requires_grad_(True)
    xx = x.clone().requires_grad_(True)
    again.spmm_nt(v, xx).sum().backward()
    w = tb.to_dense().clone().requires_grad_(True)
    x2 = x.clone().requires_grad_(True)
    (x2 @ w.t()).sum().backward()
    torch.testing.assert_close(xx.grad, x2.grad, rtol=1e-4, atol=1e-4)


def test_non_differentiable_plan_has_no_grad_section(tmp_path):
    _, tb, _ = _problem()
    p = sparse.plan(tb, N, device="cpu", ctx=sparse.PlanContext(
        cache_dir=str(tmp_path), differentiable=False))
    assert "grad" not in json.load(open(_path(tmp_path)))["entries"][p.key]
    assert sparse.plan_report()["per_plan"][p.key]["grad"] == {
        "mode": "unavailable"}


def test_remeasure_plan_upgrades_and_persists(tmp_path, monkeypatch):
    """The re-planner's body: an analytic plan is timed on synthesized
    inputs, its measured verdict installed and persisted, the stale plan
    dropped; the next plan() and a restart both adopt it."""
    _, tb, _ = _problem()
    ctx = sparse.PlanContext(cache_dir=str(tmp_path))
    p = sparse.plan(tb, N, device="cpu", ctx=ctx)
    assert p.source == "analytic" and sparse.analytic_plans() == [p]
    times = _FakeTimes(monkeypatch, [9, 8, 7, 6, 1, 5])
    out = sparse.remeasure_plan(p)
    assert times.calls == 6
    assert out["upgraded"] and out["route_before"] == p.route
    assert out["route_after"] == "dynamic_grouped_torch"
    assert sparse.cache_stats()["measurements"] == 1
    assert not sparse.is_live(p) and sparse.analytic_plans() == []
    assert sparse.remeasure_plan(p) is None       # done once
    q = sparse.plan(tb, N, device="cpu", ctx=ctx)
    assert q.route == "dynamic_grouped_torch" and q.source == "measured"
    assert q.from_disk and q.grad_routes == p.grad_routes
    sparse.reset()
    r = sparse.plan(tb, N, device="cpu", ctx=ctx)
    assert r.route == q.route and r.source == "measured"
    assert sparse.cache_stats()["decisions"] == 0


def test_remeasure_skips_forced_and_measured_plans(monkeypatch):
    _, tb, x = _problem()
    forced = sparse.plan(tb, N, device="cpu",
                         ctx=sparse.PlanContext(mode="static"))
    assert forced.source == "forced"
    assert sparse.remeasure_plan(forced) is None
    _FakeTimes(monkeypatch, [1.0])
    measured = sparse.plan(tb, N, x=x, device="cpu",
                           ctx=sparse.PlanContext(measure=True))
    assert measured.source == "measured"
    assert sparse.remeasure_plan(measured) is None


def test_synth_inputs_follow_the_spec():
    mask, tb, _ = _problem()
    p = sparse.plan(tb, N, device="cpu")
    synth = sparse.plan.__globals__["_synth_inputs"]
    op, x = synth(p.spec, p.pattern, 0, torch.device("cpu"))
    assert x.shape == (N, 192) and op.values.shape == tb.values.shape
    np.testing.assert_array_equal(op.row_idx, tb.row_idx)
    op2, x2 = synth(p.spec, p.pattern, 0, torch.device("cpu"))
    assert torch.equal(op.values, op2.values) and torch.equal(x, x2)
    dspec = sparse.OpSpec(kind="dynamic", m=128, k=192, n=8, block_size=16,
                          density=0.25)
    dop, dx = synth(dspec, None, 1, torch.device("cpu"))
    assert dop.shape == (128, 192) and dx.shape == (8, 192)


def _smoke_lm():
    cfg = tconfigs.sparsify_ffn(tconfigs.smoke("llama3_2_1b"), 0.25)
    return LM(cfg, device="cpu", seed=0)


def _serve(eng, seed=5):
    rng = np.random.default_rng(seed)
    reqs = [Request(uid=i, prompt=rng.integers(0, 256, size=n),
                    max_new_tokens=3) for i, n in enumerate((3, 9, 14))]
    eng.run(reqs)
    return [r.output for r in reqs]


def test_engine_plan_cache_dir_restart_is_decision_free(tmp_path,
                                                        monkeypatch):
    """``Engine(plan_cache_dir=)`` persists every verdict its startup
    pass makes; a fresh engine from that directory replays them (from
    disk, zero decisions) and generates the same tokens, also after the
    re-planner upgraded the pool's verdicts to measured ones."""
    lm = _smoke_lm()
    eng = Engine(lm, batch=2, max_len=32, buckets=(8, 16), device="cpu",
                 plan_cache_dir=str(tmp_path))
    assert eng.plan_ctx.persist is True
    assert eng.plan_stats["decisions"] > 0
    tokens = _serve(eng)
    rep = eng.plan_report()["plans"]["per_plan"]
    assert rep and all(r["from_disk"] is False for r in rep.values())
    assert {r["source"] for r in rep.values()} <= {"analytic", "forced"}
    _FakeTimes(monkeypatch, [3.0, 2.0, 1.0, 4.0, 5.0, 6.0])
    upgraded = [sparse.remeasure_plan(p)
                for p in sparse.analytic_plans(eng.pool)]
    assert upgraded and all(u["upgraded"] for u in upgraded)
    sparse.reset()                                  # a fresh process
    again = Engine(lm, batch=2, max_len=32, buckets=(8, 16), device="cpu",
                   plan_cache_dir=str(tmp_path))
    assert again.plan_stats["decisions"] == 0
    assert again.plan_report()["startup"]["decisions"] == 0
    rep2 = again.plan_report()["plans"]["per_plan"]
    static = [r for r in rep2.values() if r["kind"] == "static"]
    assert static and all(r["from_disk"] and r["source"] == "measured"
                          for r in static)
    assert all(r["route"] == "dense_torch" for r in static)
    assert _serve(again) == tokens
