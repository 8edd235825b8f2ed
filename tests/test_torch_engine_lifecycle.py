"""The port's serving engine's plan-first startup lifecycle against the
JAX package's (``tests/test_serve.py``), at the smoke config on the CPU:
plan pools and the ambient planning context, the startup ``warm_plans``
pass and its ``plan_stats``, zero plans and decisions while serving
after it, ``stats()`` / ``plan_report()`` and their fields,
``priced_waste_s``, ``telemetry``, ``pad_safe``; greedy tokens equal to
the JAX engine's; and the capture-safe pieces the card's CUDA graphs
need (expert counts without ``bincount``, a combine in a fixed order,
device ids used without a copy).  The graphs themselves run only on a
card (``tests/test_torch_cuda.py``); on the CPU the engine runs its
programs eagerly and ``graphs=True`` raises.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import sparse as jsparse  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve.engine import _pad_safe as j_pad_safe  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import sparse  # noqa: E402
from repro_torch.core import capture  # noqa: E402
from repro_torch.core import dispatch  # noqa: E402
from repro_torch.core.sparse_layers import SparseLinear  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.model import LM as TLM  # noqa: E402
from repro_torch.serve import Engine, Request  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402

VOCAB = 512
BUCKETS = (8, 16)


def _tcfg(arch="llama3_2_1b"):
    cfg = tconfigs.smoke(arch)
    if cfg.moe is None:
        cfg = tconfigs.sparsify_ffn(cfg, 0.25)
    return dataclasses.replace(cfg, dtype="float32")


def _jcfg(tcfg, arch="llama3_2_1b"):
    jcfg = dataclasses.replace(jconfigs.smoke(arch), groups=tcfg.groups,
                               ffn_density=tcfg.ffn_density,
                               dtype="float32")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg


@pytest.fixture(scope="module")
def pair():
    """The llama smoke LM with a sparse FFN (d = 1/4) in both packages,
    the port's carrying the JAX weights."""
    tcfg = _tcfg()
    jlm = JLM(_jcfg(tcfg))
    params = jlm.init(jax.random.PRNGKey(3))
    tlm = TLM(tcfg, device="cpu").load_jax_params(
        jax.tree.map(np.asarray, params))
    return jlm, params, tlm


@pytest.fixture(scope="module")
def jengine(pair):
    """The reference engine over the same weights, built first after
    the reference's own ``sparse.reset`` (so its startup pass builds)."""
    jlm, params, _ = pair
    jsparse.reset()
    return JEngine(jlm, params, batch=2, max_len=32, buckets=BUCKETS)


def _fresh_lm():
    """A new LM (no plan cached on its layers) after ``sparse.reset``."""
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


def _static_plans(lm):
    return [m._plan for m in lm.modules() if isinstance(m, SparseLinear)]


# -- plan pools --------------------------------------------------------------

def test_pool_registers_engine_plans():
    """Every plan of the engine's pool was built under its context, the
    static FFN plans included; the pool label changes neither a plan's
    key nor the cached plan or its route."""
    lm = _fresh_lm()
    eng = _engine(lm)
    plans = sparse.pool_plans(eng.pool)
    assert plans, "warm_plans must register plans under the engine pool"
    assert all(p.ctx.pool == eng.pool for p in plans)
    static = _static_plans(lm)
    assert static and all(p is not None for p in static)
    ids = {id(p) for p in plans}
    assert {id(p) for p in static} <= ids
    assert {p.kind for p in plans} == {"static", "dense"}
    dense = next(p for p in plans if p.kind == "dense")
    other = dataclasses.replace(dense.ctx, pool="other")
    q = sparse.plan(dense.spec, device="cpu", ctx=other)
    assert q is dense and q.key == dense.key and q.route == dense.route
    assert [p.key for p in sparse.pool_plans("other")] == [dense.key]


def test_second_engine_pools_the_cached_static_plans():
    """``SparseLinear`` caches its plan on the module: a second engine
    over the same model still lists every static FFN plan in its own
    pool (the plans keep the context they were built under)."""
    lm = _fresh_lm()
    first = _engine(lm)
    second = _engine(lm)
    assert first.pool != second.pool
    ids = {id(p) for p in sparse.pool_plans(second.pool)}
    assert {id(p) for p in _static_plans(lm)} <= ids
    assert len(sparse.pool_plans(second.pool)) == len(
        sparse.pool_plans(first.pool))


def test_use_ctx_is_ambient_and_nests():
    w = torch.randn(16, 8)
    x = torch.randn(3, 16)
    sparse.reset()
    outer = sparse.PlanContext(pool="outer")
    with sparse.use_ctx(outer):
        assert sparse.current_ctx() is outer
        with sparse.use_ctx(sparse.PlanContext(pool="inner")):
            sparse.matmul(x, w)
        assert sparse.current_ctx() is outer
        sparse.matmul(x, w)
    assert sparse.current_ctx() == sparse.PlanContext()
    assert [p.ctx.pool for p in sparse.pool_plans("inner")] == ["inner"]
    # the second call hit the plan the inner context built
    assert sparse.pool_plans("outer") == sparse.pool_plans("inner")
    assert sparse.cache_stats()["plan_hits"] == 1


# -- plan-first startup ------------------------------------------------------

def test_warm_serving_zero_decisions(pair, jengine):
    """After ``warm_plans`` a stream over three buckets builds no plan
    and makes no route decision, in the port as in the reference."""
    lm = _fresh_lm()
    eng = _engine(lm, buckets=(4, 8, 16))
    assert eng.plan_stats["plans_built"] > 0
    assert eng.plan_stats["decisions"] == eng.plan_stats["plans_built"]
    assert jengine.plan_stats["plans_built"] > 0
    before = sparse.cache_stats()
    reqs = [Request(uid=i, prompt=p, max_new_tokens=3)
            for i, p in enumerate(_prompts([2, 5, 9, 3, 15, 7, 12, 4]))]
    eng.run(reqs)
    assert {r.bucket for r in reqs} == {4, 8, 16}
    after = sparse.cache_stats()
    assert after["plans_built"] == before["plans_built"]
    assert after["decisions"] == before["decisions"]
    assert after["plan_hits"] > before["plan_hits"]
    assert eng.stats()["admission"]["exact_prefills"] == 0


def test_warm_plans_off_builds_at_first_use():
    lm = _fresh_lm()
    eng = _engine(lm, warm_plans=False)
    assert eng.plan_stats == {} and sparse.cache_stats()["plans_built"] == 0
    eng.run([Request(uid=0, prompt=np.arange(5), max_new_tokens=2)])
    assert sparse.cache_stats()["plans_built"] > 0


def test_engine_tokens_match_jax_with_warm_plans(pair, jengine):
    jlm, params, tlm = pair
    prompts = _prompts([6, 7, 13])
    jeng = JEngine(jlm, params, batch=2, max_len=32, buckets=BUCKETS,
                   warm_plans=True)
    jreqs = [JRequest(uid=i, prompt=p, max_new_tokens=5)
             for i, p in enumerate(prompts)]
    jeng.run(jreqs)
    eng = _engine(tlm, warm_plans=True)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=5)
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    assert set(jeng.plan_stats) >= set(eng.plan_stats)
    for j, t in zip(jreqs, reqs):
        assert t.output == j.output, t.uid
        assert t.bucket == j.bucket


# -- stats and plan_report ---------------------------------------------------

def test_stats_and_plan_report_fields(pair, jengine):
    """The reference's ``stats()`` and ``plan_report()`` sections, less
    the ones that wait for unported modules (named in ``not_ported``)."""
    _, _, tlm = pair
    eng = _engine(tlm)
    eng.run([Request(uid=0, prompt=np.arange(1, 4), max_new_tokens=4)])
    st = eng.stats()
    jst = jengine.stats()
    assert set(jst) - {"replanner"} <= set(st)
    for section in ("padding", "admission", "step_latency"):
        assert set(jst[section]) <= set(st[section]), section
    assert set(jst["buckets"][8]) <= set(st["buckets"][8])
    assert set(jst["capacity_overflow"]) == set(st["capacity_overflow"])
    assert st["step_latency"]["count"] == st["steps"] == 3
    assert st["buckets"][8]["latency"]["count"] == 1
    assert st["padding"]["pad_tokens"] == 5          # 3 -> bucket 8
    assert st["pad_safe"] is True
    assert st["logits"] == {"checks": 4, "nonfinite": 0}
    assert st["graphs"]["enabled"] is False
    assert st["graphs"]["captures"] == 0
    rep = eng.plan_report()
    jrep = jengine.plan_report()
    assert set(jrep) - set(tengine.NOT_PORTED) <= set(rep)
    assert set(rep["not_ported"]) == {"tp", "roofline", "replanner"}
    assert not set(rep["not_ported"]) & set(rep)
    assert rep["engine"]["steps"] == 3
    assert set(rep["startup"]) == {"plans_built", "plan_hits", "decisions"}
    assert set(jrep["plans"]["totals"]) - {"evolution"} <= set(
        rep["plans"]["totals"])


def test_plan_report_lists_routes_and_backward_routes():
    lm = _fresh_lm()
    _engine(lm)
    rep = sparse.plan_report()
    per = rep["per_plan"]
    assert rep["totals"]["plans"] == len(per) == sparse.cache_stats(
        )["cached"]
    static = [r for r in per.values() if r["kind"] == "static"]
    assert static and all(r["route"] == "static_torch" for r in static)
    assert all(r["source"] == "fixed" for r in per.values())
    assert static[0]["grad"] == {
        "mode": "planned",
        "dx": {"route": "static_torch", "source": "fixed"},
        "dvalues": {"route": "sddmm_torch", "source": "fixed"}}
    assert rep["totals"]["by_route"]["static_torch"] == len(static)


def test_pad_safe_matches_the_reference():
    for arch in ("llama3_2_1b", "gemma2-2b", "qwen3-moe-30b-a3b"):
        jarch = arch.replace("-", "_")
        assert tengine._pad_safe(tconfigs.smoke(arch)) is True
        assert j_pad_safe(jconfigs.smoke(jarch)) is True
    assert j_pad_safe(jconfigs.smoke("mamba2_130m")) is False
    assert tengine._pad_safe(jconfigs.smoke("mamba2_130m")) is False


def test_priced_waste_is_the_reference_formula_on_the_port_price(pair):
    """Per bucket, the sum over its prefills of price(bucket) -
    price(prompt), priced by ``dispatch.price_tokens`` at the model's
    dtype; the padding total is their sum."""
    _, _, tlm = pair
    eng = _engine(tlm)
    lengths = [3, 6, 9, 13, 16]
    eng.run([Request(uid=i, prompt=p, max_new_tokens=2)
             for i, p in enumerate(_prompts(lengths))])
    shapes = tengine._stack_shapes(tlm.cfg)

    def price(n):
        return dispatch.price_tokens(shapes, n, dtype=tlm.cfg.dtype)

    st = eng.stats()
    want = {L: sum(price(L) - price(n) for n in lengths
                   if eng.bucket_for(n) == L) for L in eng.buckets}
    for L, w in want.items():
        assert st["buckets"][L]["priced_waste_s"] == pytest.approx(
            round(w, 9), abs=2e-9), L
    assert st["buckets"][8]["priced_waste_s"] > 0
    assert st["padding"]["priced_waste_s"] == pytest.approx(
        sum(want.values()), abs=1e-8)


def test_graphs_on_the_cpu_raise(pair):
    _, _, tlm = pair
    with pytest.raises(ValueError, match="graphs=True needs a card"):
        _engine(tlm, graphs=True)
    assert _engine(tlm, graphs=False).graphs is False
    assert _engine(tlm).graphs is False


# -- telemetry ---------------------------------------------------------------

@pytest.fixture(scope="module")
def moe_lm():
    return TLM(_tcfg("qwen3-moe-30b-a3b"), device="cpu", seed=1)


@pytest.mark.parametrize("telemetry", [True, False])
def test_engine_telemetry_records_routing_drops(moe_lm, telemetry):
    """One ``moe_dispatch`` value a layer a served forward with
    ``telemetry``, none without; the startup pass records none."""
    sparse.reset_telemetry()
    eng = Engine(moe_lm, batch=2, max_len=96, device="cpu",
                 telemetry=telemetry)
    assert sparse.dropped_history("moe_dispatch") == []
    calls = []
    admit, step = eng.admit, eng.step

    def noted_admit(req):
        calls.append("prefill")
        return admit(req)

    def noted_step():
        if eng.live:
            calls.append("decode")
        return step()

    eng.admit, eng.step = noted_admit, noted_step
    eng.run([Request(uid=i, prompt=p, max_new_tokens=3)
             for i, p in enumerate(_prompts([20, 45]))])
    hist = sparse.dropped_history("moe_dispatch")
    if telemetry:
        assert len(hist) == moe_lm.cfg.num_layers * len(calls)
        assert len(calls) >= 4
    else:
        assert hist == []


def test_record_dropped_under_a_record_is_kept_for_it():
    sparse.reset_telemetry()
    with capture.recording() as rec:
        sparse.record_dropped("moe_dispatch", torch.tensor(0.5))
        sparse.record_dropped("moe_dispatch", 0.25)
    assert sparse.dropped_history("moe_dispatch") == []
    assert [float(v) for v in rec.drops["moe_dispatch"]] == [0.5, 0.25]
    sparse.queue_dropped("moe_dispatch", torch.cat(rec.drops[
        "moe_dispatch"]))
    assert sparse.dropped_history("moe_dispatch") == [0.5, 0.25]
    with sparse.use_ctx(sparse.PlanContext(telemetry=False)):
        sparse.record_dropped("moe_dispatch", 1.0)
    assert sparse.dropped_history("moe_dispatch") == [0.5, 0.25]
    sparse.reset_telemetry()


def test_capture_hold_keeps_objects_only_under_a_record():
    obj = object()
    capture.hold(obj)                           # no record: a no-op
    with capture.recording() as outer:
        with capture.recording() as inner:
            capture.hold(obj)
        assert capture.active() is outer
    assert capture.active() is None
    assert list(inner.held.values()) == [obj] and not outer.held


# -- the capture-safe pieces -------------------------------------------------

@pytest.mark.parametrize("cf", [1.25, 0.25])
@pytest.mark.parametrize("ranking", ["sort", "cumsum"])
def test_expert_counts_match_jax_route_and_rank(cf, ranking):
    """``expert_counts`` (``scatter_add_``, no ``bincount``) gives the
    reference's ``_route_and_rank`` counts, experts with none included."""
    jcfg = dataclasses.replace(jconfigs.smoke("qwen3_moe_30b_a3b"),
                               dtype="float32")
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=cf))
    tcfg = dataclasses.replace(_tcfg("qwen3-moe-30b-a3b"), moe=jcfg.moe)
    rng = np.random.default_rng(11)
    w = (rng.standard_normal((jcfg.d_model, jcfg.moe.num_experts))
         / np.sqrt(jcfg.d_model)).astype(np.float32)
    x = rng.standard_normal((24, jcfg.d_model)).astype(np.float32)
    cap = jmoe._capacity(24, jcfg)
    want = np.asarray(jmoe._route_and_rank(jnp.asarray(x), jnp.asarray(w),
                                           jcfg, cap)[2])
    got = tmoe._route_and_rank(torch.as_tensor(x), torch.as_tensor(w),
                               tcfg, cap, ranking=ranking)[2]
    assert got.dtype == torch.long
    assert np.array_equal(got.numpy(), want)
    ids = torch.as_tensor([3, 3, 0, 7, 3], dtype=torch.long)
    assert tmoe.expert_counts(ids, 9).tolist() == np.bincount(
        ids.numpy(), minlength=9).tolist()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cf", [1.25, 0.25])
def test_combine_is_the_sequential_scatter_add(dtype, cf):
    """``combine`` equals ``index_add_`` over the flat slots on the CPU
    (a sequential scatter-add) bit for bit, with and without drops."""
    cfg = dataclasses.replace(_tcfg("qwen3-moe-30b-a3b"))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))
    g = torch.Generator().manual_seed(4)
    w = torch.randn((cfg.d_model, cfg.moe.num_experts), generator=g)
    x = torch.randn((40, cfg.d_model), generator=g)
    cap = tmoe._capacity(40, cfg)
    tfs, ws, _, dropped, _, _, _, flat = tmoe._route_and_rank(x, w, cfg,
                                                               cap)
    if cf < 1:
        assert float(dropped) > 0
    out_e = torch.randn((cfg.moe.num_experts, cap, cfg.d_model),
                        generator=g)
    want = torch.zeros((40, cfg.d_model), dtype=dtype)
    want.index_add_(0, tfs.reshape(-1), (out_e.to(dtype) * ws[
        ..., None].to(dtype)).reshape(-1, cfg.d_model))
    assert torch.equal(tmoe.combine(out_e, ws, flat, dtype), want)


def test_lm_tokens_take_a_device_long_tensor_without_a_copy(pair):
    _, _, tlm = pair
    t = torch.arange(6, dtype=torch.long)
    assert tlm._tokens(t) is t
    assert tlm._tokens(t.int()).dtype == torch.long
    assert tlm._tokens(np.arange(3)).tolist() == [0, 1, 2]
