"""The port's cost calibration against the JAX package's
(``tests/test_cost_calibration.py``): ``CostCoeffs`` load / apply /
digest semantics, the identity reproducing the hand-tuned H100 model bit
for bit, a non-identity digest joining the decision key, the plan
fingerprint and the disk key (a refit orphans a disk verdict), the
engine keeping the prices it was built with; and ``analysis.calibrate``
on the committed H100 corpus: an idempotent refit that reproduces the
committed ``cost_coeffs.json`` byte for byte, a synthetic 1.3x scale
recovered, a bad glob and an empty corpus raising, and every corpus
record replaying the analytic race it came from.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis import calibrate as jcalibrate  # noqa: E402
from repro.core import dispatch as jdispatch  # noqa: E402
from repro.core import masks as jmasks  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import sparse  # noqa: E402
from repro_torch.analysis import calibrate  # noqa: E402
from repro_torch.core import dispatch  # noqa: E402
from repro_torch.core.bsr import BlockSparseMatrix as TBSR  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.serve import Engine  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402

STATIC = tuple(f + "_cuda" for f in sparse.spec.ADMISSIBLE["static"])
SDDMM = tuple(f + "_cuda" for f in dispatch.SDDMM_FAMILIES)


@pytest.fixture
def _restore_coeffs():
    prev = dispatch.cost_coeffs()
    try:
        yield
    finally:
        dispatch.set_cost_coeffs(prev)
        sparse.reset()


def _bsr(m=256, k=256, b=16, density=0.25, seed=0, kind="uniform"):
    gen = {"uniform": jmasks.random_block_mask,
           "power_law": jmasks.power_law_block_mask}[kind]
    mask = gen(m, k, b, density, seed=seed)
    mask[0, 0] = True
    return TBSR.from_mask(mask, b, values=torch.zeros(
        (int(mask.sum()), b, b)))


# -- CostCoeffs ----------------------------------------------------------------

def test_load_missing_or_garbage_file_is_identity(tmp_path):
    c = dispatch.load_cost_coeffs(str(tmp_path / "none.json"))
    assert c.is_identity and c.digest == "" and c is dispatch.IDENTITY_COEFFS
    bad = tmp_path / "cost_coeffs.json"
    for text in ("{not json", '{"routes": 42}'):
        bad.write_text(text)
        assert dispatch.load_cost_coeffs(str(bad)).is_identity


def test_apply_affine_and_unknown_route_passthrough():
    c = dispatch.CostCoeffs(route_scale={"static_cuda": 2.0},
                            route_fixed_us={"static_cuda": 5.0},
                            digest="abc")
    assert c.apply("static_cuda", 1e-6) == pytest.approx(7e-6)
    assert c.apply("dynamic_cuda", 3e-6) == pytest.approx(3e-6)
    j = jdispatch.CostCoeffs(route_scale={"static_xla": 2.0},
                             route_fixed_us={"static_xla": 5.0},
                             digest="abc")
    assert c.apply("static_cuda", 1e-6) == j.apply("static_xla", 1e-6)


@pytest.mark.parametrize("routes,skew,version", [
    ({"static_cuda": {"scale": 1.1, "fixed_us": 2.0, "n_obs": 9}},
     {"imb_slope": 0.4}, 1),
    ({}, {}, 1),
    ({"dense_cuda": {"scale": 0.9}}, {"cv_slope": 0.2, "cap": 2.0}, 2)])
def test_digest_is_the_reference_hash_over_the_port_knees(routes, skew,
                                                         version):
    """The reference's content hash, its skew defaults replaced by the
    port's hand-tuned knees; diagnostics excluded, values included."""
    d = dispatch.coeffs_digest(routes, skew, version)
    full = dict(dispatch.SKEW_KNEES, **skew)
    # the reference's payload with the port's knees spelled out equals it
    jd = jdispatch.coeffs_digest(routes, {
        "imb_knee": full["imb_knee"], "imb_slope": full["imb_slope"],
        "cv_knee": full["cv_knee"], "cv_slope": full["cv_slope"],
        "cap": full["cap"]}, version)
    assert d == jd
    assert d == dispatch.coeffs_digest(
        {r: {k: v for k, v in c.items() if k != "n_obs"}
         for r, c in routes.items()}, skew, version)
    assert dispatch.coeffs_digest(routes, skew, version + 1) != d


def test_file_roundtrip_through_loader(tmp_path):
    blob = {"version": 1,
            "routes": {"static_cuda": {"scale": 1.5, "fixed_us": 2.5}},
            "skew": {"imb_knee": 1.5, "imb_slope": 0.5, "cv_knee": 0.3,
                     "cv_slope": 0.2, "cap": 2.5}}
    path = tmp_path / "cost_coeffs.json"
    path.write_text(json.dumps(blob))
    c = dispatch.load_cost_coeffs(str(path))
    assert not c.is_identity
    assert c.route_scale == {"static_cuda": 1.5}
    assert c.route_fixed_us == {"static_cuda": 2.5}
    assert c.skew() == blob["skew"]
    assert c.digest == dispatch.coeffs_digest(blob["routes"], blob["skew"],
                                              1)
    # absent skew keys are the port's hand-tuned knees
    path.write_text(json.dumps({"routes": {}}))
    assert dispatch.load_cost_coeffs(str(path)).skew() == \
        dispatch.SKEW_KNEES


# -- the identity is the hand-tuned model -------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 4, 300, 2048])
def test_identity_reproduces_the_hand_tuned_model(dtype, n, _restore_coeffs):
    """Under the identity every estimate is the raw walk model, bit for
    bit, whichever calibration is active."""
    b = _bsr(512, 256, 16, 0.3, kind="power_law")
    counts = dispatch.static_counts(b.row_idx, b.col_idx, 512, 256, 16)
    imb, cv = dispatch.pattern_balance(b)
    dispatch.set_cost_coeffs(dispatch.IDENTITY_COEFFS)
    for route in STATIC + SDDMM + tuple(
            r.replace("_cuda", "_torch") for r in STATIC):
        raw = dispatch._estimate_raw(route, 512, 256, n, 16, 0.3, dtype,
                                     imbalance=imb, cv=cv, counts=counts)
        assert dispatch._estimate(route, 512, 256, n, 16, 0.3, dtype,
                                  imbalance=imb, cv=cv,
                                  counts=counts) == raw
        assert dispatch._estimate(
            route, 512, 256, n, 16, 0.3, dtype, imbalance=imb, cv=cv,
            counts=counts, coeffs=dispatch.IDENTITY_COEFFS) == raw
    assert dispatch._skew_factor(imb, cv) == min(
        dispatch.SKEW_KNEES["cap"], 1.0 + dispatch.SKEW_KNEES["imb_slope"]
        * max(0.0, imb - dispatch.SKEW_KNEES["imb_knee"]))


def test_calibrated_estimate_applies_the_card_route_terms(_restore_coeffs):
    """The fitted terms of a card route price its plain version too, so
    the CPU's analytic verdict stays the card's."""
    args = ("static_cuda", 1024, 1024, 256, 16, 0.25, "float32")
    raw = dispatch._estimate_raw(*args)
    dispatch.set_cost_coeffs(dispatch.CostCoeffs(
        route_scale={"static_cuda": 2.0},
        route_fixed_us={"static_cuda": 10.0}, digest="t"))
    assert dispatch._estimate(*args) == pytest.approx(2.0 * raw + 10e-6)
    assert dispatch._estimate("static_torch", *args[1:]) == \
        dispatch._estimate(*args)
    assert dispatch._estimate("dense_cuda", *args[1:]) == \
        dispatch._estimate_raw("dense_cuda", *args[1:])


def test_skew_knees_come_from_the_active_coefficients(_restore_coeffs):
    dispatch.set_cost_coeffs(dispatch.CostCoeffs(
        skew_imb_knee=1.0, skew_imb_slope=0.5, skew_cv_slope=0.0,
        digest="k"))
    assert dispatch._skew_factor(3.0, 0.0) == pytest.approx(2.0)
    assert dispatch._skew_factor(3.0, 0.0,
                                 dispatch.IDENTITY_COEFFS) == 1.015


def test_cache_key_and_fingerprint_join_a_nonidentity_digest(
        tmp_path, _restore_coeffs):
    """A refit's digest joins the decision key, the plan fingerprint and
    the disk key: a verdict persisted under the old coefficients is
    orphaned (a fresh decision, not a disk hit)."""
    args = ("static", 1024, 1024, 256, 16, 0.25, "float32")
    dispatch.set_cost_coeffs(dispatch.IDENTITY_COEFFS)
    key_id = dispatch._cache_key(*args)
    assert "coeffs" not in key_id
    ctx = sparse.PlanContext(cache_dir=str(tmp_path))
    b = _bsr()
    sparse.reset()
    k1 = sparse.plan(b, 64, device="cpu", ctx=ctx).key
    sparse.reset()
    assert sparse.plan(b, 64, device="cpu", ctx=ctx).from_disk
    dispatch.set_cost_coeffs(dispatch.CostCoeffs(digest="deadbeef0000"))
    key_cal = dispatch._cache_key(*args)
    assert key_cal[-2:] == ("coeffs", "deadbeef0000")
    assert key_cal[:-2] == key_id
    sparse.reset()
    p = sparse.plan(b, 64, device="cpu", ctx=ctx)
    assert p.key != k1 and not p.from_disk
    assert sparse.cache_stats()["decisions"] >= 1


def test_set_cost_coeffs_clears_the_caches(_restore_coeffs):
    shapes = ((4096, 2048), (2048, 2048))
    dispatch.set_cost_coeffs(dispatch.IDENTITY_COEFFS)
    base = dispatch.price_tokens(shapes, 64)
    dispatch.decide(sparse.OpSpec(kind="dense", m=64, k=64, n=8), "cpu")
    assert dispatch.cache_stats()["entries"] == 1
    dispatch.set_cost_coeffs(dispatch.CostCoeffs(
        route_scale={"dense_cuda": 2.0}, digest="x2"))
    assert dispatch.cache_stats()["entries"] == 0
    assert dispatch.price_tokens(shapes, 64) == pytest.approx(2 * base)
    dispatch.set_cost_coeffs(None)
    assert dispatch.cost_coeffs().digest == dispatch.load_cost_coeffs(
        ).digest


def test_the_committed_fit_is_read_unless_the_env_names_a_file(
        tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_COST_COEFFS", raising=False)
    assert dispatch.load_cost_coeffs().digest == json.load(
        open(dispatch.COEFFS_PATH))["digest"]
    path = tmp_path / "c.json"
    path.write_text(json.dumps({"routes": {"dense_cuda": {"scale": 2.0}}}))
    monkeypatch.setenv("REPRO_TORCH_COST_COEFFS", str(path))
    assert dispatch.load_cost_coeffs().route_scale == {"dense_cuda": 2.0}


def test_engine_keeps_the_prices_it_was_built_with(_restore_coeffs):
    cfg = dataclasses.replace(tconfigs.smoke("llama3_2_1b"),
                              dtype="float32")
    lm = LM(cfg, device="cpu", seed=0)
    dispatch.set_cost_coeffs(dispatch.IDENTITY_COEFFS)
    eng = Engine(lm, batch=2, max_len=96, device="cpu", warm_plans=False)
    price = eng._price(40)
    ladder = eng.buckets
    wrong = dispatch.CostCoeffs(route_fixed_us={"dense_cuda": 100.0},
                                route_scale={"dense_cuda": 0.25},
                                digest="w")
    dispatch.set_cost_coeffs(wrong)
    assert eng._price(40) == price and eng._price(41) == \
        dispatch.price_tokens(eng._shapes, 41, dtype="float32",
                              coeffs=dispatch.IDENTITY_COEFFS)
    again = Engine(lm, batch=2, max_len=96, device="cpu", warm_plans=False)
    assert again._price(40) != price
    assert again.buckets == tengine._auto_buckets(
        95, eng._shapes, 0.75, dtype="float32", coeffs=wrong)
    assert eng.buckets == ladder


# -- the corpus and the fit ---------------------------------------------------

def test_committed_corpus_refit_is_the_committed_file(tmp_path):
    """Idempotence: a refit of the committed corpus writes the committed
    ``cost_coeffs.json`` byte for byte, whatever calibration is active."""
    obs = calibrate.load_corpus()
    assert len(obs) >= 50
    assert {o.fig for o in obs} <= set(calibrate.EXTRACTORS)
    assert all(o.route.endswith("_cuda") for o in obs)
    out = tmp_path / "cost_coeffs.json"
    assert calibrate.main(["--out", str(out)]) == 0
    committed = open(calibrate.DEFAULT_OUT, "rb").read()
    assert out.read_bytes() == committed
    blob = json.loads(committed)
    assert blob == calibrate.fit(obs)
    assert dispatch.load_cost_coeffs(calibrate.DEFAULT_OUT).digest == \
        blob["digest"]
    assert calibrate.DEFAULT_OUT == dispatch.COEFFS_PATH
    header = json.load(open(os.path.join(
        calibrate.BASELINE_DIR, blob["corpus"]["files"][0])))["header"]
    assert header["card"].startswith("NVIDIA H100")
    assert header["torch"] and header["cuda"]


def test_corpus_records_replay_their_races():
    """Each observation carries the raw model's inputs: the identity
    prices it finite and positive, as the race did."""
    for o in calibrate.load_corpus():
        assert calibrate._raw_us(o) > 0 and o.measured_us > 0


@pytest.mark.parametrize("kind", ["static", "dynamic"])
@pytest.mark.parametrize("n", [4, 300])
def test_model_inputs_replay_the_plan_race(kind, n, _restore_coeffs):
    """The inputs a corpus record keeps reproduce the plan's analytic
    estimates exactly: forward, and for a static plan both backward
    products."""
    dispatch.set_cost_coeffs(dispatch.IDENTITY_COEFFS)
    sparse.reset()
    b = _bsr(512, 256, 16, 0.3, kind="power_law")
    if kind == "static":
        p = sparse.plan(b, n, device="cpu")
    else:
        from repro_torch.core.dynamic_sparse import DynamicOperand
        op = DynamicOperand(b.values, torch.as_tensor(b.row_idx),
                            torch.as_tensor(b.col_idx),
                            torch.tensor(len(b.row_idx)), (512, 256), 16)
        p = sparse.plan(op, n, device="cpu")
    got = calibrate.price(calibrate.plan_model_inputs(p),
                          list(p.est_seconds))
    assert got == p.est_seconds
    if kind == "static":
        for side, inputs in calibrate.grad_model_inputs(p).items():
            est = p.artifacts["grad"][side]["est_seconds"]
            assert calibrate.price(inputs, list(est)) == est, side


def _obs(route, m, n, scale, **kw):
    b = _bsr(m, m, 16, 0.25, seed=m)
    inputs = calibrate.static_model_inputs(b.row_idx, b.col_idx, m, m, n,
                                           16, "bfloat16")
    o = calibrate.Observation(
        fig="race", route=route, m=m, k=m, n=n, b=16,
        density=inputs["density"], dtype="bfloat16",
        imbalance=inputs["imbalance"], cv=inputs["cv"], kind="static",
        counts=inputs["counts"], **kw)
    return dataclasses.replace(o, measured_us=scale * calibrate._raw_us(o))


def test_fit_recovers_synthetic_scale(_restore_coeffs):
    obs = [_obs("static_cuda", m, n, 1.3)
           for m, n in ((256, 64), (512, 128), (1024, 256), (2048, 256),
                        (4096, 512))]
    blob = calibrate.fit(obs)
    c = blob["routes"]["static_cuda"]
    assert c["scale"] == pytest.approx(1.3, abs=0.02)
    assert c["fixed_us"] == 0.0
    assert c["median_rel_err"] < 0.01
    # the knees and the cap are kept; only the slopes are fitted
    for key in ("imb_knee", "cv_knee", "cap"):
        assert blob["skew"][key] == dispatch.SKEW_KNEES[key]
    # within the snap of identity: no correction at all
    near = calibrate.fit([dataclasses.replace(
        o, measured_us=o.measured_us / 1.3 * 1.01) for o in obs])
    assert near["routes"]["static_cuda"]["scale"] == 1.0


@pytest.mark.parametrize("n_obs", [1, 2])
def test_fit_keeps_the_identity_below_the_minimum_observations(
        n_obs, _restore_coeffs):
    """A route with fewer than ``MIN_SCALE_OBS`` points gets no
    correction, however far its ratios are from 1 (the reference fits
    their median ratio)."""
    obs = [_obs("sddmm_dense_cuda", m, 256, 1.6)
           for m in (512, 1024)[:n_obs]]
    xs = np.array([calibrate._raw_us(o) for o in obs])
    ys = np.array([o.measured_us for o in obs])
    assert jcalibrate._fit_route(xs, ys)[0] == pytest.approx(1.6)
    assert calibrate._fit_route(xs, ys) == (1.0, 0.0)
    c = calibrate.fit(obs)["routes"]["sddmm_dense_cuda"]
    assert (c["scale"], c["fixed_us"], c["n_obs"]) == (1.0, 0.0, n_obs)


def test_fit_weighs_each_point_by_its_relative_error():
    """On exact affine points the port's fit is the reference's; across
    three decades the reference's unweighted fit is the large points'
    alone, while the port's keeps every point's relative error small."""
    xs = np.array([10.0, 20.0, 50.0, 400.0, 3000.0, 20000.0])
    ys = 1.1 * xs + 4.0
    assert calibrate._fit_route(xs, ys) == pytest.approx(
        jcalibrate._fit_route(xs, ys))
    rng = np.random.default_rng(0)
    worse = 0
    for _ in range(20):
        noisy = ys * rng.uniform(0.9, 1.1, size=xs.size)
        rel = {}
        for name, mod in (("port", calibrate), ("ref", jcalibrate)):
            s, f = mod._fit_route(xs, noisy)
            rel[name] = np.median(np.abs(s * xs + f - noisy) / noisy)
        worse += rel["port"] > rel["ref"] + 1e-12
    assert worse <= 2
    assert calibrate._snap(1.01, 1.0, 0.02) == jcalibrate._snap(
        1.01, 1.0, 0.02)


def test_load_corpus_bad_glob_raises():
    with pytest.raises(FileNotFoundError, match="matched nothing"):
        calibrate.load_corpus(["/nonexistent/H100_*.json"])


def test_fit_empty_corpus_raises():
    with pytest.raises(ValueError, match="empty corpus"):
        calibrate.fit([])
