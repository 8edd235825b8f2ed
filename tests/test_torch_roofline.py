"""The port's roofline layer against the JAX package's: the analytic work
counts (``analysis.cost`` against ``repro.analysis.hlo_cost``), the
roofline terms and route efficiency with the reference's TPU peaks
passed in (equal to the reference's outputs), the H100's own peaks by
operand type, ``OpSpec.roofline_cost``, ``MatmulPlan.roofline`` and
``sparse.roofline_report`` (mirroring ``tests/test_cost_calibration.py``'s
roofline tests), on seeded patterns on the CPU.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis import hlo_cost as jcost  # noqa: E402
from repro.analysis import roofline as jroof  # noqa: E402
from repro.core import masks as jmasks  # noqa: E402
from repro.sparse import spec as jspec  # noqa: E402
from repro_torch import sparse  # noqa: E402
from repro_torch.analysis import cost as tcost  # noqa: E402
from repro_torch.analysis import roofline as troof  # noqa: E402
from repro_torch.core.bsr import BlockSparseMatrix as TBSR  # noqa: E402

SHAPES = [(64, 128, 32), (256, 256, 4), (4096, 4096, 4096),
          (8192, 2048, 2048), (2048, 8192, 1)]
DENSITIES = [0.0, 1 / 16, 0.125, 0.5, 1.0, 1.5]


def _bsr(m=256, k=256, b=16, density=0.25, seed=0, dtype=torch.float32):
    mask = jmasks.random_block_mask(m, k, b, density, seed=seed)
    mask[0, 0] = True
    return TBSR.from_mask(mask, b, values=torch.zeros(
        (int(mask.sum()), b, b), dtype=dtype))


@pytest.fixture
def _fresh():
    sparse.reset()
    yield
    sparse.reset()


# -- analytic work counts -----------------------------------------------------

@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("bytes_el", [2, 4])
def test_cost_dicts_match_reference(m, k, n, density, bytes_el):
    for port, ref in ((tcost.spmm_cost_dict, jcost.spmm_cost_dict),
                      (tcost.sddmm_cost_dict, jcost.sddmm_cost_dict)):
        assert port(m, k, n, density=density, bytes_el=bytes_el) == \
            ref(m, k, n, density=density, bytes_el=bytes_el)


# -- roofline terms and route efficiency --------------------------------------

V5E = troof.HwSpec(jroof.V5E.name, jroof.V5E.peak_flops_bf16,
                   jroof.V5E.hbm_bw, jroof.V5E.ici_bw)
COSTS = [dict(flops=f, bytes=b, collective_bytes=c)
         for f, b, c in itertools.product((0.0, 1e9, 3e14), (1.0, 4e7, 2e11),
                                          (0.0, 5e8))]


@pytest.mark.parametrize("cost", COSTS)
@pytest.mark.parametrize("model_flops", [None, 5e8])
def test_roofline_terms_match_reference(cost, model_flops):
    want = jroof.roofline_terms(cost, jroof.V5E,
                                model_flops_per_device=model_flops)
    got = troof.roofline_terms(cost, V5E,
                               model_flops_per_device=model_flops)
    assert set(got) == set(want)
    for key, v in want.items():
        if isinstance(v, str):
            assert got[key] == v
        else:
            assert got[key] == pytest.approx(v, rel=1e-12, abs=1e-300)


@pytest.mark.parametrize("cost", COSTS)
@pytest.mark.parametrize("est", [1e-6, 1e-3, 2.5])
@pytest.mark.parametrize("flag", [2.0, 20.0])
def test_route_efficiency_matches_reference(cost, est, flag):
    want = jroof.route_efficiency(est, cost, jroof.V5E, flag_headroom=flag)
    got = troof.route_efficiency(est, cost, V5E, flag_headroom=flag)
    assert set(got) == set(want)
    for key, v in want.items():
        if isinstance(v, (str, bool)):
            assert got[key] == v, key
        else:
            assert got[key] == pytest.approx(v, rel=1e-12), key


def test_model_flops_match_reference():
    for n, d in ((1.2e9, 2048), (3e10, 1)):
        assert troof.model_flops_train(n, d) == jroof.model_flops_train(n, d)
        assert troof.model_flops_forward(n, d) == \
            jroof.model_flops_forward(n, d)


def test_h100_peaks_follow_the_operand_type():
    h = troof.H100
    assert h.name == "NVIDIA H100 80GB HBM3"
    assert troof.PEAK_BYTES == h.hbm_bw == 3.35e12
    assert troof.PEAK_FLOPS == {"bfloat16": 989e12, "float16": 989e12,
                                "float32": 67e12}
    assert h.peak_flops(torch.float32) == 67e12
    assert h.peak_flops(None) == h.peak_flops("bfloat16") == 989e12
    cost = dict(flops=67e12, bytes=0.0, collective_bytes=0.0)
    assert troof.roofline_terms(cost, dtype="float32")["bound_seconds"] == \
        pytest.approx(1.0)
    assert troof.roofline_terms(cost, dtype="bfloat16")["bound_seconds"] \
        == pytest.approx(67 / 989)
    # one card: no collective term
    assert troof.roofline_terms(dict(cost, collective_bytes=1e9))[
        "t_collective"] == pytest.approx(1e9 / 900e9)
    # a reference spec without an fp32 peak uses its one peak
    assert V5E.peak_flops("float32") == jroof.V5E.peak_flops_bf16


# -- the plan layer -----------------------------------------------------------

# port route -> the reference route of the same work
REF_ROUTE = {"dense_torch": "dense_xla", "static_torch": "static_xla",
             "static_balanced_torch": "static_balanced",
             "dynamic_torch": "dynamic_xla",
             "dynamic_grouped_torch": "dynamic_grouped",
             "dynamic_grouped_balanced_torch": "dynamic_grouped_balanced",
             "sddmm_torch": "sddmm_xla", "sddmm_dense_torch": "sddmm_dense"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("density", [0.125, 0.5])
def test_roofline_cost_matches_reference(dtype, density):
    """Each route pays the work it executes, as the reference's spec
    prices it: the dense routes and the dense SDDMM the full product,
    the sparse ones the pattern's share."""
    t = sparse.OpSpec(kind="static", m=512, k=256, n=64, block_size=16,
                      density=density, dtype=dtype)
    j = jspec.OpSpec(kind="static", m=512, k=256, n=64, block_size=16,
                     density=density, dtype=dtype)
    for port, ref in REF_ROUTE.items():
        assert t.roofline_cost(port) == j.roofline_cost(ref), port
    dense = t.roofline_cost("dense_cuda")
    assert dense["flops"] == pytest.approx(
        t.roofline_cost("static_cuda")["flops"] / density)
    assert sparse.OpSpec(kind="dense", m=64, k=64, n=8).roofline_cost(
        "dense_torch")["flops"] == 2 * 64 * 64 * 8


def test_plan_explain_reports_roofline(_fresh):
    p = sparse.plan(_bsr(), 64, device="cpu")
    roof = p.explain()["roofline"]
    assert roof["hw"] == troof.H100.name
    assert roof["source"] == p.source == "analytic"
    assert roof["chosen"] is not None
    assert roof["chosen"] == roof["routes"][p.route]
    assert set(roof["routes"]) == set(p.est_seconds)
    for r, e in roof["routes"].items():
        assert e["bound_us"] > 0
        assert 0 < e["efficiency"] <= 1.0
        assert e["flagged"] == (e["headroom"] > roof["flag_headroom"])
        want = troof.route_efficiency(
            p.est_seconds[r], p.spec.roofline_cost(r), dtype=p.spec.dtype)
        assert e["bound_us"] == round(want["bound_seconds"] * 1e6, 3)
        assert e["achieved_us"] == round(p.est_seconds[r] * 1e6, 3)
    assert roof["kernel_work"] == sorted(
        r for r, e in roof["routes"].items() if e["flagged"])
    assert "roofline:" in sparse.format_plan(p)


def test_roofline_takes_measured_seconds(_fresh, monkeypatch):
    """A measured verdict's roofline prices the measured times."""
    from repro_torch.core import dispatch
    monkeypatch.setattr(dispatch, "measure_callable",
                        lambda fn, *a, windows=None: (fn(*a), 2e-3)[1])
    b = _bsr()
    x = torch.zeros(64, 256)
    p = sparse.plan(b, 64, x=x, device="cpu",
                    ctx=sparse.PlanContext(measure=True,
                                           differentiable=False))
    assert p.source == "measured"
    roof = p.roofline()
    assert {e["achieved_us"] for e in roof["routes"].values()} == {2000.0}


def test_roofline_bound_follows_the_plan_dtype(_fresh):
    """The compute term is priced at the operand type's peak: an fp32
    product's bound is at least as long as the same bf16 one's."""
    p32 = sparse.plan(_bsr(m=1024, k=1024, density=1.0), 4096,
                      device="cpu")
    p16 = sparse.plan(_bsr(m=1024, k=1024, density=1.0,
                           dtype=torch.bfloat16), 4096, device="cpu")
    r32 = p32.roofline()["routes"]["dense_torch"]
    r16 = p16.roofline()["routes"]["dense_torch"]
    assert r32["dominant"] == "compute"
    assert r32["bound_us"] == pytest.approx(
        2 * 1024 ** 2 * 4096 / 67e12 * 1e6, abs=1e-3)
    assert r16["bound_us"] < r32["bound_us"]


def test_roofline_report_totals(_fresh):
    sparse.plan(_bsr(), 64, device="cpu")
    sparse.plan(_bsr(m=512, k=512, seed=1), 128, device="cpu")
    rep = sparse.roofline_report()
    assert rep["totals"]["plans"] == 2
    assert rep["totals"]["min_chosen_efficiency"] is not None
    assert 0 < rep["totals"]["min_chosen_efficiency"] <= 1.0
    assert rep["totals"]["kernel_work_routes"] == sorted(
        set().union(*(p["kernel_work"] for p in rep["per_plan"].values())))
    assert rep["totals"]["chosen_flagged"] == sum(
        1 for p in rep["per_plan"].values() if p["chosen"]["flagged"])
    for per in rep["per_plan"].values():
        assert {"route", "chosen", "kernel_work"} <= set(per)


def test_dense_routes_priced_at_full_density(_fresh):
    p = sparse.plan(_bsr(density=0.125), 64, device="cpu")
    dense = p.spec.roofline_cost("dense_cuda")
    sparse_c = p.spec.roofline_cost("static_cuda")
    assert dense["flops"] == pytest.approx(
        sparse_c["flops"] / p.spec.density)
    assert np.isclose(p.spec.density, 0.125, atol=0.05)
