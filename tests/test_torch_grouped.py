"""The port's grouped dynamic routes against the JAX package, on the CPU.

Mirrors ``tests/test_gmm_capacity.py`` at small sizes: the device-side
tile pack is bit-equal to the JAX pack (tiles, tile rows/cols, tile
count), its overflow accounting (``GroupedPackStats``) and the plan
layer's ``capacity_report`` counts equal the JAX package's after the
same calls, the guardrail escalates on the same call, and outputs hold
the conftest budgets against the JAX routes (Pallas in interpret mode)
and the dense product.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from conftest import assert_close_for_dtype  # noqa: E402
from repro import sparse as jsparse  # noqa: E402
from repro.core import dynamic_sparse as jdsp  # noqa: E402
from repro.core import masks as jmasks  # noqa: E402
from repro.core.bsr import BlockSparseMatrix as JBSR  # noqa: E402
from repro.kernels.gmm import balanced as jgbal  # noqa: E402
from repro.kernels.gmm import ops as jgmm  # noqa: E402
from repro_torch import sparse as tsparse  # noqa: E402
from repro_torch.core import dynamic_sparse as tdsp  # noqa: E402
from repro_torch.core.bsr import BlockSparseMatrix as TBSR  # noqa: E402
from repro_torch.kernels.gmm import balanced as tgbal  # noqa: E402
from repro_torch.kernels.gmm import ops as tgmm  # noqa: E402

M = K = 256
N = 16


@pytest.fixture(autouse=True)
def _fresh_plans():
    tsparse.reset()
    jsparse.reset()
    yield
    tsparse.reset()
    jsparse.reset()


def _operands(seed, b=16, d=1 / 16, pad=4, gen=jmasks.random_block_mask):
    mask = gen(M, K, b, d, seed=seed)
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((int(mask.sum()), b, b)).astype(np.float32)
    nnz_max = int(mask.sum()) + pad
    jop = jdsp.encode_from_bsr(JBSR.from_mask(mask, b).with_values(
        jnp.asarray(vals)), nnz_max=nnz_max)
    top = tdsp.encode_from_bsr(TBSR.from_mask(
        mask, b, values=torch.as_tensor(vals)), nnz_max=nnz_max)
    x = rng.standard_normal((N, K)).astype(np.float32)
    return jop, top, x


def _stats(st):
    return {k: float(np.asarray(v)) for k, v in st._asdict().items()}


@pytest.mark.parametrize("b", [4, 16])
@pytest.mark.parametrize("cap", [1, 2, 3, None])
def test_pack_tiles_bit_equal_and_stats_exact(b, cap):
    jop, top, _ = _operands(5 + b, b=b, d=1 / 8)
    t = tgmm.grouped_tile_size(M, K, b)
    assert t == jgmm.grouped_tile_size(M, K, b) == 128
    cap = cap or (M // t) * (K // t)
    jp, jst = jgmm.pack_tiles_device(jop, tile=t, tiles_cap=cap)
    tp, tst = tgmm.pack_tiles_device(top, tile=t, tiles_cap=cap)
    np.testing.assert_array_equal(np.asarray(jp.values), tp.values.numpy())
    np.testing.assert_array_equal(np.asarray(jp.row_idx), tp.row_idx.numpy())
    np.testing.assert_array_equal(np.asarray(jp.col_idx), tp.col_idx.numpy())
    assert int(jp.nnz) == int(tp.nnz)
    js, ts = _stats(jst), _stats(tst)
    for key in ("tiles_total", "tiles_dropped", "blocks_dropped"):
        assert ts[key] == js[key], key
    assert ts["dropped_value_frac"] == pytest.approx(
        js["dropped_value_frac"], rel=1e-6)


def test_encode_slots_balanced_bit_equal():
    """The port's balanced slot order against the reference's, slot for
    slot: the reference's without its per-row zero coverage slot (the
    first of each row's run) and its padding (the last ``capacity - nnz``
    slots of row 0's run), in the same order; the port's padding follows,
    off the grid at row ``grid_m``."""
    jop, top, _ = _operands(9, b=16, d=0.25, gen=jmasks.power_law_block_mask)
    mt = top.grid[0]
    nnz = int(top.nnz)
    pad = top.capacity - nnz
    assert pad > 0
    for bins in (1, 3, 8):
        jr, jc, jv = (np.asarray(a)
                      for a in jgbal._encode_slots_balanced(jop, bins))
        tr, tc, tv = tgbal._encode_slots_balanced(top, bins)
        starts = np.flatnonzero(np.r_[True, jr[1:] != jr[:-1]])
        keep = np.ones(jr.size, bool)
        keep[starts] = False
        row0 = np.flatnonzero(jr == 0)
        keep[row0[-pad:]] = False
        assert not jv[~keep].any() and not jc[~keep].any()
        np.testing.assert_array_equal(jr[keep], tr[:nnz].numpy())
        np.testing.assert_array_equal(jc[keep], tc[:nnz].numpy())
        np.testing.assert_array_equal(jv[keep], tv[:nnz].numpy())
        assert (tr[nnz:] == mt).all() and not tv[nnz:].any()


@pytest.mark.parametrize("route", ["dynamic_grouped",
                                   "dynamic_grouped_balanced"])
@pytest.mark.parametrize("cap", [1, None])
def test_grouped_spmm_matches_jax(route, cap):
    jop, top, x = _operands(13, b=16, d=1 / 8)
    jfn = jgmm.grouped_spmm if route == "dynamic_grouped" else \
        jgbal.balanced_spmm
    tfn = tgmm.grouped_spmm if route == "dynamic_grouped" else \
        tgbal.balanced_spmm
    jy, jst = jfn(jop, jnp.asarray(x.T), tiles_cap=cap, interpret=True,
                  return_stats=True)
    ty, tst = tfn(top, torch.as_tensor(x), tiles_cap=cap, return_stats=True)
    assert _stats(tst)["tiles_dropped"] == _stats(jst)["tiles_dropped"]
    assert_close_for_dtype(ty.numpy(), np.asarray(jy).T, "float32", route)
    if cap is None:
        dense = x @ top.to_dense().numpy().T
        assert_close_for_dtype(ty.numpy(), dense, "float32", "dense")


def test_empty_operand_zero_output_zero_stats():
    op = tdsp.DynamicOperand(torch.zeros((0, 16, 16)),
                             torch.zeros(0, dtype=torch.int32),
                             torch.zeros(0, dtype=torch.int32),
                             torch.tensor(0, dtype=torch.int32), (128, 128),
                             16)
    y, st = tgmm.grouped_spmm(op, torch.randn(8, 128), return_stats=True)
    assert torch.all(y == 0)
    assert all(v == 0 for v in _stats(st).values())


def test_plan_capacity_report_matches_jax():
    """The same three calls through both plan layers at an overflowing
    headroom: equal per-plan and total counts."""
    jop, top, x = _operands(11, d=1 / 16)
    jctx = jsparse.PlanContext(mode="dynamic_grouped", interpret=True,
                               headroom=0.5, overflow_threshold=0.0)
    tctx = tsparse.PlanContext(mode="dynamic_grouped", headroom=0.5,
                               overflow_threshold=0.0)
    jp = jsparse.plan(jop, N, ctx=jctx)
    tp = tsparse.plan(top, N, device="cpu", ctx=tctx)
    assert tp.artifacts["capacity"] == jp.artifacts["capacity"]
    assert tp.tiles_cap == jp.artifacts["grouped_tiles_cap"]
    for _ in range(3):
        jy = jp(jop, jnp.asarray(x.T))
        ty = tp.spmm_nt(top, torch.as_tensor(x))
    assert_close_for_dtype(ty.numpy(), np.asarray(jy).T, "float32", "y")
    js, ts = jp.capacity_stats.report(), tp.capacity_stats.report()
    assert ts == js
    assert ts["calls"] == 3 and ts["overflow_calls"] == 3
    assert ts["tiles_dropped_total"] > 0
    jagg, tagg = jsparse.capacity_report(), tsparse.capacity_report()
    assert tagg["totals"] == jagg["totals"]
    assert tagg["per_plan"][tp.key] == ts
    assert tp.capacity_report()["stats"] == ts
    tsparse.reset_telemetry()
    assert tp.capacity_stats.report()["calls"] == 0


@pytest.mark.parametrize("route", ["dynamic_grouped",
                                   "dynamic_grouped_balanced"])
def test_guardrail_escalates_on_the_fourth_call(route):
    jop, top, x = _operands(13, d=1 / 16)
    jctx = jsparse.PlanContext(mode=route, interpret=True, headroom=0.5,
                               overflow_threshold=0.25)
    tctx = tsparse.PlanContext(mode=route, headroom=0.5,
                               overflow_threshold=0.25)
    jp1 = jsparse.plan(jop, N, ctx=jctx)
    tp1 = tsparse.plan(top, N, device="cpu", ctx=tctx)
    assert tp1.artifacts["capacity"]["policy"] == "planned"
    for i in range(tsparse.ESCALATION_MIN_CALLS):
        jp1(jop, jnp.asarray(x.T))
        tp1.spmm_nt(top, torch.as_tensor(x))
        assert tp1.capacity_stats.escalated == jp1.capacity_stats.escalated \
            == (i + 1 >= tsparse.ESCALATION_MIN_CALLS)
    tp2 = tsparse.plan(top, N, device="cpu", ctx=tctx)
    jp2 = jsparse.plan(jop, N, ctx=jctx)
    assert tp2 is not tp1
    assert tp2.artifacts["capacity"] == jp2.artifacts["capacity"]
    assert tp2.artifacts["capacity"]["policy"] == "worst"
    assert tp2.tiles_cap == tp2.artifacts["capacity"]["worst_tiles"]
    y = tp2.spmm_nt(top, torch.as_tensor(x))
    assert_close_for_dtype(y.numpy(), x @ top.to_dense().numpy().T,
                           "float32", "escalated")
    assert tp2.capacity_stats is tp1.capacity_stats
    assert tp2.capacity_stats.report()["calls"] == \
        tsparse.ESCALATION_MIN_CALLS + 1
    assert tsparse.capacity_report()["totals"]["escalated_plans"] == 1


def test_worst_policy_and_telemetry_off():
    _, top, x = _operands(15, d=1 / 16)
    p = tsparse.plan(top, N, device="cpu", ctx=tsparse.PlanContext(
        mode="dynamic_grouped", capacity_policy="worst"))
    y = p.spmm_nt(top, torch.as_tensor(x))
    assert_close_for_dtype(y.numpy(), x @ top.to_dense().numpy().T,
                           "float32", "worst")
    assert p.capacity_stats.report()["overflow_calls"] == 0
    q = tsparse.plan(top, N, device="cpu", ctx=tsparse.PlanContext(
        mode="dynamic_grouped", headroom=0.5, telemetry=False))
    q.spmm_nt(top, torch.as_tensor(x))
    assert q.capacity_stats.calls == 0


def test_plan_identity_knobs():
    _, top, _ = _operands(21, d=1 / 16)
    base = tsparse.PlanContext(mode="dynamic_grouped")
    p1 = tsparse.plan(top, N, device="cpu", ctx=base)
    p2 = tsparse.plan(top, N, device="cpu", ctx=tsparse.PlanContext(
        mode="dynamic_grouped", overflow_threshold=0.0))
    p3 = tsparse.plan(top, N, device="cpu", ctx=tsparse.PlanContext(
        mode="dynamic_grouped", headroom=2.0))
    assert p1 is not p2 and p1.key == p2.key
    assert p3.key != p1.key


def test_clamp_is_warned_once_and_signalled():
    _, top, x = _operands(23, d=1 / 16)
    t = tgmm.grouped_tile_size(M, K, 16)
    grid = (M // t) * (K // t)
    tgmm._clamp_warned.clear()
    with pytest.warns(UserWarning, match="clamped"):
        tgmm.grouped_spmm(top, torch.as_tensor(x), tile=t,
                          tiles_cap=grid + 123)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tgmm.grouped_spmm(top, torch.as_tensor(x), tile=t,
                          tiles_cap=grid + 123)
    assert tgmm.clamped_tiles_cap(grid + 7, M, K, t, warn=False) == (grid,
                                                                     True)
