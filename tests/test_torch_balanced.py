"""The port's skew-balanced static walk against the JAX package, on the
CPU.

Mirrors ``tests/test_skew.py`` at small sizes: the row swizzle and the
balanced visit schedule are bit-equal to the JAX package's for uniform,
power-law and DLMC patterns; the bsmm_balanced kernel's plain version
and the ``static_balanced`` route (forward and planned backward), and
the dynamic routes forced on a static operand, hold the conftest
budgets against the JAX Pallas kernels in interpret mode, its plans and
the dense product.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import assert_close_for_dtype  # noqa: E402
from repro import sparse as jsparse  # noqa: E402
from repro.core import masks as jmasks  # noqa: E402
from repro.core import partitioner as jpart  # noqa: E402
from repro.core.bsr import BlockSparseMatrix as JBSR  # noqa: E402
from repro.kernels.bsmm import ops as jbsmm_ops  # noqa: E402
from repro.kernels.bsmm.ref import bsmm_ref  # noqa: E402
from repro_torch import sparse as tsparse  # noqa: E402
from repro_torch.core import partitioner as tpart  # noqa: E402
from repro_torch.core.bsr import BlockSparseMatrix as TBSR  # noqa: E402
from repro_torch.kernels.bsmm import balanced as tbal  # noqa: E402

DTYPES = ["float32", "bfloat16", "float16"]
TDTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}
JDTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
          "float16": jnp.float16}
GENS = {"uniform": jmasks.random_block_mask,
        "power_law": jmasks.power_law_block_mask,
        "dlmc": jmasks.dlmc_block_mask}


def _np(t):
    return t.detach().float().numpy()


def _problem(kind, b, dtype="float32", m=128, k=256, n=40, density=0.25,
             seed=1):
    mask = GENS[kind](m, k, b, density, seed=seed)
    rng = np.random.default_rng(seed + 1)
    vals = rng.standard_normal((int(mask.sum()), b, b)).astype(np.float32)
    x = rng.standard_normal((n, k)).astype(np.float32)
    jb = JBSR.from_mask(mask, b).with_values(jnp.asarray(vals, JDTYPE[dtype]))
    tb = TBSR.from_mask(mask, b,
                        values=torch.as_tensor(vals).to(TDTYPE[dtype]))
    return mask, jb, tb, x


@pytest.mark.parametrize("kind", list(GENS))
@pytest.mark.parametrize("b", [4, 16])
@pytest.mark.parametrize("bins", [None, 3, 64])
def test_balanced_schedule_bit_equal(kind, b, bins):
    m, k = 256, 256
    mask = GENS[kind](m, k, b, 1 / 8, seed=b)
    rows, cols = np.nonzero(mask)
    jm = jpart.plan_packing_balanced(rows, cols, (m, k), b, b, b,
                                     num_bins=bins)
    tm = tpart.plan_packing_balanced(rows, cols, (m, k), b, b, b,
                                     num_bins=bins)
    for name in ("visit_slot", "visit_rows", "visit_cols"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name))
    for name in ("order", "inverse", "bin_of", "loads"):
        np.testing.assert_array_equal(getattr(tm.swizzle, name),
                                      getattr(jm.swizzle, name))
    assert tm.swizzle.num_bins == jm.swizzle.num_bins
    assert tm.swizzle.steps_per_bin == jm.swizzle.steps_per_bin
    np.testing.assert_array_equal(tm.base.tile_rows, jm.base.tile_rows)
    assert tpart.balance_report(mask.sum(1)) == jpart.balance_report(
        mask.sum(1))


def test_balance_report_edges():
    rep = tpart.balance_report(np.array([0, 2, 2, 4]))
    assert rep == jpart.balance_report(np.array([0, 2, 2, 4]))
    assert tpart.balance_report(np.array([], np.int64))["cv"] == 0.0


def test_card_bins():
    # Table 3's grid: 256 row-tiles, N = 4096 in 64-token tiles
    assert tbal.card_bins(256, 4096, 16) == 8
    assert tbal.card_bins(256, 256, 16) == 66
    assert tbal.card_bins(16, 4, 16) == 16
    assert tbal.card_bins(1024, 4096, 4) == 17


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [4, 16])
@pytest.mark.parametrize("kind", list(GENS))
def test_bsmm_balanced_plain_matches_jax(kind, b, dtype):
    m, k = 128, 256
    mask, jb, tb, x = _problem(kind, b, dtype)
    jx = jnp.asarray(x.T, JDTYPE[dtype])
    jm = jpart.plan_packing_balanced(jb.row_idx, jb.col_idx, (m, k), b,
                                     b, b)
    want = np.asarray(jbsmm_ops.bsmm_balanced_from_plan(
        jm, jb.values, jx, interpret=True).T.astype(jnp.float32))
    oracle = np.asarray(bsmm_ref(jb, jx).T.astype(jnp.float32))
    tm = tpart.plan_packing_balanced(tb.row_idx, tb.col_idx, (m, k), b, b,
                                     b)
    got = tbal.bsmm_balanced_from_plan(
        tm, tb.values, torch.as_tensor(x).to(TDTYPE[dtype]))
    assert got.dtype == TDTYPE[dtype] and got.shape == (x.shape[0], m)
    assert_close_for_dtype(_np(got), want, dtype, "balanced vs pallas")
    assert_close_for_dtype(_np(got), oracle, dtype, "balanced vs ref")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [4, 16])
def test_static_balanced_plan_matches_jax(b, dtype):
    m, k = 128, 256
    _, jb, tb, x = _problem("power_law", b, dtype)
    jp = jsparse.plan(jb, x.shape[0], ctx=jsparse.PlanContext(
        mode="static_balanced", interpret=True, differentiable=False,
        cache=False))
    want = np.asarray(jp(jb.values, jnp.asarray(x.T, JDTYPE[dtype])).T
                      .astype(jnp.float32))
    tp = tsparse.plan(tb, x.shape[0], device="cpu", ctx=tsparse.PlanContext(
        mode="static_balanced"))
    assert tp.route == "static_balanced_torch"
    assert tp.artifacts["swizzle_bins"] == 8
    assert tp.artifacts["nnz_blocks"] == jp.artifacts["nnz_blocks"]
    got = tsparse.spmm_nt(tb, torch.as_tensor(x).to(TDTYPE[dtype]),
                          ctx=tsparse.PlanContext(mode="static_balanced"))
    assert_close_for_dtype(_np(got), want, dtype, "static_balanced")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_static_balanced_grads_match_jax(dtype):
    """The balanced forward trains through the static plan's backward
    (bsmm on the transposed pattern, SDDMM), as JAX's ``_planned_vjp``
    does whatever the forward route."""
    _, jb, tb, x = _problem("dlmc", 16, dtype, n=24)
    gy = np.random.default_rng(5).standard_normal((24, 128)).astype(
        np.float32)
    ctx = jsparse.PlanContext(mode="static_balanced", interpret=True,
                              grad_mode="static_pallas",
                              sddmm_mode="sddmm_grouped")
    jp = jsparse.plan(jb, 24, ctx=ctx)

    def loss(v, xt):
        return jnp.sum(jp(v, xt).astype(jnp.float32) * gy.T)

    jdv, jdx = jax.grad(loss, argnums=(0, 1))(
        jb.values, jnp.asarray(x.T, JDTYPE[dtype]))
    tp = tsparse.plan(tb, 24, device="cpu",
                      ctx=tsparse.PlanContext(mode="static_balanced",
                                              grad_mode="static_pallas",
                                              sddmm_mode="sddmm_grouped"))
    assert tp.grad_routes == {"dx": "static_torch",
                              "dvalues": "sddmm_torch"}
    tv = tb.values.clone().requires_grad_(True)
    tx = torch.as_tensor(x).to(TDTYPE[dtype]).requires_grad_(True)
    (tp.spmm_nt(tv, tx).float() * torch.as_tensor(gy)).sum().backward()
    assert_close_for_dtype(_np(tv.grad), jdv, dtype, "dvalues")
    assert_close_for_dtype(_np(tx.grad), np.asarray(jdx, np.float32).T,
                           dtype, "dx")


@pytest.mark.parametrize("route", ["dynamic_xla", "dynamic_pallas",
                                   "dynamic_grouped",
                                   "dynamic_grouped_balanced",
                                   "dense_pallas"])
def test_forced_routes_on_static_operand_match_jax(route):
    _, jb, tb, x = _problem("power_law", 16)
    jp = jsparse.plan(jb, x.shape[0], ctx=jsparse.PlanContext(
        mode=route, interpret=True, differentiable=False, cache=False))
    want = np.asarray(jp(jb.values, jnp.asarray(x.T)).T)
    tp = tsparse.plan(tb, x.shape[0], device="cpu",
                      ctx=tsparse.PlanContext(mode=route))
    for key in ("grouped_tile", "grouped_tiles_cap"):
        assert tp.artifacts.get(key) == jp.artifacts.get(key), key
    got = tp.spmm_nt(tb.values, torch.as_tensor(x))
    assert_close_for_dtype(_np(got), want, "float32", route)
