"""The port's dynamic mode against the JAX package, on the CPU.

Seeded numpy inputs go to both packages: the runtime encoder and the
dsmm slot encoder bit for bit, the planner number for number, the dsmm
kernel's plain version and every dynamic route of the plan layer against
the JAX Pallas kernels in interpret mode and the ``dsmm_ref`` oracle,
and ``DynamicSparseLinear``'s output and gradients against ``jax.grad``
through the JAX ``dynamic_xla`` and ``dynamic_pallas`` planned backward.
Budgets are ``tests/conftest.py``'s per-dtype ones (fp32 1e-4, bf16
6e-2, fp16 2e-2, rel-max over the reference's max magnitude).  The CUDA
kernel is held against the plain version on a card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import assert_close_for_dtype  # noqa: E402
from repro import sparse as jsparse  # noqa: E402
from repro.core import dynamic_sparse as jdsp  # noqa: E402
from repro.core import masks as jmasks  # noqa: E402
from repro.core import planner as jplanner  # noqa: E402
from repro.core.bsr import BlockSparseMatrix as JBSR  # noqa: E402
from repro.core.sparse_layers import DynamicSparseLinear as JDSL  # noqa: E402
from repro.kernels.dsmm import ops as jdsmm_ops  # noqa: E402
from repro.kernels.dsmm.ref import dsmm_ref  # noqa: E402
from repro_torch import sparse as tsparse  # noqa: E402
from repro_torch.core import dynamic_sparse as tdsp  # noqa: E402
from repro_torch.core import planner as tplanner  # noqa: E402
from repro_torch.core.bsr import BlockSparseMatrix as TBSR  # noqa: E402
from repro_torch.core.sparse_layers import DynamicSparseLinear  # noqa: E402
from repro_torch.kernels.dsmm import ops as tdsmm_ops  # noqa: E402

DTYPES = ["float32", "bfloat16", "float16"]
TDTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}
JDTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
          "float16": jnp.float16}
ROUTES = ["dynamic_xla", "dynamic_pallas", "dynamic_grouped",
          "dynamic_grouped_balanced"]


def _np(t):
    return t.detach().float().numpy()


def _mask_w(m, k, b, density, seed):
    mask = jmasks.random_block_mask(m, k, b, density, seed=seed)
    w = np.random.default_rng(seed).standard_normal((m, k)).astype(
        np.float32)
    return mask, w


def _encode_both(m, k, b, density, seed, nnz_max, dtype="float32"):
    mask, w = _mask_w(m, k, b, density, seed)
    jop = jdsp.encode(jnp.asarray(w, JDTYPE[dtype]), jnp.asarray(mask),
                      block_size=b, nnz_max=nnz_max)
    top = tdsp.encode(torch.as_tensor(w).to(TDTYPE[dtype]),
                      torch.as_tensor(mask), block_size=b, nnz_max=nnz_max)
    return mask, w, jop, top


def _same_slots(jop, top):
    np.testing.assert_array_equal(np.asarray(jop.row_idx),
                                  top.row_idx.numpy())
    np.testing.assert_array_equal(np.asarray(jop.col_idx),
                                  top.col_idx.numpy())
    assert int(jop.nnz) == int(top.nnz)
    np.testing.assert_array_equal(
        np.asarray(jop.values.astype(jnp.float32)), _np(top.values))


# -- encoders: bit-equal metadata -----------------------------------------

@pytest.mark.parametrize("b", [4, 16])
@pytest.mark.parametrize("slack", [5, 0, -7], ids=["room", "exact",
                                                   "overflow"])
def test_encode_bit_equal(b, slack):
    m, k = 128, 256
    mask = jmasks.random_block_mask(m, k, b, 0.25, seed=b)
    nnz_max = int(mask.sum()) + slack
    _, _, jop, top = _encode_both(m, k, b, 0.25, b, nnz_max)
    assert top.row_idx.dtype == torch.int32 and top.capacity == nnz_max
    _same_slots(jop, top)
    np.testing.assert_array_equal(np.asarray(jop.to_dense()),
                                  _np(top.to_dense()))


def test_encode_from_bsr_bit_equal():
    mask, _ = _mask_w(64, 128, 16, 0.3, 4)
    vals = np.random.default_rng(4).standard_normal(
        (int(mask.sum()), 16, 16)).astype(np.float32)
    jop = jdsp.encode_from_bsr(JBSR.from_mask(mask, 16).with_values(
        jnp.asarray(vals)), nnz_max=int(mask.sum()) + 3)
    top = tdsp.encode_from_bsr(TBSR.from_mask(
        mask, 16, values=torch.as_tensor(vals)), nnz_max=int(mask.sum()) + 3)
    _same_slots(jop, top)
    with pytest.raises(ValueError, match="exceeds capacity"):
        tdsp.encode_from_bsr(TBSR.from_mask(mask, 16), nnz_max=3)


@pytest.mark.parametrize("b", [4, 16])
def test_encode_slots_bit_equal(b):
    """The port's slot encoder against the reference's, slot for slot:
    the reference's pattern slots without its per-row zero coverage slot
    (the first of each row) and its padding (the last ``capacity - nnz``
    of row 0), brought into the port's order (stable by ``row * grid_k +
    col``); the port's padding follows, off the grid at row ``grid_m``."""
    _, _, jop, top = _encode_both(128, 256, b, 0.2, 7 + b, 40)
    jr, jc, jv = (np.asarray(a) for a in jdsmm_ops._encode_slots(jop))
    jv = jv.astype(np.float32)
    tr, tc, tv = tdsmm_ops.encode_slots(top)
    mb, kb = top.grid
    nnz = int(top.nnz)
    pad = top.capacity - nnz
    first = np.searchsorted(jr, np.arange(mb))
    keep = np.ones(jr.size, bool)
    keep[first] = False
    row0_end = int(np.searchsorted(jr, 1))
    keep[row0_end - pad:row0_end] = False
    assert not jv[~keep].any() and not jc[~keep].any()
    order = np.argsort(jr[keep].astype(np.int64) * kb + jc[keep],
                       kind="stable")
    assert tr.numel() == top.capacity
    np.testing.assert_array_equal(jr[keep][order], tr[:nnz].numpy())
    np.testing.assert_array_equal(jc[keep][order], tc[:nnz].numpy())
    np.testing.assert_array_equal(jv[keep][order], _np(tv[:nnz]))
    assert (tr[nnz:] == mb).all() and not _np(tv[nnz:]).any()


def test_operand_validation():
    with pytest.raises(ValueError, match="not divisible"):
        tdsp.DynamicOperand(torch.zeros(1, 16, 16),
                            torch.zeros(1, dtype=torch.int32),
                            torch.zeros(1, dtype=torch.int32),
                            torch.tensor(1), (40, 64), 16)
    with pytest.raises(ValueError, match="mask shape"):
        tdsp.encode(torch.zeros(64, 64), torch.zeros(2, 2, dtype=bool),
                    block_size=16, nnz_max=2)


# -- planner: the same numbers --------------------------------------------

@pytest.mark.parametrize("mkn,d_max,b,units", list(itertools.product(
    [(1024, 1024, 256), (4096, 4096, 4096), (8192, 2048, 2048)],
    [1 / 32, 1 / 16, 1 / 8], [4, 16], [4, 16])))
def test_planner_numbers_equal(mkn, d_max, b, units):
    m, k, n = mkn
    jp = jplanner.plan_dynamic(m, k, n, d_max=d_max, block_size=b,
                               units=units)
    tp = tplanner.plan_dynamic(m, k, n, d_max=d_max, block_size=b,
                               units=units)
    assert vars(tp) == vars(jp)
    assert (tplanner.nnz_max_blocks(m, k, b, d_max)
            == jplanner.nnz_max_blocks(m, k, b, d_max))
    t = 128
    for headroom in (0.6, 1.0, 1.25):
        jc = jplanner.plan_grouped_capacity(m, k, b, d_max, tile=t,
                                            headroom=headroom)
        tc = tplanner.plan_grouped_capacity(m, k, b, d_max, tile=t,
                                            headroom=headroom)
        assert vars(tc) == vars(jc)
    assert (tplanner.expected_grouped_tiles(m, k, b, d_max, t)
            == jplanner.expected_grouped_tiles(m, k, b, d_max, t))


# -- the kernel's plain version and every plan route -----------------------

def _case(dtype, b, m=128, k=256, n=48, density=0.25, seed=3):
    mask, w = _mask_w(m, k, b, density, seed)
    nnz_max = int(mask.sum()) + 6
    _, _, jop, top = _encode_both(m, k, b, density, seed, nnz_max, dtype)
    x = np.random.default_rng(seed + 1).standard_normal((n, k)).astype(
        np.float32)
    return jop, top, x


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [4, 16])
def test_dsmm_plain_matches_jax(dtype, b):
    jop, top, x = _case(dtype, b)
    jx = jnp.asarray(x.T, JDTYPE[dtype])
    want_kernel = np.asarray(jdsmm_ops.dsmm(jop, jx, interpret=True).T)
    want_ref = np.asarray(dsmm_ref(jop, jx).T.astype(jnp.float32))
    got = tdsmm_ops.dsmm(top, torch.as_tensor(x).to(TDTYPE[dtype]))
    assert got.dtype == TDTYPE[dtype] and got.shape == (x.shape[0], 128)
    assert_close_for_dtype(_np(got), want_kernel, dtype, "dsmm vs pallas")
    assert_close_for_dtype(_np(got), want_ref, dtype, "dsmm vs ref")


def test_dsmm_writes_rows_without_slots():
    """A pattern with empty block-rows, slots fed without coverage: the
    walk still writes every output row (zeros for an empty run)."""
    b, m, k = 16, 64, 64
    mask = np.zeros((4, 4), bool)
    mask[1, 2] = mask[3, 0] = True
    w = torch.randn(m, k)
    op = tdsp.encode(w, torch.as_tensor(mask), block_size=b, nnz_max=2)
    x = torch.randn(5, k)
    y = tdsmm_ops.dsmm_slots(x, op.values, op.row_idx, op.col_idx, m)
    assert torch.all(y[:, :b] == 0) and torch.all(y[:, 2 * b:3 * b] == 0)
    torch.testing.assert_close(y, x @ op.to_dense().t())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [4, 16])
@pytest.mark.parametrize("route", ROUTES)
def test_dynamic_plan_route_matches_jax(route, b, dtype):
    jop, top, x = _case(dtype, b)
    jx = jnp.asarray(x.T, JDTYPE[dtype])
    jp = jsparse.plan(jop, x.shape[0], ctx=jsparse.PlanContext(
        mode=route, interpret=True, differentiable=False,
        capacity_policy="worst"))
    want = np.asarray(jp(jop, jx).T.astype(jnp.float32))
    oracle = np.asarray(dsmm_ref(jop, jx).T.astype(jnp.float32))
    ctx = tsparse.PlanContext(mode=route, capacity_policy="worst")
    tp = tsparse.plan(top, x.shape[0], device="cpu", ctx=ctx)
    assert tp.route == route.replace("_xla", "").replace(
        "_pallas", "") + "_torch"
    for key in ("bucket_blocks", "nnz_max_blocks", "grouped_tile",
                "grouped_tiles_cap"):
        assert tp.artifacts.get(key) == jp.artifacts.get(key), key
    got = tsparse.spmm(top, torch.as_tensor(x.T).to(TDTYPE[dtype]), ctx=ctx)
    assert got.dtype == TDTYPE[dtype]
    assert_close_for_dtype(_np(got.t()), want, dtype, f"plan {route}")
    assert_close_for_dtype(_np(got.t()), oracle, dtype, f"{route} vs ref")


def test_dynamic_plan_is_keyed_by_problem_not_pattern():
    tsparse.reset()
    m, k, b = 128, 256, 16
    layer = DynamicSparseLinear(k, m, b, 0.25, device="cpu")
    layer.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(8, k)
    layer(x)
    built = tsparse.cache_stats()["plans_built"]
    for seed in range(1, 5):
        layer.set_mask(jmasks.random_block_mask(m, k, b, 0.25, seed=seed))
        y = layer(x)
        want = x @ tdsp.encode(layer.weight, layer.mask, block_size=b,
                               nnz_max=layer.nnz_max).to_dense().t()
        torch.testing.assert_close(y, want, rtol=1e-4, atol=1e-4)
    assert tsparse.cache_stats()["plans_built"] == built
    assert tsparse.cache_stats()["plan_hits"] >= 4
    with pytest.raises(ValueError, match="cannot execute"):
        tsparse.plan(layer.encode(), 8, device="cpu",
                     ctx=tsparse.PlanContext(mode="static_pallas"))


# -- DynamicSparseLinear: output and gradients vs jax.grad ----------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("jax_route", ["dynamic_xla", "dynamic_pallas"])
@pytest.mark.parametrize("port_backend", ["auto", "grouped"])
def test_dynamic_sparse_linear_grads_match_jax(jax_route, port_backend,
                                               dtype):
    d_in, d_out, b, n, d_max = 128, 64, 16, 24, 0.25
    rng = np.random.default_rng(11)
    w = rng.standard_normal((d_out, d_in)).astype(np.float32) * 0.2
    mask = jmasks.random_block_mask(d_out, d_in, b, d_max, seed=12)
    bias = rng.standard_normal(d_out).astype(np.float32)
    x = rng.standard_normal((n, d_in)).astype(np.float32)
    gy = rng.standard_normal((n, d_out)).astype(np.float32)

    jl = JDSL(d_in, d_out, b, d_max, use_bias=True, dtype=JDTYPE[dtype])
    ctx = jsparse.PlanContext(mode=jax_route, interpret=True)
    jw, jx = jnp.asarray(w, JDTYPE[dtype]), jnp.asarray(x, JDTYPE[dtype])
    jsparse.plan(jdsp.encode(jw, jnp.asarray(mask), block_size=b,
                             nnz_max=jl.nnz_max), n, ctx=ctx)

    def jfwd(wv, bv, xv):
        op = jdsp.encode(wv, jnp.asarray(mask), block_size=b,
                         nnz_max=jl.nnz_max)
        return jsparse.spmm_nt(op, xv, ctx=ctx) + bv

    def loss(wv, bv, xv):
        return jnp.sum(jfwd(wv, bv, xv).astype(jnp.float32) * gy)

    jy = jfwd(jw, jnp.asarray(bias, JDTYPE[dtype]), jx)
    jdw, jdb, jdx = jax.grad(loss, argnums=(0, 1, 2))(
        jw, jnp.asarray(bias, JDTYPE[dtype]), jx)

    layer = DynamicSparseLinear(d_in, d_out, b, d_max, use_bias=True,
                                dtype=TDTYPE[dtype], backend=port_backend,
                                device="cpu")
    layer.load_jax_params({"w": w, "mask": mask, "bias": bias})
    assert layer.nnz_max == jl.nnz_max
    tx = torch.as_tensor(x).to(TDTYPE[dtype]).requires_grad_(True)
    y = layer(tx)
    assert y.dtype == TDTYPE[dtype]
    (y.float() * torch.as_tensor(gy)).sum().backward()
    assert_close_for_dtype(_np(y), np.asarray(jy, np.float32), dtype, "y")
    assert_close_for_dtype(_np(layer.weight.grad), np.asarray(
        jdw, np.float32), dtype, "dW")
    assert_close_for_dtype(_np(layer.bias.grad), np.asarray(
        jdb, np.float32), dtype, "dbias")
    assert_close_for_dtype(_np(tx.grad), np.asarray(jdx, np.float32),
                           dtype, "dx")
    # only the masked blocks get a weight gradient
    dense_mask = np.repeat(np.repeat(mask, b, 0), b, 1)
    assert np.all(_np(layer.weight.grad)[~dense_mask] == 0)


def test_jax_layer_init_loads_into_port_layer():
    jl = JDSL(64, 32, 16, 0.5, use_bias=True)
    params = jl.init(jax.random.PRNGKey(0))
    x = np.random.default_rng(0).standard_normal((4, 64)).astype(np.float32)
    jparams = {k: v for k, v in params.items()}
    # the JAX layer's default backend needs Pallas off the TPU: run its
    # formulation through the XLA route
    jl_xla = JDSL(64, 32, 16, 0.5, use_bias=True, backend="xla")
    want = np.asarray(jl_xla.apply(jparams, jnp.asarray(x)))
    layer = DynamicSparseLinear(64, 32, 16, 0.5, use_bias=True,
                                device="cpu")
    layer.load_jax_params({k: np.asarray(v) for k, v in params.items()})
    with torch.no_grad():
        got = layer(torch.as_tensor(x)).numpy()
    assert_close_for_dtype(got, want, "float32", "layer")
