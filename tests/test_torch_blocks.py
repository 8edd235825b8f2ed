"""Block sizes outside the port kernels' own tiles, against the JAX package
on the CPU.

The reference admits blocks 1..128 on every route.  The port's static
kernels (bsmm, bsmm_balanced, sddmm) walk tiles of 4..64 and dsmm blocks
of 4..128, so the plan maps every other block onto them
(``sparse.plan.kernel_tile``): each block split exactly into sub-blocks
of g, the largest kernel tile dividing b (else 2 or 1), those below 4
packed into 4 x 4 tiles (the dL/dvalues product sampled on those tiles
and the blocks gathered out), b = 128 split into four 64 x 64 blocks,
b = 12 into nine 4 x 4 blocks, b = 3 into 1 x 1 blocks packed 4 x 4 on
a grid padded to the tile (m = 99).  A dynamic operand is split and
re-blocked on the device (``dsmm.ops.kernel_operand``), the grouped
routes pack its sub-blocks (``gmm.ops.fit_tile``).

Seeded numpy inputs go to both packages; the JAX side runs its
``static_xla`` / ``dynamic_xla`` routes (as its own tests run them), the
port the kernels' plain versions on the same packed layouts the card
walks.  Budget: fp32 2e-4, bf16 6e-2 (``tests/conftest.py``), rel-max
over the reference's max magnitude.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import GRAD_TOLS  # noqa: E402
from repro import sparse as jsparse  # noqa: E402
from repro.core import dynamic_sparse as jdsp  # noqa: E402
from repro.core import masks as jmasks  # noqa: E402
from repro.core.bsr import BlockSparseMatrix as JBSR  # noqa: E402
from repro_torch import sparse as tsparse  # noqa: E402
from repro_torch.core import dynamic_sparse as tdsp  # noqa: E402
from repro_torch.core.bsr import BlockSparseMatrix as TBSR  # noqa: E402
from repro_torch.kernels import contract as tcontract  # noqa: E402
from repro_torch.kernels.dsmm import ops as tdsmm_ops  # noqa: E402
from repro_torch.sparse.plan import dynamic_tile, kernel_tile  # noqa: E402

TDTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TOL = dict(GRAD_TOLS, float32=2e-4)
# (m, k, n, density) per block size: small grids, ragged n
SHAPES = {1: (32, 48, 12, 0.25), 2: (32, 64, 12, 0.25),
          128: (256, 384, 12, 0.5)}


def _close(got, want, dtype, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-6)
    assert err <= TOL[dtype], f"{what}: rel-max err {err:.2e} > {TOL[dtype]}"


def _np(t):
    return t.detach().float().numpy()


def _static_case(b, seed):
    m, k, n, density = SHAPES[b]
    mask = jmasks.random_block_mask(m, k, b, density, seed=seed)
    mask[0] = False                                  # an empty block-row
    rows, cols = (a.astype(np.int32) for a in np.nonzero(mask))
    p = np.random.default_rng(seed).permutation(rows.size)   # not lexsort
    rows, cols = rows[p], cols[p]
    rng = np.random.default_rng(seed + 1)
    vals = rng.standard_normal((rows.size, b, b)).astype(np.float32)
    x = rng.standard_normal((n, k)).astype(np.float32)
    gy = rng.standard_normal((n, m)).astype(np.float32)
    return (m, k, n), rows, cols, vals, x, gy


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["static", "static_balanced"])
@pytest.mark.parametrize("b", [1, 2, 128])
def test_static_plan_blocks_match_jax(b, mode, dtype):
    """Forward ``spmm_nt``, dL/dx and dL/dvalues of a static plan at a
    block the kernels do not walk as it is, against ``jax.grad`` of the
    JAX plan on its ``static_xla`` route."""
    (m, k, n), rows, cols, vals, x, gy = _static_case(b, 7 + b)
    jb = JBSR(jnp.asarray(vals, JDTYPE[dtype]), rows, cols, (m, k), b)
    jp = jsparse.plan(jb, n, ctx=jsparse.PlanContext(
        mode="static_xla", grad_mode="static_xla", sddmm_mode="sddmm_xla"))

    def loss(v, xt):         # JAX layout: x [k, n] -> y [m, n]
        return jnp.sum(jp(v, xt).astype(jnp.float32) * gy.T)

    jy = np.asarray(jp(jb.values, jnp.asarray(x.T, JDTYPE[dtype])).T,
                    np.float32)
    jdv, jdx = jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(vals, JDTYPE[dtype]), jnp.asarray(x.T, JDTYPE[dtype]))

    tb = TBSR(torch.as_tensor(vals).to(TDTYPE[dtype]), rows, cols, (m, k),
              b)
    tp = tsparse.plan(tb, n, device="cpu",
                      ctx=tsparse.PlanContext(mode=mode))
    tile, split = kernel_tile(b)
    assert tp.route == f"{mode}_torch"
    assert (tp.artifacts["kernel_tile"], tp.artifacts["block_split"]) == (
        tile, split) == {1: (4, 1), 2: (4, 1), 128: (64, 2)}[b]
    assert tp.packing.tm == tp.packing.tk == tile
    tv = tb.values.clone().requires_grad_(True)
    tx = torch.as_tensor(x).to(TDTYPE[dtype]).requires_grad_(True)
    y = tp.spmm_nt(tv, tx)
    assert y.dtype == TDTYPE[dtype] and tuple(y.shape) == (n, m)
    (y.float() * torch.as_tensor(gy)).sum().backward()
    assert tuple(tv.grad.shape) == (rows.size, b, b)
    _close(_np(y), jy, dtype, "forward")
    _close(_np(tv.grad), jdv, dtype, "dL/dvalues")
    _close(_np(tx.grad), np.asarray(jdx, np.float32).T, dtype, "dL/dx")


@pytest.mark.parametrize("b", [1, 2])
def test_packed_sddmm_gathers_each_block(b):
    """dL/dvalues at b < 4 is sampled on the packed 4 x 4 tiles: each
    block equals its slice of the dense dy^T x."""
    (m, k, n), rows, cols, vals, x, gy = _static_case(b, 3)
    tb = TBSR(torch.as_tensor(vals), rows, cols, (m, k), b)
    tp = tsparse.plan(tb, n, device="cpu")
    assert tp.grad.sddmm_block == 4 and tp.grad.gather is not None
    dv = tp.sddmm(torch.as_tensor(gy), torch.as_tensor(x))
    dense = gy.T @ x
    want = np.stack([dense[r * b:(r + 1) * b, c * b:(c + 1) * b]
                     for r, c in zip(rows, cols)])
    _close(_np(dv), want, "float32", "packed sddmm")


def _dynamic_case(b, dtype, seed=11):
    m, k, n, density = SHAPES[b]
    mask = jmasks.random_block_mask(m, k, b, density, seed=seed)
    w = np.random.default_rng(seed).standard_normal((m, k)).astype(
        np.float32)
    nnz_max = int(mask.sum()) + 5                    # padded slots too
    jop = jdsp.encode(jnp.asarray(w, JDTYPE[dtype]), jnp.asarray(mask),
                      block_size=b, nnz_max=nnz_max)
    top = tdsp.encode(torch.as_tensor(w).to(TDTYPE[dtype]),
                      torch.as_tensor(mask), block_size=b, nnz_max=nnz_max)
    x = np.random.default_rng(seed + 1).standard_normal((n, k)).astype(
        np.float32)
    return jop, top, x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", ["dynamic", "dynamic_grouped",
                                   "dynamic_grouped_balanced"])
@pytest.mark.parametrize("b", [1, 2])
def test_dynamic_plan_blocks_match_jax(b, route, dtype):
    """A dynamic plan at b in {1, 2}: the port's route, and the dsmm
    wrapper's re-blocked walk that ``dynamic_cuda`` launches, against
    the JAX plan on its ``dynamic_xla`` route."""
    jop, top, x = _dynamic_case(b, dtype)
    jx = jnp.asarray(x.T, JDTYPE[dtype])
    jp = jsparse.plan(jop, x.shape[0], ctx=jsparse.PlanContext(
        mode="dynamic_xla", differentiable=False))
    want = np.asarray(jp(jop, jx).T, np.float32)
    tx = torch.as_tensor(x).to(TDTYPE[dtype])
    ctx = tsparse.PlanContext(mode=route, capacity_policy="worst")
    tp = tsparse.plan(top, x.shape[0], device="cpu", ctx=ctx)
    assert tp.route == f"{route}_torch"
    _close(_np(tsparse.spmm_nt(top, tx, ctx=ctx)), want, dtype, route)
    _close(_np(tdsmm_ops.dsmm(top, tx)), want, dtype, "reblocked dsmm")


@pytest.mark.parametrize("b", [1, 2])
def test_reblock_embeds_each_slot(b):
    """``reblock`` keeps the operand: the same dense matrix at block 4,
    padding slots zero, nothing read on the host."""
    _, top, _ = _dynamic_case(b, "float32")
    rb = tdsmm_ops.reblock(top)
    assert rb.block_size == 4 and rb.capacity == top.capacity
    assert rb.row_idx.dtype == torch.int32 and rb.nnz is top.nnz
    torch.testing.assert_close(rb.to_dense(), top.to_dense())


# fp32 budget of the blocks that are not powers of two (the same sums in
# another order); bf16 as above
ODD_TOL = dict(TOL, float32=1e-5)


def _odd_static_case(b, m, k, seed, n=12, density=0.4):
    """A static pattern of ``b x b`` blocks over ``m x k`` (an empty
    block-row, blocks not in lexsort order) and seeded activations."""
    mask = np.random.default_rng(seed).random((m // b, k // b)) < density
    mask[0] = False
    mask[-1, -1] = True
    rows, cols = (a.astype(np.int32) for a in np.nonzero(mask))
    p = np.random.default_rng(seed).permutation(rows.size)
    rows, cols = rows[p], cols[p]
    rng = np.random.default_rng(seed + 1)
    vals = rng.standard_normal((rows.size, b, b)).astype(np.float32)
    x = rng.standard_normal((n, k)).astype(np.float32)
    gy = rng.standard_normal((n, m)).astype(np.float32)
    return rows, cols, vals, x, gy


def _odd_static_parity(b, m, k, mode, dtype, seed):
    """Forward, dL/dx and dL/dvalues of the port's plan at ``mode``
    against ``jax.grad`` of the JAX plan on its ``static_xla`` route."""
    rows, cols, vals, x, gy = _odd_static_case(b, m, k, seed)
    n = x.shape[0]
    jb = JBSR(jnp.asarray(vals, JDTYPE[dtype]), rows, cols, (m, k), b)
    jp = jsparse.plan(jb, n, ctx=jsparse.PlanContext(
        mode="static_xla", grad_mode="static_xla", sddmm_mode="sddmm_xla"))

    def loss(v, xt):
        return jnp.sum(jp(v, xt).astype(jnp.float32) * gy.T)

    jy = np.asarray(jp(jb.values, jnp.asarray(x.T, JDTYPE[dtype])).T,
                    np.float32)
    jdv, jdx = jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(vals, JDTYPE[dtype]), jnp.asarray(x.T, JDTYPE[dtype]))

    tb = TBSR(torch.as_tensor(vals).to(TDTYPE[dtype]), rows, cols, (m, k),
              b)
    tp = tsparse.plan(tb, n, device="cpu",
                      ctx=tsparse.PlanContext(mode=mode))
    assert tp.route == f"{mode}_torch"
    tile, split = kernel_tile(b)
    assert (tp.artifacts["kernel_tile"], tp.artifacts["block_split"],
            tp.artifacts["sub_block"]) == (tile, split, b // split)
    assert tp.artifacts["walk_shape"] == (-(-m // tile) * tile,
                                          -(-k // tile) * tile)
    tv = tb.values.clone().requires_grad_(True)
    tx = torch.as_tensor(x).to(TDTYPE[dtype]).requires_grad_(True)
    y = tp.spmm_nt(tv, tx)
    assert y.dtype == TDTYPE[dtype] and tuple(y.shape) == (n, m)
    (y.float() * torch.as_tensor(gy)).sum().backward()
    assert tuple(tv.grad.shape) == (rows.size, b, b)
    tol = ODD_TOL[dtype]
    for got, want, what in ((_np(y), jy, "forward"),
                            (_np(tv.grad), np.asarray(jdv), "dL/dvalues"),
                            (_np(tx.grad), np.asarray(jdx, np.float32).T,
                             "dL/dx")):
        want = np.asarray(want, np.float32)
        err = float(np.abs(got - want).max()) / max(
            float(np.abs(want).max()), 1e-6)
        assert err <= tol, f"{what}: rel-max err {err:.2e} > {tol}"


def _odd_dynamic_parity(b, m, k, mode, dtype, seed):
    """The port's dynamic plan at ``mode`` and the dsmm wrapper's
    split / re-blocked walk (what ``dynamic_cuda`` launches) on a
    runtime operand at block ``b``, against the JAX plan's
    ``dynamic_xla`` route."""
    mask = np.random.default_rng(seed).random((m // b, k // b)) < 0.4
    mask[0, 0] = True
    w = np.random.default_rng(seed + 2).standard_normal((m, k)).astype(
        np.float32)
    nnz_max = int(mask.sum()) + 3                    # padded slots too
    jop = jdsp.encode(jnp.asarray(w, JDTYPE[dtype]), jnp.asarray(mask),
                      block_size=b, nnz_max=nnz_max)
    top = tdsp.encode(torch.as_tensor(w).to(TDTYPE[dtype]),
                      torch.as_tensor(mask), block_size=b, nnz_max=nnz_max)
    x = np.random.default_rng(seed + 3).standard_normal((10, k)).astype(
        np.float32)
    jp = jsparse.plan(jop, x.shape[0], ctx=jsparse.PlanContext(
        mode="dynamic_xla", differentiable=False))
    want = np.asarray(jp(jop, jnp.asarray(x.T, JDTYPE[dtype])).T,
                      np.float32)
    tx = torch.as_tensor(x).to(TDTYPE[dtype])
    ctx = tsparse.PlanContext(mode=mode, capacity_policy="worst")
    tp = tsparse.plan(top, x.shape[0], device="cpu", ctx=ctx)
    assert tp.route == f"{mode}_torch"
    tol = ODD_TOL[dtype]
    for got, what in ((tsparse.spmm_nt(top, tx, ctx=ctx), mode),
                      (tdsmm_ops.dsmm(top, tx), "split dsmm")):
        got = _np(got)
        assert got.shape == (x.shape[0], m)
        err = float(np.abs(got - want).max()) / max(
            float(np.abs(want).max()), 1e-6)
        assert err <= tol, f"{what}: rel-max err {err:.2e} > {tol}"


@pytest.mark.parametrize("b", [3, 6, 12, 24])
@pytest.mark.parametrize("mode", ["static", "dense", "dynamic"])
def test_block_no_tile_takes_raises_at_plan_time(b, mode):
    """A block that is not a power of two, which no kernel tile takes as
    it is: ``plan`` builds (where it once raised), walks the block split
    into sub-blocks the kernels take, and matches the JAX plan in the
    forward and, for the static pattern, dL/dx and dL/dvalues."""
    m, k = 96, 192
    for dtype in ("float32", "bfloat16"):
        _odd_static_parity(b, m, k, mode, dtype, seed=b)


def test_dynamic_block_no_tile_takes_raises_at_plan_time():
    """A runtime operand at b = 3 plans (where it once raised) and its
    split, re-blocked dsmm walk matches the JAX plan."""
    for dtype in ("float32", "bfloat16"):
        _odd_dynamic_parity(3, 96, 192, "dynamic", dtype, seed=3)


# the other routes, b = 5, and a grid the 4 x 4 packing tile does not
# divide (m = 99, k = 51 at b = 3: the walk pads it)
ODD_SHAPES = [(3, 96, 192), (5, 40, 80), (6, 96, 192), (12, 96, 192),
              (24, 96, 192), (3, 99, 51)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["static", "dense"])
@pytest.mark.parametrize("b,m,k", [(5, 40, 80), (3, 99, 51)])
def test_odd_static_blocks_match_jax(b, m, k, mode, dtype):
    _odd_static_parity(b, m, k, mode, dtype, seed=b + m)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,m,k", ODD_SHAPES)
def test_odd_static_balanced_blocks_match_jax(b, m, k, dtype):
    _odd_static_parity(b, m, k, "static_balanced", dtype, seed=b + k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["dynamic", "dynamic_grouped",
                                  "dynamic_grouped_balanced"])
@pytest.mark.parametrize("b,m,k", ODD_SHAPES)
def test_odd_dynamic_blocks_match_jax(b, m, k, mode, dtype):
    _odd_dynamic_parity(b, m, k, mode, dtype, seed=b + m + k)


@pytest.mark.parametrize("b,tile,split", [(3, 4, 3), (5, 4, 5), (6, 4, 3),
                                          (12, 4, 3), (24, 8, 3),
                                          (48, 16, 3), (96, 32, 3),
                                          (100, 4, 25), (1, 4, 1),
                                          (128, 64, 2)])
def test_kernel_tile_maps_every_block(b, tile, split):
    assert kernel_tile(b) == (tile, split)
    assert tcontract.sub_block(b, (4, 8, 16, 32, 64)) * split == b


@pytest.mark.parametrize("b", [1, 2, 4, 8, 16, 32, 64, 128])
def test_every_power_of_two_block_plans(b):
    """Every power-of-two block in 1..128 plans on the static and dynamic
    routes, at the tile the kernels admit."""
    m = k = 256
    mask = np.random.default_rng(b).random((m // b, k // b)) < 0.3
    mask[0, 0] = True
    tb = TBSR.from_mask(mask, b, values=torch.randn(int(mask.sum()), b, b))
    for mode in ("static", "static_balanced", "dynamic", "dynamic_grouped"):
        p = tsparse.plan(tb, 8, device="cpu",
                         ctx=tsparse.PlanContext(mode=mode))
        assert p.route == f"{mode}_torch"
    op = tdsp.encode(torch.randn(m, k), torch.as_tensor(mask), block_size=b,
                     nnz_max=int(mask.sum()))
    assert tsparse.plan(op, 8, device="cpu", ctx=tsparse.PlanContext(
        mode="dynamic")).route == "dynamic_torch"
    assert dynamic_tile(m, k, b, "dynamic_cuda") == max(b, 4)
