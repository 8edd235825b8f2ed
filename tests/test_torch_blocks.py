"""Block sizes outside the port kernels' own tiles, against the JAX package
on the CPU.

The reference admits blocks 1..128 on every route.  The port's static
kernels (bsmm, bsmm_balanced, sddmm) walk tiles of 4..64 and dsmm blocks
of 4..128, so the plan maps the other powers of two onto them
(``sparse.plan.kernel_tile``): b in {1, 2} packed into 4 x 4 tiles (the
dL/dvalues product sampled on those tiles and the blocks gathered out),
b = 128 split into four exact 64 x 64 blocks, and a dynamic operand at
b in {1, 2} re-blocked on the device (``dsmm.ops.reblock``).  A block no
tile takes raises when the plan is built, with the contract's reason.

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


@pytest.mark.parametrize("b", [3, 6, 12, 24])
@pytest.mark.parametrize("mode", ["static", "dense", "dynamic"])
def test_block_no_tile_takes_raises_at_plan_time(b, mode):
    """A block that is not a power of two and that no admitted tile is a
    multiple of: ``plan`` raises with the kernel contract's reason,
    before anything runs."""
    m, k = 96, 192
    mask = np.random.default_rng(b).random((m // b, k // b)) < 0.4
    tb = TBSR.from_mask(mask, b, values=torch.randn(int(mask.sum()), b, b))
    t = kernel_tile(b)[0]
    reason = tcontract.load_all()["bsmm"].admits(m, k, 4, t, "float32")
    assert reason is not None
    with pytest.raises(ValueError, match="cannot take") as err:
        tsparse.plan(tb, 4, device="cpu",
                     ctx=tsparse.PlanContext(mode=mode))
    assert reason in str(err.value) or mode == "dynamic"


def test_dynamic_block_no_tile_takes_raises_at_plan_time():
    op = tdsp.encode(torch.randn(96, 192), torch.ones(32, 64, dtype=bool),
                     block_size=3, nnz_max=8)
    reason = tcontract.load_all()["dsmm"].admits(96, 192, 4, 3, "float32")
    with pytest.raises(ValueError, match="cannot take") as err:
        tsparse.plan(op, 4, device="cpu")
    assert reason in str(err.value)


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
    assert tsparse.plan(op, 8, device="cpu").route == "dynamic_torch"
    assert dynamic_tile(m, k, b, "dynamic_cuda") == max(b, 4)
