"""The port's training slice against the JAX package, on the CPU.

Seeded numpy inputs go to both packages.  On the CPU the port's wrappers
run their kernels' plain versions; the JAX side runs its Pallas kernels
in interpret mode, its ``ref.py`` oracles, or its XLA routes.  Budgets
are ``tests/conftest.py``'s per-dtype ones (fp32 1e-4, bf16 6e-2,
rel-max over the reference's max magnitude) unless a test states its
own.  The CUDA kernels are held against these plain versions on a card
by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import assert_close_for_dtype  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro import sparse as jsparse  # noqa: E402
from repro.core import masks as jmasks  # noqa: E402
from repro.core import partitioner as jpart  # noqa: E402
from repro.core import static_sparse as jss  # noqa: E402
from repro.core.bsr import BlockSparseMatrix as JBSR  # noqa: E402
from repro.kernels.sddmm import grouped_sddmm, sddmm_ref  # noqa: E402
from repro.kernels.sddmm import ops as jsddmm_ops  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import sparse as tsparse  # noqa: E402
from repro_torch.core import partitioner as tpart  # noqa: E402
from repro_torch.core import static_sparse as tss  # noqa: E402
from repro_torch.core.bsr import BlockSparseMatrix as TBSR  # noqa: E402
from repro_torch.core.sparse_layers import SparseLinear  # noqa: E402
from repro_torch.kernels.sddmm import ops as tsddmm_ops  # noqa: E402
from repro_torch.models.model import LM as TLM  # noqa: E402

TDTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
# the model-level budget: fp32 summation-order noise through two layers,
# the attention's one-pass vs online softmax and the chunked unembed
MODEL_TOL = 1e-4


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / max(
        float(np.abs(want).max()), 1e-6)


def _pattern(m, k, b, density, seed, empty=False):
    mask = jmasks.random_block_mask(m, k, b, density, seed=seed)
    if empty:
        mask[0] = False
        mask[:, -1] = False
    rows, cols = np.nonzero(mask)
    return mask, rows.astype(np.int32), cols.astype(np.int32)


def _np(t):
    return t.detach().float().numpy()


# -- host metadata ----------------------------------------------------------------

@pytest.mark.parametrize("b", [4, 16])
@pytest.mark.parametrize("order", ["lexsort", "shuffled"])
@pytest.mark.parametrize("empty", [False, True], ids=["full", "empty"])
def test_plan_transpose_matches_jax(b, order, empty):
    m, k = 64, 128
    _, rows, cols = _pattern(m, k, b, 0.25, 5 + b, empty)
    if order == "shuffled":
        p = np.random.default_rng(b).permutation(rows.size)
        rows, cols = rows[p], cols[p]
    jt = jpart.plan_transpose(rows, cols, (m, k), b)
    tt = tpart.plan_transpose(rows, cols, (m, k), b)
    for name in ("perm", "row_idx", "col_idx"):
        want, got = getattr(jt, name), getattr(tt, name)
        assert got.dtype == want.dtype, name
        assert np.array_equal(got, want), name
    assert tt.shape == jt.shape == (k, m) and tt.block_size == b
    vals = np.random.default_rng(1).standard_normal(
        (rows.size, b, b)).astype(np.float32)
    want = np.asarray(jpart.apply_transpose(jt, jnp.asarray(vals)))
    assert np.array_equal(tpart.apply_transpose(tt, torch.as_tensor(vals))
                          .numpy(), want)


# -- the SDDMM kernel's plain version ---------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b", [4, 16])
@pytest.mark.parametrize("empty", [False, True], ids=["full", "empty"])
def test_sddmm_plain_matches_jax(dtype, b, empty):
    m, k, n = 64, 128, 48
    _, rows, cols = _pattern(m, k, b, 0.25, 11 + b, empty)
    rng = np.random.default_rng(b)
    dy = rng.standard_normal((m, n)).astype(np.float32)
    x = rng.standard_normal((k, n)).astype(np.float32)
    jdy, jx = jnp.asarray(dy, JDTYPE[dtype]), jnp.asarray(x, JDTYPE[dtype])
    t = jsddmm_ops.sddmm_tile_size(m, k, b)
    meta = jpart.plan_packing(rows, cols, (m, k), b, t, t)
    want_kernel = grouped_sddmm(meta, jdy, jx, interpret=True)
    want_ref = sddmm_ref(rows, cols, jdy, jx, block_size=b)

    tdy = torch.as_tensor(dy.T.copy()).to(TDTYPE[dtype])
    tx = torch.as_tensor(x.T.copy()).to(TDTYPE[dtype])
    ptr = torch.as_tensor(tsddmm_ops.block_row_ptr(rows, m // b))
    got = tsddmm_ops.sddmm(tdy, tx, ptr, torch.as_tensor(cols),
                           torch.as_tensor(rows), b)
    assert got.shape == (rows.size, b, b) and got.dtype == TDTYPE[dtype]
    assert_close_for_dtype(_np(got), want_kernel, dtype, "sddmm vs Pallas")
    assert_close_for_dtype(_np(got), want_ref, dtype, "sddmm vs ref")


def test_block_row_ptr_and_splits():
    rows = np.asarray([0, 0, 2, 2, 2, 5], np.int32)
    assert tsddmm_ops.block_row_ptr(rows, 6).tolist() == [0, 2, 2, 5, 5, 5, 6]
    assert tsddmm_ops.n_splits(2048, 512) == 2
    assert tsddmm_ops.n_splits(2048, 128) == 8
    assert tsddmm_ops.n_splits(256, 128) == 1
    assert tsddmm_ops.n_splits(100, 4) == 1


@pytest.mark.parametrize("bad, msg", [
    (dict(b=12), "blocks of"),
    (dict(x2=torch.zeros(5, 32)), "dy2 \\[N, m\\]"),
    (dict(col_idx=torch.zeros(2, dtype=torch.int64)), "int32"),
    (dict(row_ptr=torch.zeros(4, dtype=torch.int32)), "entries"),
])
def test_sddmm_wrapper_validates(bad, msg):
    args = dict(dy2=torch.zeros(4, 32), x2=torch.zeros(4, 32),
                row_ptr=torch.tensor([0, 1, 2], dtype=torch.int32),
                col_idx=torch.tensor([0, 1], dtype=torch.int32), b=16)
    args.update(bad)
    with pytest.raises(ValueError, match=msg):
        tsddmm_ops.sddmm_cuda(**args)


def test_sddmm_cuda_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensors"):
        tsddmm_ops.sddmm_cuda(
            torch.zeros(4, 32), torch.zeros(4, 32),
            torch.tensor([0, 1, 2], dtype=torch.int32),
            torch.tensor([0, 1], dtype=torch.int32), 16)


# -- static_sparse formulations ----------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b", [4, 16])
def test_static_sparse_products_match_jax(dtype, b):
    m, k, n = 64, 96, 40
    _, rows, cols = _pattern(m, k, b, 0.3, 21 + b)
    grid = (m // b, k // b)
    rng = np.random.default_rng(b)
    vals = rng.standard_normal((rows.size, b, b)).astype(np.float32)
    x = rng.standard_normal((k, n)).astype(np.float32)
    dy = rng.standard_normal((m, n)).astype(np.float32)
    jv, jx, jdy = (jnp.asarray(a, JDTYPE[dtype]) for a in (vals, x, dy))
    tv, tx, tdy = (torch.as_tensor(a).to(TDTYPE[dtype])
                   for a in (vals, x, dy))
    want_y = jss.make_spmm(rows, cols, grid, b)(jv, jx)
    want_dx = jss.make_spmm_t(rows, cols, grid, b)(jv, jdy)
    want_dv = jss.make_sddmm(rows, cols, grid, b)(jdy, jx)
    got_y = tss.make_spmm(rows, cols, grid, b)(tv, tx)
    got_dx = tss.make_spmm_t(rows, cols, grid, b)(tv, tdy)
    got_dv = tss.make_sddmm(rows, cols, grid, b)(tdy, tx)
    for got, want, what in ((got_y, want_y, "spmm"),
                            (got_dx, want_dx, "spmm_t"),
                            (got_dv, want_dv, "sddmm")):
        assert got.dtype == TDTYPE[dtype], what
        assert tuple(got.shape) == tuple(want.shape), what
        assert_close_for_dtype(_np(got), want, dtype, what)


def test_make_spmm_backward_matches_jax():
    m, k, n, b = 64, 96, 24, 16
    _, rows, cols = _pattern(m, k, b, 0.3, 3)
    grid = (m // b, k // b)
    rng = np.random.default_rng(0)
    vals = rng.standard_normal((rows.size, b, b)).astype(np.float32)
    x = rng.standard_normal((k, n)).astype(np.float32)
    gy = rng.standard_normal((m, n)).astype(np.float32)
    jf = jss.make_spmm(rows, cols, grid, b)
    jdv, jdx = jax.grad(lambda v, x_: jnp.sum(jf(v, x_) * gy),
                        argnums=(0, 1))(jnp.asarray(vals), jnp.asarray(x))
    tv = torch.as_tensor(vals).requires_grad_(True)
    tx = torch.as_tensor(x).requires_grad_(True)
    (tss.make_spmm(rows, cols, grid, b)(tv, tx) * torch.as_tensor(gy)
     ).sum().backward()
    assert_close_for_dtype(_np(tv.grad), jdv, "float32", "dvalues")
    assert_close_for_dtype(_np(tx.grad), jdx, "float32", "dx")


# -- the static plan's planned backward -------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b", [4, 16])
@pytest.mark.parametrize("order", ["lexsort", "shuffled"])
def test_planned_backward_matches_jax_grad(dtype, b, order):
    """The port's static autograd Function (bsmm forward; SDDMM and bsmm
    on the transposed pattern backward) against ``jax.grad`` of the JAX
    plan on its Pallas routes (bsmm, sddmm_grouped) in interpret mode."""
    m, k, n = 64, 128, 32
    _, rows, cols = _pattern(m, k, b, 0.25, 31 + b, empty=True)
    if order == "shuffled":
        p = np.random.default_rng(b).permutation(rows.size)
        rows, cols = rows[p], cols[p]
    rng = np.random.default_rng(b + 1)
    vals = rng.standard_normal((rows.size, b, b)).astype(np.float32)
    x = rng.standard_normal((n, k)).astype(np.float32)
    gy = rng.standard_normal((n, m)).astype(np.float32)

    jb = JBSR(jnp.asarray(vals, JDTYPE[dtype]), rows, cols, (m, k), b)
    ctx = jsparse.PlanContext(mode="static_pallas", interpret=True,
                              grad_mode="static_pallas",
                              sddmm_mode="sddmm_grouped")
    jp = jsparse.plan(jb, n, ctx=ctx)

    def loss(v, xt):       # JAX layout: x [k, n] -> y [m, n]
        return jnp.sum(jp(v, xt).astype(jnp.float32) * gy.T)

    jdv, jdx = jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(vals, JDTYPE[dtype]), jnp.asarray(x.T, JDTYPE[dtype]))

    tb = TBSR(torch.as_tensor(vals).to(TDTYPE[dtype]), rows, cols, (m, k), b)
    tp = tsparse.plan(tb, n, device="cpu", ctx=tsparse.PlanContext(
        mode="static_pallas", grad_mode="static_pallas",
        sddmm_mode="sddmm_grouped"))
    assert tp.grad_routes == {"dx": "static_torch",
                              "dvalues": "sddmm_torch"}
    tv = tb.values.clone().requires_grad_(True)
    tx = torch.as_tensor(x).to(TDTYPE[dtype]).requires_grad_(True)
    y = tp.spmm_nt(tv, tx)
    assert y.requires_grad and y.dtype == TDTYPE[dtype]
    (y.float() * torch.as_tensor(gy)).sum().backward()
    assert tv.grad.dtype == tv.dtype and tx.grad.dtype == tx.dtype
    assert_close_for_dtype(_np(tv.grad), jdv, dtype, "dL/dvalues")
    assert_close_for_dtype(_np(tx.grad), np.asarray(jdx, np.float32).T,
                           dtype, "dL/dx")


def test_planned_backward_under_no_grad_is_forward_only():
    m, k, b = 32, 64, 16
    layer = SparseLinear.random_pattern(k, m, b, 0.5, seed=2, device="cpu")
    layer.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(5, k)
    with torch.no_grad():
        y0 = layer(x)
    assert not y0.requires_grad
    layer.requires_grad_(True)
    y1 = layer(x)
    assert y1.requires_grad
    assert torch.equal(y0, y1.detach())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_planned_backward_matches_jax_grad(dtype):
    n, k, d = 12, 48, 40
    rng = np.random.default_rng(4)
    x = rng.standard_normal((n, k)).astype(np.float32)
    w = rng.standard_normal((k, d)).astype(np.float32)
    gy = rng.standard_normal((n, d)).astype(np.float32)

    def loss(x_, w_):
        return jnp.sum((x_ @ w_).astype(jnp.float32) * gy)

    jdx, jdw = jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(x, JDTYPE[dtype]), jnp.asarray(w, JDTYPE[dtype]))
    tx = torch.as_tensor(x).to(TDTYPE[dtype]).requires_grad_(True)
    tw = torch.as_tensor(w).to(TDTYPE[dtype]).requires_grad_(True)
    y = tsparse.matmul(tx, tw)
    (y.float() * torch.as_tensor(gy)).sum().backward()
    assert tx.grad.dtype == TDTYPE[dtype] and tw.grad.dtype == TDTYPE[dtype]
    assert_close_for_dtype(_np(tx.grad), jdx, dtype, "dL/dx")
    assert_close_for_dtype(_np(tw.grad), jdw, dtype, "dL/dw")


@pytest.mark.parametrize("bias", [False, True])
def test_sparse_linear_grads_match_plain_make_spmm(bias):
    """SparseLinear's autograd path against core/static_sparse's plain
    formulation on the same values (fp32)."""
    d_in, d_out, b = 64, 96, 16
    layer = SparseLinear.random_pattern(d_in, d_out, b, 0.25, seed=7,
                                        use_bias=bias, device="cpu")
    layer.reset_parameters(torch.Generator().manual_seed(3))
    if bias:
        with torch.no_grad():
            layer.bias.normal_(generator=torch.Generator().manual_seed(4))
    layer.requires_grad_(True)
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.standard_normal((3, 5, d_in)).astype(
        np.float32)).requires_grad_(True)
    gy = torch.as_tensor(rng.standard_normal((3, 5, d_out)).astype(
        np.float32))
    (layer(x) * gy).sum().backward()

    grid = (d_out // b, d_in // b)
    f = tss.make_spmm(layer.row_idx, layer.col_idx, grid, b)
    v = layer.values.detach().clone().requires_grad_(True)
    x2 = x.detach().reshape(-1, d_in).clone().requires_grad_(True)
    (f(v, x2.t()).t() * gy.reshape(-1, d_out)).sum().backward()
    assert _rel(_np(layer.values.grad), _np(v.grad)) <= 1e-5
    assert _rel(_np(x.grad.reshape(-1, d_in)), _np(x2.grad)) <= 1e-5
    if bias:
        assert torch.allclose(layer.bias.grad, gy.sum((0, 1)))


# -- the model: LM.loss and every parameter's gradient ------------------------------

def _model_cfg(port: bool, density: float = 0.25):
    if port:
        cfg = tconfigs.sparsify_ffn(tconfigs.smoke("llama3_2_1b"), density)
    else:
        cfg = jconfigs.smoke("llama3_2_1b")
        groups = tuple((tuple(dataclasses.replace(s, ffn="sparse")
                              for s in period), rep)
                       for period, rep in cfg.groups)
        cfg = dataclasses.replace(cfg, groups=groups, ffn_density=density)
    return dataclasses.replace(cfg, dtype="float32")


def prewarm_jax_sparse_plans(jcfg, params, n):
    """Build the JAX sparse FFN's plans for ``n`` tokens outside any
    trace.  The reference's ``_dx_closure`` (``sparse/plan.py:1328``)
    materialises ``perm`` with ``jnp.asarray`` when a plan is built; a
    plan first built inside the scanned layer stack caches a tracer, and
    ``jax.grad`` of ``LM.loss`` then fails with a leaked tracer.  Plans
    built eagerly here are what the traced calls find in the cache."""
    from repro.models import transformer as jtfm
    ffn = jtfm._sparse_ffn(jcfg)
    layer0 = jax.tree.map(lambda a: a[0], params["stack"][0][0]["ffn"])
    ffn.apply(layer0, jnp.zeros((n, jcfg.d_model), jnp.dtype(jcfg.dtype)))


@pytest.fixture(scope="module")
def model_pair():
    jcfg, tcfg = _model_cfg(False), _model_cfg(True)
    jlm = JLM(jcfg)
    params = jlm.init(jax.random.PRNGKey(0))
    # drop the reference's in-memory plans first: one an earlier test of
    # the same process built inside a trace (this smoke pattern at the
    # same n) would be the cache hit, tracer and all
    jsparse.reset()
    for n in (32, 8):      # the batches' B * S below
        prewarm_jax_sparse_plans(jcfg, params, n)
    tlm = TLM(tcfg, device="cpu").load_jax_params(
        jax.tree.map(np.asarray, params))
    return jlm, params, tlm


def _batch(b, s, seed, pad=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 512, size=(b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:].copy()}
    if pad:
        batch["targets"][0, -pad:] = -1
    return batch


@pytest.mark.parametrize("chunk", [1024, 4], ids=["one_chunk", "chunked"])
def test_loss_and_param_grads_match_jax(model_pair, chunk):
    jlm, params, tlm = model_pair
    batch = _batch(2, 16, 5, pad=3)
    jb = jax.tree.map(jnp.asarray, batch)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss(p, jb, loss_chunk=chunk), has_aux=True))(params)
    want = tlm.jax_leaves(jax.tree.map(np.asarray, jgrads))

    tlm.requires_grad_(True)
    try:
        loss, metrics = tlm.loss(batch["tokens"], batch["targets"],
                                 loss_chunk=chunk)
        names = [n for n, _ in tlm.named_parameters()]
        grads = torch.autograd.grad(loss, [p for _, p in
                                           tlm.named_parameters()])
    finally:
        tlm.requires_grad_(False)
    assert loss.dtype == torch.float32
    assert abs(float(loss.detach()) - float(jloss)) <= \
        MODEL_TOL * abs(float(jloss))
    assert abs(float(metrics["xent"]) - float(jm["xent"])) <= \
        MODEL_TOL * abs(float(jm["xent"]))
    assert set(names) == set(want)
    worst = {n: _rel(_np(g), want[n]) for n, g in zip(names, grads)}
    assert max(worst.values()) <= MODEL_TOL, sorted(
        worst.items(), key=lambda kv: -kv[1])[:3]


def test_tied_embedding_collects_both_grads(model_pair):
    """The tied table's gradient is the gather's plus the unembed's: a
    token that never appears as input still gets the unembed's."""
    _, _, tlm = model_pair
    batch = _batch(1, 8, 9)
    tlm.requires_grad_(True)
    try:
        loss, _ = tlm.loss(batch["tokens"], batch["targets"])
        (g,) = torch.autograd.grad(loss, [tlm.embed.table])
    finally:
        tlm.requires_grad_(False)
    unused = sorted(set(range(512)) - set(batch["tokens"].ravel().tolist()))
    assert float(g[unused].abs().max()) > 0
    assert tlm.lm_head is None


def test_loss_without_grad_matches_forward(model_pair):
    """``loss`` under no_grad equals a cross entropy over ``forward``'s
    logits; entry points stay no_grad after training is switched on."""
    _, _, tlm = model_pair
    batch = _batch(2, 10, 6, pad=2)
    with torch.no_grad():
        loss, _ = tlm.loss(batch["tokens"], batch["targets"], loss_chunk=2)
    logits = tlm.forward(batch["tokens"]).float()
    tg = torch.as_tensor(batch["targets"]).long()
    want = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), tg.reshape(-1),
        ignore_index=-1)
    assert abs(float(loss) - float(want)) <= 1e-5 * float(want)
    tlm.requires_grad_(True)
    try:
        assert not tlm.forward(batch["tokens"]).requires_grad
    finally:
        tlm.requires_grad_(False)
