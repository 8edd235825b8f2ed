"""The port's attention against the JAX package: the tile mask and
walk against the reference's static block schedules and
``mask_to_pairs`` bit for bit, the plain ``bs_attn`` against
the Pallas kernel in interpret mode and its oracle, ``attend_train``
(row and balanced schedules, windows, global prefix, soft-cap, GQA,
halved tiles) and its gradients against ``jax.grad``, and the windowed
``attend_decode``.  Inputs come from a numpy seed; budgets are the
conftest's per-dtype rel-max (fp32 1e-4, bf16 6e-2)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import assert_close_for_dtype  # noqa: E402
from repro.core import masks as jmasks  # noqa: E402
from repro.kernels.bs_attn import ops as jbs_ops  # noqa: E402
from repro.kernels.bs_attn.ref import bs_attn_ref as jbs_attn_ref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels.bs_attn import ops as tbs_ops  # noqa: E402
from repro_torch.kernels.bs_attn.ref import bs_attn_ref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(x, dtype="float32"):
    return torch.as_tensor(x).to(TORCH_DT[dtype])


def _j(x, dtype="float32"):
    return jnp.asarray(x).astype(JAX_DT[dtype])


# --- schedule metadata -------------------------------------------------------

SCHED_CASES = [
    # nq, nkv, window_tiles, global_tiles, tile_q, tile_kv, causal
    (1, 1, 0, 0, 37, 37, True),
    (8, 8, 0, 0, 64, 64, True),
    (6, 12, 0, 0, 64, 32, True),
    (16, 16, 3, 0, 32, 32, True),
    (16, 16, 3, 2, 32, 32, True),
    (10, 10, 2, 1, 1, 1, True),
    (5, 7, 0, 0, 16, 16, False),
]


def _visited(sched, shape):
    """The tiles a reference scan schedule visits, as a bool mask."""
    seen = np.zeros(shape, bool)
    for i, r in enumerate(sched.rows):
        seen[r, sched.cols[i][sched.valid[i]]] = True
    return seen


@pytest.mark.parametrize("case", SCHED_CASES)
@pytest.mark.parametrize("balanced", [False, True])
def test_causal_schedule_bit_equal(case, balanced):
    """The tile mask the kernel walks is the one the reference's
    ``_causal_schedule`` visits, row by row in the same column order."""
    nq, nkv, wt, gt, tq, tkv, causal = case
    want = jattn._causal_schedule(nq, nkv, wt, gt, tq, tkv, balanced,
                                  causal)
    mask = tattn.causal_block_mask(nq, nkv, wt, gt, tq, tkv, causal)
    assert mask.dtype == bool and mask.shape == (nq, nkv)
    assert np.array_equal(mask, _visited(want, (nq, nkv)))
    row_ptr, cols = tbs_ops.walk_csr(mask, 1)
    for i, r in enumerate(want.rows):
        assert np.array_equal(cols[row_ptr[r]:row_ptr[r + 1]],
                              want.cols[i][want.valid[i]])
    with pytest.raises(ValueError):
        mask[0, 0] = False                      # cached: read-only


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("balanced", [False, True])
def test_build_schedule_bit_equal_on_random_masks(seed, balanced):
    """On any tile mask the walk's CSR lists, for each q tile, the kv
    tiles the reference's ``build_schedule`` visits, in its order; both
    refuse a q tile that sees no kv tile."""
    rng = np.random.default_rng(seed)
    mask = rng.random((9, 13)) < 0.3
    mask[np.arange(9), rng.integers(0, 13, 9)] = True
    want = jattn.build_schedule(mask, balanced=balanced)
    row_ptr, cols = tbs_ops.walk_csr(mask, 1)
    assert row_ptr.dtype == cols.dtype == want.cols.dtype
    for i, r in enumerate(want.rows):
        assert np.array_equal(cols[row_ptr[r]:row_ptr[r + 1]],
                              want.cols[i][want.valid[i]])
    mask[4] = False
    with pytest.raises(ValueError, match="at least|>=1"):
        jattn.build_schedule(mask)
    with pytest.raises(ValueError, match=">=1"):
        tbs_ops.walk_csr(mask, 1)


@pytest.mark.parametrize("nq", [1, 2, 3, 8, 9])
def test_pair_schedule_bit_equal_and_covers_the_causal_tiles(nq):
    """The reference's folded-pair schedule (``schedule="balanced"``)
    visits exactly the causal tiles the port walks for either
    schedule."""
    want = jattn.build_pair_schedule(nq)
    seen = np.zeros((nq, nq), bool)
    for i in range(want.rows.shape[0]):
        for lane in np.flatnonzero(want.valid[i]):
            assert not seen[want.rows[i, want.tag[i, lane]],
                            want.cols[i, lane]]
            seen[want.rows[i, want.tag[i, lane]], want.cols[i, lane]] = True
    assert np.array_equal(
        seen, tattn.causal_block_mask(nq, nq, 0, 0, 32, 32, True))
    q = _t(_np((1, nq * 4, 2, 8), nq))
    k, v = _t(_np((1, nq * 4, 2, 8), nq + 1)), _t(_np((1, nq * 4, 2, 8), 9))
    row = tattn.attend_train(q, k, v, tile_q=4, tile_kv=4)
    bal = tattn.attend_train(q, k, v, tile_q=4, tile_kv=4,
                             schedule="balanced")
    assert torch.equal(row, bal)
    with pytest.raises(ValueError, match="schedule"):
        tattn.attend_train(q, k, v, schedule="folded")


def _grid_mask(pattern, nb):
    if pattern == "causal_local":
        return jmasks.local_global_attention_mask(nb, nb, window_blocks=2,
                                                  global_blocks=1)
    if pattern == "banded":
        bm = jmasks.banded_block_mask(nb * 128, nb * 128, 128, 1)
        bm = np.tril(bm)
        bm[np.diag_indices(nb)] = True
        return bm
    return np.tril(np.ones((nb, nb), bool))


@pytest.mark.parametrize("pattern", ["causal_local", "banded", "full",
                                     "random"])
def test_mask_to_pairs_bit_equal(pattern):
    if pattern == "random":
        mask = np.random.default_rng(4).random((7, 11)) < 0.4
        mask[:, 3] = True
    else:
        mask = _grid_mask(pattern, 4)
    for got, want in zip(tbs_ops.mask_to_pairs(mask),
                         jbs_ops.mask_to_pairs(mask)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    row_ptr, cols = tbs_ops.walk_csr(mask, 1)
    rows, want_cols = jbs_ops.mask_to_pairs(mask)
    assert np.array_equal(cols, want_cols)
    assert np.array_equal(np.repeat(np.arange(mask.shape[0]),
                                    np.diff(row_ptr)), rows)
    mask[2] = False
    for mod in (tbs_ops, jbs_ops):
        with pytest.raises(ValueError, match="block-row"):
            mod.mask_to_pairs(mask)


@pytest.mark.parametrize("group", [2, 4, 64])
def test_walk_csr_groups_take_the_union_of_their_tiles(group):
    mask = np.random.default_rng(group).random((10, 9)) < 0.3
    mask[np.arange(10), np.arange(10) % 9] = True
    row_ptr, cols = tbs_ops.walk_csr(mask, group)
    ng = -(-10 // group)
    assert row_ptr.shape == (ng + 1,) and row_ptr.dtype == np.int32
    for g in range(ng):
        want = np.flatnonzero(mask[g * group:(g + 1) * group].any(axis=0))
        assert np.array_equal(cols[row_ptr[g]:row_ptr[g + 1]], want)
    assert tbs_ops.walk_group(10, 1) == 64 and tbs_ops.walk_group(1, 8) == 1
    assert tbs_ops.walk_group(10, 128) == 1
    walk = tbs_ops.make_walk(mask, 1, 1, "cpu")
    assert walk.group == 64 and walk.n_blocks == 1
    assert walk.tile_mask is not None and walk.tile_mask.shape == (10, 9)
    walk = tbs_ops.make_walk(np.ones((2, 2), bool), 200, 200, "cpu")
    assert walk.group == 1 and walk.n_blocks == 2 * 4
    assert walk.tile_mask is None


# --- the kernel's plain version vs the JAX kernel and oracle -----------------

@pytest.fixture(scope="module")
def bs_attn_inputs():
    h, s, dh = 2, 512, 64
    return (_np((h, s, dh), 0, 0.3), _np((h, s, dh), 1, 0.3),
            _np((h, s, dh), 2))


@pytest.mark.parametrize("pattern", ["causal_local", "banded", "full"])
@pytest.mark.parametrize("softcap", [None, 30.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bs_attn_plain_matches_jax(bs_attn_inputs, pattern, softcap, dtype):
    q, k, v = bs_attn_inputs
    bm = _grid_mask(pattern, 4)
    jq, jk, jv = (_j(x, dtype) for x in (q, k, v))
    want_ref = jbs_attn_ref(jq, jk, jv, bm, softcap=softcap)
    want_kernel = jbs_ops.bs_attn(jq, jk, jv, bm, softcap=softcap,
                                  interpret=True)
    got = tbs_ops.bs_attn(_t(q, dtype), _t(k, dtype), _t(v, dtype), bm,
                          softcap=softcap)
    assert got.dtype == TORCH_DT[dtype] and got.shape == q.shape
    assert_close_for_dtype(got.float(), np.asarray(want_ref, np.float32),
                           dtype, "vs bs_attn_ref")
    assert_close_for_dtype(got.float(), np.asarray(want_kernel, np.float32),
                           dtype, "vs bs_attn (interpret)")
    ref = bs_attn_ref(_t(q, dtype), _t(k, dtype), _t(v, dtype), bm,
                      softcap=softcap)
    assert torch.equal(ref, got)


def test_bs_attn_rejects_rows_that_see_no_key():
    q = torch.zeros((1, 256, 32))
    bm = np.zeros((2, 2), bool)
    bm[0, 1] = bm[1, 1] = True          # tile 0 sees only later keys
    with pytest.raises(ValueError, match="see no key"):
        tbs_ops.bs_attn(q, q, q, bm)
    with pytest.raises(ValueError, match="grid"):
        tbs_ops.bs_attn(q, q, q, np.ones((3, 2), bool))


def test_bs_attn_cuda_refuses_cpu_tensors():
    q = torch.zeros((1, 64, 2, 32))
    walk = tbs_ops.make_walk(np.ones((1, 1), bool), 64, 64, "cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tbs_ops.bs_attn_cuda(q, q, q, walk, scale=1.0)
    with pytest.raises(ValueError, match="head dims"):
        tbs_ops.bs_attn_cuda(q[..., :16], q[..., :16], q[..., :16], walk,
                             scale=1.0)


# --- attend_train ------------------------------------------------------------

TRAIN_CASES = {
    # name: (B, S, H, KV, dh, tile, kwargs)
    "causal": (2, 128, 4, 2, 32, 32, {}),
    "balanced": (2, 128, 4, 2, 32, 32, {"schedule": "balanced"}),
    "window": (1, 160, 4, 2, 32, 32, {"window": 40}),
    "window_prefix": (1, 160, 4, 4, 32, 32, {"window": 40,
                                              "global_prefix": 20}),
    "window_softcap": (2, 96, 4, 1, 32, 32, {"window": 17,
                                             "softcap": 30.0}),
    "softcap_gqa": (1, 64, 8, 2, 32, 16, {"softcap": 50.0}),
    "halved_tile": (1, 96, 2, 1, 32, 64, {}),
    "tile_to_one": (1, 37, 2, 1, 32, 16, {"window": 9}),
    "dh64": (1, 128, 2, 2, 64, 64, {"window": 50}),
    "noncausal": (2, 48, 2, 1, 32, 16, {"causal": False}),
}


def _train_inputs(b, s, h, kv, dh, seed):
    return (_np((b, s, h, dh), seed, 0.5), _np((b, s, kv, dh), seed + 1, 0.5),
            _np((b, s, kv, dh), seed + 2))


@pytest.mark.parametrize("name", list(TRAIN_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attend_train_matches_jax(name, dtype):
    b, s, h, kv, dh, tile, kw = TRAIN_CASES[name]
    q, k, v = _train_inputs(b, s, h, kv, dh, len(name))
    want = jattn.attend_train(_j(q, dtype), _j(k, dtype), _j(v, dtype),
                              tile_q=tile, tile_kv=tile, **kw)
    got = tattn.attend_train(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                             tile_q=tile, tile_kv=tile, **kw)
    assert got.shape == (b, s, h, dh) and got.dtype == TORCH_DT[dtype]
    assert_close_for_dtype(got.float(), np.asarray(want, np.float32),
                           dtype, name)


@pytest.mark.parametrize("name", ["causal", "window_prefix",
                                  "window_softcap", "softcap_gqa",
                                  "tile_to_one"])
def test_attend_train_grads_match_jax(name):
    b, s, h, kv, dh, tile, kw = TRAIN_CASES[name]
    q, k, v = _train_inputs(b, s, h, kv, dh, 10 + len(name))
    g = _np((b, s, h, dh), 99)

    def loss(q_, k_, v_):
        out = jattn.attend_train(q_, k_, v_, tile_q=tile, tile_kv=tile, **kw)
        return jnp.sum(out * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x)
                                               for x in (q, k, v)))
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    out = tattn.attend_train(tq, tk, tv, tile_q=tile, tile_kv=tile, **kw)
    (out * _t(g)).sum().backward()
    for got, w, label in zip((tq.grad, tk.grad, tv.grad), want,
                             ("dq", "dk", "dv")):
        assert got.shape == w.shape
        assert_close_for_dtype(got, np.asarray(w), "float32", label)


# --- decode ------------------------------------------------------------------

@pytest.mark.parametrize("window, prefix, softcap",
                         [(0, 0, None), (5, 0, None), (5, 2, 50.0),
                          (64, 0, None)])
def test_attend_decode_matches_jax(window, prefix, softcap):
    b, s, h, kv, dh = 3, 24, 4, 2, 32
    q = _np((b, 1, h, dh), 20)
    kc, vc = _np((b, s, kv, dh), 21), _np((b, s, kv, dh), 22)
    lengths = np.asarray([1, 9, 24], np.int32)
    want = jattn.attend_decode(jnp.asarray(q), jnp.asarray(kc),
                               jnp.asarray(vc), lengths=jnp.asarray(lengths),
                               softcap=softcap, window=window,
                               global_prefix=prefix)
    got = tattn.attend_decode(_t(q), _t(kc), _t(vc),
                              lengths=torch.as_tensor(lengths).long(),
                              softcap=softcap, window=window,
                              global_prefix=prefix)
    assert_close_for_dtype(got, np.asarray(want), "float32", "decode")


def test_decode_after_prefill_keeps_the_window():
    """A prompt longer than the window: decode at each next position
    equals the full-sequence attention's row there."""
    b, s, h, kv, dh, window, prefix = 1, 150, 2, 1, 32, 40, 8
    q, k, v = _train_inputs(b, s, h, kv, dh, 31)
    full = tattn.attend_train(_t(q), _t(k), _t(v), window=window,
                              global_prefix=prefix, tile_q=32, tile_kv=32)
    for pos in (100, 149):
        got = tattn.attend_decode(
            _t(q[:, pos:pos + 1]), _t(k), _t(v),
            lengths=torch.as_tensor([pos + 1]), window=window,
            global_prefix=prefix)
        assert_close_for_dtype(got[:, 0], full[:, pos].numpy(), "float32",
                               f"pos {pos}")


@pytest.mark.parametrize("case", [
    (12, 12, 16, 16, True, 0, 0, "causal"),
    (8, 8, 16, 16, True, 40, 8, "causal"),
    (10, 10, 8, 8, True, 20, 0, "causal"),
    (6, 9, 32, 16, False, 0, 0, "causal"),
    (8, 8, 16, 16, True, 0, 0, "random"),
    (8, 8, 16, 16, True, 40, 16, "random"),
    (7, 7, 3, 3, False, 10, 0, "random")])
def test_tile_mask_implied_matches_element_masks(case):
    """``tile_mask_implied`` is true exactly where the element mask over
    the block mask equals the element mask over every tile: the group
    walk may then skip its per-element tile-mask lookups."""
    from repro_torch.kernels.bs_attn.ref import element_mask
    nq, nkv, bq, bkv, causal, window, prefix, kind = case
    if kind == "causal":
        wt = (window - 1) // bkv + 2 if window > 0 else 0
        gt = -(-prefix // bkv) if prefix > 0 else 0
        mask = tattn.causal_block_mask(nq, nkv, wt, gt, bq, bkv, causal)
    else:
        mask = np.random.default_rng(nq * bq + window).random((nq, nkv)) < 0.6
        mask[np.arange(min(nq, nkv)), np.arange(min(nq, nkv))] = True
    kw = dict(causal=causal, window=window, global_prefix=prefix)
    want = torch.equal(element_mask(mask, bq, bkv, **kw),
                       element_mask(np.ones_like(mask), bq, bkv, **kw))
    assert tbs_ops.tile_mask_implied(mask, bq, bkv, **kw) == want
    if kind == "causal":
        assert want        # attend_train's masks never need the lookup
        walk = tbs_ops.make_walk(mask, bq, bkv, "cpu", causal=causal,
                                 window=window, global_prefix=prefix)
        assert walk.tile_mask is None


@pytest.mark.parametrize("dtype,walk", [("bfloat16", "wgmma"),
                                        ("float16", "wgmma"),
                                        ("float32", "cuda_core")])
def test_bs_attn_walk_selection(dtype, walk):
    """16-bit attention takes the tensor-core walk; fp32 stays on the
    CUDA cores (TF32 would miss the fp32 budget); other types are
    refused."""
    assert tbs_ops.kernel_walk(getattr(torch, dtype)) == walk
    with pytest.raises(ValueError, match="takes"):
        tbs_ops.kernel_walk(torch.float64)
