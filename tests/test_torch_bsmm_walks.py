"""The walks of the bsmm and bsmm_balanced kernels, on the CPU.

``bsmm.ops.walk`` and ``bsmm.balanced.walk`` are pure Python: they name
the walk a wrapper launches on a card ("decode" for the fewest tokens,
"mma" -- the tensor-core walk -- for bf16/fp16 at b in {16, 32, 64},
"ffma" elsewhere).  The "mma" walk reads a schedule the plan records
once on the host (``bsmm.ops.mma_schedule``): groups of block-rows
(consecutive rows for bsmm, the row swizzle's bins for bsmm_balanced),
each group's ascending chunks of x, and per stage and row the run's
first tile and block columns.  Here the schedule is checked for what the
kernel relies on, and ``bsmm_schedule_plain`` -- the schedule read as the
kernel reads it -- is held against the JAX ``bsmm`` and ``bsmm_balanced``
(Pallas in interpret mode, and their ``ref``) on uniform, power-law and
DLMC masks with empty rows and on the transposed pattern, within
tests/conftest.py's per-dtype budgets (fp32 1e-4, bf16 6e-2, fp16
2e-2).  The kernels themselves are held against their plain versions on
a card by tests/test_torch_cuda.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from conftest import assert_close_for_dtype  # noqa: E402
from repro.core import masks as jmasks  # noqa: E402
from repro.core import partitioner as jpart  # noqa: E402
from repro.core.bsr import BlockSparseMatrix as JBSR  # noqa: E402
from repro.kernels.bsmm import ops as jbsmm_ops  # noqa: E402
from repro.kernels.bsmm.ref import bsmm_ref  # noqa: E402
from repro_torch import sparse as tsparse  # noqa: E402
from repro_torch.core import partitioner as tpart  # noqa: E402
from repro_torch.core.bsr import BlockSparseMatrix as TBSR  # noqa: E402
from repro_torch.kernels.bsmm import balanced as tbal  # noqa: E402
from repro_torch.kernels.bsmm import ops as tops  # noqa: E402
from repro_torch.launch import profile_serve  # noqa: E402

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


# -- walk choice ------------------------------------------------------------

# (b, 16-bit): the most tokens the decode walk takes
DECODE_UP_TO = {(4, False): 32, (8, False): 16, (16, False): 8,
                (32, False): 4, (64, False): 0,
                (4, True): 32, (8, True): 16, (16, True): 4, (32, True): 4,
                (64, True): 0}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("n", [1, 3, 4, 5, 8, 9, 16, 17, 32, 33, 2048])
def test_bsmm_walk_choice(b, dtype, n):
    half = dtype != "float32"
    if n <= DECODE_UP_TO[(b, half)]:
        want = "decode"
    else:
        want = "mma" if half and b >= 16 else "ffma"
    assert tops.walk(b, TDTYPE[dtype], n) == want
    assert want in tops.WALK_COUNTERS


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [4, 8, 16, 32, 64])
def test_bsmm_balanced_walk_choice(b, dtype):
    want = "mma" if dtype != "float32" and b >= 16 else "ffma"
    assert tbal.walk(b, TDTYPE[dtype]) == want
    assert want in tbal.WALK_COUNTERS


def test_walk_choice_refuses_tiles_outside_the_kernels():
    with pytest.raises(ValueError, match="tiles of"):
        tops.walk(12, torch.bfloat16, 64)
    with pytest.raises(ValueError, match="tiles of"):
        tbal.walk(128, torch.bfloat16)


@pytest.mark.parametrize("dtype, b, n, plan", [
    (torch.float32, 16, 64, "mma"), (torch.bfloat16, 8, 64, "mma"),
    (torch.bfloat16, 16, 9, "decode"), (torch.float16, 64, 1, "decode"),
    (torch.bfloat16, 16, 64, "wgmma")])
def test_bsmm_cuda_refuses_a_walk_that_does_not_apply(dtype, b, n, plan):
    x = torch.zeros(n, 4 * b, dtype=dtype)
    tiles = torch.zeros(2, b, b, dtype=dtype)
    with pytest.raises(ValueError, match="does not take"):
        tops.bsmm_nt_cuda(x, tiles, torch.tensor([0, 1, 2],
                                                 dtype=torch.int32),
                          torch.tensor([0, 1], dtype=torch.int32), 2 * b,
                          plan=plan)


@pytest.mark.parametrize("dtype, b, plan", [
    (torch.float32, 16, "mma"), (torch.float16, 4, "mma"),
    (torch.bfloat16, 16, "decode")])
def test_bsmm_balanced_cuda_refuses_a_walk_that_does_not_apply(dtype, b,
                                                                plan):
    x = torch.zeros(5, 4 * b, dtype=dtype)
    tiles = torch.zeros(3, b, b, dtype=dtype)
    v = torch.zeros(2, 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="does not take"):
        tbal.bsmm_balanced_cuda(x, tiles, v, v, v, 2 * b, plan=plan)


def test_mma_walk_needs_a_schedule_of_its_tile():
    x = torch.zeros(64, 64, dtype=torch.bfloat16)
    tiles = torch.zeros(2, 16, 16, dtype=torch.bfloat16)
    rp = torch.tensor([0, 1, 2], dtype=torch.int32)
    tc = torch.tensor([0, 1], dtype=torch.int32)
    other = tops.mma_schedule([0, 1], [0], 32, tops.uniform_groups(1, 32))
    for sched in (None, other):
        with pytest.raises(ValueError, match="MmaSchedule"):
            tops.check_schedule(sched, 16, 32, x.device)
    with pytest.raises(ValueError, match="CUDA"):
        tops.bsmm_nt_cuda(x, tiles, rp, tc, 32, None)


@pytest.mark.parametrize("b, groups, stages, n, want", [
    (16, 32, 1025, 2048, 1),     # llama up/gate at the train batch
    (16, 32, 1025, 256, 2),
    (16, 32, 1025, 16, 4),
    (16, 8, 1025, 16, 16),       # llama down: 128 chunks a group
    (16, 8, 1025, 496, 4),
    (16, 8, 1025, 2048, 1),      # one wave of 128 blocks already
    (32, 16, 70, 64, 1),         # too few stages a group to split
    (64, 2, 40, 64, 2),
])
def test_mma_slices_rule(b, groups, stages, n, want):
    sched = tops.MmaSchedule(
        b, torch.zeros(groups, tops.MMA_ROWS[b], dtype=torch.int32),
        torch.zeros(groups + 1, dtype=torch.int32),
        torch.zeros(stages, dtype=torch.int32),
        torch.zeros(stages, tops.MMA_ROWS[b], 2, dtype=torch.int32))
    s = tops.mma_slices(sched, n)
    assert s == want
    blocks = groups * -(-n // tops.MMA_TOKENS[b])
    assert s == 1 or blocks * s <= tops.SMS


# -- the schedule -------------------------------------------------------------

def _mask(kind, m, k, b, density, seed, empty=True):
    mask = GENS[kind](m, k, b, density, seed=seed)
    if empty:
        mask[0] = False
        mask[::5] = False
    return mask


def _decode(sched):
    """Every block the schedule names, in stage order: (group, stage,
    row slot, block-row, tile, block column, place in the stage)."""
    b = sched.b
    e_cols = tops.MMA_CHUNK // b
    ptr = sched.stage_ptr.numpy()
    out = []
    for g in range(sched.groups):
        for st in range(ptr[g], ptr[g + 1]):
            q = int(sched.stage_chunk[st])
            for r in range(sched.rows):
                first, word = (int(v) for v in sched.stage_runs[st, r])
                j = 0
                for c in range(e_cols):
                    if (word >> c) & 1:
                        out.append((g, st, r, int(sched.group_rows[g, r]),
                                    first + j, q * e_cols + c,
                                    (word >> 8) + j))
                        j += 1
    return out


@pytest.mark.parametrize("kind", list(GENS))
@pytest.mark.parametrize("b", [16, 32, 64])
@pytest.mark.parametrize("density", [0.15, 0.6])
def test_schedule_walks_every_real_tile_once(kind, b, density):
    m, k = 40 * b, 23 * b
    mask = _mask(kind, m, k, b, density, seed=b)
    rows, cols = np.nonzero(mask)
    meta = tpart.plan_packing(rows, cols, (m, k), b, b, b)
    sched = tops.packing_schedule(meta)
    blocks = _decode(sched)
    tiles = [t for *_, t, _, _ in blocks]
    real = tops.real_tiles(meta.num_tiles, meta.block_slot)
    # each non-pad tile once, no pad tile
    assert sorted(tiles) == list(np.flatnonzero(real))
    assert np.count_nonzero(~real) == int((mask.sum(1) == 0).sum())
    for g, st, r, row, t, col, place in blocks:
        assert meta.tile_rows[t] == row and meta.tile_cols[t] == col
        assert row == g * tops.MMA_ROWS[b] + r
    ptr = sched.stage_ptr.numpy()
    chunks = sched.stage_chunk.numpy()
    for g in range(sched.groups):
        q = chunks[ptr[g]:ptr[g + 1]]
        assert np.all(np.diff(q) >= 0)          # ascending, a full chunk
    # a stage's blocks fill places 0 .. count - 1, at most a stage's cap
    by_stage = {}
    for g, st, r, row, t, col, place in blocks:
        by_stage.setdefault(st, []).append(place)
    for st, places in by_stage.items():
        assert sorted(places) == list(range(len(places)))
        assert len(places) <= tops.MMA_STAGE_BLOCKS[b]
    assert set(by_stage) == set(range(sched.stages))    # no empty stage
    # a chunk is split into stages only where it overflows a stage
    for g in range(sched.groups):
        q = list(chunks[ptr[g]:ptr[g + 1]])
        for c in set(q):
            n_st = q.count(c)
            n_blk = sum(1 for bl in blocks if bl[0] == g
                        and bl[5] // (tops.MMA_CHUNK // b) == c)
            assert n_st == -(-n_blk // tops.MMA_STAGE_BLOCKS[b])


@pytest.mark.parametrize("kind", list(GENS))
@pytest.mark.parametrize("b", [16, 32, 64])
@pytest.mark.parametrize("mb", [8, 37, 64])
def test_balanced_groups_are_the_bins(kind, b, mb):
    """At ``mma_bins`` bins, sorted-snake dealing puts floor(mb / bins) or
    ceil(mb / bins) row-tiles (at most R) in every bin, so each bin is one
    group of the walk and the groups' tile counts are the swizzle's
    loads."""
    m, k = mb * b, 24 * b
    mask = _mask(kind, m, k, b, 0.3, seed=mb, empty=False)
    rows, cols = np.nonzero(mask)
    bins = tbal.mma_bins(mb, b)
    bm = tpart.plan_packing_balanced(rows, cols, (m, k), b, b, b,
                                     num_bins=bins)
    r = tops.MMA_ROWS[b]
    groups = tops.bin_groups(bm.swizzle.bin_of, b)
    assert groups.shape == (bins, r)
    sizes = (groups >= 0).sum(1)
    assert set(sizes) <= {mb // bins, -(-mb // bins)} and sizes.max() <= r
    for g in range(bins):
        got = groups[g][groups[g] >= 0]
        np.testing.assert_array_equal(
            got, np.flatnonzero(bm.swizzle.bin_of == g))
    sched = tbal.balanced_schedule(bm)
    loads = np.zeros(bins, np.int64)
    for g, *_ in _decode(sched):
        loads[g] += 1
    np.testing.assert_array_equal(loads, bm.swizzle.loads)


def test_bin_groups_cut_bins_larger_than_a_group():
    bin_of = np.array([0] * 20 + [1] * 3)
    groups = tops.bin_groups(bin_of, 16)
    assert groups.shape == (3, 16)
    np.testing.assert_array_equal(groups[0], np.arange(16))
    assert list(groups[1][:4]) == [16, 17, 18, 19] and groups[1][4] == -1
    assert list(groups[2][:3]) == [20, 21, 22]


def test_schedule_refuses_what_the_kernel_cannot_read():
    with pytest.raises(ValueError, match="at most once"):
        tops.mma_schedule([0, 1, 2], [0, 0], 16, [[0, 0] + [-1] * 14])
    # a row's tiles out of column order within a chunk
    with pytest.raises(ValueError, match="consecutive"):
        tops.mma_schedule([0, 2], [1, 0], 16, tops.uniform_groups(1, 16))
    with pytest.raises(ValueError, match="tiles of"):
        tops.mma_schedule([0, 1], [0], 8, [[0] + [-1] * 15])


# -- the schedule walked, against the JAX package ---------------------------

def _jax_bsmm(mask, vals, x, b, dtype):
    """JAX bsmm (Pallas, interpret mode) and its ref oracle: x . W^T."""
    m, k = mask.shape[0] * b, mask.shape[1] * b
    jb = JBSR.from_mask(mask, b).with_values(jnp.asarray(vals, JDTYPE[dtype]))
    jx = jnp.asarray(x, JDTYPE[dtype]).T
    tm, tk, _ = jbsmm_ops._pick_tiles(m, k, x.shape[0], b)
    meta = jpart.plan_packing(jb.row_idx, jb.col_idx, (m, k), b, tm, tk)
    kern = np.asarray(jbsmm_ops.bsmm_from_plan(
        meta, jb.values, jx, interpret=True).T.astype(jnp.float32))
    ref = np.asarray(bsmm_ref(jb, jx).T.astype(jnp.float32))
    return kern, ref


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [16, 32])
@pytest.mark.parametrize("kind", list(GENS))
def test_schedule_walk_matches_jax_bsmm(kind, b, dtype):
    """Forward and the dL/dx product over the transposed pattern, each on
    the schedule of its packing (as ``sparse.plan`` records them)."""
    m, k, n = 12 * b, 9 * b, 20
    mask = _mask(kind, m, k, b, 0.3, seed=b + 7)
    rng = np.random.default_rng(b)
    vals = rng.standard_normal((int(mask.sum()), b, b)).astype(np.float32)
    x = rng.standard_normal((n, k)).astype(np.float32)
    dy = rng.standard_normal((n, m)).astype(np.float32)
    tb = TBSR.from_mask(mask, b,
                        values=torch.as_tensor(vals).to(TDTYPE[dtype]))
    p = tsparse.plan(tb, n, device="cpu",
                     ctx=tsparse.PlanContext(mode="static"))
    # forward
    got = tops.bsmm_schedule_plain(torch.as_tensor(x).to(TDTYPE[dtype]),
                                   p.pack(tb.values),
                                   tops.packing_schedule(p.packing), m)
    assert got.dtype == TDTYPE[dtype] and got.shape == (n, m)
    kern, ref = _jax_bsmm(mask, vals, x, b, dtype)
    assert_close_for_dtype(_np(got), kern, dtype, "schedule vs pallas")
    assert_close_for_dtype(_np(got), ref, dtype, "schedule vs ref")
    assert torch.all(got[:, :b] == 0)
    # dL/dx = dy . W over W^T's tiles
    g = p.grad
    got_t = tops.bsmm_schedule_plain(torch.as_tensor(dy).to(TDTYPE[dtype]),
                                     p.pack_t(tb.values),
                                     tops.packing_schedule(g.packing), k)
    perm = g.transpose.perm
    kern_t, ref_t = _jax_bsmm(mask.T, vals[perm].transpose(0, 2, 1), dy, b,
                              dtype)
    assert_close_for_dtype(_np(got_t), kern_t, dtype, "transposed vs pallas")
    assert_close_for_dtype(_np(got_t), ref_t, dtype, "transposed vs ref")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [16, 64])
@pytest.mark.parametrize("kind", list(GENS))
def test_balanced_schedule_walk_matches_jax(kind, b, dtype):
    """bsmm_balanced's schedule (the bins at ``mma_bins``) against the JAX
    balanced walk at the same bin count and its ref oracle."""
    mb, kb, n = 40, 6, 12
    m, k = mb * b, kb * b
    mask = _mask(kind, m, k, b, 0.3, seed=3)
    rng = np.random.default_rng(5)
    vals = rng.standard_normal((int(mask.sum()), b, b)).astype(np.float32)
    x = rng.standard_normal((n, k)).astype(np.float32)
    rows, cols = np.nonzero(mask)
    bins = tbal.mma_bins(mb, b)
    jb = JBSR.from_mask(mask, b).with_values(jnp.asarray(vals, JDTYPE[dtype]))
    jx = jnp.asarray(x, JDTYPE[dtype]).T
    jm = jpart.plan_packing_balanced(jb.row_idx, jb.col_idx, (m, k), b, b, b,
                                     num_bins=bins)
    want = np.asarray(jbsmm_ops.bsmm_balanced_from_plan(
        jm, jb.values, jx, interpret=True).T.astype(jnp.float32))
    ref = np.asarray(bsmm_ref(jb, jx).T.astype(jnp.float32))
    tm = tpart.plan_packing_balanced(rows, cols, (m, k), b, b, b,
                                     num_bins=bins)
    tiles = tpart.pack_values(tm.base, torch.as_tensor(vals).to(
        TDTYPE[dtype]))
    got = tops.bsmm_schedule_plain(torch.as_tensor(x).to(TDTYPE[dtype]),
                                   tiles, tbal.balanced_schedule(tm), m)
    assert_close_for_dtype(_np(got), want, dtype, "balanced vs pallas")
    assert_close_for_dtype(_np(got), ref, dtype, "balanced vs ref")
    assert torch.all(got[:, :b] == 0)


@pytest.mark.parametrize("b", [16, 32, 64])
def test_schedule_walk_of_a_pattern_without_blocks(b):
    """No block at all: no stage, every output zero."""
    mask = np.zeros((5, 3), bool)
    meta = tpart.plan_packing(*np.nonzero(mask), (5 * b, 3 * b), b, b, b)
    sched = tops.packing_schedule(meta)
    assert sched.stages == 0 and sched.groups == 1
    tiles = tpart.pack_values(meta, torch.zeros(0, b, b))
    y = tops.bsmm_schedule_plain(torch.ones(4, 3 * b), tiles, sched, 5 * b)
    assert y.shape == (4, 5 * b) and torch.all(y == 0)


# -- profile_serve's kernel families ----------------------------------------

@pytest.mark.parametrize("name, family", [
    ("void (anonymous namespace)::bsmm_nt_kernel<__nv_bfloat16, 16>(...)",
     "bsmm"),
    ("void (anonymous namespace)::bsmm_nt_decode_kernel<float, 16>(...)",
     "bsmm"),
    ("void bsmm_mma::bsmm_mma_kernel<__nv_bfloat16, 16>(CUtensorMap, ...)",
     "bsmm"),
    ("void bsmm_mma::reduce_kernel<__half>(float const*, __half*, ...)",
     "bsmm"),
    ("void (anonymous namespace)::bsmm_balanced_kernel<__half, 32>(...)",
     "bsmm"),
    ("void (anonymous namespace)::dsmm_mma_kernel<__nv_bfloat16, 16>(...)",
     "other"),
    ("void (anonymous namespace)::gmm_tc_kernel<__nv_bfloat16>(...)", "gmm"),
    ("void (anonymous namespace)::sddmm_mma_kernel<__half, 16>(...)",
     "sddmm"),
    ("void (anonymous namespace)::bs_attn_wgmma_kernel<...>(...)",
     "bs_attn"),
    ("void (anonymous namespace)::dense_mm_tc_kernel<...>(...)", "dense_mm"),
])
def test_profile_families_name_every_bsmm_walk(name, family):
    assert profile_serve._family(name) == family
