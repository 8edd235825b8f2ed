"""Host pattern layer of the port against the JAX package: block masks,
packing metadata and packed values must be equal exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import bsr as jbsr  # noqa: E402
from repro.core import masks as jmasks  # noqa: E402
from repro.core import partitioner as jpart  # noqa: E402
from repro_torch.core import bsr as tbsr  # noqa: E402
from repro_torch.core import masks as tmasks  # noqa: E402
from repro_torch.core import partitioner as tpart  # noqa: E402


@pytest.mark.parametrize("m,k,b,density,seed,clustered", [
    (8192, 2048, 16, 1 / 8, 1, False),     # the slice's up/gate pattern
    (2048, 8192, 16, 1 / 8, 2, False),     # down
    (256, 512, 16, 0.25, 7, False),
    (128, 128, 4, 0.05, 3, False),
    (512, 512, 16, 0.3, 5, True),
    (64, 64, 16, 0.0, 0, False),
])
def test_random_block_mask_bit_identical(m, k, b, density, seed, clustered):
    want = jmasks.random_block_mask(m, k, b, density, seed=seed,
                                    clustered=clustered)
    got = tmasks.random_block_mask(m, k, b, density, seed=seed,
                                   clustered=clustered)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _pattern(m, k, b, density, seed, empty_rows=()):
    mask = jmasks.random_block_mask(m, k, b, density, seed=seed)
    for r in empty_rows:
        mask[r] = False
    rows, cols = np.nonzero(mask)
    order = np.lexsort((cols, rows))
    return rows[order].astype(np.int32), cols[order].astype(np.int32)


@pytest.mark.parametrize("tile", [16, 32, 128])
@pytest.mark.parametrize("empty_rows", [(), (0, 5, 15)])
def test_plan_packing_metadata_equal(tile, empty_rows):
    m, k, b = 256, 512, 16
    rows, cols = _pattern(m, k, b, 1 / 8, 11, empty_rows)
    want = jpart.plan_packing(rows, cols, (m, k), b, tile, tile)
    got = tpart.plan_packing(rows, cols, (m, k), b, tile, tile)
    for field in ("tile_rows", "tile_cols", "block_slot", "in_r", "in_c"):
        w, g = getattr(want, field), getattr(got, field)
        assert g.dtype == w.dtype, field
        assert np.array_equal(g, w), field
    for field in ("tm", "tk", "grid", "shape", "block_size", "nnz_blocks",
                  "num_tiles", "occupancy"):
        assert getattr(got, field) == getattr(want, field), field


@pytest.mark.parametrize("tile", [16, 32, 128])
def test_pack_values_equal(tile):
    m, k, b = 256, 512, 16
    rows, cols = _pattern(m, k, b, 1 / 8, 12, empty_rows=(3,))
    vals = np.random.default_rng(0).standard_normal(
        (len(rows), b, b)).astype(np.float32)
    want = jpart.pack_values(jpart.plan_packing(rows, cols, (m, k), b,
                                                tile, tile), vals)
    got = tpart.pack_values(tpart.plan_packing(rows, cols, (m, k), b,
                                               tile, tile),
                            torch.from_numpy(vals))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_row_ptr_is_csr_over_tiles():
    rows, cols = _pattern(256, 512, 16, 1 / 8, 13, empty_rows=(2, 9))
    meta = tpart.plan_packing(rows, cols, (256, 512), 16, 16, 16)
    ptr = meta.row_ptr()
    assert ptr.dtype == np.int32 and ptr.shape == (meta.grid[0] + 1,)
    assert ptr[0] == 0 and ptr[-1] == meta.num_tiles
    for r in range(meta.grid[0]):
        assert np.all(meta.tile_rows[ptr[r]:ptr[r + 1]] == r)
        assert ptr[r + 1] > ptr[r]          # empty rows got a pad tile


def test_bsr_to_dense_matches_jax():
    b = 4
    mask = jmasks.random_block_mask(32, 48, b, 0.3, seed=4)
    nnz = int(mask.sum())
    vals = np.random.default_rng(1).standard_normal((nnz, b, b)).astype(
        np.float32)
    want = jbsr.BlockSparseMatrix.from_mask(mask, b).with_values(
        jnp.asarray(vals)).to_dense()
    got = tbsr.BlockSparseMatrix.from_mask(
        mask, b, values=torch.from_numpy(vals)).to_dense()
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("rows, cols, msg", [
    ([0, 0], [1, 1], "duplicate"),
    ([0, 4], [0, 0], "out of range"),
])
def test_check_unique_blocks_rejects(rows, cols, msg):
    with pytest.raises(ValueError, match=msg):
        tbsr.check_unique_blocks(np.asarray(rows), np.asarray(cols), (4, 4))
    with pytest.raises(ValueError, match=msg):
        tpart.plan_packing(np.asarray(rows), np.asarray(cols), (16, 16), 4,
                           4, 4)
