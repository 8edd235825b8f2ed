"""The walks of the dsmm and sddmm kernels, on the CPU.

``dsmm.ops.walk`` and ``sddmm.ops.walk`` are pure Python: they name the
walk a wrapper launches on a card ("mma", the tensor-core walk, for
bf16/fp16 at their blocks; "ffma" elsewhere).  The dsmm
tensor-core walk reads each block-row's slots in ascending column order,
which the runtime encoder ``encode_slots`` gives on the device (padding
slots off the grid); through it ``dsmm``'s plain version still matches
the JAX ``dsmm`` (Pallas in interpret mode, and its ``ref``) within
tests/conftest.py's per-dtype budgets (fp32 1e-4, bf16 6e-2, fp16 2e-2).
The kernels themselves are held against their plain versions on a card
by tests/test_torch_cuda.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from conftest import assert_close_for_dtype  # noqa: E402
from repro.core import dynamic_sparse as jdsp  # noqa: E402
from repro.core import masks as jmasks  # noqa: E402
from repro.kernels.dsmm import ops as jdsmm_ops  # noqa: E402
from repro.kernels.dsmm.ref import dsmm_ref  # noqa: E402
from repro_torch.core import dynamic_sparse as tdsp  # noqa: E402
from repro_torch.kernels.dsmm import ops as tdsmm_ops  # noqa: E402
from repro_torch.kernels.sddmm import ops as tsddmm_ops  # noqa: E402

DTYPES = ["float32", "bfloat16", "float16"]
TDTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}
JDTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
          "float16": jnp.float16}


def _np(t):
    return t.detach().float().numpy()


# -- walk choice ------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [4, 8, 16, 32, 64, 128])
def test_dsmm_walk_choice(b, dtype):
    want = "mma" if dtype != "float32" and b >= 16 else "ffma"
    assert tdsmm_ops.walk(b, TDTYPE[dtype]) == want
    assert want in tdsmm_ops.WALK_COUNTERS


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [4, 8, 16, 32, 64])
def test_sddmm_walk_choice(b, dtype):
    want = "mma" if dtype != "float32" and b >= 16 else "ffma"
    assert tsddmm_ops.walk(b, TDTYPE[dtype]) == want
    assert want in tsddmm_ops.WALK_COUNTERS


def test_walk_choice_refuses_blocks_outside_the_kernels():
    with pytest.raises(ValueError, match="blocks of"):
        tdsmm_ops.walk(12, torch.bfloat16)
    with pytest.raises(ValueError, match="blocks of"):
        tsddmm_ops.walk(128, torch.bfloat16)


@pytest.mark.parametrize("dtype, b, plan", [
    (torch.float32, 16, "mma"), (torch.bfloat16, 8, "mma"),
    (torch.float16, 4, "mma"), (torch.bfloat16, 16, "wgmma")])
def test_dsmm_cuda_refuses_a_walk_that_does_not_apply(dtype, b, plan):
    x = torch.zeros(3, 4 * b, dtype=dtype)
    vals = torch.zeros(2, b, b, dtype=dtype)
    idx = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="does not take"):
        tdsmm_ops.dsmm_cuda(x, vals, idx, idx, 2 * b, plan=plan)


@pytest.mark.parametrize("dtype, b, plan", [
    (torch.float32, 16, "mma"), (torch.bfloat16, 8, "mma"),
    (torch.float16, 16, "wgmma")])
def test_sddmm_cuda_refuses_a_walk_that_does_not_apply(dtype, b, plan):
    dy, x = torch.zeros(5, 2 * b, dtype=dtype), torch.zeros(5, 2 * b,
                                                            dtype=dtype)
    with pytest.raises(ValueError, match="does not take"):
        tsddmm_ops.sddmm_cuda(dy, x, torch.tensor([0, 1, 1],
                                                  dtype=torch.int32),
                              torch.tensor([1], dtype=torch.int32), b,
                              plan=plan)


# -- the split of N ---------------------------------------------------------

@pytest.mark.parametrize("n, grid_rows, ffma, mma", [
    (2048, 512, 2, 1),      # llama up/gate at the train batch
    (2048, 128, 8, 2),      # llama down
    (4096, 32, 16, 8),
    (8192, 4, 32, 32),      # capped at 256 rows of N a split
    (256, 128, 1, 1),
    (600, 16, 2, 2),
    (100, 4, 1, 1),
])
def test_n_splits_rule(n, grid_rows, ffma, mma):
    assert tsddmm_ops.n_splits(n, grid_rows) == ffma
    assert tsddmm_ops.n_splits(n, grid_rows, "ffma") == ffma
    assert tsddmm_ops.n_splits(n, grid_rows, "mma") == mma


@pytest.mark.parametrize("walk", tsddmm_ops.WALKS)
def test_n_splits_keep_slices_long(walk):
    """Each slice at least 256 rows of N; the FMA walk reaches ~1024
    blocks where N allows; the mma walk never leaves its one wave of
    blocks (it splits only rows fewer than that)."""
    wave = tsddmm_ops._MMA_WAVE
    for n in (1, 255, 256, 700, 2048, 8192):
        for rows in (1, 3, 64, 512, 4096):
            s = tsddmm_ops.n_splits(n, rows, walk)
            cap = max(1, n // 256)
            assert 1 <= s <= cap
            if walk == "ffma":
                assert s * rows >= 1024 or s == cap
            else:
                assert s == 1 or s * rows <= wave
                assert s == cap or (s + 1) * rows > wave


# -- the slot encoder -------------------------------------------------------

M, K = 128, 192
PATTERNS = ["random", "empty_rows", "all_padded", "overflow"]


def _mask(pattern, b, seed):
    if pattern == "all_padded":
        return np.zeros((M // b, K // b), bool), 6
    density = 0.5 if pattern == "overflow" else 0.3
    mask = jmasks.random_block_mask(M, K, b, density, seed=seed)
    if pattern == "empty_rows":
        mask[0] = mask[2] = False
    nnz = int(mask.sum())
    return mask, (nnz - 5 if pattern == "overflow" else nnz + 7)


def _operands(pattern, b, dtype="float32", seed=3):
    mask, cap = _mask(pattern, b, seed)
    w = np.random.default_rng(seed).standard_normal((M, K)).astype(
        np.float32)
    jop = jdsp.encode(jnp.asarray(w, JDTYPE[dtype]), jnp.asarray(mask),
                      block_size=b, nnz_max=cap)
    top = tdsp.encode(torch.as_tensor(w).to(TDTYPE[dtype]),
                      torch.as_tensor(mask), block_size=b, nnz_max=cap)
    return jop, top


@pytest.mark.parametrize("b", [4, 16])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_encode_slots_rows_contiguous_columns_ascending(pattern, b):
    _, top = _operands(pattern, b)
    rows, cols, vals = tdsmm_ops.encode_slots(top)
    r, c = rows.numpy().astype(np.int64), cols.numpy().astype(np.int64)
    mb, kb = top.grid
    nnz = int(top.nnz)
    assert rows.numel() == top.capacity
    # every block-row one run, its columns ascending; the padding last,
    # off the grid, zero
    assert np.all(np.diff(r * kb + c) >= 0)
    assert np.all(r[:nnz] < mb) and np.all(r[nnz:] == mb)
    assert not _np(vals[nnz:]).any()
    for row in range(mb):
        assert int((r == row).sum()) == int((top.row_idx[:nnz] == row).sum())
    # the slots still hold the operand: x = I gives W^T
    eye = torch.eye(K)
    y = tdsmm_ops.dsmm_plain(eye, vals, rows, cols, M)
    torch.testing.assert_close(y, top.to_dense().t(), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pattern", PATTERNS)
def test_dsmm_plain_through_the_encoder_matches_jax(pattern, dtype):
    """``dsmm`` (``encode_slots`` + the plain walk on the CPU) against
    the JAX ``dsmm`` in interpret mode and ``dsmm_ref``, at the tensor-
    core walk's block."""
    jop, top = _operands(pattern, 16, dtype)
    x = np.random.default_rng(5).standard_normal((70, K)).astype(
        np.float32)
    jx = jnp.asarray(x.T, JDTYPE[dtype])
    want_kernel = np.asarray(jdsmm_ops.dsmm(jop, jx, interpret=True).T)
    want_ref = np.asarray(dsmm_ref(jop, jx).T.astype(jnp.float32))
    got = tdsmm_ops.dsmm(top, torch.as_tensor(x).to(TDTYPE[dtype]))
    assert got.dtype == TDTYPE[dtype] and got.shape == (70, M)
    assert_close_for_dtype(_np(got), want_kernel, dtype, "dsmm vs pallas")
    assert_close_for_dtype(_np(got), want_ref, dtype, "dsmm vs ref")


def test_dsmm_plain_skips_slots_off_the_grid():
    b, m, k = 16, 64, 48
    g = torch.Generator().manual_seed(0)
    vals = torch.randn((5, b, b), generator=g)
    rows = torch.tensor([0, 3, 4, -1, 1], dtype=torch.int32)
    cols = torch.tensor([2, 0, 1, 0, 3], dtype=torch.int32)
    x = torch.randn((7, k), generator=g)
    y = tdsmm_ops.dsmm_plain(x, vals, rows, cols, m)
    want = torch.zeros(7, m)
    for s in (0, 1):        # the only slots inside the 4 x 3 grid
        r, c = int(rows[s]), int(cols[s])
        want[:, r * b:(r + 1) * b] += x[:, c * b:(c + 1) * b] @ vals[s].t()
    torch.testing.assert_close(y, want)
