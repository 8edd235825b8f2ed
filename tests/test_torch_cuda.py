"""The port's CUDA kernels on a card, against their plain versions, and
the serving engine's CUDA graphs against the same engine run eagerly.

Needs a CUDA device and skips without one.  Imports neither JAX nor the
JAX package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py

Budgets (rel-max over the plain version's max magnitude): fp32 1e-4 (the
kernels differ only by summation order; TF32 is off for the plain
matmul) and bf16 2e-2 (one rounding of each fp32-accumulated output).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import sparse  # noqa: E402
from repro_torch.core import masks  # noqa: E402
from repro_torch.core.bsr import BlockSparseMatrix  # noqa: E402
from repro_torch.kernels.bsmm import ops as bsmm_ops  # noqa: E402
from repro_torch.kernels.dense_mm import ops as dmm_ops  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 2e-2}


def _rel(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-6)
            ).item()


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on a card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("b", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("n", [1, 8, 9, 70])   # both walks at b = 16
def test_bsmm_cuda_matches_plain(dev, dtype, b, n):
    m, k = 256, 512
    mask = masks.random_block_mask(m, k, b, 0.25, seed=b)
    mask[0] = False                                  # an empty row
    g = torch.Generator(device=dev).manual_seed(b)
    vals = torch.randn((int(mask.sum()), b, b), generator=g,
                       device=dev).to(dtype)
    bsr = BlockSparseMatrix.from_mask(mask, b, values=vals)
    plan = sparse.plan(bsr, n, device=dev)
    assert plan.route == "static_cuda"
    tiles = plan.pack(vals)
    x = torch.randn((n, k), generator=g, device=dev).to(dtype)
    wk = bsmm_ops.walk(b, dtype, n)
    before = bsmm_ops.COUNTER.launches
    walk_before = bsmm_ops.WALK_COUNTERS[wk].launches
    got = bsmm_ops.bsmm_nt(x, tiles, plan.row_ptr, plan.tile_cols,
                           plan.tile_rows, m, plan.mma)
    torch.cuda.synchronize()
    assert bsmm_ops.COUNTER.launches == before + 1
    assert bsmm_ops.WALK_COUNTERS[wk].launches == walk_before + 1
    want = bsmm_ops.bsmm_nt_plain(x, tiles, plan.tile_rows.long(),
                                  plan.tile_cols.long(), m)
    assert torch.all(got[:, :b] == 0)
    assert _rel(got, want) <= TOL[dtype]


def _bsmm_problem(dev, dtype, b, n, m, k, kind="uniform", density=0.25,
                  seed=0):
    """A static plan on the card with empty rows (the first and every
    seventh block-row), its packed tiles, the dense weight and x."""
    mask = GENS[kind](m, k, b, density, seed=seed + b)
    mask[::7] = False
    g = torch.Generator(device=dev).manual_seed(seed + n)
    vals = torch.randn((int(mask.sum()), b, b), generator=g,
                       device=dev).to(dtype)
    bsr = BlockSparseMatrix.from_mask(mask, b, values=vals)
    x = torch.randn((n, k), generator=g, device=dev).to(dtype)
    return bsr, vals, x


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("b", [16, 32, 64])
@pytest.mark.parametrize("n", [16, 256, 1000, 2048])
def test_bsmm_mma_walk_matches_plain(dev, dtype, b, n):
    """The tensor-core walk on the plan's schedule, forward and on the
    transposed pattern (dL/dx), against the plain version, and the FFMA
    walk forced on the same inputs; a pattern with empty rows, whose pad
    tiles the schedule leaves out, on a k that is not a multiple of the
    64-column chunk."""
    m, k = 40 * b, 23 * b
    bsr, vals, x = _bsmm_problem(dev, dtype, b, n, m, k)
    plan = sparse.plan(bsr, n, device=dev)
    assert plan.mma is not None and plan.grad.mma is not None
    assert bsmm_ops.walk(b, dtype, n) == "mma"
    for tiles, meta, d_in, d_out, a in (
            (plan.pack(vals), plan, k, m, x),
            (plan.pack_t(vals), plan.grad, m, k,
             torch.randn((n, m), device=dev).to(dtype))):
        before = bsmm_ops.WALK_COUNTERS["mma"].launches
        got = bsmm_ops.bsmm_nt(a, tiles, meta.row_ptr, meta.tile_cols,
                               meta.tile_rows, d_out, meta.mma)
        ffma = bsmm_ops.bsmm_nt_cuda(a, tiles, meta.row_ptr, meta.tile_cols,
                                     d_out, meta.mma, plan="ffma")
        torch.cuda.synchronize()
        assert bsmm_ops.WALK_COUNTERS["mma"].launches == before + 1
        want = bsmm_ops.bsmm_nt_plain(a, tiles, meta.tile_rows.long(),
                                      meta.tile_cols.long(), d_out)
        assert _rel(got, want) <= TOL[dtype]
        assert _rel(ffma, want) <= TOL[dtype]
        if meta is plan:                             # block-row 0 is empty
            assert torch.all(got[:, :b] == 0)
        assert _rel(bsmm_ops.bsmm_schedule_plain(a, tiles, meta.mma, d_out),
                    want) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("b", [16, 32, 64])
@pytest.mark.parametrize("density", [0.7, 1.0])
def test_bsmm_mma_walk_full_stages_match_plain(dev, dtype, b, density):
    """Chunks holding more of a group's blocks than a stage takes (dense
    rows: the schedule splits them into several stages of one chunk),
    and an unaligned view of x (copied for TMA)."""
    m, k, n = 24 * b, 17 * b, 300
    bsr, vals, x = _bsmm_problem(dev, dtype, b, n, m, k, density=density)
    plan = sparse.plan(bsr, n, device=dev)
    tiles = plan.pack(vals)
    xv = torch.empty(n * k + 1, dtype=dtype, device=dev)[1:].view(n, k)
    xv.copy_(x)
    assert xv.data_ptr() % 16 != 0
    assert plan.mma.stages > plan.mma.groups * -(-k // 64)
    got = bsmm_ops.bsmm_nt_cuda(x, tiles, plan.row_ptr, plan.tile_cols, m,
                                plan.mma)
    got_v = bsmm_ops.bsmm_nt_cuda(xv, tiles, plan.row_ptr, plan.tile_cols,
                                  m, plan.mma)
    want = bsmm_ops.bsmm_nt_plain(x, tiles, plan.tile_rows.long(),
                                  plan.tile_cols.long(), m)
    assert _rel(got, want) <= TOL[dtype]
    assert torch.equal(got, got_v)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("n", [1, 4, 8, 9, 16])
def test_bsmm_decode_and_mma_agree_at_small_n(dev, dtype, n):
    """Around the crossover each walk that takes N agrees with the plain
    version (decode up to its capacity, mma and ffma at every N)."""
    m, k, b = 1024, 512, 16
    bsr, vals, x = _bsmm_problem(dev, dtype, b, n, m, k, density=1 / 8)
    plan = sparse.plan(bsr, n, device=dev)
    tiles = plan.pack(vals)
    want = bsmm_ops.bsmm_nt_plain(x, tiles, plan.tile_rows.long(),
                                  plan.tile_cols.long(), m)
    for wk in bsmm_ops.WALKS:
        if wk == "decode" and n > bsmm_ops.DECODE_CAPACITY[b]:
            with pytest.raises(ValueError, match="does not take"):
                bsmm_ops.bsmm_nt_cuda(x, tiles, plan.row_ptr, plan.tile_cols,
                                      m, plan.mma, plan=wk)
            continue
        got = bsmm_ops.bsmm_nt_cuda(x, tiles, plan.row_ptr, plan.tile_cols,
                                    m, plan.mma, plan=wk)
        assert _rel(got, want) <= TOL[dtype], wk


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("b", [16, 32, 64])
@pytest.mark.parametrize("kind", ["uniform", "power_law", "dlmc"])
@pytest.mark.parametrize("n", [16, 1000])
def test_bsmm_balanced_mma_walk_matches_plain(dev, dtype, b, kind, n):
    """The balanced tensor-core walk (the bins as groups) on the skew
    masks, against the plain version over the visit schedule and the
    FFMA walk forced on the same inputs."""
    from repro_torch.kernels.bsmm import balanced as bal
    m, k = 48 * b, 20 * b
    bsr, vals, x = _bsmm_problem(dev, dtype, b, n, m, k, kind=kind,
                                 density=0.2)
    plan = sparse.plan(bsr, n, device=dev,
                       ctx=sparse.PlanContext(mode="static_balanced"))
    assert plan.artifacts["swizzle_bins"] == bal.mma_bins(m // b, b)
    assert plan.mma.groups == plan.artifacts["swizzle_bins"]
    tiles = plan.pack(vals)
    vr, vc, vs = plan.visit
    before = bal.WALK_COUNTERS["mma"].launches
    got = plan.run_packed(tiles, x)
    ffma = bal.bsmm_balanced_cuda(x, tiles, vr, vc, vs, m, plan.mma,
                                  plan="ffma")
    torch.cuda.synchronize()
    assert bal.WALK_COUNTERS["mma"].launches == before + 1
    want = bal.bsmm_balanced_plain(x, tiles, vr, vc, vs, m)
    assert _rel(got, want) <= TOL[dtype]
    assert _rel(ffma, want) <= TOL[dtype]
    assert torch.all(got[:, :b] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("n,k,d", [(1, 200, 72), (4, 2048, 512),
                                   (17, 64, 100), (130, 333, 2048)])
def test_dense_mm_cuda_matches_plain(dev, dtype, n, k, d):
    g = torch.Generator(device=dev).manual_seed(n + k + d)
    x = torch.randn((n, k), generator=g, device=dev).to(dtype)
    w = torch.randn((k, d), generator=g, device=dev).to(dtype)
    before = dmm_ops.COUNTER.launches
    got = dmm_ops.dense_mm(x, w)
    torch.cuda.synchronize()
    assert dmm_ops.COUNTER.launches == before + 1
    assert _rel(got, dmm_ops.dense_mm_plain(x, w)) <= TOL[dtype]


# each walk at its shapes and ragged edges: (n, k, d), the walks that
# dense_mm.walk picks in 16-bit types and in fp32
DENSE_WALK_CASES = [
    (1, 2048, 4096, "wgmma", "decode"), (4, 2048, 512, "decode", "decode"),
    (4, 2048, 2048, "decode", "decode"), (16, 4096, 2048, "wgmma", "decode"),
    (3, 100, 72, "decode", "decode"), (4, 8, 8, "decode", "decode"),
    (17, 2048, 4096, "wgmma", "ffma"), (64, 2048, 512, "wgmma", "ffma"),
    (256, 2048, 512, "wgmma", "ffma"), (1008, 2048, 4096, "wgmma", "ffma"),
    (1008, 4096, 2048, "wgmma", "ffma"), (300, 520, 200, "wgmma", "ffma"),
    (129, 64, 136, "wgmma", "ffma"), (2048, 2048, 2048, "wgmma", "ffma"),
    (130, 333, 2048, "ffma", "ffma"), (70, 64, 100, "ffma", "ffma"),
    (40, 4, 3, "ffma", "ffma"),
    # K past what the decode walk stages in shared memory at N 16
    (16, 32768, 1024, "wgmma", "ffma"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("n,k,d,walk16,walk32", DENSE_WALK_CASES)
def test_dense_mm_walks_match_plain(dev, dtype, n, k, d, walk16, walk32):
    g = torch.Generator(device=dev).manual_seed(n * 7 + k + d)
    x = torch.randn((n, k), generator=g, device=dev).to(dtype)
    w = (torch.randn((k, d), generator=g, device=dev) / k ** 0.5).to(dtype)
    wk = dmm_ops.walk(n, k, d, dtype)
    assert wk.name == (walk32 if dtype == torch.float32 else walk16)
    before = {n_: c.launches for n_, c in dmm_ops.WALK_COUNTERS.items()}
    got = dmm_ops.dense_mm(x, w)
    torch.cuda.synchronize()
    for name, c in dmm_ops.WALK_COUNTERS.items():
        assert c.launches == before[name] + (name == wk.name)
    assert got.shape == (n, d) and got.dtype == dtype
    assert _rel(got, dmm_ops.dense_mm_plain(x, w)) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("n", [1, 2, 4, 7, 16])
@pytest.mark.parametrize("cl,slices", [(8, 1), (16, 3), (32, 8)])
def test_dense_mm_decode_walk_matches_plain(dev, dtype, n, cl, slices):
    """The decode walk, forced, at every row count it holds, column
    width and cluster size, on a ragged D."""
    k, d = 1000, 1048
    g = torch.Generator(device=dev).manual_seed(n + cl + slices)
    x = torch.randn((n, k), generator=g, device=dev).to(dtype)
    w = (torch.randn((k, d), generator=g, device=dev) / k ** 0.5).to(dtype)
    got = dmm_ops.dense_mm_cuda(x, w, dmm_ops.Walk("decode", cl=cl,
                                                   slices=slices))
    torch.cuda.synchronize()
    assert _rel(got, dmm_ops.dense_mm_plain(x, w)) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("bm,bn,slices", [(64, 64, 1), (128, 128, 1),
                                          (128, 128, 3), (64, 64, 7)])
def test_dense_mm_wgmma_tiles_match_plain(dev, dtype, bm, bn, slices):
    """Every wgmma tile shape and a K split, forced, at ragged N and D."""
    n, k, d = 200, 1000, 328
    g = torch.Generator(device=dev).manual_seed(bm + bn + slices)
    x = torch.randn((n, k), generator=g, device=dev).to(dtype)
    w = (torch.randn((k, d), generator=g, device=dev) / k ** 0.5).to(dtype)
    got = dmm_ops.dense_mm_cuda(x, w, dmm_ops.Walk(
        "wgmma", bm=bm, bn=bn, slices=slices))
    torch.cuda.synchronize()
    assert _rel(got, dmm_ops.dense_mm_plain(x, w)) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("plan", [dmm_ops.Walk("decode", cl=16, slices=8),
                                  dmm_ops.Walk("wgmma", bm=64, bn=64,
                                               slices=5)],
                         ids=["decode_cluster", "wgmma_split"])
def test_dense_mm_k_split_is_deterministic(dev, plan):
    """K slices add in a fixed order (the decode cluster's ranks, the
    split-K reduce's slices): equal inputs, equal bits."""
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((4, 4096), generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn((4096, 2048), generator=g, device=dev).to(torch.bfloat16)
    first = dmm_ops.dense_mm_cuda(x, w, plan)
    for _ in range(3):
        assert torch.equal(dmm_ops.dense_mm_cuda(x, w, plan), first)


@pytest.mark.cuda
def test_sparse_lm_on_card_matches_cpu(dev):
    """The smoke config with a sparse FFN, fp32: the card (both kernels)
    against the CPU (both plain versions) on the same weights."""
    from repro_torch import configs
    import dataclasses
    cfg = dataclasses.replace(
        configs.sparsify_ffn(configs.smoke("llama3_2_1b"), 0.25),
        dtype="float32")
    gpu = LM(cfg, device=dev, seed=0)
    cpu = LM(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    toks = np.random.default_rng(0).integers(0, 512, size=(2, 9))
    b0, d0 = bsmm_ops.COUNTER.launches, dmm_ops.COUNTER.launches
    got = gpu.forward(toks)
    assert bsmm_ops.COUNTER.launches - b0 == 2 * 3
    assert dmm_ops.COUNTER.launches - d0 == 2 * 4
    assert _rel(got.cpu(), cpu.forward(toks)) <= 2e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("b", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("n", [1, 70, 600, 2047])   # one pass and split N
def test_sddmm_cuda_matches_plain(dev, dtype, b, n):
    from repro_torch.kernels.sddmm import ops as sddmm_ops
    m, k = 256, 512
    mask = masks.random_block_mask(m, k, b, 0.25, seed=b + 1)
    mask[0] = False                                  # an empty block-row
    rows, cols = np.nonzero(mask)
    g = torch.Generator(device=dev).manual_seed(b + n)
    dy = torch.randn((n, m), generator=g, device=dev).to(dtype)
    x = torch.randn((n, k), generator=g, device=dev).to(dtype)
    ptr = torch.as_tensor(sddmm_ops.block_row_ptr(rows, m // b),
                          device=dev)
    tc = torch.as_tensor(cols.astype(np.int32), device=dev)
    tr = torch.as_tensor(rows, device=dev)
    wk = sddmm_ops.walk(b, dtype)
    assert wk == ("ffma" if dtype == torch.float32 or b < 16 else "mma")
    # split N at 600 and 2047 tokens, one pass at 1 and 70
    assert (sddmm_ops.n_splits(n, m // b, wk) > 1) == (n >= 600)
    before = sddmm_ops.COUNTER.launches
    walk_before = sddmm_ops.WALK_COUNTERS[wk].launches
    got = sddmm_ops.sddmm(dy, x, ptr, tc, tr, b)
    torch.cuda.synchronize()
    assert sddmm_ops.COUNTER.launches == before + 1
    assert sddmm_ops.WALK_COUNTERS[wk].launches == walk_before + 1
    assert got.shape == (rows.size, b, b) and got.dtype == dtype
    want = sddmm_ops.sddmm_plain(dy, x, tr.long(), tc.long(), b)
    assert _rel(got, want) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("b", [16, 32, 64])
@pytest.mark.parametrize("n", [3, 2047])
def test_sddmm_mma_walk_long_rows_match_plain(dev, dtype, b, n):
    """Rows of more blocks than one group holds (16 / 8 / 4 at b = 16 /
    32 / 64), an empty row and a row of one block, on the mma walk and on
    the FFMA walk forced on the same inputs."""
    from repro_torch.kernels.sddmm import ops as sddmm_ops
    m, k = 8 * b, 2048
    mask = masks.random_block_mask(m, k, b, 0.4, seed=b + n)
    mask[1] = False
    mask[2] = False
    mask[2, 5] = True
    rows, cols = np.nonzero(mask)
    g = torch.Generator(device=dev).manual_seed(b)
    dy = torch.randn((n, m), generator=g, device=dev).to(dtype)
    x = torch.randn((n, k), generator=g, device=dev).to(dtype)
    ptr = torch.as_tensor(sddmm_ops.block_row_ptr(rows, m // b),
                          device=dev)
    tc = torch.as_tensor(cols.astype(np.int32), device=dev)
    tr = torch.as_tensor(rows, device=dev)
    want = sddmm_ops.sddmm_plain(dy, x, tr.long(), tc.long(), b)
    before = sddmm_ops.WALK_COUNTERS["mma"].launches
    got = sddmm_ops.sddmm_cuda(dy, x, ptr, tc, b)
    ffma = sddmm_ops.sddmm_cuda(dy, x, ptr, tc, b, plan="ffma")
    torch.cuda.synchronize()
    assert sddmm_ops.WALK_COUNTERS["mma"].launches == before + 1
    assert _rel(got, want) <= TOL[dtype]
    assert _rel(ffma, want) <= TOL[dtype]
    assert torch.all(got[ptr[2]:ptr[3]].float().abs().sum() > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sparse_linear_autograd_on_card_matches_plain(dev, dtype):
    """One autograd step of a SparseLinear through the kernels (bsmm
    forward; sddmm and bsmm on the transposed pattern backward) against
    core/static_sparse's plain formulation on the same card tensors."""
    from repro_torch.core import static_sparse
    from repro_torch.core.sparse_layers import SparseLinear
    from repro_torch.kernels.sddmm import ops as sddmm_ops
    d_in, d_out, b, n = 512, 1024, 16, 300
    layer = SparseLinear.random_pattern(d_in, d_out, b, 0.125, seed=3,
                                        dtype=dtype, device=dev)
    layer.reset_parameters(torch.Generator(device=dev).manual_seed(0))
    layer.requires_grad_(True)
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((n, d_in), generator=g, device=dev).to(dtype)
    gy = torch.randn((n, d_out), generator=g, device=dev).to(dtype)
    x.requires_grad_(True)
    b0, s0 = bsmm_ops.COUNTER.launches, sddmm_ops.COUNTER.launches
    layer(x).backward(gy)
    torch.cuda.synchronize()
    assert bsmm_ops.COUNTER.launches - b0 == 2
    assert sddmm_ops.COUNTER.launches - s0 == 1
    f = static_sparse.make_spmm(layer.row_idx, layer.col_idx,
                                (d_out // b, d_in // b), b)
    v = layer.values.detach().clone().requires_grad_(True)
    xt = x.detach().t().contiguous().requires_grad_(True)
    f(v, xt).backward(gy.t())
    assert _rel(layer.values.grad, v.grad) <= TOL[dtype]
    assert _rel(x.grad, xt.grad.t()) <= TOL[dtype]


GENS = {"uniform": masks.random_block_mask,
        "power_law": masks.power_law_block_mask,
        "dlmc": masks.dlmc_block_mask}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("b", [4, 8, 16, 32, 64, 128])
@pytest.mark.parametrize("kind", list(GENS))
@pytest.mark.parametrize("n", [1, 3, 300, 2047])
def test_dsmm_cuda_matches_plain(dev, dtype, b, kind, n):
    from repro_torch.core import dynamic_sparse as dsp
    from repro_torch.kernels.dsmm import ops as dsmm_ops
    m, k = 512, 256
    mask = GENS[kind](m, k, b, 0.25, seed=b)
    mask[1] = False                                  # a row with no slots
    g = torch.Generator(device=dev).manual_seed(b + n)
    w = torch.randn((m, k), generator=g, device=dev).to(dtype)
    op = dsp.encode(w, torch.as_tensor(mask, device=dev), block_size=b,
                    nnz_max=int(mask.sum()) + 5)
    x = torch.randn((n, k), generator=g, device=dev).to(dtype)
    # exact capacity: the encoder's row-major slots, no padding, are
    # contiguous per row without coverage or sorting; row 1 has no run
    exact = dsp.encode(w, torch.as_tensor(mask, device=dev), block_size=b,
                       nnz_max=int(mask.sum()))
    wk = dsmm_ops.walk(b, dtype)
    assert wk == ("ffma" if dtype == torch.float32 or b < 16 else "mma")
    before = dsmm_ops.COUNTER.launches
    walk_before = dsmm_ops.WALK_COUNTERS[wk].launches
    got = dsmm_ops.dsmm(op, x)
    raw = dsmm_ops.dsmm_slots(x, exact.values, exact.row_idx,
                              exact.col_idx, m)
    torch.cuda.synchronize()
    assert dsmm_ops.COUNTER.launches == before + 2
    assert dsmm_ops.WALK_COUNTERS[wk].launches == walk_before + 2
    rows, cols, vals = dsmm_ops.encode_slots(op)
    want = dsmm_ops.dsmm_plain(x, vals, rows, cols, m)
    assert got.dtype == dtype and torch.all(raw[:, b:2 * b] == 0)
    assert _rel(got, want) <= TOL[dtype]
    assert _rel(raw, want) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("b", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("kind", list(GENS))
@pytest.mark.parametrize("n", [5, 300])
def test_bsmm_balanced_cuda_matches_plain(dev, dtype, b, kind, n):
    from repro_torch.kernels.bsmm import balanced as bal
    m, k = 512, 256
    mask = GENS[kind](m, k, b, 0.25, seed=b + 1)
    mask[0] = False                                  # an empty row-tile
    g = torch.Generator(device=dev).manual_seed(b)
    vals = torch.randn((int(mask.sum()), b, b), generator=g,
                       device=dev).to(dtype)
    bsr = BlockSparseMatrix.from_mask(mask, b, values=vals)
    plan = sparse.plan(bsr, n, device=dev,
                       ctx=sparse.PlanContext(mode="static_balanced"))
    assert plan.route == "static_balanced_cuda"
    tiles = plan.pack(vals)
    x = torch.randn((n, k), generator=g, device=dev).to(dtype)
    vr, vc, vs = plan.visit
    before = bal.COUNTER.launches
    got = plan.run_packed(tiles, x)
    torch.cuda.synchronize()
    assert bal.COUNTER.launches == before + 1
    want = bal.bsmm_balanced_plain(x, tiles, vr, vc, vs, m)
    assert torch.all(got[:, :b] == 0)
    assert _rel(got, want) <= TOL[dtype]
    assert _rel(got, x @ bsr.to_dense().t()) <= TOL[dtype] * 5


def _slot_cases(b, dev, dtype):
    """``(name, values, rows, cols, m, k)`` slot lists the dsmm tensor-
    core walk must take: padding only; rows in descending order; each
    row's columns descending; chunks of K that no row of a group touches
    (only the first and last block-columns used, at k = 40 blocks); every
    block present (more slots a chunk than a stage holds); k below one
    64-column chunk; duplicate slots of one block."""
    from repro_torch.core import dynamic_sparse as dsp
    from repro_torch.kernels.dsmm import ops as dsmm_ops
    g = torch.Generator(device=dev).manual_seed(b)
    out = []

    def enc(m, k, mask, cap):
        w = torch.randn((m, k), generator=g, device=dev).to(dtype)
        return dsp.encode(w, torch.as_tensor(mask, device=dev),
                          block_size=b, nnz_max=cap)

    m, k = 16 * b, 8 * b
    op = enc(m, k, np.zeros((16, 8), bool), 9)
    r, c, v = dsmm_ops.encode_slots(op)
    out.append(("all padded", v, r, c, m, k))
    mask = masks.random_block_mask(m, k, b, 0.3, seed=b)
    op = enc(m, k, mask, int(mask.sum()) + 4)
    r, c, v = dsmm_ops.encode_slots(op)
    # whole row runs in descending row order, and each run reversed
    runs = torch.unique_consecutive(r, return_counts=True)[1].tolist()
    idx = torch.arange(r.numel(), device=dev).split(runs)
    down = torch.cat(idx[::-1])
    out.append(("rows descending", v[down], r[down], c[down], m, k))
    rev = torch.cat([i.flip(0) for i in idx])
    out.append(("columns descending", v[rev], r[rev], c[rev], m, k))
    m, k = 8 * b, 40 * b
    mask = np.zeros((8, 40), bool)
    mask[::2, 0] = mask[1::3, 39] = mask[5, 20] = True
    r, c, v = dsmm_ops.encode_slots(enc(m, k, mask, int(mask.sum())))
    out.append(("untouched chunks", v, r, c, m, k))
    m, k = 8 * b, 8 * b
    r, c, v = dsmm_ops.encode_slots(enc(m, k, np.ones((8, 8), bool), 64))
    out.append(("dense", v, r, c, m, k))
    if b < 64:
        m, k = 4 * b, (48 // b) * b
        mask = np.ones((4, k // b), bool)
        r, c, v = dsmm_ops.encode_slots(enc(m, k, mask, int(mask.sum())))
        out.append(("k below a chunk", v, r, c, m, k))
    m, k = 4 * b, 4 * b
    v = torch.randn((6, b, b), generator=g, device=dev).to(dtype)
    r = torch.tensor([0, 0, 0, 2, 2, 3], dtype=torch.int32, device=dev)
    c = torch.tensor([1, 1, 3, 0, 0, 2], dtype=torch.int32, device=dev)
    out.append(("duplicates", v, r, c, m, k))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("b", [16, 32, 64, 128])
@pytest.mark.parametrize("n", [1, 300])
def test_dsmm_mma_walk_slot_orders_match_plain(dev, dtype, b, n):
    """The tensor-core walk on slot lists the runtime encoders may give or
    a caller may pass (``_slot_cases``), against the plain version, and
    the FFMA walk forced on the same inputs."""
    from repro_torch.kernels.dsmm import ops as dsmm_ops
    for name, v, r, c, m, k in _slot_cases(b, dev, dtype):
        g = torch.Generator(device=dev).manual_seed(n)
        x = torch.randn((n, k), generator=g, device=dev).to(dtype)
        before = dsmm_ops.WALK_COUNTERS["mma"].launches
        got = dsmm_ops.dsmm_slots(x, v, r, c, m)
        ffma = dsmm_ops.dsmm_cuda(x, v, r, c, m, plan="ffma")
        torch.cuda.synchronize()
        assert dsmm_ops.WALK_COUNTERS["mma"].launches == before + 1, name
        want = dsmm_ops.dsmm_plain(x, v, r, c, m)
        if not want.float().abs().max() > 0:
            assert torch.all(got == 0) and torch.all(ffma == 0), name
            continue
        assert _rel(got, want) <= TOL[dtype], name
        assert _rel(ffma, want) <= TOL[dtype], name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("n", [3, 2047])
def test_dsmm_mma_walk_on_grouped_tiles(dev, dtype, n):
    """The grouped routes' t = 128 tiles through the tensor-core walk,
    at the FFN's up/gate shape (8192 x 2048, b = 16, d = 1/8)."""
    from repro_torch.core import dynamic_sparse as dsp
    from repro_torch.kernels.dsmm import ops as dsmm_ops
    from repro_torch.kernels.gmm import ops as gmm_ops
    m, k, b = 8192, 2048, 16
    mask = masks.random_block_mask(m, k, b, 1 / 8, seed=1)
    g = torch.Generator(device=dev).manual_seed(n)
    w = (torch.randn((m, k), generator=g, device=dev) / 45).to(dtype)
    op = dsp.encode(w, torch.as_tensor(mask, device=dev), block_size=b,
                    nnz_max=int(mask.sum()))
    x = torch.randn((n, k), generator=g, device=dev).to(dtype)
    before = dsmm_ops.WALK_COUNTERS["mma"].launches
    got = gmm_ops.grouped_spmm(op, x, tile=128)
    torch.cuda.synchronize()
    assert dsmm_ops.WALK_COUNTERS["mma"].launches == before + 1
    want = torch.matmul(x.float(), op.to_dense().float().t())
    assert _rel(got, want) <= TOL[dtype]


# (m, k) per block outside the kernels' tiles: b = 3 on a grid the 4 x 4
# packing tile does not divide (the walk pads it), b = 12 and 24 split
# into 4 x 4 and 8 x 8 blocks
BLOCK_SHAPES = {1: (256, 512), 2: (256, 512), 128: (256, 512),
                3: (291, 483), 12: (288, 480), 24: (288, 480)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["static", "static_balanced"])
@pytest.mark.parametrize("b", [1, 2, 128, 3, 12, 24])
def test_static_blocks_outside_tiles_on_card(dev, dtype, mode, b):
    """Static plans at b in {1, 2} (packed into 4 x 4 tiles), 128 (split
    into 64 x 64 blocks) and blocks that are not powers of two (split
    into sub-blocks, packed below 4): forward, dL/dx and dL/dvalues
    through the bsmm / bsmm_balanced and sddmm kernels against the dense
    product."""
    from repro_torch.kernels.bsmm import balanced as bal
    from repro_torch.kernels.sddmm import ops as sddmm_ops
    (m, k), n = BLOCK_SHAPES[b], 40
    mask = masks.random_block_mask(m, k, b, 0.25 if b < 128 else 0.5,
                                   seed=b)
    g = torch.Generator(device=dev).manual_seed(b)
    vals = torch.randn((int(mask.sum()), b, b), generator=g,
                       device=dev).to(dtype)
    bsr = BlockSparseMatrix.from_mask(mask, b, values=vals)
    plan = sparse.plan(bsr, n, device=dev,
                       ctx=sparse.PlanContext(mode=mode))
    assert plan.route == f"{mode}_cuda"
    counter = bal.COUNTER if mode == "static_balanced" else bsmm_ops.COUNTER
    before = (counter.launches, bsmm_ops.COUNTER.launches,
              sddmm_ops.COUNTER.launches)
    tv = vals.clone().requires_grad_(True)
    x = torch.randn((n, k), generator=g, device=dev).to(dtype)
    tx = x.clone().requires_grad_(True)
    y = plan.spmm_nt(tv, tx)
    gy = torch.randn((n, m), generator=g, device=dev).to(dtype)
    dv, dx = torch.autograd.grad(y, (tv, tx), gy)
    torch.cuda.synchronize()
    assert counter.launches > before[0]
    assert bsmm_ops.COUNTER.launches > before[1]           # dL/dx
    assert sddmm_ops.COUNTER.launches == before[2] + 1     # dL/dvalues
    w = bsr.to_dense().float()
    assert _rel(y, x.float() @ w.t()) <= TOL[dtype] * 5
    assert _rel(dx, gy.float() @ w) <= TOL[dtype] * 5
    dense_dv = (gy.float().t() @ x.float()).reshape(
        m // b, b, k // b, b).permute(0, 2, 1, 3)
    r, c = (torch.as_tensor(a, device=dev) for a in np.nonzero(mask))
    assert dv.shape == vals.shape
    assert _rel(dv, dense_dv[r, c]) <= TOL[dtype] * 5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["dynamic", "dynamic_grouped",
                                  "dynamic_grouped_balanced"])
@pytest.mark.parametrize("b", [1, 2, 3, 12, 24])
def test_dynamic_blocks_below_tiles_on_card(dev, dtype, mode, b):
    """Dynamic plans at b in {1, 2} and at blocks that are not powers of
    two: split and re-blocked (dynamic) or packed (grouped) on the
    device, through the dsmm kernel, against the CPU."""
    from repro_torch.core import dynamic_sparse as dsp
    from repro_torch.kernels.dsmm import ops as dsmm_ops
    m, k = BLOCK_SHAPES[b]
    mask = masks.random_block_mask(m, k, b, 1 / 8, seed=b)
    w = torch.randn((m, k), generator=torch.Generator().manual_seed(b))
    x = torch.randn((70, k), generator=torch.Generator().manual_seed(1))
    ctx = sparse.PlanContext(mode=mode, capacity_policy="worst")
    outs = []
    for d in (dev, torch.device("cpu")):
        op = dsp.encode(w.to(d, dtype), torch.as_tensor(mask, device=d),
                        block_size=b, nnz_max=int(mask.sum()) + 9)
        before = dsmm_ops.COUNTER.launches
        outs.append(sparse.spmm_nt(op, x.to(d, dtype), ctx=ctx).cpu())
        if d.type == "cuda":
            torch.cuda.synchronize()
            assert dsmm_ops.COUNTER.launches == before + 1
    assert _rel(outs[0], outs[1]) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["dynamic_grouped",
                                   "dynamic_grouped_balanced"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_routes_on_card_match_cpu(dev, route, dtype):
    from repro_torch.core import dynamic_sparse as dsp
    from repro_torch.kernels.dsmm import ops as dsmm_ops
    m, k, b = 1024, 512, 16
    mask = masks.power_law_block_mask(m, k, b, 1 / 8, seed=3)
    w = torch.randn((m, k), generator=torch.Generator().manual_seed(0))
    ctx = sparse.PlanContext(mode=route, capacity_policy="worst")
    x = torch.randn((200, k), generator=torch.Generator().manual_seed(1))
    outs = []
    for d in (dev, torch.device("cpu")):
        op = dsp.encode(w.to(d, dtype), torch.as_tensor(mask, device=d),
                        block_size=b, nnz_max=int(mask.sum()))
        before = dsmm_ops.COUNTER.launches
        outs.append(sparse.spmm_nt(op, x.to(d, dtype), ctx=ctx).cpu())
        if d.type == "cuda":
            torch.cuda.synchronize()
            assert dsmm_ops.COUNTER.launches == before + 1
    assert _rel(outs[0], outs[1]) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dynamic_sparse_linear_on_card_matches_cpu(dev, dtype):
    """Forward and backward of a DynamicSparseLinear through the dsmm
    kernel against the CPU's plain dynamic_torch route on the same
    weights and mask."""
    from repro_torch.core.sparse_layers import DynamicSparseLinear
    from repro_torch.kernels.dsmm import ops as dsmm_ops
    d_in, d_out, b, n = 512, 1024, 16, 96
    res = []
    for d in (dev, torch.device("cpu")):
        layer = DynamicSparseLinear(d_in, d_out, b, 1 / 8, use_bias=True,
                                    dtype=dtype, device=d)
        layer.reset_parameters(torch.Generator(device=d).manual_seed(0),
                               mask_seed=4)
        if d.type == "cpu":
            layer.weight.data.copy_(res[0][3].cpu())
        x = torch.randn((n, d_in), generator=torch.Generator()
                        .manual_seed(1)).to(d, dtype).requires_grad_(True)
        gy = torch.randn((n, d_out), generator=torch.Generator()
                         .manual_seed(2)).to(d, dtype)
        before = dsmm_ops.COUNTER.launches
        y = layer(x)
        y.backward(gy)
        if d.type == "cuda":
            torch.cuda.synchronize()
            assert dsmm_ops.COUNTER.launches == before + 1
        res.append((y.detach(), x.grad, layer.weight.grad,
                    layer.weight.detach().clone()))
    for got, want in zip(res[0][:3], res[1][:3]):
        assert _rel(got.cpu(), want) <= TOL[dtype]


# (S, tile, heads, kv heads, batch, causal, window, global prefix,
# softcap): tiles split into several 64-row blocks, one partial tile,
# small tiles walked 64 / bq at a time (bq = 8 and, at odd S, bq = 1),
# windows that cut tiles, GQA and a non-causal mask
ATTN_CASES = [
    (256, 64, 4, 2, 2, True, 0, 0, None),
    (300, 512, 2, 2, 1, True, 0, 0, 50.0),
    (1000, 512, 4, 1, 1, True, 0, 0, None),
    (37, 16, 2, 1, 2, True, 9, 0, None),
    (131, 64, 4, 2, 1, True, 40, 8, 30.0),
    (640, 128, 2, 1, 1, True, 100, 20, 50.0),
    (96, 32, 2, 2, 2, False, 0, 0, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("dh", [32, 64, 128, 256])
@pytest.mark.parametrize("case", ATTN_CASES)
def test_bs_attn_cuda_matches_plain(dev, dtype, dh, case):
    from repro_torch.kernels.bs_attn import ops as bs_ops
    from repro_torch.kernels.bs_attn.ref import attend_plain
    from repro_torch.models import attention
    s, tile, h, kvh, b_, causal, window, prefix, softcap = case
    g = torch.Generator(device=dev).manual_seed(s + dh)
    q = torch.randn((b_, s, h, dh), generator=g, device=dev).to(dtype)
    k = torch.randn((b_, s, kvh, dh), generator=g, device=dev).to(dtype)
    v = torch.randn((b_, s, kvh, dh), generator=g, device=dev).to(dtype)
    counter = bs_ops.WALK_COUNTERS[bs_ops.kernel_walk(dtype)]
    before, walk_before = bs_ops.COUNTER.launches, counter.launches
    got = attention.attend_train(q, k, v, causal=causal, window=window,
                                 global_prefix=prefix, softcap=softcap,
                                 tile_q=tile, tile_kv=tile)
    torch.cuda.synchronize()
    assert bs_ops.COUNTER.launches == before + 1
    assert counter.launches == walk_before + 1
    spec = attention.attn_spec(s, s, dh, causal=causal, window=window,
                               global_prefix=prefix, softcap=softcap,
                               tile_q=tile, tile_kv=tile)
    want = attend_plain(q, k, v, spec.element_mask(dev), scale=spec.scale,
                        softcap=softcap)
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= TOL[dtype]


# the served tilings: qwen3's 1008-token prefill (tiles halved to 16, 32
# heads over 4 kv heads, dh 128) and gemma2's 6112-token local layer
# (tiles of 32, dh 256, soft-cap 50, window 4096), each read from the
# fused projection's strided [B, S, H + 2 KV, dh] buffer as served
SERVED_ATTN = [(1008, 32, 4, 128, 0, None), (6112, 8, 4, 256, 4096, 50.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", SERVED_ATTN)
def test_bs_attn_wgmma_served_tilings_match_plain(dev, dtype, case):
    from repro_torch.kernels.bs_attn import ops as bs_ops
    from repro_torch.kernels.bs_attn.ref import attend_plain
    from repro_torch.models import attention
    s, h, kvh, dh, window, softcap = case
    g = torch.Generator(device=dev).manual_seed(s)
    qkv = torch.randn((1, s, h + 2 * kvh, dh), generator=g,
                      device=dev).to(dtype)
    q, k, v = qkv.split([h, kvh, kvh], dim=2)
    spec = attention.attn_spec(s, s, dh, window=window, softcap=softcap)
    assert spec.tile_q == {1008: 16, 6112: 32}[s]
    before = bs_ops.WALK_COUNTERS["wgmma"].launches
    got = attention.attend_train(q, k, v, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert bs_ops.WALK_COUNTERS["wgmma"].launches == before + 1
    want = attend_plain(q, k, v, spec.element_mask(dev), scale=spec.scale,
                        softcap=softcap)
    assert _rel(got, want) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_bs_attn_walks_agree(dev, dtype):
    """The wgmma walk against the CUDA-core walk forced on the same
    16-bit inputs (group walk at bq 16, GQA, window and soft-cap)."""
    from repro_torch.kernels.bs_attn import ops as bs_ops
    from repro_torch.models import attention
    s, h, kvh, dh = 400, 4, 2, 64
    g = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn((2, s, h, dh), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((2, s, kvh, dh), generator=g, device=dev).to(dtype)
            for _ in range(2))
    spec = attention.attn_spec(s, s, dh, window=100, global_prefix=16,
                               softcap=30.0, tile_q=16, tile_kv=16)
    walk = spec.walk(dev)
    kw = dict(scale=spec.scale, causal=True, softcap=30.0, window=100,
              global_prefix=16)
    tc = bs_ops.bs_attn_cuda(q, k, v, walk, **kw)
    cc = bs_ops.bs_attn_cuda(q, k, v, walk, plan="cuda_core", **kw)
    torch.cuda.synchronize()
    assert _rel(tc, cc) <= TOL[dtype]
    with pytest.raises(ValueError, match="does not take"):
        bs_ops.bs_attn_cuda(q.float(), k.float(), v.float(), walk,
                            plan="wgmma", **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("softcap", [None, 30.0])
def test_bs_attn_masks_on_card_match_plain(dev, dtype, softcap):
    """The mask-level entry point on the reference kernel test's masks
    (``[H, S, dh]`` layout, tiles 128; read and written strided)."""
    from repro_torch.core import masks as tmasks
    from repro_torch.kernels.bs_attn import ops as bs_ops
    from repro_torch.kernels.bs_attn.ref import bs_attn_ref
    h, s, dh, nb = 2, 512, 64, 4
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (torch.randn((h, s, dh), generator=g, device=dev).to(dtype)
               for _ in range(3))
    banded = np.tril(tmasks.banded_block_mask(s, s, 128, 1))
    banded[np.diag_indices(nb)] = True
    for bm in (tmasks.local_global_attention_mask(
                   nb, nb, window_blocks=2, global_blocks=1),
               banded, np.tril(np.ones((nb, nb), bool))):
        got = bs_ops.bs_attn(q, k, v, bm, softcap=softcap)
        want = bs_attn_ref(q, k, v, bm, softcap=softcap)
        assert _rel(got, want) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_bs_attn_group_walk_tile_mask_on_card(dev, dtype):
    """A group walk (tiles of 16, 4 a block) over a random block mask
    that the causal element mask does not imply: the kernel's per-element
    tile-mask lookups (and, in 16-bit, its chunk-level check) against the
    plain version."""
    from repro_torch.kernels.bs_attn import ops as bs_ops
    from repro_torch.kernels.bs_attn.ref import bs_attn_ref
    h, s, dh, t = 2, 320, 64, 16
    n = s // t
    mask = np.random.default_rng(4).random((n, n)) < 0.5
    mask |= np.eye(n, dtype=bool)
    mask = np.tril(mask)
    assert not bs_ops.tile_mask_implied(mask, t, t, causal=True)
    assert bs_ops.make_walk(mask, t, t, dev, causal=True).tile_mask is not None
    g = torch.Generator(device=dev).manual_seed(9)
    q, k, v = (torch.randn((h, s, dh), generator=g, device=dev).to(dtype)
               for _ in range(3))
    got = bs_ops.bs_attn(q, k, v, mask, bq=t, bkv=t)
    want = bs_attn_ref(q, k, v, mask, bq=t, bkv=t)
    assert _rel(got, want) <= TOL[dtype]


@pytest.mark.cuda
def test_attend_train_grads_on_card_match_cpu(dev):
    from repro_torch.models import attention
    g = torch.Generator().manual_seed(3)
    base = [torch.randn(shape, generator=g) for shape in
            ((2, 192, 4, 64), (2, 192, 2, 64), (2, 192, 2, 64))]
    dout = torch.randn((2, 192, 4, 64), generator=g)
    grads = []
    for device in (dev, torch.device("cpu")):
        leaves = [t.to(device).requires_grad_(True) for t in base]
        out = attention.attend_train(*leaves, window=50, global_prefix=10,
                                     softcap=50.0, tile_q=64, tile_kv=64)
        (out * dout.to(device)).sum().backward()
        grads.append([t.grad.cpu() for t in leaves])
    for got, want in zip(*grads):
        assert _rel(got, want) <= 1e-4


@pytest.mark.cuda
def test_gemma2_lm_on_card_matches_cpu(dev):
    """gemma2's smoke config with a sparse FFN, fp32, at a prompt past
    window + tile: the card (all three kernels) against the CPU."""
    from repro_torch import configs
    from repro_torch.kernels.bs_attn import ops as bs_ops
    import dataclasses
    cfg = dataclasses.replace(
        configs.sparsify_ffn(configs.smoke("gemma2-2b"), 0.25),
        dtype="float32")
    gpu = LM(cfg, device=dev, seed=0)
    cpu = LM(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    toks = np.random.default_rng(0).integers(0, 512, size=(2, 150))
    a0 = bs_ops.COUNTER.launches
    got = gpu.forward(toks)
    assert bs_ops.COUNTER.launches - a0 == 2
    assert _rel(got.cpu(), cpu.forward(toks)) <= 2e-4
    logits, caches = gpu.prefill(toks[:, :140], max_len=160)
    for pos in range(140, 150):
        logits, caches = gpu.decode_step(toks[:, pos:pos + 1], caches,
                                         np.asarray([pos, pos]))
        assert _rel(logits.cpu(), got[:, pos].cpu()) <= 2e-4


# gmm: (E, tm, row tiles, D, F, ids); ids "monotone" (each expert's rows
# one run, as batched_matmul lays them out) or "random" (non-monotone);
# F 96 and 100 exercise the 64-column edge and the element-wise w loads
GMM_CASES = [(8, 8, 16, 128, 96, "monotone"), (8, 8, 16, 128, 100, "random"),
             (4, 40, 8, 96, 96, "monotone"), (4, 40, 8, 100, 64, "random"),
             (8, 64, 4, 128, 96, "random"), (3, 24, 6, 64, 128, "monotone")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("case", GMM_CASES)
def test_gmm_cuda_matches_plain(dev, dtype, case):
    from repro_torch.kernels.gmm import ops as gmm_ops
    from repro_torch.kernels.gmm.ref import gmm_ref
    e, tm, tiles, d, f, kind = case
    g = torch.Generator(device=dev).manual_seed(tm * 7 + f)
    x = torch.randn((tiles * tm, d), generator=g, device=dev).to(dtype)
    w = (torch.randn((e, d, f), generator=g, device=dev)
         / np.sqrt(d)).to(dtype)
    if kind == "monotone":
        ids = torch.arange(e, device=dev).repeat_interleave(
            -(-tiles // e))[:tiles]
    else:
        ids = torch.randint(0, e, (tiles,), generator=g, device=dev)
    ids = ids.to(torch.int32)
    counter = gmm_ops.WALK_COUNTERS[gmm_ops.walk(tm, d, f, dtype).name]
    before, walk_before = gmm_ops.COUNTER.launches, counter.launches
    got = gmm_ops.gmm(x, w, ids, tm=tm)
    torch.cuda.synchronize()
    assert gmm_ops.COUNTER.launches == before + 1
    assert counter.launches == walk_before + 1
    assert _rel(got, gmm_ref(x, w, ids, tm=tm)) <= TOL[dtype]


# the wgmma walk: (E, tm, row tiles, D, F); row tiles of 8 to 128 rows
# (two m64 halves above 64), F and D off the 64-column grid, random
# non-monotone ids with some past E (zero rows); qwen3's C 80 prefill
# shape at full width
GMM_TC_CASES = [(8, 8, 16, 128, 96), (4, 40, 8, 72, 200), (8, 64, 4, 256, 128),
                (6, 80, 12, 136, 64), (5, 128, 6, 520, 264),
                (128, 80, 128, 2048, 768)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", GMM_TC_CASES)
def test_gmm_wgmma_walk_matches_plain(dev, dtype, case):
    from repro_torch.kernels.gmm import ops as gmm_ops
    from repro_torch.kernels.gmm.ref import gmm_ref
    e, tm, tiles, d, f = case
    assert gmm_ops.walk(tm, d, f, dtype).name == "wgmma"
    g = torch.Generator(device=dev).manual_seed(tm + d)
    x = torch.randn((tiles * tm, d), generator=g, device=dev).to(dtype)
    w = (torch.randn((e, d, f), generator=g, device=dev)
         / np.sqrt(d)).to(dtype)
    ids = torch.randint(-1, e + 2, (tiles,), generator=g, device=dev)
    ids = ids.to(torch.int32)
    before = gmm_ops.WALK_COUNTERS["wgmma"].launches
    got = gmm_ops.gmm(x, w, ids, tm=tm)
    torch.cuda.synchronize()
    assert gmm_ops.WALK_COUNTERS["wgmma"].launches == before + 1
    dead = ((ids < 0) | (ids >= e)).repeat_interleave(tm)
    assert torch.all(got[dead] == 0)
    assert _rel(got, gmm_ref(x, w, ids, tm=tm)) <= TOL[dtype]
    ffma = gmm_ops.gmm_cuda(x, w, ids, tm=tm, plan=gmm_ops.Walk("ffma"))
    assert _rel(got, ffma) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gmm_cuda_id_past_e_gives_zero_rows(dev, dtype):
    from repro_torch.kernels.gmm import ops as gmm_ops
    from repro_torch.kernels.gmm.ref import gmm_ref
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((32, 64), generator=g, device=dev).to(dtype)
    w = torch.randn((2, 64, 72), generator=g, device=dev).to(dtype)
    ids = torch.tensor([0, 2, -5, 1], dtype=torch.int32, device=dev)
    got = gmm_ops.gmm_cuda(x, w, ids, tm=8)
    torch.cuda.synchronize()
    assert torch.all(got[8:24] == 0)
    assert _rel(got, gmm_ref(x, w, ids, tm=8)) <= TOL[dtype]
    with pytest.raises(ValueError, match="outside"):
        gmm_ops.gmm_cuda(x, w, ids[:0], tm=256)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["short ids", "long ids", "ragged rows",
                                 "d mismatch", "w dtype"])
def test_gmm_cuda_refuses_bad_shapes_and_dtypes(dev, bad):
    """gmm_cuda itself (called directly by batched_matmul) refuses what
    would make the kernel read past expert_ids or reinterpret w."""
    from repro_torch.kernels.gmm import ops as gmm_ops
    x = torch.zeros((32, 64), device=dev)
    w = torch.zeros((2, 64, 72), device=dev)
    ids = torch.zeros((4,), dtype=torch.int32, device=dev)
    if bad == "short ids":
        ids = ids[:2]
    elif bad == "long ids":
        ids = torch.zeros((5,), dtype=torch.int32, device=dev)
    elif bad == "ragged rows":
        x = x[:30]
    elif bad == "d mismatch":
        w = torch.zeros((2, 48, 72), device=dev)
    else:
        w = w.to(torch.bfloat16)
    before = gmm_ops.COUNTER.launches
    with pytest.raises(ValueError):
        gmm_ops.gmm_cuda(x, w, ids, tm=8)
    assert gmm_ops.COUNTER.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("c", [8, 40, 72])
def test_batched_matmul_on_card_runs_gmm(dev, c):
    from repro_torch.kernels.gmm import ops as gmm_ops
    g = torch.Generator(device=dev).manual_seed(c)
    a = torch.randn((16, c, 256), generator=g, device=dev)
    b = torch.randn((16, 256, 96), generator=g, device=dev) / 16
    before = gmm_ops.COUNTER.launches
    got = sparse.batched_matmul(a.to(torch.bfloat16), b)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert gmm_ops.COUNTER.launches == before + 1
    assert _rel(got, torch.matmul(a.to(torch.bfloat16).float(), b)) <= 1e-4


@pytest.mark.cuda
def test_qwen3_moe_lm_on_card_matches_cpu(dev):
    """qwen3-moe's smoke config (8 experts top-2, QK-norm), fp32: forward
    with its metrics, prefill and decode on the card (gmm, dense_mm,
    bs_attn) against the CPU."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels.gmm import ops as gmm_ops
    cfg = dataclasses.replace(configs.smoke("qwen3-moe-30b-a3b"),
                              dtype="float32")
    gpu = LM(cfg, device=dev, seed=0)
    cpu = LM(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    toks = np.random.default_rng(0).integers(0, 512, size=(2, 90))
    before = gmm_ops.COUNTER.launches
    got, gm = gpu.forward(toks, return_metrics=True)
    assert gmm_ops.COUNTER.launches - before == 3 * cfg.num_layers
    want, wm = cpu.forward(toks, return_metrics=True)
    assert _rel(got.cpu(), want) <= 2e-4
    assert float(gm["dropped_frac"]) == float(wm["dropped_frac"])
    logits, caches = gpu.prefill(toks[:, :80], max_len=96)
    for pos in range(80, 90):
        logits, caches = gpu.decode_step(toks[:, pos:pos + 1], caches,
                                         np.asarray([pos, pos]))
    cl, cc = cpu.prefill(toks[:, :80], max_len=96)
    for pos in range(80, 90):
        cl, cc = cpu.decode_step(toks[:, pos:pos + 1], cc,
                                 np.asarray([pos, pos]))
    assert _rel(logits.cpu(), cl) <= 2e-4


# ---------------------------------------------------------------------------
# the serving engine through CUDA graphs, against the same engine eagerly
# ---------------------------------------------------------------------------

def _serve_cfg(which):
    from repro_torch import configs
    if which == "llama-sparse":
        return configs.sparsify_ffn(configs.smoke("llama3_2_1b"), 0.25)
    if which == "gemma2":
        return configs.sparsify_ffn(configs.smoke("gemma2-2b"), 0.25)
    return configs.smoke("qwen3-moe-30b-a3b")


def _serve_stream(seed, lengths, new=4):
    from repro_torch.serve import Request
    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(0, 512, size=n),
                    max_new_tokens=new) for i, n in enumerate(lengths)]


def _serve(lm, dev, graphs, lengths, *, buckets, max_len, batch=2,
           warm_compile=True, after_warm=None):
    """Serve ``lengths`` (seeded prompts) through a fresh engine; returns
    the tokens, every call's logits, the launch counts of the run by
    counter, the run's routing drops and the engine."""
    from repro_torch.kernels import _build
    from repro_torch.serve import Engine
    eng = Engine(lm, batch=batch, max_len=max_len, device=dev,
                 buckets=buckets, graphs=graphs, warm_compile=warm_compile)
    if after_warm is not None:
        after_warm(eng)
    seen = []
    read = eng._read

    def keep(out_logits):
        seen.append(out_logits[1].clone())
        return read(out_logits)

    eng._read = keep
    reqs = _serve_stream(7, lengths)
    torch.cuda.synchronize()
    sparse.reset_telemetry()
    before = _build.launch_counts()
    eng.run(reqs)
    torch.cuda.synchronize()
    launches = [a - b for a, b in zip(_build.launch_counts(), before)]
    return ([r.output for r in reqs], seen, launches,
            sparse.dropped_history("moe_dispatch"), eng)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["llama-sparse", "gemma2", "qwen3"])
def test_engine_graphs_match_eager(dev, which):
    """A mixed-length stream over three buckets after ``warm_compile``:
    one capture per bucket and one for decode, none and no plan or
    decision while serving; tokens, every call's logits (bit for bit),
    the launch counters (by kernel and walk) and the MoE routing drops
    (count and values) equal to the same engine run eagerly."""
    lm = LM(_serve_cfg(which), device=dev, seed=0)
    lengths = [5, 20, 9, 40, 3, 33]
    kw = dict(buckets=(8, 24, 48), max_len=64)
    want = _serve(lm, dev, False, lengths, **kw)
    stats = {}

    def mark(eng):
        stats["graphs"] = eng.stats()["graphs"]
        stats["plans"] = sparse.cache_stats()

    got = _serve(lm, dev, True, lengths, after_warm=mark, **kw)
    eng = got[4]
    assert stats["graphs"]["captures"] == len(eng.buckets) + 1
    g = eng.stats()["graphs"]
    assert g["captures"] == stats["graphs"]["captures"]
    assert all(v["captures"] == 1 for v in g["prefill"].values())
    assert g["decode"]["captures"] == 1 and g["decode"]["replays"] > 0
    now = sparse.cache_stats()
    for key in ("plans_built", "decisions"):
        assert now[key] == stats["plans"][key], key
    assert {r for r in eng.stats()["buckets"]
            if eng.stats()["buckets"][r]["prefills"]} == {8, 24, 48}
    assert got[0] == want[0]
    assert len(got[1]) == len(want[1])
    for a, b in zip(got[1], want[1]):
        assert torch.equal(a, b)
    assert got[2] == want[2]
    assert sum(got[2]) > 0
    assert got[3] == want[3]
    if which == "qwen3":
        assert len(got[3]) == lm.cfg.num_layers * len(got[1])
    assert eng.stats()["logits"]["nonfinite"] == 0


@pytest.mark.cuda
def test_engine_graphs_capture_on_first_use(dev):
    """Without ``warm_compile`` a bucket's prefill graph is captured at
    its first use and the decode graph at the first step; the tokens
    equal eager's."""
    lm = LM(_serve_cfg("llama-sparse"), device=dev, seed=0)
    kw = dict(buckets=(8, 24, 48), max_len=64, warm_compile=False)
    want = _serve(lm, dev, False, [5, 20, 6], **kw)
    got = _serve(lm, dev, True, [5, 20, 6], **kw)
    g = got[4].stats()["graphs"]
    # the startup pass ran every bucket's prefill eagerly: only the two
    # buckets the stream used were captured
    assert {L: v["captures"] for L, v in g["prefill"].items()} == {
        8: 1, 24: 1, 48: 0, 63: 0}
    assert g["decode"]["captures"] == 1
    assert got[0] == want[0]


@pytest.mark.cuda
def test_engine_graphs_keep_their_walks(dev):
    """gemma2 (a local and a global walk per bucket) on a ladder of six
    buckets: twelve walks overflow the walk cache (8), and the cache and
    the plan cache are then emptied and the freed memory written over;
    replaying every captured graph still gives eager's tokens."""
    from repro_torch.models import attention
    lm = LM(_serve_cfg("gemma2"), device=dev, seed=0)
    lengths = [5, 20, 40, 70, 100, 150, 7]
    kw = dict(buckets=(16, 32, 48, 80, 112, 159), max_len=160)

    def scrub(eng):
        attention._device_walk.cache_clear()
        attention.causal_block_mask.cache_clear()
        sparse.reset()
        import gc
        gc.collect()
        torch.cuda.empty_cache()
        junk = torch.full((64 << 20,), -7, dtype=torch.int32, device=dev)
        del junk

    want = _serve(lm, dev, False, lengths, **kw)
    got = _serve(lm, dev, True, lengths, after_warm=scrub, **kw)
    assert got[4].stats()["graphs"]["captures"] == 7
    assert got[0] == want[0]
    for a, b in zip(got[1], want[1]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_program_capture_failure_raises(dev):
    """A body that reads the device on the host cannot be captured: the
    capture raises, and the launch counters are left as they were."""
    from repro_torch.kernels import _build
    from repro_torch.serve.graphs import Program

    def body(io):
        return io + int(io.sum().item())

    prog = Program("sync", body, 4, device=dev, graph=True,
                   ctx=sparse.PlanContext())
    before = _build.launch_counts()
    with pytest.raises(RuntimeError, match="CUDA graph"):
        prog()
    assert _build.launch_counts() == before
