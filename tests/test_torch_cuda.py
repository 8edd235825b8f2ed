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
    plan = sparse.plan(bsr, n, device=dev,
                       ctx=sparse.PlanContext(mode="static"))
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
    plan = sparse.plan(bsr, n, device=dev,
                       ctx=sparse.PlanContext(mode="static"))
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
    plan = sparse.plan(bsr, n, device=dev,
                       ctx=sparse.PlanContext(mode="static"))
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
    plan = sparse.plan(bsr, n, device=dev,
                       ctx=sparse.PlanContext(mode="static"))
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
    """The smoke config with a sparse FFN, fp32: the card (its kernels)
    against the CPU (their plain versions) on the same weights.  The FFN
    plans race their routes (the same verdicts on both devices): each
    launches the kernel of the route it won."""
    from repro_torch import configs
    from repro_torch.core.sparse_layers import SparseLinear
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
    want = cpu.forward(toks)

    def routes(lm):
        return [p.route.rsplit("_", 1)[0] for m in lm.modules()
                if isinstance(m, SparseLinear) for p in m._plans.values()]
    ffn = routes(gpu)
    assert len(ffn) == 2 * 3 and ffn == routes(cpu)
    assert set(ffn) <= {"static", "dense"}
    assert bsmm_ops.COUNTER.launches - b0 == ffn.count("static")
    assert dmm_ops.COUNTER.launches - d0 == 2 * 4 + ffn.count("dense")
    assert _rel(got.cpu(), want) <= 2e-4


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
    # the bsmm and sddmm routes named (the race may price another)
    with sparse.use_ctx(sparse.PlanContext(mode="static",
                                           grad_mode="static",
                                           sddmm_mode="sddmm_grouped")):
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


# every backward route a static plan's race can pick: dL/dx as each
# static-admissible family on the transposed problem, dL/dvalues as the
# block SDDMM or the dense product and a gather
GRAD_DX = ("static", "static_balanced", "dense", "dynamic",
           "dynamic_grouped", "dynamic_grouped_balanced")
GRAD_DV = ("sddmm_grouped", "sddmm_dense")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sddmm_mode", GRAD_DV)
@pytest.mark.parametrize("grad_mode", GRAD_DX)
def test_backward_routes_on_card_match_plain(dev, dtype, grad_mode,
                                             sddmm_mode):
    """One autograd step of a SparseLinear with each backward route
    forced (dL/dx through a forward plan of W^T on another family,
    dL/dvalues through dense_mm and a gather) against core/static_sparse's
    plain formulation on the same card tensors; the route's kernel
    launches."""
    from repro_torch.core import static_sparse
    from repro_torch.core.sparse_layers import SparseLinear
    from repro_torch.kernels import bsmm, dsmm
    from repro_torch.kernels.sddmm import ops as sddmm_ops
    d_in, d_out, b, n = 512, 1024, 16, 300
    layer = SparseLinear.random_pattern(d_in, d_out, b, 0.125, seed=5,
                                        dtype=dtype, device=dev)
    layer.reset_parameters(torch.Generator(device=dev).manual_seed(0))
    layer.requires_grad_(True)
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((n, d_in), generator=g, device=dev).to(dtype)
    gy = torch.randn((n, d_out), generator=g, device=dev).to(dtype)
    x.requires_grad_(True)
    dx_counter = {"static": bsmm.COUNTER,
                  "static_balanced": bsmm.BALANCED_COUNTER,
                  "dense": dmm_ops.COUNTER}.get(grad_mode, dsmm.COUNTER)
    dv_counter = (sddmm_ops.COUNTER if sddmm_mode == "sddmm_grouped"
                  else dmm_ops.COUNTER)
    c0 = {id(c): c.launches for c in (dx_counter, dv_counter)}
    ctx = sparse.PlanContext(mode="static", grad_mode=grad_mode,
                             sddmm_mode=sddmm_mode)
    with sparse.use_ctx(ctx):
        layer(x).backward(gy)
        p = layer.plan(n)
    torch.cuda.synchronize()
    assert p.grad_routes == {
        "dx": grad_mode + "_cuda",
        "dvalues": ("sddmm" if sddmm_mode == "sddmm_grouped"
                    else "sddmm_dense") + "_cuda"}
    assert dx_counter.launches > c0[id(dx_counter)]
    assert dv_counter.launches > c0[id(dv_counter)]
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
    # the backward's routes named too: dL/dx on bsmm, dL/dvalues on sddmm
    plan = sparse.plan(bsr, n, device=dev, ctx=sparse.PlanContext(
        mode=mode, grad_mode="static", sddmm_mode="sddmm_grouped"))
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
                                    dtype=dtype, backend="pallas",
                                    device=d)
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
@pytest.mark.parametrize("dh", [32, 64, 128, 192, 256])
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


# non-causal attention: (S, Skv, heads, kv heads, batch, tile): the
# encoder's T x T (tiles of 512, 64-row blocks, every chunk full), cross
# attention of a prompt that is not a multiple of 64 over 1024 frames
# (one q tile of 300: the last block's rows past S are TMA zero fill;
# and at the smoke configs' tiles of 64, which halve to 4 and group 16 q
# tiles a block, the last group padded past S), decode's single row,
# and tiles that halve into a group walk
NONCAUSAL_CASES = [
    (1024, 1024, 16, 16, 2, 512),
    (300, 1024, 16, 16, 4, 512),
    (300, 1024, 16, 16, 4, 64),
    (1, 1024, 16, 16, 4, 512),
    (1, 1024, 14, 2, 3, 512),
    (301, 1024, 14, 2, 2, 512),
    (96, 160, 4, 2, 2, 64),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", NONCAUSAL_CASES)
def test_bs_attn_non_causal_matches_plain(dev, dtype, case):
    """``attend_train(causal=False)`` on the kernel at S = Skv, S != Skv
    (S not a multiple of 64) and S = 1, MHA and GQA, against the plain
    version; each launch on its dtype's walk."""
    from repro_torch.kernels.bs_attn import ops as bs_ops
    from repro_torch.kernels.bs_attn.ref import attend_plain
    from repro_torch.models import attention
    s, skv, h, kvh, b_, tile = case
    g = torch.Generator(device=dev).manual_seed(s + skv + h)
    q = torch.randn((b_, s, h, 64), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((b_, skv, kvh, 64), generator=g, device=dev
                        ).to(dtype) for _ in range(2))
    counter = bs_ops.WALK_COUNTERS[bs_ops.kernel_walk(dtype)]
    before = counter.launches
    got = attention.attend_train(q, k, v, causal=False, tile_q=tile,
                                 tile_kv=tile)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    spec = attention.attn_spec(s, skv, 64, causal=False, tile_q=tile,
                               tile_kv=tile)
    want = attend_plain(q, k, v, spec.element_mask(dev), scale=spec.scale)
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= TOL[dtype]
    # rows of one batch row do not leak into another: each row alone
    one = attention.attend_train(q[-1:], k[-1:], v[-1:], causal=False,
                                 tile_q=tile, tile_kv=tile)
    assert torch.equal(one, got[-1:])


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


# MLA's q.k head dim (DeepSeek-V2: 128 nope + 64 rope, v padded from 128)
# at deepseek-v2-lite's 16 heads, at its served and trained lengths
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("s", [512, 1008])
def test_bs_attn_walks_agree_at_dh_192(dev, dtype, s):
    """Both walks at dh 192 against the plain version on the same 16-bit
    inputs (v's last 64 columns zero, as MLA pads it), causal; each
    walk's counter."""
    from repro_torch.kernels.bs_attn import ops as bs_ops
    from repro_torch.kernels.bs_attn.ref import attend_plain
    from repro_torch.models import attention
    h, dh = 16, 192
    g = torch.Generator(device=dev).manual_seed(s)
    q, k = (torch.randn((1, s, h, dh), generator=g, device=dev).to(dtype)
            for _ in range(2))
    v = torch.nn.functional.pad(
        torch.randn((1, s, h, 128), generator=g, device=dev), (0, 64)
    ).to(dtype)
    spec = attention.attn_spec(s, s, dh, scale=1 / np.sqrt(dh))
    walk = spec.walk(dev)
    want = attend_plain(q, k, v, spec.element_mask(dev), scale=spec.scale)
    for name in bs_ops.WALKS:
        before = bs_ops.WALK_COUNTERS[name].launches
        got = bs_ops.bs_attn_cuda(q, k, v, walk, scale=spec.scale,
                                  plan=name)
        torch.cuda.synchronize()
        assert bs_ops.WALK_COUNTERS[name].launches == before + 1
        assert torch.isfinite(got).all()
        assert _rel(got, want) <= TOL[dtype], name
        assert not got[..., 128:].any()


# the full configs' GQA groups: qwen2-1.5b 12 heads over 2 kv heads,
# glm4-9b 32 over 2 (groups that are not a power of two and 16)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("heads", [12, 32])
@pytest.mark.parametrize("s", [512, 1008])
def test_bs_attn_gqa_groups_match_plain(dev, dtype, heads, s):
    from repro_torch.kernels.bs_attn import ops as bs_ops
    from repro_torch.kernels.bs_attn.ref import attend_plain
    from repro_torch.models import attention
    g = torch.Generator(device=dev).manual_seed(heads + s)
    q = torch.randn((2, s, heads, 128), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((2, s, 2, 128), generator=g, device=dev).to(dtype)
            for _ in range(2))
    counter = bs_ops.WALK_COUNTERS[bs_ops.kernel_walk(dtype)]
    before = counter.launches
    got = attention.attend_train(q, k, v)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    spec = attention.attn_spec(s, s, 128)
    want = attend_plain(q, k, v, spec.element_mask(dev), scale=spec.scale)
    assert _rel(got, want) <= TOL[dtype]


def _mla_card_cfg(dtype="bfloat16", q_lora=None):
    """deepseek-v2-lite's smoke config (one dense layer, two MoE layers)
    at MLA's full head geometry (qk_nope 128, qk_rope 64, v 128,
    kv_lora_rank 512, so bs_attn runs at dh 192) and a narrow d_model:
    the smoke config's dh of 48 is not a kernel head dim."""
    import dataclasses

    from repro_torch import configs
    return dataclasses.replace(
        configs.smoke("deepseek-v2-lite-16b"), dtype=dtype, d_model=256,
        head_dim=192, kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
        v_head_dim=128, q_lora_rank=q_lora)


# MLA on the card against its CPU run: fp32 within the model budget of the
# qwen3 test above; bf16 within the repo's bf16 model budget
# (tests/conftest.py GRAD_TOLS: projections, attention and wo each round)
MLA_TOL = {torch.float32: 2e-4, torch.bfloat16: 6e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q_lora", [None, 96])
def test_mla_on_card_matches_cpu(dev, dtype, q_lora):
    """The ``MLA`` module's prefill (bs_attn at dh 192, dense_mm) and
    three absorbed-latent decode steps on the card against the same
    module on the CPU (plain versions), outputs and caches."""
    from repro_torch.kernels.bs_attn import ops as bs_ops
    from repro_torch.models.attention import MLA
    name = "float32" if dtype == torch.float32 else "bfloat16"
    cfg = _mla_card_cfg(name, q_lora)
    gen = torch.Generator().manual_seed(3)
    cpu = MLA(cfg, dtype=dtype, device="cpu")
    for mod in cpu.modules():
        if mod is not cpu and hasattr(mod, "reset_parameters"):
            mod.reset_parameters(gen)
    gpu = MLA(cfg, dtype=dtype, device=dev)
    gpu.load_state_dict({k: v.to(dev) for k, v in cpu.state_dict().items()})
    s, max_len = 200, 256
    x = (torch.randn((2, s, 256), generator=gen) * 0.5).to(dtype)
    pos = torch.arange(s)[None, :]
    counter = bs_ops.WALK_COUNTERS[bs_ops.kernel_walk(dtype)]
    before = counter.launches
    with torch.no_grad():
        yg, cg = gpu.prefill(x.to(dev), pos.to(dev), max_len=max_len)
        yc, cc = cpu.prefill(x, pos, max_len=max_len)
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        assert _rel(yg.cpu(), yc) <= MLA_TOL[dtype]
        for key in ("latent", "k_rope"):
            assert _rel(cg[key].cpu(), cc[key]) <= MLA_TOL[dtype], key
        positions = torch.tensor([s, 150])
        for step in range(3):
            xt = (torch.randn((2, 1, 256), generator=gen) * 0.5).to(dtype)
            yg, _ = gpu.decode(xt.to(dev), cg, positions.to(dev))
            yc, _ = cpu.decode(xt, cc, positions)
            assert _rel(yg.cpu(), yc) <= MLA_TOL[dtype], step
            positions = positions + 1
        assert _rel(cg["latent"].cpu(), cc["latent"]) <= MLA_TOL[dtype]


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


# batched_matmul's backward at qwen3's expert GEMMs (E 128): (C, D, F);
# C 160 is the train phase's capacity (batch 4 x seq 512: row tile 80 in
# 16-bit), C 8 the decode capacity
BMM_GRAD_CASES = [(160, 2048, 768), (160, 768, 2048), (8, 2048, 768)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", BMM_GRAD_CASES)
def test_batched_matmul_backward_matches_plain(dev, dtype, case):
    """``_BatchedMatmulFn`` against ``torch.matmul``'s autograd in fp32 on
    the same inputs: the forward and dL/da are gmm launches (dL/da on
    b^T, one launch, on the forward's walk), dL/db ``torch.bmm``."""
    from repro_torch.kernels.gmm import ops as gmm_ops
    from repro_torch.sparse.plan import batched_row_tile
    c, d, f = case
    e = 128
    g = torch.Generator(device=dev).manual_seed(c + d)
    a = torch.randn((e, c, d), generator=g, device=dev).to(dtype)
    b = (torch.randn((e, d, f), generator=g, device=dev)
         / np.sqrt(d)).to(dtype)
    gy = torch.randn((e, c, f), generator=g, device=dev).to(dtype)
    tm = batched_row_tile(c, gmm_ops.tma_ok(d, f, dtype))
    if c == 160 and dtype != torch.float32:
        assert tm == 80
    walk = gmm_ops.walk(tm, d, f, dtype).name
    assert walk == gmm_ops.walk(tm, f, d, dtype).name
    assert walk == ("ffma" if dtype == torch.float32 else "wgmma")
    ta, tb = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    before = gmm_ops.WALK_COUNTERS[walk].launches
    y = sparse.batched_matmul(ta, tb)
    assert gmm_ops.WALK_COUNTERS[walk].launches == before + 1
    y.backward(gy)
    torch.cuda.synchronize()
    assert gmm_ops.WALK_COUNTERS[walk].launches == before + 2
    ra = a.float().requires_grad_(True)
    rb = b.float().requires_grad_(True)
    want = torch.matmul(ra, rb)
    want.backward(gy.float())
    assert y.dtype == ta.grad.dtype == tb.grad.dtype == dtype
    assert _rel(y, want) <= TOL[dtype]
    assert _rel(ta.grad, ra.grad) <= TOL[dtype]
    assert _rel(tb.grad, rb.grad) <= TOL[dtype]
    p = sparse.plan(sparse.OpSpec(kind="dense", m=c, k=d, n=f, dtype=dtype,
                                  op="batched_matmul"), device=dev)
    assert p.row_tile == tm
    assert sparse.plan_report()["per_plan"][p.key]["grad"]["dx"] == {
        "route": "gmm_cuda", "source": "forced"}


@pytest.mark.cuda
def test_moe_layer_grads_gmm_match_plain(dev):
    """One full-width qwen3 MoE layer (d 2048, 128 experts top-8, d_ff
    768, bf16) on 2048 tokens (C 160): every parameter's and the input's
    gradient through the gmm path against the plain path (the three
    expert products by ``torch.matmul`` in fp32 on the same bf16
    inputs), both under the same fp32 routing."""
    from repro_torch import configs
    from repro_torch.kernels.gmm import ops as gmm_ops
    from repro_torch.models import moe as moe_lib
    cfg = configs.get("qwen3-moe-30b-a3b")
    mod = moe_lib.moe_init(cfg, dtype=torch.bfloat16, device=dev, seed=3)
    mod.requires_grad_(True)
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((4, 512, cfg.d_model), generator=g,
                    device=dev).to(torch.bfloat16)
    gy = torch.randn(x.shape, generator=g, device=dev).to(torch.bfloat16)
    named = list(mod.named_parameters())

    def grads():
        xx = x.clone().requires_grad_(True)
        y, m = moe_lib.moe_apply(mod, cfg, xx)
        loss = (y.float() * gy.float()).sum() + 0.01 * m.aux_loss
        return [y] + list(torch.autograd.grad(
            loss, [xx] + [p for _, p in named])), float(m.dropped_frac)

    before = gmm_ops.COUNTER.launches
    got, drop = grads()
    assert gmm_ops.COUNTER.launches - before == 6
    kernel_bmm = sparse.batched_matmul
    sparse.batched_matmul = lambda a, b: torch.matmul(
        a.float(), b.float()).to(a.dtype)
    try:
        want, drop_plain = grads()
    finally:
        sparse.batched_matmul = kernel_bmm
    assert drop == drop_plain
    for name, a, b in zip(["y", "x"] + [n for n, _ in named], got, want):
        assert _rel(a, b) <= TOL[torch.bfloat16], name


@pytest.mark.cuda
def test_engine_graphs_match_eager_after_training(dev):
    """A training step on the MoE smoke model (the expert GEMMs' planned
    backward on gmm), then the engine's graphs against the same engine
    eagerly: the plans the step used are the ones the engine serves
    with, and tokens, logits and drops stay equal."""
    from repro_torch.data import TokenPipeline
    from repro_torch.train.step import (TrainHParams, init_train_state,
                                        make_train_step)
    lm = LM(_serve_cfg("qwen3"), device=dev, seed=0)
    hp = TrainHParams(peak_lr=1e-3, warmup_steps=0, total_steps=10)
    state = init_train_state(lm, hp=hp)
    state, metrics = make_train_step(lm, hp)(
        state, TokenPipeline(512, 2, 40).get_batch(0))
    assert np.isfinite(float(metrics["loss"]))
    lm.requires_grad_(False)
    assert any(r["op"] == "batched_matmul"
               and r["grad"].get("dx", {}).get("route") == "gmm_cuda"
               for r in sparse.plan_report()["per_plan"].values())
    lengths = [5, 20, 9, 40]
    kw = dict(buckets=(8, 24, 48), max_len=64)
    want = _serve(lm, dev, False, lengths, **kw)
    got = _serve(lm, dev, True, lengths, **kw)
    assert got[0] == want[0]
    for a, b in zip(got[1], want[1]):
        assert torch.equal(a, b)
    assert got[2] == want[2] and got[3] == want[3]


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
    if which == "deepseek":
        return _mla_card_cfg()
    if which in ("mamba2", "jamba", "seamless", "internvl2"):
        return configs.smoke({"mamba2": "mamba2-130m",
                              "jamba": "jamba-v0.1-52b",
                              "seamless": "seamless-m4t-medium",
                              "internvl2": "internvl2-1b"}[which])
    return configs.smoke("qwen3-moe-30b-a3b")


def _serve_stream(seed, lengths, new=4):
    from repro_torch.serve import Request
    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(0, 512, size=n),
                    max_new_tokens=new) for i, n in enumerate(lengths)]


def _serve(lm, dev, graphs, lengths, *, buckets, max_len, batch=2,
           warm_compile=True, after_warm=None, mesh=None):
    """Serve ``lengths`` (seeded prompts) through a fresh engine; returns
    the tokens, every call's logits, the launch counts of the run by
    counter, the run's routing drops and the engine."""
    from repro_torch.kernels import _build
    from repro_torch.serve import Engine
    eng = Engine(lm, batch=batch, max_len=max_len, device=dev,
                 buckets=buckets, graphs=graphs, warm_compile=warm_compile,
                 mesh=mesh)
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
@pytest.mark.parametrize("which", ["llama-sparse", "gemma2", "qwen3",
                                   "deepseek"])
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
    if which in ("qwen3", "deepseek"):
        moe_layers = sum(layer.moe for layer in lm.layers)
        assert len(got[3]) == moe_layers * len(got[1])
    if which == "deepseek":
        assert all(set(c) == {"latent", "k_rope"} for c in eng.caches)
    assert eng.stats()["logits"]["nonfinite"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["mamba2", "jamba"])
def test_engine_graphs_match_eager_exact_length(dev, which):
    """A stack with mamba layers: no buckets, every prompt prefilled
    eagerly at its exact length (odd lengths: SSD chunks of 1), the
    decode step one captured graph; tokens, every call's logits (bit
    for bit), the launch counters and jamba's routing drops equal to the
    same engine run eagerly."""
    lm = LM(_serve_cfg(which), device=dev, seed=0)
    lengths = [5, 20, 9, 40, 3, 33]
    kw = dict(buckets=None, max_len=64)
    want = _serve(lm, dev, False, lengths, **kw)
    got = _serve(lm, dev, True, lengths, **kw)
    eng = got[4]
    assert eng.buckets == ()
    st = eng.stats()
    assert st["admission"]["exact_prefills"] == len(lengths)
    assert st["graphs"]["captures"] == 1
    assert st["graphs"]["decode"]["replays"] > 0
    assert got[0] == want[0]
    assert len(got[1]) == len(want[1])
    for a, b in zip(got[1], want[1]):
        assert torch.equal(a, b)
    assert got[2] == want[2] and sum(got[2]) > 0
    assert got[3] == want[3]
    kinds = [frozenset(c) for c in eng.caches]
    assert frozenset({"state", "conv"}) in kinds
    assert set(kinds) <= {frozenset({"state", "conv"}),
                          frozenset({"k", "v"})}
    assert st["logits"]["nonfinite"] == 0


@pytest.mark.cuda
def test_ssm_decode_graph_updates_the_cache_in_place(dev):
    """mamba2's decode step replayed from its graph writes the SSM
    state and conv history into the engine's own cache tensors (the
    same storage before and after), step for step equal to the eager
    engine's caches, bit for bit."""
    from repro_torch.serve import Engine, Request
    lm = LM(_serve_cfg("mamba2"), device=dev, seed=0)
    prompt = np.random.default_rng(3).integers(0, 512, size=11)
    engines = [Engine(lm, batch=2, max_len=64, device=dev, graphs=g,
                      warm_compile=True) for g in (False, True)]
    ptrs = [(c["state"].data_ptr(), c["conv"].data_ptr())
            for c in engines[1].caches]
    for eng in engines:
        eng.admit(Request(uid=0, prompt=prompt, max_new_tokens=8))
    for _ in range(3):
        before = [c["state"].clone() for c in engines[1].caches]
        for eng in engines:
            eng.step()
        torch.cuda.synchronize()
        for a, b, old in zip(engines[0].caches, engines[1].caches, before):
            assert torch.equal(a["state"], b["state"])
            assert torch.equal(a["conv"], b["conv"])
            assert not torch.equal(b["state"], old)
    assert ptrs == [(c["state"].data_ptr(), c["conv"].data_ptr())
                    for c in engines[1].caches]
    assert engines[1].stats()["graphs"]["decode"]["replays"] == 3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,k,d", [(4, 768, 3352), (900, 768, 3352),
                                   (512 * 4, 768, 3352), (4, 4096, 16544),
                                   (899, 4096, 16544), (4, 1536, 768),
                                   (4, 8192, 4096)])
def test_dense_mm_matches_plain_at_ssd_projections(dev, dtype, n, k, d):
    """The SSD in/out projections of mamba2-130m (768 -> 3352, 1536 ->
    768) and jamba-v0.1 (4096 -> 16544, 8192 -> 4096) at decode, an odd
    exact prefill and the train batch: widths that are not a multiple
    of the kernel's tiles (3352 = 26 x 128 + 24)."""
    g = torch.Generator(device=dev).manual_seed(n + d)
    x = torch.randn((n, k), generator=g, device=dev).to(dtype)
    w = (torch.randn((k, d), generator=g, device=dev)
         / k ** 0.5).to(dtype)
    wk = dmm_ops.walk(n, k, d, dtype)
    before = dmm_ops.WALK_COUNTERS[wk.name].launches
    got = dmm_ops.dense_mm(x, w)
    torch.cuda.synchronize()
    assert dmm_ops.WALK_COUNTERS[wk.name].launches == before + 1
    if dtype != torch.float32:
        assert wk.name in ("wgmma", "decode")
    assert _rel(got, dmm_ops.dense_mm_plain(x, w)) <= TOL[dtype]


@pytest.mark.cuda
def test_train_graph_matches_eager_on_mamba2(dev):
    """mamba2's smoke config (SSD layers, no FFN), five steps replayed
    from the captured step against five eager ones, bit for bit."""
    want = _train_run(dev, "mamba2", False, 5, seq=64)
    got = _train_run(dev, "mamba2", True, 5, seq=64)
    st = got["prog"].program.stats()
    assert st["captures"] == 1 and st["recaptures"] == 0
    _same_run(got, want)


@pytest.mark.cuda
def test_train_graph_matches_eager_on_seamless(dev):
    """seamless's smoke config (2 encoder + 2 decoder layers with cross
    attention), five steps on batches that carry seeded ``enc_frames``
    (``TrainProgram``'s float buffer), replayed from the captured step
    against five eager ones, bit for bit; bs_attn launches 6 times a
    forward (2 encoder, 2 self, 2 cross), twice a step (the forward and
    its recompute under ``remat="full"``).  After each step the float
    buffer holds that step's frames in the model's dtype."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.bs_attn import ops as bs_ops

    def frames_landed(i, prog):
        torch.cuda.synchronize()
        cfg = prog.lm.cfg
        fio = prog.program.fio.view(2, cfg.frontend_len, cfg.d_model)
        frames = np.random.default_rng(i).standard_normal(
            tuple(fio.shape)).astype(np.float32)
        assert torch.equal(fio, torch.as_tensor(frames).to(dev, fio.dtype)), i

    want = _train_run(dev, "seamless", False, 5, seq=64,
                      between=frames_landed)
    got = _train_run(dev, "seamless", True, 5, seq=64,
                     between=frames_landed)
    st = got["prog"].program.stats()
    assert st["captures"] == 1 and st["recaptures"] == 0
    _same_run(got, want)
    idx = _build.COUNTERS.index(bs_ops.COUNTER)
    assert [n[idx] for n in want["launches"]] == [2 * 6] * 5


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["seamless", "internvl2"])
def test_encdec_and_vlm_on_card_match_cpu(dev, which):
    """The smoke encoder-decoder (``enc_frames``) and VLM (``frontend``)
    in fp32 on the card against the same weights on the CPU: forward,
    then ``prefill`` and two ``decode_step``s (the VLM's at positions
    offset by its patch rows), within 2e-4."""
    import dataclasses
    cfg = dataclasses.replace(_serve_cfg(which), dtype="float32")
    cpu = LM(cfg, device="cpu", seed=3)
    card = LM(cfg, device=dev, seed=3)
    with torch.no_grad():
        for (n, a), (_, b) in zip(cpu.named_parameters(),
                                  card.named_parameters()):
            b.copy_(a)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 21))
    extra = rng.standard_normal((2, cfg.frontend_len, cfg.d_model)).astype(
        np.float32)
    kw = ({"enc_frames": extra} if cfg.encoder_layers
          else {"frontend": extra})
    off = 0 if cfg.encoder_layers else cfg.frontend_len
    want = cpu.forward(toks, **kw)
    assert _rel(card.forward(toks, **kw).cpu(), want) <= 2e-4
    got, caches = card.prefill(toks[:, :19], max_len=off + 24, **kw)
    assert _rel(got.cpu(), want[:, 18]) <= 2e-4
    for pos in (19, 20):
        got, caches = card.decode_step(toks[:, pos:pos + 1], caches,
                                       np.asarray([off + pos] * 2))
        assert _rel(got.cpu(), want[:, pos]) <= 2e-4, pos


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
                   ctx=sparse.PlanContext(), stream=torch.cuda.Stream(dev))
    before = _build.launch_counts()
    with pytest.raises(RuntimeError, match="CUDA graph"):
        prog()
    assert _build.launch_counts() == before


# ---------------------------------------------------------------------------
# the engine's re-planner and its graph re-captures; one capture stream
# ---------------------------------------------------------------------------

def _tag_races(monkeypatch, fastest):
    """Every race's candidates timed by fixed seconds: ``fastest`` at 1
    ms, every other route at 9 ms (each candidate still runs once)."""
    import sys
    from repro_torch.core import dispatch
    plan_mod = sys.modules["repro_torch.sparse.plan"]
    runner_of = plan_mod._race_runner

    def tagged(*a, **kw):
        run = runner_of(*a, **kw)

        def runner(route):
            fn, args = run(route)

            def call(*xs):
                return fn(*xs)
            call.route = route
            return call, args
        return runner

    def times(fn, *args, windows=None, lock=None, build_lock=None):
        fn(*args)
        return 1e-3 if fn.route == fastest else 9e-3

    monkeypatch.setattr(plan_mod, "_race_runner", tagged)
    monkeypatch.setattr(dispatch, "measure_callable", times)


@pytest.mark.cuda
def test_engine_replanner_recaptures_graphs(dev, monkeypatch):
    """Under a calibration that prices static_cuda's model at 4x, "auto"
    captures the sparse FFN plans on other routes; a sweep whose timings
    put static_cuda first marks every program stale, and serving
    re-captures each one it runs before replaying it: the new graph
    holds the new plan and launches bsmm, the old plan lives until its
    graph is dropped, and the tokens and every call's logits equal a
    fresh engine's built on the measured verdicts."""
    import gc
    import weakref

    from repro_torch.core import dispatch
    from repro_torch.kernels import _build, bsmm
    from repro_torch.sparse import MatmulPlan
    lm = LM(_serve_cfg("llama-sparse"), device=dev, seed=0)
    kw = dict(buckets=(8, 24, 48), max_len=64)
    lengths = [5, 20, 9, 40, 3, 33]
    prev = dispatch.cost_coeffs()
    dispatch.set_cost_coeffs(dispatch.CostCoeffs(
        route_scale={"static_cuda": 4.0}, version=1, digest="static-x4"))
    sparse.reset()
    try:
        eng = _serve(lm, dev, True, lengths, **kw)[4]
        static = [p for p in sparse.pool_plans(eng.pool)
                  if p.kind == "static"]
        assert static and all(p.route != "static_cuda" for p in static)
        old = [(p.n, weakref.ref(p)) for p in static]
        _tag_races(monkeypatch, "static_cuda")
        assert eng.replan_once() > 0
        assert all(p.stale for p in eng.programs())
        del static
        gc.collect()
        assert all(r() is not None for _, r in old)         # held
        decode_before = dict(eng._decode.launches_per_replay())
        seen = []
        read = eng._read

        def keep(out_logits):
            seen.append(out_logits[1].clone())
            return read(out_logits)

        eng._read = keep
        reqs = _serve_stream(7, lengths)
        eng.run(reqs)
        torch.cuda.synchronize()
        ran = [p for p in eng.programs() if p.replays and not p.stale]
        assert {p.name for p in ran} == {"prefill[8]", "prefill[24]",
                                         "prefill[48]", "decode"}
        assert all(p.recaptures == 1 for p in ran)
        assert eng.stats()["replanner"]["recaptures"] == 4
        assert eng._prefills[63].stale                     # not yet run
        gc.collect()
        assert {n for n, _ in old} == {2, 8, 24, 48, 63}
        assert all((r() is None) == (n != 63) for n, r in old)
        for p in ran:
            held = [h for h in p._held.values() if isinstance(h, MatmulPlan)
                    and h.kind == "static"]
            assert held and all(h.route == "static_cuda"
                                and h.source == "measured" for h in held)
        bsmm_i = next(i for i, c in enumerate(_build.COUNTERS)
                      if c is bsmm.COUNTER)
        assert decode_before.get(bsmm_i, 0) == 0
        assert eng._decode.launches_per_replay()[bsmm_i] > 0
        monkeypatch.undo()
        # a fresh engine with the same history (the stream served once)
        fresh = _serve(lm, dev, True, lengths, **kw)[4]
        want = []
        read = fresh._read

        def keep_fresh(out_logits):
            want.append(out_logits[1].clone())
            return read(out_logits)

        fresh._read = keep_fresh
        again = _serve_stream(7, lengths)
        fresh.run(again)
        assert [r.output for r in reqs] == [r.output for r in again]
        assert len(seen) == len(want)
        for a, b in zip(seen, want):
            assert torch.equal(a, b)
    finally:
        dispatch.set_cost_coeffs(prev)
        sparse.reset()


@pytest.mark.cuda
def test_engine_captures_on_one_stream_and_memory_holds(dev, monkeypatch):
    """Every warm-up and capture of an engine runs on the one stream it
    owns (no stream is made per capture), so three more engines built,
    served and dropped leave at most one cuBLAS workspace each (32 MiB on
    sm_90, and cublasLt's) where a stream per capture pinned one per
    program."""
    import gc

    from repro_torch.serve import Engine
    lm = LM(_serve_cfg("llama-sparse"), device=dev, seed=0)
    kw = dict(batch=2, max_len=64, buckets=(8, 24, 48), device=dev,
              warm_compile=True)
    captured, made = [], []
    graph_cls, stream_cls = torch.cuda.graph, torch.cuda.Stream

    class GraphSpy(graph_cls):
        def __init__(self, g, pool=None, stream=None, **k):
            captured.append(stream)
            super().__init__(g, pool=pool, stream=stream, **k)

    def stream_spy(*a, **k):
        s = stream_cls(*a, **k)
        if k.get("stream_id") is None:       # a new stream, not a view
            made.append(s)
        return s

    monkeypatch.setattr(torch.cuda, "graph", GraphSpy)
    monkeypatch.setattr(torch.cuda, "Stream", stream_spy)

    def one():
        captured.clear()
        made.clear()
        eng = Engine(lm, **kw)
        eng.run(_serve_stream(3, [5, 20, 40]))
        torch.cuda.synchronize()
        assert len(captured) == len(eng.programs()) == 5
        assert all(s is eng._capture_stream for s in captured)
        assert made == [eng._capture_stream]
        del eng
        gc.collect()
        torch.cuda.synchronize()

    one()
    base = torch.cuda.memory_allocated(dev)
    for _ in range(3):
        one()
    grown = torch.cuda.memory_allocated(dev) - base
    assert grown <= 3 * (36 << 20), grown / 2 ** 20


# -- RigL topology updates on static plans -------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("d_in, d_out", [(2048, 8192), (8192, 2048)])
def test_evolved_plan_kernels_match_plain_at_llama_width(dev, d_in, d_out):
    """llama's FFN projections (b 16, d 1/8, bf16, N 2048) after a RigL
    step moving 20 % of the blocks (``rigl_evolve``): the evolved plan's
    forward (bsmm), dL/dx (bsmm on W^T's re-recorded schedule) and
    dL/dvalues (sddmm) on the tensor-core walks, against the plain
    formulation on the evolved pattern; no route decision."""
    from repro_torch.core import static_sparse
    from repro_torch.core.sparse_layers import SparseLinear
    from repro_torch.kernels.sddmm import ops as sddmm_ops
    from repro_torch.train.step import rigl_evolve
    dt, b, n = torch.bfloat16, 16, 2048
    layer = SparseLinear.random_pattern(d_in, d_out, b, 1 / 8, seed=1,
                                        dtype=dt, device=dev)
    layer.reset_parameters(torch.Generator(device=dev).manual_seed(0))
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((n, d_in), generator=g, device=dev).to(dt)
    gy = torch.randn((n, d_out), generator=g, device=dev).to(dt)
    with sparse.use_ctx(sparse.PlanContext(mode="static",
                                           grad_mode="static",
                                           sddmm_mode="sddmm_grouped")):
        p = layer.plan(n, x)
        s0 = sparse.cache_stats()
        p2, _ = rigl_evolve(p, layer.values.detach(), gy.float().t() @
                            x.float(), fraction=0.2, generator=g)
        ep = layer.evolve(_mask_of(p2, d_out // b, d_in // b))
        assert ep.dropped == ep.grown == int(np.float32(p.artifacts[
            "nnz_blocks"]) * np.float32(0.2))
        assert layer.plan(n) is p2
        assert sparse.cache_stats()["decisions"] == s0["decisions"]
        layer.requires_grad_(True)
        xg = x.clone().requires_grad_(True)
        walks = (bsmm_ops.WALK_COUNTERS["mma"],
                 sddmm_ops.WALK_COUNTERS["mma"])
        before = [c.launches for c in walks]
        layer(xg).backward(gy)
        torch.cuda.synchronize()
    assert [c.launches - b0 for c, b0 in zip(walks, before)] == [2, 1]
    f = static_sparse.make_spmm(layer.row_idx, layer.col_idx,
                                (d_out // b, d_in // b), b)
    v = layer.values.detach().clone().requires_grad_(True)
    xt = x.t().contiguous().requires_grad_(True)
    y_ref = f(v, xt)
    y_ref.backward(gy.t())
    with torch.no_grad():
        assert _rel(layer(x), y_ref.t()) <= TOL[dt]
    assert _rel(layer.values.grad, v.grad) <= TOL[dt]
    assert _rel(xg.grad, xt.grad.t()) <= TOL[dt]


def _mask_of(p, mb, kb):
    mask = np.zeros((mb, kb), bool)
    mask[p.pattern[0], p.pattern[1]] = True
    return mask


@pytest.mark.cuda
def test_engine_graphs_recapture_after_evolve(dev):
    """Serve through the engine's graphs, evolve the up projection of
    every layer onto one new mask, serve again: each program that runs
    is re-captured once before its replay (its graph held the superseded
    plans), the old plans are freed once no graph holds them, and the
    tokens and every call's logits equal a fresh engine's on the evolved
    model."""
    import gc
    import weakref

    from repro_torch.core.sparse_layers import SparseFFN
    lm = LM(_serve_cfg("llama-sparse"), device=dev, seed=0)
    kw = dict(buckets=(8, 24, 48), max_len=64)
    lengths = [5, 20, 9, 40, 3, 33]
    sparse.reset()
    first, _, _, _, eng = _serve(lm, dev, True, lengths, **kw)
    ffns = [m for m in lm.modules() if isinstance(m, SparseFFN)]
    up = ffns[0].up
    old = [weakref.ref(p) for p in up._plans.values()]
    new_mask = masks.random_block_mask(up.out_features, up.in_features,
                                       up.block_size, 0.25, seed=11)
    s0 = sparse.cache_stats()
    for f in ffns:
        f.up.evolve(new_mask)
    assert sparse.cache_stats()["decisions"] == s0["decisions"]
    assert all(r() is not None for r in old)          # the graphs hold them
    seen = []
    read = eng._read

    def keep(out_logits):
        seen.append(out_logits[1].clone())
        return read(out_logits)

    eng._read = keep
    reqs = _serve_stream(7, lengths)
    eng.run(reqs)
    torch.cuda.synchronize()
    ran = [p for p in eng.programs() if p.replays and not p.stale]
    assert {p.name for p in ran} == {"prefill[8]", "prefill[24]",
                                     "prefill[48]", "decode"}
    assert all(p.recaptures == 1 for p in ran)
    assert eng._prefills[63].superseded()               # not yet run
    gc.collect()
    assert sum(r() is None for r in old) == len(ran)
    got = [r.output for r in reqs]
    assert got != first
    # a fresh engine with the same history (the stream served once)
    fresh = _serve(lm, dev, True, lengths, **kw)[4]
    want = []
    read = fresh._read

    def keep_fresh(out_logits):
        want.append(out_logits[1].clone())
        return read(out_logits)

    fresh._read = keep_fresh
    again = _serve_stream(7, lengths)
    fresh.run(again)
    assert [r.output for r in again] == got
    assert len(want) == len(seen)
    for a, b in zip(seen, want):
        assert torch.equal(a, b)
    sparse.reset()


# ---------------------------------------------------------------------------
# the captured train step (train/program.py) against the same step eagerly
# ---------------------------------------------------------------------------

TRAIN_HP = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)


def _train_run(dev, which, graph, steps, *, between=None, batch=2, seq=32):
    """``steps`` steps of a ``TrainProgram`` on ``which``'s smoke config
    from seed 0: every step's loss and metrics (copied), launch counts
    and the run's MoE drops, the parameters after, and the program.
    ``between(i, program)`` runs after step ``i``."""
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import _build
    from repro_torch.train.program import TrainProgram
    from repro_torch.train.step import TrainHParams, init_train_state
    lm = LM(_serve_cfg(which), device=dev, seed=0)
    hp = TrainHParams(**TRAIN_HP)
    # an encoder-decoder's batches carry seeded frames
    frames = ((batch, lm.cfg.frontend_len, lm.cfg.d_model)
              if lm.cfg.encoder_layers else None)
    prog = TrainProgram(lm, init_train_state(lm, hp=hp), hp, batch=batch,
                        seq=seq, graph=graph,
                        floats=frames and {"enc_frames": frames})
    pipe = TokenPipeline(lm.cfg.vocab_size, batch, seq)
    torch.cuda.synchronize()
    sparse.reset_telemetry()
    out = {"losses": [], "metrics": [], "launches": []}
    for i in range(steps):
        before = _build.launch_counts()
        data = pipe.get_batch(i)
        if frames:
            data["enc_frames"] = np.random.default_rng(i).standard_normal(
                frames).astype(np.float32)
        prog.load(data)
        m = prog()
        out["metrics"].append({k: v.clone() for k, v in m.items()})
        out["losses"].append(float(m["loss"]))
        out["launches"].append([a - b for a, b in
                                zip(_build.launch_counts(), before)])
        if between is not None:
            between(i, prog)
    torch.cuda.synchronize()
    out["params"] = {n: p.detach().clone()
                     for n, p in prog.state.params.items()}
    out["drops"] = sparse.dropped_history("moe_dispatch")
    out["prog"] = prog
    return out


def _same_run(got, want):
    assert got["losses"] == want["losses"]
    for a, b in zip(got["metrics"], want["metrics"]):
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert set(got["params"]) == set(want["params"])
    for n, p in want["params"].items():
        assert torch.equal(got["params"][n], p), n
    assert got["launches"] == want["launches"]
    assert got["drops"] == want["drops"]


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["llama-sparse", "qwen3", "deepseek"])
def test_train_graph_matches_eager(dev, which):
    """Five steps replayed from one captured graph (forward, backward,
    clip, AdamW) against five eager steps from the same seed: losses,
    every metric and the parameters after, bit for bit; the launches of
    every step, by counter (the first step is the capture's warm-up, the
    others replays); the MoE routing drops, once per layer per step."""
    want = _train_run(dev, which, False, 5)
    got = _train_run(dev, which, True, 5)
    st = got["prog"].program.stats()
    assert st["captures"] == 1 and st["recaptures"] == 0
    assert st["replays"] == 4 and st["launches_per_replay"] > 0
    _same_run(got, want)
    if which in ("qwen3", "deepseek"):
        moe_layers = sum(layer.moe for layer in got["prog"].lm.layers)
        assert len(got["drops"]) == 5 * moe_layers
    assert int(got["prog"].state.step) == 5
    assert int(got["prog"].state.opt.count) == 5


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["llama-sparse", "qwen3"])
def test_train_graph_replay_makes_no_host_sync(dev, which):
    """A replayed train step (the batch loaded before) runs under
    ``set_sync_debug_mode("error")``: no synchronising call."""
    from repro_torch.data import TokenPipeline
    from repro_torch.train.program import TrainProgram
    from repro_torch.train.step import TrainHParams, init_train_state
    lm = LM(_serve_cfg(which), device=dev, seed=0)
    hp = TrainHParams(**TRAIN_HP)
    prog = TrainProgram(lm, init_train_state(lm, hp=hp), hp, batch=2,
                        seq=32, graph=True)
    pipe = TokenPipeline(lm.cfg.vocab_size, 2, 32)
    for i in range(3):
        prog.load(pipe.get_batch(i))
        if i == 2:
            torch.cuda.set_sync_debug_mode("error")
        try:
            m = prog()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert prog.program.stats()["replays"] == 2
    assert np.isfinite(float(m["loss"]))


def _evolve_up0(i, prog, at=2):
    """After step ``at``: layer 0's up projection onto a seeded pattern of
    the same block count (a fifth of its blocks moved)."""
    from repro_torch.train.step import evolve_sparse_layer
    if i != at:
        return
    up = prog.lm.layers[0].ffn.up
    rng = np.random.default_rng(5)
    mask = up.pattern.copy()
    on, off = np.flatnonzero(mask), np.flatnonzero(~mask)
    k = max(1, on.size // 5)
    flat = mask.reshape(-1)
    flat[rng.choice(on, k, replace=False)] = False
    flat[rng.choice(off, k, replace=False)] = True
    evolve_sparse_layer(prog.state, "layers.0.ffn.up.values", up, mask)


@pytest.mark.cuda
def test_train_graph_recaptures_once_after_evolve(dev):
    """Three steps, a topology step on layer 0's up projection (constant
    block count), two more: the graph is captured again exactly once,
    before the step after the topology step, and every step equals the
    same run eagerly."""
    want = _train_run(dev, "llama-sparse", False, 5, between=_evolve_up0)
    got = _train_run(dev, "llama-sparse", True, 5, between=_evolve_up0)
    st = got["prog"].program.stats()
    assert st["captures"] == 2 and st["recaptures"] == 1
    assert st["replays"] == 3
    _same_run(got, want)


@pytest.mark.cuda
def test_train_graph_reads_a_restored_state(dev):
    """A captured program trains steps 0-3; the state after step 1,
    saved, is restored into its tensors (``load_state_tree``) and steps
    2-3 replayed again: no re-capture, and the same losses and
    parameters as the first time and as the eager run."""
    from repro_torch.data import TokenPipeline
    from repro_torch.train.step import load_state_tree, state_tree
    want = _train_run(dev, "llama-sparse", False, 4)
    snap = {}

    def keep(i, prog):
        if i == 1:
            snap["tree"] = {k: (v.detach().cpu().clone() if isinstance(
                v, torch.Tensor) else v) for k, v in _flat(
                    state_tree(prog.state)).items()}

    got = _train_run(dev, "llama-sparse", True, 4, between=keep)
    _same_run(got, want)
    prog = got["prog"]
    load_state_tree(prog.state, _unflat(snap["tree"]))
    assert int(prog.state.step) == int(prog.state.opt.count) == 2
    pipe = TokenPipeline(prog.lm.cfg.vocab_size, 2, 32)
    again = []
    for i in (2, 3):
        prog.load(pipe.get_batch(i))
        again.append(float(prog()["loss"]))
    assert again == want["losses"][2:]
    assert prog.program.stats()["captures"] == 1
    for n, p in want["params"].items():
        assert torch.equal(prog.state.params[n], p), n


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _unflat(flat):
    tree = {}
    for key, v in flat.items():
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


@pytest.mark.cuda
def test_train_backward_runs_off_the_capture_thread(dev, monkeypatch):
    """On a card autograd runs the backward on its own device thread: a
    capture record, and the caller's ``use_ctx`` context, are not seen
    there.  So the bs_attn backward's element mask is looked up and held
    in the forward, on the caller's thread, and the backward makes no
    plan: nothing it reads depends on the thread-local state."""
    import threading

    from repro_torch.core import capture
    from repro_torch.data import TokenPipeline
    from repro_torch.models import attention
    from repro_torch.train.step import (TrainHParams, init_train_state,
                                        make_train_step)
    lm = LM(_serve_cfg("llama-sparse"), device=dev, seed=0)
    hp = TrainHParams(**TRAIN_HP)
    state = init_train_state(lm, hp=hp)
    fn = make_train_step(lm, hp)
    batch = TokenPipeline(lm.cfg.vocab_size, 2, 32).get_batch(0)
    fn(state, batch)                                # plans built
    seen = []
    plain = attention.attend_plain

    def probe(*args, **kwargs):
        seen.append((threading.get_ident(), capture.active(),
                     sparse.current_ctx().pool))
        return plain(*args, **kwargs)

    monkeypatch.setattr(attention, "attend_plain", probe)
    ctx = sparse.PlanContext(pool="train-probe")
    before = sparse.cache_stats()
    with sparse.use_ctx(ctx), capture.recording() as rec:
        fn(state, batch)
    torch.cuda.synchronize()
    assert seen, "the bs_attn backward recomputes with attend_plain"
    main = threading.get_ident()
    assert all(t != main and r is None and pool is None
               for t, r, pool in seen)
    masks_held = [o for o in rec.held.values()
                  if isinstance(o, torch.Tensor) and o.dtype == torch.bool
                  and o.shape == (32, 32)]
    assert masks_held
    after = sparse.cache_stats()
    for key in ("plans_built", "decisions"):
        assert after[key] == before[key], key


@pytest.mark.cuda
def test_train_capture_shares_a_stream_and_collects_cycles(dev):
    """Two train programs on one card capture on one stream (cuBLAS pins
    a workspace per stream), and a capture collects reference cycles
    before it empties the allocator's cache, so a tensor that only a
    cycle keeps does not hold its segment through the capture."""
    import gc
    import weakref

    from repro_torch.data import TokenPipeline
    from repro_torch.train.program import TrainProgram
    from repro_torch.train.step import TrainHParams, init_train_state
    lm = LM(_serve_cfg("llama-sparse"), device=dev, seed=0)
    hp = TrainHParams(**TRAIN_HP)
    state = init_train_state(lm, hp=hp)
    a = TrainProgram(lm, state, hp, batch=2, seq=32, graph=True)
    b = TrainProgram(lm, state, hp, batch=2, seq=32, graph=True)
    assert a.program.stream is b.program.stream
    enabled = gc.isenabled()
    gc.disable()
    try:
        t = torch.empty(1 << 20, device=dev)
        ref = weakref.ref(t)
        cycle = [t]
        cycle.append(cycle)
        del t, cycle
        assert ref() is not None
        a.load(TokenPipeline(lm.cfg.vocab_size, 2, 32).get_batch(0))
        a()
        assert ref() is None
        assert a.program.stats()["captures"] == 1
    finally:
        if enabled:
            gc.enable()


def _port_objects(objs):
    """The objects of ``objs`` that belong to the port: instances of its
    classes, its functions, and frames of its code."""
    out = []
    for o in objs:
        code = getattr(o, "f_code", None)
        where = (code.co_filename if code is not None else
                 getattr(o, "__module__", None) or type(o).__module__)
        if "repro_torch" in str(where):
            out.append(o)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["llama-sparse", "deepseek"])
def test_eager_train_step_forms_no_cycle(dev, which):
    """Fault 3.10: an eager train step (after the first, whose first call
    of ``torch.utils.checkpoint`` imports ``torch._dynamo`` under the
    step's frames) leaves nothing to Python's cycle collector that holds
    a CUDA tensor or belongs to the port: no autograd ``ctx``, plan,
    closure or frame of the port forms a reference cycle, so an eager
    ``train_loop`` pins no step's transients."""
    import gc

    from repro_torch.data import TokenPipeline
    from repro_torch.train.program import TrainProgram
    from repro_torch.train.step import TrainHParams, init_train_state
    lm = LM(_serve_cfg(which), device=dev, seed=0)
    hp = TrainHParams(**TRAIN_HP)
    prog = TrainProgram(lm, init_train_state(lm, hp=hp), hp, batch=2,
                        seq=32, graph=False)
    pipe = TokenPipeline(lm.cfg.vocab_size, 2, 32)

    def step(i):
        prog.load(pipe.get_batch(i))
        float(prog()["loss"])
        torch.cuda.synchronize()

    step(0)
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        step(1)
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        garbage = list(gc.garbage)
        gc.garbage.clear()
    finally:
        gc.set_debug(0)
        if enabled:
            gc.enable()
    assert not [o for o in garbage if torch.is_tensor(o) and o.is_cuda]
    assert not _port_objects(garbage)


@pytest.mark.cuda
def test_train_graph_keeps_the_backward_mask(dev):
    """The bs_attn element masks and walks are dropped from their caches
    and their memory written over after the capture: the replays still
    equal the eager run (the graph holds what its backward reads)."""
    import gc

    from repro_torch.models import attention

    def scrub(i, prog):
        if i == 0:
            attention._device_element_mask.cache_clear()
            attention._device_walk.cache_clear()
            gc.collect()
            torch.cuda.empty_cache()
            junk = torch.full((64 << 20,), -7, dtype=torch.int32, device=dev)
            del junk

    want = _train_run(dev, "llama-sparse", False, 4)
    got = _train_run(dev, "llama-sparse", True, 4, between=scrub)
    _same_run(got, want)


# ---------------------------------------------------------------------------
# long context: the retained ring cache and bs_attn's global prefix
# ---------------------------------------------------------------------------

RING_PREFIX, RING_WINDOW = 8, 32


def _ring_cfg(which, dtype="bfloat16"):
    """A small ring (prefix 8, window 32: 40 slots) on llama's smoke config
    with sparse FFNs (GQA) or deepseek's at MLA's full head geometry."""
    import dataclasses

    from repro_torch import configs
    if which == "gqa":
        cfg = configs.sparsify_ffn(configs.smoke("llama3_2_1b"), 0.25)
    else:
        cfg = _mla_card_cfg(dtype)
    return dataclasses.replace(cfg, dtype=dtype, retained_prefix=RING_PREFIX,
                               retained_window=RING_WINDOW)


def _ring_decode(lm, dev, toks, n, graph):
    """``toks[:, :n]`` prefilled into the ring, then a
    ``decode_step(retained=True)`` at each later position of ``toks`` (its
    tokens, not greedy ones) through a ``serve.graphs.Program`` run eagerly
    or captured and replayed, as the engine runs its decode step: each
    step's logits, the caches and the program."""
    from repro_torch.serve.graphs import Program
    b, total = toks.shape
    ring = lm.cfg.retained_prefix + lm.cfg.retained_window
    _, caches = lm.prefill(toks[:, :n], max_len=ring)

    def body(io):
        logits, _ = lm.decode_step(io[:b].view(b, 1), caches, io[b:],
                                   retained=True)
        return logits

    prog = Program("ring decode", body, 2 * b, device=dev, graph=graph,
                   ctx=sparse.PlanContext(),
                   pool=torch.cuda.graph_pool_handle() if graph else None,
                   stream=torch.cuda.Stream(dev) if graph else None)
    out = []
    for pos in range(n, total):
        prog.load(np.concatenate([toks[:, pos], np.full(b, pos)]))
        out.append(prog().clone())
    torch.cuda.synchronize()
    return out, caches, prog


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["gqa", "mla"])
def test_ring_decode_graph_matches_eager(dev, which):
    """30 steps past a 40-slot ring's wrap, the ring slot computed on the
    device inside the captured step (a capture that syncs raises):
    every step's logits and the caches bit-equal to the same program run
    eagerly; one capture, a replay a step."""
    lm = LM(_ring_cfg(which), device=dev, seed=0)
    toks = np.random.default_rng(31).integers(0, 512, size=(2, 70))
    n = 40
    want, wc, _ = _ring_decode(lm, dev, toks, n, graph=False)
    got, gc_, prog = _ring_decode(lm, dev, toks, n, graph=True)
    assert prog.captures == 1 and prog.replays == len(got) == 30
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert torch.equal(a, b)
    for a, b in zip(gc_, wc):
        for key in a:
            assert torch.equal(a[key], b[key]), key
    if which == "mla":
        assert all(set(c) == {"latent", "k_rope"} for c in gc_)


@pytest.mark.cuda
def test_gqa_ring_decode_matches_windowed_forward(dev):
    """fp32, a stack without local layers: decoding past the ring's wrap
    equals the forward whose layers keep window w and prefix g (bs_attn
    with a global prefix), logits within the fp32 model budget."""
    import dataclasses
    cfg = _ring_cfg("gqa", "float32")
    lm = LM(cfg, device=dev, seed=0)
    groups = tuple((tuple(dataclasses.replace(s, mixer="attn_local")
                          for s in period), rep)
                   for period, rep in cfg.groups)
    wlm = LM(dataclasses.replace(cfg, groups=groups,
                                 local_window=RING_WINDOW,
                                 global_prefix=RING_PREFIX),
             device=dev, seed=0)
    for a, b in zip(lm.parameters(), wlm.parameters()):
        assert torch.equal(a, b)
    toks = np.random.default_rng(32).integers(0, 512, size=(2, 90))
    n = 40
    got, _, _ = _ring_decode(lm, dev, toks, n, graph=True)
    full = wlm.forward(toks)
    for i, logits in enumerate(got):
        assert _rel(logits, full[:, n + i]) <= 2e-4, i


@pytest.mark.cuda
def test_mla_ring_decode_matches_cpu(dev):
    """MLA has no windowed forward (no local MLA layer in the reference),
    so its ring decode on the card is held against the same model's ring
    decode on the CPU (itself held against JAX by
    ``tests/test_torch_long.py``), fp32, logits and caches."""
    cfg = _ring_cfg("mla", "float32")
    cpu = LM(cfg, device="cpu", seed=0)
    gpu = LM(cfg, device=dev, seed=0)
    gpu.load_state_dict({k: v.to(dev) for k, v in cpu.state_dict().items()})
    toks = np.random.default_rng(33).integers(0, 512, size=(2, 70))
    n = 30
    got, gcache, _ = _ring_decode(gpu, dev, toks, n, graph=True)
    _, ccache = cpu.prefill(toks[:, :n], max_len=RING_PREFIX + RING_WINDOW)
    for i, pos in enumerate(range(n, toks.shape[1])):
        want, ccache = cpu.decode_step(toks[:, pos:pos + 1], ccache,
                                       np.full(2, pos), retained=True)
        assert _rel(got[i].cpu(), want) <= MLA_TOL[torch.float32], pos
    for a, b in zip(gcache, ccache):
        for key in ("latent", "k_rope"):
            assert _rel(a[key].cpu(), b[key]) <= MLA_TOL[torch.float32], key


# bs_attn with a global prefix at the configs' tiles of 512: (S, window,
# prefix, heads, kv heads): the long-context check's shape (prefix 1024,
# window 4096) at fewer heads, a prefix wider than the window, and a
# prefix that ends inside a tile
PREFIX_CASES = [(5632, 4096, 1024, 4, 2), (2560, 1024, 512, 4, 2),
                (1536, 512, 1024, 4, 4), (2048, 1024, 300, 8, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", PREFIX_CASES)
def test_bs_attn_global_prefix_at_tiles_of_512(dev, dtype, case):
    from repro_torch.kernels.bs_attn import ops as bs_ops
    from repro_torch.kernels.bs_attn.ref import attend_plain
    from repro_torch.models import attention
    s, window, prefix, h, kvh = case
    g = torch.Generator(device=dev).manual_seed(s + prefix)
    q = torch.randn((1, s, h, 64), generator=g, device=dev).to(dtype)
    k = torch.randn((1, s, kvh, 64), generator=g, device=dev).to(dtype)
    v = torch.randn((1, s, kvh, 64), generator=g, device=dev).to(dtype)
    spec = attention.attn_spec(s, s, 64, window=window, global_prefix=prefix)
    assert spec.tile_q == 512 and spec.global_tiles > 0
    counter = bs_ops.WALK_COUNTERS[bs_ops.kernel_walk(dtype)]
    before = counter.launches
    got = attention.attend_train(q, k, v, window=window, global_prefix=prefix)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    el = spec.element_mask(dev)
    # the prefix is visible past the window: some pair is kept by it alone
    r = torch.arange(s, device=dev)[:, None]
    c = torch.arange(s, device=dev)[None, :]
    assert bool((el & (r - c >= window)).any())
    want = attend_plain(q, k, v, el, scale=spec.scale)
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= TOL[dtype]


@pytest.mark.cuda
def test_convenience_shims_run_the_plan_on_card(dev):
    """The reference's shims (``core/static_sparse.py``,
    ``core/dispatch.py``) on CUDA tensors: each equals the plan's own
    output bit for bit and launches the plan's kernel."""
    from repro_torch.core import dispatch
    from repro_torch.core import static_sparse as ss
    from repro_torch.kernels import gmm as gmm_k
    from repro_torch.kernels import sddmm as sddmm_k
    dtype = torch.bfloat16
    m, k, n, b = 256, 512, 64, 16
    mask = masks.random_block_mask(m, k, b, 0.25, seed=5)
    g = torch.Generator(device=dev).manual_seed(5)
    vals = torch.randn((int(mask.sum()), b, b), generator=g,
                       device=dev).to(dtype)
    bsr = BlockSparseMatrix.from_mask(mask, b, values=vals)
    x = torch.randn((k, n), generator=g, device=dev).to(dtype)
    dy = torch.randn((m, n), generator=g, device=dev).to(dtype)
    ctx = sparse.PlanContext(mode="static", grad_mode="static",
                             sddmm_mode="sddmm_grouped")
    p = sparse.plan(bsr, n, device=dev, ctx=ctx)
    assert p.route == "static_cuda"

    def launched(counter, fn):
        before = counter.launches
        out = fn()
        torch.cuda.synchronize()
        assert counter.launches > before
        return out

    for backend in ("xla", "pallas"):
        got = launched(bsmm_ops.COUNTER, lambda: ss.spmm(bsr, x,
                                                         backend=backend))
        assert torch.equal(got, p.spmm_nt(vals, x.t().contiguous()).t())
        got = ss.spmm_nt(bsr, x.t(), backend=backend)
        assert torch.equal(got, p.spmm_nt(vals, x.t().contiguous()))
    assert torch.equal(ss.spmm_cached(bsr, x), ss.spmm(bsr, x))
    got = launched(bsmm_ops.COUNTER, lambda: ss.spmm_t(bsr, dy))
    assert torch.equal(got, p.spmm_t(vals, dy.t().contiguous()).t())
    got = launched(sddmm_k.COUNTER, lambda: ss.sddmm(bsr, dy, x))
    assert torch.equal(got, p.sddmm(dy.t().contiguous(),
                                    x.t().contiguous()))
    dense = bsr.to_dense()
    want = (dense.float() @ x.float())
    assert _rel(ss.spmm(bsr, x), want) <= TOL[dtype]
    got = dispatch.spmm(bsr, x)
    assert torch.equal(got, sparse.spmm(bsr, x))
    assert _rel(got, want) <= TOL[dtype]
    got = launched(dmm_ops.COUNTER, lambda: dispatch.spmm(dense, x))
    assert _rel(got, want) <= TOL[dtype]
    xa = torch.randn((4, 8, k), generator=g, device=dev).to(dtype)
    w = torch.randn((k, 128), generator=g, device=dev).to(dtype)
    got = launched(dmm_ops.COUNTER, lambda: dispatch.matmul(xa, w))
    assert torch.equal(got, sparse.matmul(xa, w))
    a3 = torch.randn((4, 16, 128), generator=g, device=dev).to(dtype)
    b3 = torch.randn((4, 128, 64), generator=g, device=dev).to(dtype)
    got = launched(gmm_k.COUNTER, lambda: dispatch.batched_matmul(a3, b3))
    assert torch.equal(got, sparse.batched_matmul(a3, b3))
    assert _rel(got, a3.float() @ b3.float()) <= TOL[dtype]
    rep = dispatch.explain(bsr, n, device=dev)
    assert rep["pallas_admissible"] is True
    assert all(r.endswith("_cuda") for r in rep["candidates"])


# -- tensor parallelism (static_tp, static_tp_shardmap) -------------------------

def _tp_problem(dev, dtype, n, m=512, k=1024, empty=False, seed=0):
    """A static pattern (d = 1/4, b = 16) and x, dy on the card; with
    ``empty`` the block columns of the middle half are empty, so even
    splits at q = 4 leave two shards without a block."""
    mask = masks.random_block_mask(m, k, 16, 0.25, seed=seed)
    kb = k // 16
    if empty:
        mask[:, kb // 4:3 * kb // 4] = False
        mask[0, 0] = True
    g = torch.Generator(device=dev).manual_seed(seed)
    vals = (torch.randn((int(mask.sum()), 16, 16), generator=g, device=dev)
            / 8).to(dtype)
    bsr = BlockSparseMatrix.from_mask(mask, 16, values=vals)
    x = torch.randn((n, k), generator=g, device=dev).to(dtype)
    dy = torch.randn((n, m), generator=g, device=dev).to(dtype)
    return bsr, x, dy


@pytest.mark.cuda
@pytest.mark.parametrize("empty", [False, True])
@pytest.mark.parametrize("n", [4, 256, 2048])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("q", [2, 4])
def test_static_tp_cuda_matches_plain(dev, q, dtype, n, empty):
    """``static_tp`` on the card: forward, dL/dx and dL/dvalues against the
    fp32 dense product; a forward launches bsmm once per shard that owns
    a block, a backward one dL/dx walk and one SDDMM per such shard."""
    from repro_torch.kernels import bsmm, sddmm
    bsr, x, dy = _tp_problem(dev, dtype, n, empty=empty)
    p = sparse.plan(bsr, n, device=dev, ctx=sparse.PlanContext(
        mode="static_tp", tp_q=q, tp_balanced=not empty))
    assert p.route == "static_tp"
    owners = int((p.tp.meta.real_counts > 0).sum())
    assert owners == (2 if empty and q == 4 else q)
    w = bsr.to_dense().float()
    v = bsr.values.clone().requires_grad_(True)
    xx = x.clone().requires_grad_(True)
    b0, s0 = bsmm.COUNTER.launches, sddmm.COUNTER.launches
    y = p.spmm_nt(v, xx)
    torch.cuda.synchronize()
    assert bsmm.COUNTER.launches - b0 == owners
    y.backward(dy)
    torch.cuda.synchronize()
    assert bsmm.COUNTER.launches - b0 == 2 * owners
    assert sddmm.COUNTER.launches - s0 == owners
    assert _rel(y, x.float() @ w.t()) <= TOL[dtype]
    assert _rel(xx.grad, dy.float() @ w) <= TOL[dtype]
    mb, kb = bsr.grid
    dw = (dy.float().t() @ x.float()).reshape(mb, 16, kb, 16).permute(
        0, 2, 1, 3)
    want = dw[torch.as_tensor(bsr.row_idx, dtype=torch.long, device=dev),
              torch.as_tensor(bsr.col_idx, dtype=torch.long, device=dev)]
    assert _rel(v.grad, want) <= TOL[dtype]


@pytest.mark.cuda
def test_engine_static_tp_graphs_match_eager(dev):
    """The llama smoke engine with an abstract (1, 4) mesh: its FFN plans
    on ``static_tp``, and the CUDA graphs' tokens, logits and launches
    bit-equal to the same engine run eagerly."""
    from repro_torch.launch.mesh import AbstractMesh
    lm = LM(_serve_cfg("llama-sparse"), device=dev, seed=0)
    mesh = AbstractMesh((1, 4), ("data", "model"))
    lengths = [5, 20, 9, 40, 3, 33]
    kw = dict(buckets=(8, 24, 48), max_len=64, mesh=mesh)
    want = _serve(lm, dev, False, lengths, **kw)
    got = _serve(lm, dev, True, lengths, **kw)
    assert got[0] == want[0]
    for a, b in zip(got[1], want[1]):
        assert torch.equal(a, b)
    assert got[2] == want[2]
    routes = {p.route for p in sparse.pool_plans(got[4].pool)
              if p.kind == "static"}
    assert routes == {"static_tp"}


def _nccl_rank(rank, world, init_file, out_dir):
    """One rank per card: NCCL, a ``DeviceMesh("cuda", (world,))``, the
    explicit route forward and backward on the shared seeded problem."""
    import os

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_device_mesh
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        dev = torch.device("cuda", rank)
        mesh = make_device_mesh("cuda", (world,), ("model",))
        out = {}
        for n in (4, 2048):
            bsr, x, dy = _tp_problem(dev, torch.bfloat16, n)
            p = sparse.plan(bsr, n, device=dev, ctx=sparse.PlanContext(
                mode="static_tp_shardmap", mesh=mesh))
            v = bsr.values.clone().requires_grad_(True)
            xx = x.clone().requires_grad_(True)
            y = p.spmm_nt(v, xx)
            y.backward(dy)
            out[n] = {"y": y.detach().cpu(), "dx": xx.grad.cpu(),
                      "dv": v.grad.cpu(), "route": p.route,
                      "shards": list(p.tp.shards)}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.barrier()
        dist.destroy_process_group()


@pytest.mark.cuda
def test_tp_shardmap_nccl_across_cards(dev, tmp_path):
    """``static_tp_shardmap`` with one rank per card over NCCL: every
    rank's output and dL/dx equal and within the budget of ``static_tp``
    on one card, the ranks' dL/dvalues summing to its gradient.  Needs
    two cards."""
    import time

    import torch.multiprocessing as mp
    world = torch.cuda.device_count()
    if world < 2:
        pytest.skip("needs two or more CUDA devices (one rank per card)")
    ctx = mp.start_processes(_nccl_rank, args=(world, str(tmp_path / "pg"),
                                               str(tmp_path)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + 300
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            pytest.fail("NCCL ranks still running after 300 s")
    outs = [torch.load(str(tmp_path / f"rank{r}.pt")) for r in range(world)]
    for n in (4, 2048):
        bsr, x, dy = _tp_problem(dev, torch.bfloat16, n)
        p = sparse.plan(bsr, n, device=dev, ctx=sparse.PlanContext(
            mode="static_tp", tp_q=world))
        v = bsr.values.clone().requires_grad_(True)
        xx = x.clone().requires_grad_(True)
        y = p.spmm_nt(v, xx)
        y.backward(dy)
        got = [o[n] for o in outs]
        for r, g in enumerate(got):
            assert g["route"] == "static_tp_shardmap" and g["shards"] == [r]
            assert torch.equal(g["y"], got[0]["y"])
            assert torch.equal(g["dx"], got[0]["dx"])
        assert _rel(got[0]["y"].to(dev), y) <= TOL[torch.bfloat16]
        assert _rel(got[0]["dx"].to(dev), xx.grad) <= TOL[torch.bfloat16]
        total = sum(g["dv"].float() for g in got).to(dev)
        assert _rel(total, v.grad) <= TOL[torch.bfloat16]


# -- sharded training over NCCL, one rank per card ------------------------------

SHARD_HP = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)


def _dp_cfg():
    """llama3.2-1b's smoke config, every FFN sparse (d = 1/4), fp32."""
    import dataclasses

    from repro_torch import configs
    return dataclasses.replace(
        configs.sparsify_ffn(configs.smoke("llama3_2_1b"), 0.25),
        dtype="float32")


def _ep_cfg(impl="shard_map"):
    """qwen3-moe-30b-a3b at full width, 2 layers, bf16."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch.profile_train import cut_depth
    cfg = cut_depth(configs.get("qwen3-moe-30b-a3b"), 2)
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            impl=impl))


def _shard_rank(rank, world, init_file, out_dir, case):
    """One rank per card over NCCL; ``_SHARD_CASES[case]``'s results to
    ``out_dir/rank<r>.pt``.  Each stage it passes is marked in
    ``out_dir/stage<r>`` (what a hang is reported with).  The captured
    graphs (held in reference cycles of their programs) are collected
    before the process group is destroyed: a live graph holds the
    communicators its collectives were captured on."""
    import gc
    import os

    import torch.distributed as dist

    def mark(stage):
        with open(os.path.join(out_dir, f"stage{rank}"), "w") as f:
            f.write(stage)
    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("nccl", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    mark("started")
    try:
        out = _SHARD_CASES[case](rank, world, out_dir)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
        mark("saved")
    finally:
        gc.collect()
        torch.cuda.synchronize()
        mark("collected")
        dist.barrier()
        mark("barrier")
        dist.destroy_process_group()
        mark("destroyed")


def _train_ranks(cfg, mesh, batch, seq, graphs, **kw):
    """``train_loop`` on ``mesh``: losses, the master blocks and their
    slices, and (rank 0) the program's capture counts."""
    from repro_torch.launch.mesh import block_slices
    from repro_torch.launch.train import train_loop
    from repro_torch.train.step import TrainHParams
    stats = {}
    state, losses = train_loop(
        cfg, steps=kw.pop("steps", 3), batch_per_shard=batch, seq=seq,
        hp=TrainHParams(**SHARD_HP), device="cuda", log_every=10 ** 9,
        graphs=graphs, mesh=mesh,
        on_step=lambda s, m, p: stats.update(p.program.stats()), **kw)
    lay = state.layout
    return dict(losses=losses, stats=stats,
                master={n: m.cpu() for n, m in state.opt.master.items()},
                slices={n: block_slices(lay.shapes[n], lay.specs[n], mesh)
                        for n in lay.specs})


def _dp_case(rank, world, out_dir):
    from repro_torch.launch.mesh import make_device_mesh
    mesh = make_device_mesh("cuda", (world, 1), ("data", "model"))
    return {g: _train_ranks(_dp_cfg(), mesh, 2, 32, g, ckpt_dir=None)
            for g in (False, True)}


def _ckpt_case(rank, world, out_dir):
    """A checkpoint written on (4, 1) resumed on (2, 2)."""
    import os
    import shutil

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_device_mesh
    d41, d22 = os.path.join(out_dir, "d41"), os.path.join(out_dir, "d22")
    m41 = make_device_mesh("cuda", (4, 1), ("data", "model"))
    _train_ranks(_dp_cfg(), m41, 2, 32, True, steps=2, ckpt_dir=d41,
                 ckpt_every=2)
    if rank == 0:
        shutil.copytree(d41, d22)
    dist.barrier()
    m22 = make_device_mesh("cuda", (2, 2), ("data", "model"))
    return _train_ranks(_dp_cfg(), m22, 4, 32, True, ckpt_dir=d22,
                        ckpt_every=10)


def _ep_case(rank, world, out_dir):
    """qwen3 (2 layers, full width) on (2, 2): each rank's forward of its
    data shard's rows and routing drops, then two steps eager and
    captured."""
    from repro_torch import sparse as tsparse
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.mesh import axis_index, make_device_mesh
    from repro_torch.sharding import rules
    import types

    from repro_torch.models.moe import MoE, _moe_gspmd
    cfg = _ep_cfg()
    mesh = make_device_mesh("cuda", (2, 2), ("data", "model"))
    di = axis_index(mesh, ("data",))[0]
    lm = LM(cfg, device="cuda", seed=0, mesh=mesh)
    tokens = TokenPipeline(cfg.vocab_size, 2, 512, num_shards=2,
                           shard_id=di).get_batch(0)["tokens"]
    moes = [m for m in lm.modules() if isinstance(m, MoE)]
    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, o: seen.append((inp[0], o[0]))) for m in moes]
    tsparse.reset_telemetry()
    with rules.activation_mesh(mesh):
        logits = lm(tokens)
    for h in hooks:
        h.remove()
    # each layer against the gspmd formulation on the same input, its
    # experts gathered whole
    errs = []
    for mod, (x, y) in zip(moes, seen):
        whole = {name: h.block.gather(getattr(mod, name), mesh)
                 for name, h in mod.held.items()}
        with torch.no_grad():
            y_ref, _ = _moe_gspmd(types.SimpleNamespace(
                router=mod.router, shared=mod.shared, **whole), cfg, x)
        errs.append(_rel(y, y_ref))
    out = {"shard": di, "finite": bool(torch.isfinite(logits).all()),
           "layer_errs": errs,
           "dropped": tsparse.dropped_history("moe_dispatch"),
           "held": {n: tuple(lm.get_parameter(n).shape)
                    for n in lm.held_blocks()}}
    del lm, logits, seen
    for g in (False, True):
        r = _train_ranks(cfg, mesh, 2, 512, g, steps=2, ckpt_dir=None)
        out[g] = dict(losses=r["losses"], stats=r["stats"],
                      master=r["master"])
    return out


def _preempt_case(rank, world, out_dir):
    """``train_loop`` on (world, 1), captured, where only the last rank
    gets SIGTERM, during its second step: the steps each rank ran and
    the latest checkpoint."""
    import os
    import signal

    from repro_torch.checkpoint import latest_step
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.train import program as prog_mod
    call = prog_mod.TrainProgram.__call__
    calls = []

    def signalled(self):
        calls.append(None)
        if rank == world - 1 and len(calls) == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return call(self)
    prog_mod.TrainProgram.__call__ = signalled
    mesh = make_device_mesh("cuda", (world, 1), ("data", "model"))
    d = os.path.join(out_dir, "ck")
    r = _train_ranks(_dp_cfg(), mesh, 2, 32, True, steps=20, ckpt_dir=d,
                     ckpt_every=100)
    return {"losses": r["losses"], "latest": latest_step(d)}


_SHARD_CASES = {"dp": _dp_case, "ckpt": _ckpt_case, "ep": _ep_case,
                "preempt": _preempt_case}


def _spawn_nccl(tmp_path, world, case, timeout=300):
    """``case`` on ``world`` NCCL ranks; ranks still running after
    ``timeout`` s are killed and the test fails with the stage each
    reached."""
    import os
    import time

    import torch.multiprocessing as mp
    ctx = mp.start_processes(_shard_rank, args=(world, str(tmp_path / "pg"),
                                                str(tmp_path), case),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            stages = []
            for r in range(world):
                path = tmp_path / f"stage{r}"
                stages.append(path.read_text() if os.path.exists(path)
                              else None)
            pytest.fail(f"{case}: NCCL ranks still running after "
                        f"{timeout} s; stages {stages}")
    return [torch.load(str(tmp_path / f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _one_process(dev, cfg, batch, seq, steps=3):
    from repro_torch.launch.train import train_loop
    from repro_torch.train.step import TrainHParams
    state, losses = train_loop(
        cfg, steps=steps, batch_per_shard=batch, seq=seq, ckpt_dir=None,
        hp=TrainHParams(**SHARD_HP), device=dev, log_every=10 ** 9,
        graphs=False)
    return losses, {n: m.cpu() for n, m in state.opt.master.items()}


@pytest.mark.cuda
def test_dp_nccl_across_cards(dev, tmp_path):
    """Data parallelism with the state sharded over one NCCL rank per card
    on a (cards, 1) mesh: 3 steps eager and captured as one CUDA graph
    (collectives included), bit-equal; the eager losses and each rank's
    master blocks within fp32 1e-4 of the one-process run on the global
    batch (the masters in relative L2: Adam's normalised steps move an element whose
    gradient's sign differs by a summation order by about lr).  Needs two
    cards."""
    world = torch.cuda.device_count()
    if world < 2:
        pytest.skip("needs two or more CUDA devices (one rank per card)")
    outs = _spawn_nccl(tmp_path, world, "dp")
    losses, master = _one_process(dev, _dp_cfg(), 2 * world, 32)
    for r, o in enumerate(outs):
        eager, graph = o[False], o[True]
        assert graph["losses"] == eager["losses"], r
        for n, m in eager["master"].items():
            assert torch.equal(graph["master"][n], m), (r, n)
            w = master[n][eager["slices"][n]]
            assert (m - w).norm() <= 1e-4 * w.norm(), (r, n, _rel(m, w))
        for a, b in zip(eager["losses"], losses):
            assert abs(a - b) <= 1e-4 * abs(b), (r, eager["losses"], losses)
    assert outs[0][True]["stats"]["captures"] == 1
    assert outs[0][True]["stats"]["replays"] >= 2


@pytest.mark.cuda
def test_preemption_nccl_stops_every_rank(dev, tmp_path):
    """SIGTERM to one NCCL rank of a (cards, 1) mesh during its second
    captured step: every rank runs that step, writes the step-2
    checkpoint and stops, none left waiting in a collective.  Needs two
    cards."""
    world = torch.cuda.device_count()
    if world < 2:
        pytest.skip("needs two or more CUDA devices (one rank per card)")
    outs = _spawn_nccl(tmp_path, world, "preempt")
    for o in outs:
        assert len(o["losses"]) == 2 and o["latest"] == 2, o
    assert all(o["losses"] == outs[0]["losses"] for o in outs)


@pytest.mark.cuda
def test_checkpoint_reshards_nccl_four_to_two_by_two(dev, tmp_path):
    """A checkpoint written by 4 NCCL ranks on a (4, 1) mesh resumes on a
    (2, 2) mesh (captured steps): the next step's loss within fp32 1e-4
    of the unbroken one-process run's.  Needs four cards."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    outs = _spawn_nccl(tmp_path, 4, "ckpt")
    losses, _ = _one_process(dev, _dp_cfg(), 8, 32)
    for o in outs:
        assert len(o["losses"]) == 1
        assert abs(o["losses"][0] - losses[2]) <= 1e-4 * abs(losses[2]), \
            (o["losses"], losses)


@pytest.mark.cuda
def test_ep_nccl_two_by_two(dev, tmp_path):
    """qwen3-moe at full width, 2 layers, ``impl="shard_map"`` on a (2, 2)
    mesh of 4 NCCL ranks (64 experts a rank, their data shards gathered;
    the attention and the vocabulary split over "model" too): each MoE
    layer's output within bf16 2e-2 of the gspmd formulation on the same
    input, the first layer's routing drops within 1e-2 of the mean of
    the shards' one-process drops (its input differs by the split
    attention's bf16 roundings, which re-route near-ties: 2e-4 and 7e-4
    read on H100s; later layers' inputs
    differ by the combine's summation order, which re-ranks the
    capacity queues at random init), finite logits, two train steps
    captured bit-equal to eager, the first loss within bf16 2e-2 of the
    mean of the shards' one-process losses.  Needs four cards."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    from repro_torch import sparse as tsparse
    from repro_torch.data import TokenPipeline
    outs = _spawn_nccl(tmp_path, 4, "ep", timeout=400)
    cfg = _ep_cfg("gspmd")
    lm = LM(cfg, device=dev, seed=0)
    drops, loss = [], []
    for s in (0, 1):
        batch = TokenPipeline(cfg.vocab_size, 2, 512, num_shards=2,
                              shard_id=s).get_batch(0)
        tsparse.reset_telemetry()
        lm(batch["tokens"])
        drops.append(tsparse.dropped_history("moe_dispatch"))
        with torch.no_grad():
            loss.append(float(lm.loss(batch["tokens"], batch["targets"])[0]))
    mean_first = (drops[0][0] + drops[1][0]) / 2
    for o in outs:
        assert o["finite"]
        assert len(o["layer_errs"]) == 2
        assert max(o["layer_errs"]) <= 2e-2, o["layer_errs"]
        # the first layer's input is the attention split over "model"
        # (its bf16 partials summed over the ranks): its router re-routes
        # near-ties, which move its drops by a few 1e-4
        print(f"[ep-nccl] first layer's drops {o['dropped'][0]:.4f}, one "
              f"process's mean {mean_first:.4f}")
        assert abs(o["dropped"][0] - mean_first) <= 1e-2, \
            (o["dropped"], drops)
        experts = {n: s for n, s in o["held"].items()
                   if n.rpartition(".")[2] in ("w_gate", "w_up", "w_down")}
        assert len(experts) == 6
        assert all(shape[0] == 64 for shape in experts.values())
        assert all(shape[1] in (1024, 384) for shape in experts.values())
        assert o[True]["losses"] == o[False]["losses"]
        for n, m in o[False]["master"].items():
            assert torch.equal(o[True]["master"][n], m), n
        first = o[False]["losses"][0]
        assert abs(first - sum(loss) / 2) <= 2e-2 * abs(sum(loss) / 2)


# -- model parallelism: the kernels at a rank's shapes, and across cards ------

MP_DENSE_SHAPES = [(2048, 1024), (2048, 256), (1024, 2048), (4096, 1024),
                   (4096, 3424), (3424, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("k,d", MP_DENSE_SHAPES,
                         ids=[f"{k}x{d}" for k, d in MP_DENSE_SHAPES])
@pytest.mark.parametrize("n", [4, 2048])
def test_dense_mm_at_model_parallel_shard_widths(dev, k, d, n):
    """dense_mm at the widths a model-parallel rank's projections take
    (llama3.2-1b at m = 2: q 2048 -> 1024, k/v -> 256, o 1024 -> 2048;
    glm4-9b at m = 4: q 4096 -> 1024, up / gate -> 3424, down 3424 ->
    4096) against its plain version, bf16, on its 16-bit walks."""
    g = torch.Generator(device=dev).manual_seed(k + d + n)
    x = torch.randn((n, k), generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn((k, d), generator=g, device=dev) / k ** 0.5).to(
        torch.bfloat16)
    c0 = dict(dmm_ops.WALK_COUNTERS)
    before = {w_: c.launches for w_, c in c0.items()}
    y = dmm_ops.dense_mm_cuda(x, w)
    torch.cuda.synchronize()
    walked = {w_: c.launches - before[w_] for w_, c in c0.items()}
    assert walked.get("ffma", 0) == 0 and sum(walked.values()) >= 1
    assert _rel(y, dmm_ops.dense_mm_plain(x, w)) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("h,kvh,dh", [(16, 4, 64), (8, 1, 128), (8, 2, 128)],
                         ids=["llama-m2", "glm4-m4", "glm4-m2"])
def test_bs_attn_on_a_model_parallel_rank_heads(dev, h, kvh, dh):
    """bs_attn on the heads one model-parallel rank computes (llama's 16
    of 32 query heads on 4 KV heads; glm4's 8 query heads on one KV
    head at m = 4, two at m = 2), causal S 512, batch 2, bf16, on its
    wgmma walk, against its plain version."""
    from repro_torch.kernels.bs_attn import ops as bs_ops
    from repro_torch.kernels.bs_attn.ref import attend_plain
    from repro_torch.models import attention
    g = torch.Generator(device=dev).manual_seed(h * 7 + kvh)
    s = 512
    spec = attention.attn_spec(s, s, dh, causal=True, tile_q=128,
                               tile_kv=128)
    q = torch.randn((2, s, h, dh), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((2, s, kvh, dh), generator=g, device=dev).to(
        torch.bfloat16)
    v = torch.randn((2, s, kvh, dh), generator=g, device=dev).to(
        torch.bfloat16)
    wg = bs_ops.WALK_COUNTERS["wgmma"].launches
    y = bs_ops.bs_attn_cuda(q, k, v, spec.walk(dev), scale=spec.scale,
                            causal=True)
    torch.cuda.synchronize()
    assert bs_ops.WALK_COUNTERS["wgmma"].launches == wg + 1
    want = attend_plain(q, k, v, spec.element_mask(dev), scale=spec.scale)
    assert _rel(y, want) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 2048])
def test_bsmm_on_a_held_k_shard(dev, n):
    """A model-parallel rank's sparse FFN holds one k-shard: the
    ``static_tp_shardmap`` plan's pack and walk of the held blocks alone
    (``held=True``) equal the shard's product from the whole values, and
    its plain version, at llama's up/gate (8192 x 2048, d = 1/8, b 16,
    q 2, bf16); one bsmm launch."""
    from repro_torch.kernels import bsmm
    bsr, x, _ = _tp_problem(dev, torch.bfloat16, n)
    p = sparse.plan(bsr, n, device=dev, ctx=sparse.PlanContext(
        mode="static_tp", tp_q=2))
    shard, src = p.tp.plans[0], p.tp.src[0]
    held = bsr.values[src].contiguous()
    b0 = bsmm.COUNTER.launches
    got = shard.run_packed(shard.pack(held), x)
    torch.cuda.synchronize()
    assert bsmm.COUNTER.launches == b0 + 1
    rows, cols = (torch.as_tensor(a, dtype=torch.long, device=dev)
                  for a in p.tp.meta.shard_pattern(0))
    mb, kb = bsr.grid
    dense = torch.zeros((mb, kb, 16, 16), device=dev)
    dense[rows, cols] = held.float()
    dense = dense.permute(0, 2, 1, 3).reshape(mb * 16, kb * 16)
    assert _rel(got, x.float() @ dense.t()) <= 2e-2


def _mp_cfg(layers=2, dtype="float32"):
    """llama3.2-1b at full width, ``layers`` deep, every FFN sparse
    (d = 1/8, b = 16)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch.profile_train import cut_depth
    cfg = configs.sparsify_ffn(configs.get("llama3_2_1b"), 1 / 8)
    if layers is not None:
        cfg = cut_depth(cfg, layers)
    return dataclasses.replace(cfg, dtype=dtype)


def _all_reduce_ms():
    """Time every ``torch.distributed.all_reduce`` of this process (device
    synchronised on both sides: eager calls only); returns ``(ms list,
    undo)``."""
    import time

    import torch.distributed as dist
    times, call = [], dist.all_reduce

    def timed(t, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = call(t, *a, **kw)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        return out
    dist.all_reduce = timed

    def undo():
        dist.all_reduce = call
    return times, undo


def _card_lines():
    """The cards' ``name, power.limit`` as ``nvidia-smi`` reports them."""
    import subprocess
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()


def _mp_train(cfg, mesh, batch, seq, graphs, steps=3, timed=False,
              keep_master=True, **kw):
    """``train_loop`` on a model-parallel ``mesh``: losses, the master
    blocks and their ``Block`` in the whole tensor, step ms and, ``timed``
    (eager), the all-reduce ms of each step (rank 0)."""
    from repro_torch.launch.train import train_loop
    from repro_torch.train.step import TrainHParams
    stats, step_ms, ar_steps, seen = {}, [], [], [0]
    ar, undo = _all_reduce_ms() if timed else ([], None)

    def on_step(s, m, p):
        stats.update(p.program.stats())
        step_ms.append(m["step_s"] * 1e3)
        ar_steps.append(sum(ar[seen[0]:]))
        seen[0] = len(ar)
    torch.cuda.reset_peak_memory_stats()
    try:
        state, losses = train_loop(
            cfg, steps=steps, batch_per_shard=batch, seq=seq,
            hp=TrainHParams(**SHARD_HP), device="cuda", log_every=10 ** 9,
            graphs=graphs, mesh=mesh, on_step=on_step, **kw)
    finally:
        if undo is not None:
            undo()
    lay = state.layout
    held_bytes = sum(state.params[n].numel() * state.params[n].element_size()
                     for n in lay.held)
    return dict(losses=losses, stats=stats, step_ms=step_ms,
                all_reduce_ms=ar_steps,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                held_gib=held_bytes / 2 ** 30,
                master=({n: m.cpu() for n, m in state.opt.master.items()}
                        if keep_master else None),
                blocks={n: h.state for n, h in lay.place.items()})


def _mp_case(rank, world, out_dir):
    """(a) llama3.2-1b (full width, 2 layers, fp32) on (1, 4) and (2, 2):
    3 steps eager (all-reduces timed) and captured."""
    from repro_torch.launch.mesh import make_device_mesh
    out = {}
    for shape in ((1, 4), (2, 2)):
        mesh = make_device_mesh("cuda", shape, ("data", "model"))
        out[shape] = {g: _mp_train(_mp_cfg(), mesh, 4 // shape[0], 128, g,
                                   ckpt_dir=None, timed=not g)
                      for g in (False, True)}
    return out


def _mp_glm4_case(rank, world, out_dir):
    """(b) glm4-9b at full width and depth (dense FFN, bf16) on (1, 4):
    two eager steps (all-reduces timed), then 3 captured steps."""
    from repro_torch import configs
    from repro_torch.launch.mesh import make_device_mesh
    mesh = make_device_mesh("cuda", (1, 4), ("data", "model"))
    cfg = configs.get("glm4-9b")
    eager = _mp_train(cfg, mesh, 1, 512, False, steps=2, ckpt_dir=None,
                      timed=True, keep_master=False)
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    graph = _mp_train(cfg, mesh, 1, 512, True, steps=3, ckpt_dir=None,
                      keep_master=False)
    return {"eager": eager, "graph": graph}


def _mp_requests(cfg):
    from repro_torch.serve import Request
    rng = np.random.default_rng(11)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, size=n),
                    max_new_tokens=8) for i, n in enumerate((40, 77, 128,
                                                              200))]


def _mp_engine_case(rank, world, out_dir):
    """(c) llama3.2-1b (full width and depth, d = 1/8, bf16) on (1, 4):
    ``Engine(mesh=)`` at batch 4 eagerly (all-reduces timed) and through
    its CUDA graphs, captured at startup over NCCL."""
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.serve import Engine
    mesh = make_device_mesh("cuda", (1, 4), ("data", "model"))
    cfg = _mp_cfg(layers=None, dtype="bfloat16")
    lm = LM(cfg, device="cuda", seed=0, mesh=mesh)
    out = {}
    for graphs in (False, True):
        ar, undo = _all_reduce_ms() if not graphs else ([], None)
        try:
            eng = Engine(lm, device="cuda", batch=4, max_len=256, mesh=mesh,
                         graphs=graphs, warm_compile=graphs)
            reqs = _mp_requests(cfg)
            eng.run(reqs)
            torch.cuda.synchronize()
        finally:
            if undo is not None:
                undo()
        st = eng.stats()
        out[graphs] = dict(tokens=[r.output for r in reqs],
                           decode=st["step_latency"],
                           captures=sum(p.captures for p in eng.programs()),
                           all_reduce_ms=sum(ar), all_reduces=len(ar),
                           cache_heads=int(eng.caches[0]["k"].shape[2]))
        del eng
    return out


def _mp_ckpt_case(rank, world, out_dir):
    """(d) a (1, 4) run's checkpoint at step 2 (captured steps) resumed on
    (2, 2)."""
    import os
    import shutil

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_device_mesh
    d14, d22 = os.path.join(out_dir, "d14"), os.path.join(out_dir, "d22")
    m14 = make_device_mesh("cuda", (1, 4), ("data", "model"))
    _mp_train(_mp_cfg(), m14, 4, 128, True, steps=2, ckpt_dir=d14,
              ckpt_every=2)
    if rank == 0:
        shutil.copytree(d14, d22)
    dist.barrier()
    m22 = make_device_mesh("cuda", (2, 2), ("data", "model"))
    r = _mp_train(_mp_cfg(), m22, 2, 128, True, ckpt_dir=d22, ckpt_every=10)
    return {"losses": r["losses"]}


_SHARD_CASES.update(mp=_mp_case, mp_glm4=_mp_glm4_case,
                    mp_engine=_mp_engine_case, mp_ckpt=_mp_ckpt_case)


@pytest.mark.cuda
def test_mp_nccl_train_captured_equals_eager(dev, tmp_path):
    """(a) llama3.2-1b at full width (2 layers, fp32, d = 1/8) split over
    the "model" axis of (1, 4) and (2, 2) meshes of 4 NCCL ranks: 3 steps
    captured as one CUDA graph each (the tensor-parallel all-reduces
    inside) bit-equal to eager, the eager losses within fp32 1e-4 of one
    process and each rank's master blocks within 1e-4 in relative L2.
    Prints step ms and all-reduce ms a step.  Needs four cards."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    outs = _spawn_nccl(tmp_path, 4, "mp", timeout=600)
    losses, master = _one_process(dev, _mp_cfg(), 4, 128)
    for shape in ((1, 4), (2, 2)):
        for r, o in enumerate(outs):
            eager, graph = o[shape][False], o[shape][True]
            assert graph["losses"] == eager["losses"], (shape, r)
            for n, m in eager["master"].items():
                assert torch.equal(graph["master"][n], m), (shape, r, n)
                w = eager["blocks"][n].take(master[n])
                assert (m - w).norm() <= 1e-4 * w.norm(), (shape, r, n)
            for a, b in zip(eager["losses"], losses):
                assert abs(a - b) <= 1e-4 * abs(b), (shape, r)
        o = outs[0][shape]
        print(f"[mp-nccl] llama 2 layers fp32 {shape}: eager step ms "
              f"{[round(v, 2) for v in o[False]['step_ms']]} (all-reduces "
              f"synchronised), all-reduce ms of each step "
              f"{[round(v, 2) for v in o[False]['all_reduce_ms']]}; "
              f"captured step ms "
              f"{[round(v, 2) for v in o[True]['step_ms']]}; peak "
              f"{o[True]['peak_gib']:.2f} GiB")
        assert o[True]["stats"]["captures"] == 1
    print(f"[mp-nccl] cards {_card_lines()}")


@pytest.mark.cuda
def test_mp_nccl_glm4_full_depth_on_four_cards(dev, tmp_path):
    """(b) glm4-9b at full width and depth (40 layers, dense FFN, 9.4 B
    parameters, bf16) trained on (1, 4), one process's state (~150 GB)
    split over four cards: one eager step, then 3 steps captured as one
    CUDA graph; finite losses, one capture, every rank's peak under 80
    GiB.  Prints step ms, all-reduce ms and peak GiB a rank (rank 0's
    step and all-reduce ms).  Needs four cards."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    outs = _spawn_nccl(tmp_path, 4, "mp_glm4", timeout=900)
    for r, o in enumerate(outs):
        for run in ("eager", "graph"):
            assert all(np.isfinite(v) for v in o[run]["losses"]), (r, o)
            assert o[run]["peak_gib"] < 80, (r, run, o[run]["peak_gib"])
        print(f"[mp-nccl] glm4-9b (1, 4) rank {r}: eager step ms "
              f"{[round(v, 1) for v in o['eager']['step_ms']]}, all-reduce "
              f"ms of each step "
              f"{[round(v, 1) for v in o['eager']['all_reduce_ms']]}, peak "
              f"{o['eager']['peak_gib']:.2f} GiB; captured losses "
              f"{[round(v, 4) for v in o['graph']['losses']]}, step ms "
              f"{[round(v, 1) for v in o['graph']['step_ms']]}, peak "
              f"{o['graph']['peak_gib']:.2f} GiB; held bf16 "
              f"{o['graph']['held_gib']:.2f} GiB")
    assert outs[0]["graph"]["stats"]["captures"] == 1
    print(f"[mp-nccl] cards {_card_lines()}")


@pytest.mark.cuda
def test_mp_nccl_engine_graphs_match_eager(dev, tmp_path):
    """(c) ``Engine(mesh=)`` for llama3.2-1b (full width and depth, d =
    1/8, bf16) on (1, 4) over NCCL at batch 4: the tokens of its CUDA
    graphs (each rank captures every prefill bucket and the decode step,
    the all-reduces inside) equal the same engine's eager tokens; the
    caches hold 2 of 8 KV heads.  Prints decode p50 and all-reduce ms.
    Needs four cards."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    outs = _spawn_nccl(tmp_path, 4, "mp_engine", timeout=600)
    for r, o in enumerate(outs):
        assert o[True]["tokens"] == o[False]["tokens"], r
        assert o[True]["tokens"] == outs[0][True]["tokens"], r
        assert o[True]["captures"] >= 2 and o[False]["captures"] == 0
        assert o[True]["cache_heads"] == 2
    o = outs[0]
    print(f"[mp-nccl] llama engine (1, 4): eager decode "
          f"{o[False]['decode']} (all-reduces synchronised, "
          f"{o[False]['all_reduces']} taking "
          f"{o[False]['all_reduce_ms']:.1f} ms in all, startup included); "
          f"graphs decode {o[True]['decode']}")
    print(f"[mp-nccl] cards {_card_lines()}")


@pytest.mark.cuda
def test_mp_nccl_checkpoint_one_by_four_to_two_by_two(dev, tmp_path):
    """(d) A checkpoint of llama3.2-1b (full width, 2 layers, fp32) split
    over (1, 4) resumes on (2, 2) (captured steps): the next step's loss
    within fp32 1e-4 of the unbroken one-process run's.  Needs four
    cards."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    outs = _spawn_nccl(tmp_path, 4, "mp_ckpt", timeout=600)
    losses, _ = _one_process(dev, _mp_cfg(), 4, 128)
    for o in outs:
        assert len(o["losses"]) == 1
        assert abs(o["losses"][0] - losses[2]) <= 1e-4 * abs(losses[2]), \
            (o["losses"], losses)


# -- MoE under impl="gspmd" on a production mesh's layout ----------------------

MOE_ENGINE_BUCKETS = (8, 64, 256)
MOE_ENGINE_PROMPTS = (8, 50, 200, 700)


def _moe_engine_run(lm, mesh=None):
    """qwen3's engine at batch 4, max_len 1024, its graphs captured at
    startup: the first prefill's logits (8 tokens: no assignment can
    drop) as the host reads them, decode p50, the tokens, peak GiB."""
    from repro_torch.serve import Engine, Request
    rng = np.random.default_rng(17)
    reqs = [Request(uid=i, prompt=rng.integers(0, lm.cfg.vocab_size,
                                               size=n), max_new_tokens=8)
            for i, n in enumerate(MOE_ENGINE_PROMPTS)]
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(lm, device="cuda", batch=4, max_len=1024,
                 buckets=MOE_ENGINE_BUCKETS, warm_compile=True, mesh=mesh)
    first, read = [], eng._read

    def keep(out):
        if not first:
            first.append(out[1].float().cpu())
        return read(out)
    eng._read = keep
    eng.run(reqs)
    torch.cuda.synchronize()
    eng._read = read
    st = eng.stats()
    out = dict(logits=first[0], decode=st["step_latency"],
               tokens=[r.output for r in reqs],
               captures=sum(p.captures for p in eng.programs()),
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               v0=lm._head.v0)
    del eng
    return out


def _free_card():
    """Collect this process's dead models (graphs keep them in reference
    cycles) and return their card memory."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def _moe_engine_case(rank, world, out_dir):
    """qwen3-moe-30b-a3b at full width and depth on (1, 4) under
    ``impl="gspmd"``: 32 experts a layer a rank, served through the
    engine's graphs over NCCL."""
    from repro_torch import configs
    from repro_torch.launch.mesh import make_device_mesh
    mesh = make_device_mesh("cuda", (1, 4), ("data", "model"))
    lm = LM(configs.get("qwen3-moe-30b-a3b"), device="cuda", seed=0,
            mesh=mesh)
    experts = {tuple(lm.get_parameter(n).shape) for n in lm.held_blocks()
               if n.rpartition(".")[2] in ("w_gate", "w_up", "w_down")}
    return dict(_moe_engine_run(lm, mesh), experts=experts)


def _kept_sets(cfg, flat_slot, bucket):
    e_n = cfg.moe.num_experts
    kept = torch.where(flat_slot < e_n * bucket,
                       torch.div(flat_slot, bucket, rounding_mode="floor"),
                       e_n)
    return kept.sort(dim=1).values.cpu()


def _moe_train_case(rank, world, out_dir):
    """qwen3 at full width, 4 layers, ``impl="gspmd"`` on (2, 2): a
    forward of the rank's data shard with each MoE layer's kept experts
    against one process's routing of the global batch (the layer's
    input gathered over the data ranks); then 3 steps eager and
    captured."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.mesh import (axes_group, axis_index,
                                         make_device_mesh)
    from repro_torch.launch.profile_train import cut_depth
    from repro_torch.models.moe import (MoE, _capacity, _route_and_rank,
                                        global_route)
    from repro_torch.sharding import rules
    base = cut_depth(configs.get("qwen3-moe-30b-a3b"), 4)
    cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe,
                                                            impl="gspmd"))
    mesh = make_device_mesh("cuda", (2, 2), ("data", "model"))
    di, dp = axis_index(mesh, ("data",))
    lm = LM(cfg, device="cuda", seed=0, mesh=mesh)
    tokens = TokenPipeline(cfg.vocab_size, 2, 512, num_shards=2,
                           shard_id=di).get_batch(0)["tokens"]
    moes = [m for m in lm.modules() if isinstance(m, MoE)]
    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, o: seen.append(inp[0])) for m in moes]
    with rules.activation_mesh(mesh):
        lm(tokens)
    for h in hooks:
        h.remove()
    kept_equal, tokens_seen = [], []
    group = axes_group(mesh, ("data",))
    for mod, x in zip(moes, seen):
        b_ = x.shape[0]
        whole = x.new_zeros((b_ * dp,) + tuple(x.shape[1:]))
        whole[di * b_:(di + 1) * b_] = x
        dist.all_reduce(whole, group=group)
        xf = whole.reshape(-1, x.shape[-1])
        cap = _capacity(xf.shape[0], cfg)
        with torch.no_grad(), rules.activation_mesh(mesh):
            *_, flat_ref = _route_and_rank(xf, mod.router.w, cfg, cap,
                                           ranking=cfg.moe.ranking)
            tfs, _, flat, *_ = global_route(
                mod, cfg, x.reshape(-1, x.shape[-1]), mesh)
        t = x.shape[0] * x.shape[1]
        ref = _kept_sets(cfg, flat_ref, cap)[di * t:(di + 1) * t]
        kept_equal.append(int((_kept_sets(cfg, flat, tfs.shape[1])
                               == ref).all(dim=1).sum()))
        tokens_seen.append(t)
    experts = {tuple(lm.get_parameter(n).shape) for n in lm.held_blocks()
               if n.rpartition(".")[2] in ("w_gate", "w_up", "w_down")}
    del lm, seen
    out = dict(kept_equal=kept_equal, tokens=tokens_seen, experts=experts)
    for g in (False, True):
        r = _mp_train(cfg, mesh, 2, 512, g, steps=3, ckpt_dir=None)
        out[g] = dict(losses=r["losses"], stats=r["stats"],
                      master=r["master"], peak_gib=r["peak_gib"],
                      step_ms=r["step_ms"])
    return out


_SHARD_CASES.update(moe_engine=_moe_engine_case, moe_train=_moe_train_case)


@pytest.mark.cuda
def test_moe_gspmd_nccl_engine_one_by_four(dev, tmp_path):
    """qwen3-moe-30b-a3b at full width and depth, ``impl="gspmd"``, served
    through ``Engine(mesh=)`` on (1, 4) over NCCL with its graphs: each
    rank holds 32 of every layer's 128 experts; the first prefill's
    logits (8 tokens, no drop possible) within the repo's bf16 budget
    (6e-2) of the one-card engine's.  Prints decode p50 and peak GiB a
    rank beside the one card's.  Needs four cards."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    from repro_torch import configs
    outs = _spawn_nccl(tmp_path, 4, "moe_engine", timeout=900)
    lm = LM(configs.get("qwen3-moe-30b-a3b"), device=dev, seed=0)
    one = _moe_engine_run(lm)
    # the engine's graphs hold the model in reference cycles: free the
    # card before the next test's rank 0 needs it
    del lm
    _free_card()
    vocab = one["logits"].shape[-1]
    for r, o in enumerate(outs):
        assert o["experts"] == {(32, 2048, 768), (32, 768, 2048)}, r
        assert o["captures"] >= 2, r
        cols = o["logits"].shape[-1]
        assert cols * 4 == vocab
        err = _rel(o["logits"], one["logits"][..., o["v0"]:o["v0"] + cols])
        print(f"[moe-nccl] qwen3 engine (1, 4) rank {r}: first prefill "
              f"logits vs one card {err:.3e}; decode {o['decode']}; peak "
              f"{o['peak_gib']:.2f} GiB; tokens equal one card's "
              f"{o['tokens'] == one['tokens']}")
        assert err <= 6e-2, (r, err)
    print(f"[moe-nccl] qwen3 engine one card: decode {one['decode']}; "
          f"peak {one['peak_gib']:.2f} GiB")
    print(f"[moe-nccl] cards {_card_lines()}")


@pytest.mark.cuda
def test_moe_gspmd_nccl_train_two_by_two(dev, tmp_path):
    """qwen3-moe at full width, 4 layers, ``impl="gspmd"`` on (2, 2) over
    NCCL (64 experts a rank, half of D): every MoE layer's kept experts
    of the rank's tokens equal one process's routing of the global batch
    on the same input; 3 train steps captured as one CUDA graph each
    bit-equal to eager (losses, master blocks).  Needs four cards."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    _free_card()
    outs = _spawn_nccl(tmp_path, 4, "moe_train", timeout=900)
    for r, o in enumerate(outs):
        assert o["kept_equal"] == o["tokens"], (r, o["kept_equal"])
        assert o["experts"] == {(64, 1024, 768), (64, 384, 2048)}, r
        assert o[True]["losses"] == o[False]["losses"], r
        for n, m in o[False]["master"].items():
            assert torch.equal(o[True]["master"][n], m), (r, n)
        print(f"[moe-nccl] qwen3 4 layers (2, 2) rank {r}: kept experts "
              f"equal one process's {o['kept_equal']} of {o['tokens']}; "
              f"losses "
              f"{o[False]['losses']}; eager step ms {o[False]['step_ms']}, "
              f"captured {o[True]['step_ms']}; peak eager "
              f"{o[False]['peak_gib']:.2f} / captured "
              f"{o[True]['peak_gib']:.2f} GiB")
    # rank 0 reads the program's stats (``train_loop``'s on_step)
    assert outs[0][True]["stats"]["captures"] == 1
    print(f"[moe-nccl] cards {_card_lines()}")


# -- MLA, Mamba-2, cross attention and the encoder split over "model" ----------

MIXER_ENGINE_PROMPTS = (8, 50, 200, 700)
JAMBA_ONE_CARD_LAYERS = 16
# the first prompt's prefill of an fp32 copy at one period (8 layers:
# 12.7 B parameters, 51 GB on one card), held to the fp32 budget
JAMBA_FP32_LAYERS, JAMBA_FP32_TOL = 8, 2e-4


def _mixer_prompts(vocab):
    rng = np.random.default_rng(19)
    return [rng.integers(0, vocab, size=n) for n in MIXER_ENGINE_PROMPTS]


def _mixer_engine_run(lm, mesh=None):
    """A pad-unsafe stack's engine (every prompt prefilled eagerly at its
    exact length, the decode step captured at startup) at batch 4,
    max_len 1024: the first prefill's logits as the host reads them,
    decode p50, the tokens, peak GiB."""
    from repro_torch.serve import Engine, Request
    reqs = [Request(uid=i, prompt=p, max_new_tokens=8)
            for i, p in enumerate(_mixer_prompts(lm.cfg.vocab_size))]
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(lm, device="cuda", batch=4, max_len=1024,
                 warm_compile=True, mesh=mesh)
    assert eng.buckets == ()
    first, read = [], eng._read

    def keep(out):
        if not first:
            first.append(out[1].float().cpu())
        return read(out)
    eng._read = keep
    eng.run(reqs)
    torch.cuda.synchronize()
    eng._read = read
    st = eng.stats()
    out = dict(logits=first[0], decode=st["step_latency"],
               tokens=[r.output for r in reqs],
               captures=sum(p.captures for p in eng.programs()),
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               v0=lm._head.v0,
               state_heads=[int(c["state"].shape[1]) for c in eng.caches
                            if "state" in c])
    del eng
    return out


def _jamba_fp32_prefill(mesh=None):
    """jamba cut to ``JAMBA_FP32_LAYERS`` in fp32: the first prompt's
    prefill logits (a rank's vocabulary columns on ``mesh``)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch.profile_train import cut_depth
    from repro_torch.sharding import rules
    cfg = dataclasses.replace(cut_depth(configs.get("jamba-v0.1-52b"),
                                        JAMBA_FP32_LAYERS), dtype="float32")
    lm = LM(cfg, device="cuda", seed=0, mesh=mesh)
    prompt = _mixer_prompts(cfg.vocab_size)[0]
    with rules.activation_mesh(mesh, batch_split=False):
        logits, _ = lm.prefill(prompt[None, :], max_len=64, gather=False)
    out = logits.float().cpu()
    del lm
    _free_card()
    return out


def _jamba_engine_case(rank, world, out_dir):
    """jamba-v0.1-52b at full width on (1, 4): cut to
    ``JAMBA_ONE_CARD_LAYERS`` layers (what one card holds), then at full
    depth (32 layers), each served through ``Engine(mesh=)`` with its
    decode graph captured over NCCL; the blocks each rank holds; and an
    fp32 copy's first prefill at ``JAMBA_FP32_LAYERS``."""
    from repro_torch import configs
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.launch.profile_train import cut_depth
    mesh = make_device_mesh("cuda", (1, 4), ("data", "model"))
    cfg = configs.get("jamba-v0.1-52b")
    out = {"fp32": _jamba_fp32_prefill(mesh)}
    for layers in (JAMBA_ONE_CARD_LAYERS, None):
        c = cfg if layers is None else cut_depth(cfg, layers)
        lm = LM(c, device="cuda", seed=0, mesh=mesh)
        held = {n: tuple(lm.get_parameter(n).shape)
                for n in lm.held_blocks() if ".mixer." in n}
        run = _mixer_engine_run(lm, mesh)
        run.update(layers=len(lm.layers), held=held,
                   params_gib=sum(p.numel() * p.element_size()
                                  for p in lm.parameters()) / 2 ** 30)
        out[layers or len(lm.layers)] = run
        del lm
        _free_card()
    return out


def _deepseek_train_case(rank, world, out_dir):
    """deepseek-v2-lite at full width, 4 layers (its dense layer and 3 MoE
    layers) on (1, 4): 3 train steps eager, then captured."""
    from repro_torch import configs
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.launch.profile_train import cut_depth
    mesh = make_device_mesh("cuda", (1, 4), ("data", "model"))
    cfg = cut_depth(configs.get("deepseek-v2-lite-16b"), 4)
    out = {}
    for g in (False, True):
        r = _mp_train(cfg, mesh, 2, 512, g, steps=3, ckpt_dir=None)
        out[g] = dict(losses=r["losses"], stats=r["stats"],
                      master=r["master"], peak_gib=r["peak_gib"],
                      step_ms=r["step_ms"], held_gib=r["held_gib"],
                      blocks={n: b for n, b in r["blocks"].items()
                              if ".attn." in n})
        _free_card()
    return out


_SHARD_CASES.update(jamba_engine=_jamba_engine_case,
                    deepseek_train=_deepseek_train_case)


@pytest.mark.cuda
def test_mixers_nccl_jamba_full_depth_engine_one_by_four(dev, tmp_path):
    """jamba-v0.1-52b (51.6 B parameters, bf16) at full width and depth,
    32 layers, served through ``Engine(mesh=)`` on (1, 4) over NCCL, its
    decode step one captured graph: each rank holds 32 of 128 SSD heads
    of every Mamba layer (its state cache 32 heads), the tokens whole.
    The split against one card: an fp32 copy at ``JAMBA_FP32_LAYERS``
    (one period: 7 Mamba layers, 4 MoE), whose first prefill's logits
    are within ``JAMBA_FP32_TOL`` of the one card's; in bf16 at
    ``JAMBA_ONE_CARD_LAYERS`` layers, what one card holds, the first
    prefill's logits against the one-card engine's are printed beside
    the repo's bf16 budget (6e-2): there the ranks' bf16 partial sums
    differ from one card's roundings at every layer, and the MoE layers
    of an 8-token prefill at random init re-route near-ties and drop
    other assignments (read 7.66e-02 on an H100).  Prints decode p50 and
    peak GiB a rank beside the one card's.  Needs four cards."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    from repro_torch import configs
    from repro_torch.launch.profile_train import cut_depth
    _free_card()
    outs = _spawn_nccl(tmp_path, 4, "jamba_engine", timeout=1500)
    want32 = _jamba_fp32_prefill()
    lm = LM(cut_depth(configs.get("jamba-v0.1-52b"),
                      JAMBA_ONE_CARD_LAYERS), device=dev, seed=0)
    one = _mixer_engine_run(lm)
    del lm
    _free_card()
    vocab = one["logits"].shape[-1]
    errs = {}
    for r, o in enumerate(outs):
        cut, full = o[JAMBA_ONE_CARD_LAYERS], o[32]
        cols = cut["logits"].shape[-1]
        assert cols * 4 == vocab
        errs[r] = (_rel(o["fp32"], want32[..., cut["v0"]:cut["v0"] + cols]),
                   _rel(cut["logits"],
                        one["logits"][..., cut["v0"]:cut["v0"] + cols]))
        print(f"[mixers-nccl] jamba engine (1, 4) rank {r}: fp32 "
              f"{JAMBA_FP32_LAYERS} layers: first prefill logits vs one "
              f"card {errs[r][0]:.3e} (budget {JAMBA_FP32_TOL}); bf16 "
              f"{JAMBA_ONE_CARD_LAYERS} layers: {errs[r][1]:.3e} (the "
              f"bf16 budget 6e-2), decode {cut['decode']}, peak "
              f"{cut['peak_gib']:.2f} GiB, tokens equal one card's "
              f"{cut['tokens'] == one['tokens']}; 32 layers: decode "
              f"{full['decode']}, peak {full['peak_gib']:.2f} GiB, "
              f"parameters {full['params_gib']:.2f} GiB a rank")
    print(f"[mixers-nccl] jamba engine one card, {JAMBA_ONE_CARD_LAYERS} "
          f"layers: decode {one['decode']}; peak {one['peak_gib']:.2f} GiB")
    print(f"[mixers-nccl] cards {_card_lines()}")
    for r, o in enumerate(outs):
        assert errs[r][0] <= JAMBA_FP32_TOL, (r, errs[r])
        assert o[32]["layers"] == 32, r
        for run in (o[JAMBA_ONE_CARD_LAYERS], o[32]):
            assert run["captures"] >= 1, r
            assert set(run["state_heads"]) == {32}, (r, run["state_heads"])
            assert ("layers.0.mixer.in_proj.w" in run["held"]
                    and run["held"]["layers.0.mixer.out_proj.w"]
                    == (2048, 4096)), (r, sorted(run["held"])[:4])
            assert all(len(t) == 8 for t in run["tokens"]), r
        assert o[32]["tokens"] == outs[0][32]["tokens"], r


@pytest.mark.cuda
def test_mixers_nccl_deepseek_train_captured_equals_eager(dev, tmp_path):
    """deepseek-v2-lite at full width, 4 layers (MLA at 4 of 16 heads a
    rank, 16 of 64 experts), trained on (1, 4) over NCCL: 3 steps
    captured as one CUDA graph bit-equal to 3 eager steps (losses,
    master blocks), the losses finite.  Prints step ms and peak GiB a
    rank.  Needs four cards."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    _free_card()
    outs = _spawn_nccl(tmp_path, 4, "deepseek_train", timeout=900)
    for r, o in enumerate(outs):
        assert all(np.isfinite(o[False]["losses"])), r
        assert o[True]["losses"] == o[False]["losses"], r
        for n, m in o[False]["master"].items():
            assert torch.equal(o[True]["master"][n], m), (r, n)
        assert any(n.endswith("attn.kv_b.w") for n in o[False]["blocks"])
        print(f"[mixers-nccl] deepseek 4 layers (1, 4) rank {r}: losses "
              f"{o[False]['losses']}; eager step ms {o[False]['step_ms']}, "
              f"captured {o[True]['step_ms']}; peak eager "
              f"{o[False]['peak_gib']:.2f} / captured "
              f"{o[True]['peak_gib']:.2f} GiB; held blocks "
              f"{o[False]['held_gib']:.2f} GiB")
    assert outs[0][True]["stats"]["captures"] == 1
    print(f"[mixers-nccl] cards {_card_lines()}")


# -- FSDP over NCCL: every weight held as its rule's block over "data" --------

def _fsdp_run(cfg, mesh, batch, seq, graphs, steps):
    """``train_loop`` on ``mesh``: losses, step ms and graph stats (rank
    0), peak GiB, the parameters this rank holds in GiB and as a share
    of the whole LM's (FSDP: each weight its rule's block)."""
    import math

    from repro_torch.launch.train import train_loop
    from repro_torch.train.step import TrainHParams
    stats, step_ms = {}, []

    def on_step(s, m, p):
        stats.update(p.program.stats())
        step_ms.append(m["step_s"] * 1e3)
    torch.cuda.reset_peak_memory_stats()
    state, losses = train_loop(
        cfg, steps=steps, batch_per_shard=batch, seq=seq,
        hp=TrainHParams(**SHARD_HP), device="cuda", log_every=10 ** 9,
        graphs=graphs, mesh=mesh, on_step=on_step)
    lay = state.layout
    held = sum(p.numel() * p.element_size() for p in state.params.values())
    whole = sum(math.prod(lay.shapes[n]) * p.element_size()
                for n, p in state.params.items())
    out = dict(losses=losses, step_ms=step_ms, stats=stats,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               params_gib=held / 2 ** 30, params_share=held / whole,
               data_split=sum(h.data is not None
                              for h in lay.place.values()))
    del state, lay
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _fsdp_glm4_case(rank, world, out_dir):
    """(e) glm4-9b at full width and depth (bf16) on (4, 1), every weight
    held as its rule's block (FSDP), 1 x 512 tokens a rank: 3 eager
    steps (the FSDP gathers and reduce-scatters timed: ``core.tp.
    COMM_MS``), 3 captured steps; then (1, 4) on the same global batch
    (4 x 512), one eager step."""
    from repro_torch import configs
    from repro_torch.core import tp
    from repro_torch.launch.mesh import make_device_mesh
    cfg = configs.get("glm4-9b")
    m41 = make_device_mesh("cuda", (4, 1), ("data", "model"))
    tp.COMM_MS = {}
    try:
        eager = _fsdp_run(cfg, m41, 1, 512, False, steps=3)
    finally:
        comm, tp.COMM_MS = tp.COMM_MS, None
    eager["fsdp_ms"] = {k: sum(v) / 3 for k, v in comm.items()}
    eager["fsdp_calls"] = {k: len(v) / 3 for k, v in comm.items()}
    graph = _fsdp_run(cfg, m41, 1, 512, True, steps=3)
    m14 = make_device_mesh("cuda", (1, 4), ("data", "model"))
    mp = _fsdp_run(cfg, m14, 4, 512, False, steps=1)
    return {"eager": eager, "graph": graph, "mp": mp}


_SHARD_CASES.update(fsdp_glm4=_fsdp_glm4_case)


@pytest.mark.cuda
def test_fsdp_nccl_glm4_full_depth_four_by_one(dev, tmp_path):
    """(e) glm4-9b at full width and depth (40 layers, 9.4 B parameters,
    bf16) trained on (4, 1) over NCCL with every weight held as its
    rule's block over ``"data"`` (FSDP; ``all_gather_into_tensor`` in
    the forward, ``reduce_scatter_tensor`` in the backward): 3 steps
    captured as one CUDA graph bit-equal to 3 eager steps, the
    parameters a rank within 5 % of a quarter of one process's, the
    first loss within bf16 2e-2 of the (1, 4) model-parallel run's on
    the same global batch, every rank under 80 GiB.  Prints step ms, the
    gathers' and reduce-scatters' ms a step (eager, synchronised), peak
    and held GiB a rank.  Needs four cards."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    _free_card()
    outs = _spawn_nccl(tmp_path, 4, "fsdp_glm4", timeout=1200)
    for r, o in enumerate(outs):
        eager, graph, mp = o["eager"], o["graph"], o["mp"]
        assert all(np.isfinite(eager["losses"])), (r, eager["losses"])
        assert graph["losses"] == eager["losses"], r
        assert eager["data_split"] > 0 and mp["data_split"] == 0, r
        assert abs(eager["params_share"] - 0.25) <= 0.05 * 0.25, \
            (r, eager["params_share"])
        assert abs(eager["losses"][0] - mp["losses"][0]) <= \
            2e-2 * abs(mp["losses"][0]), (r, eager["losses"], mp["losses"])
        for run in (eager, graph, mp):
            assert run["peak_gib"] < 80, (r, run["peak_gib"])
        print(f"[fsdp-nccl] glm4-9b (4, 1) rank {r}: losses "
              f"{eager['losses']} (captured bit-equal); (1, 4) first loss "
              f"{mp['losses'][0]}; eager step ms "
              f"{[round(v, 1) for v in eager['step_ms']]} (gathers "
              f"synchronised), FSDP ms a step "
              f"{ {k: round(v, 1) for k, v in eager['fsdp_ms'].items()} } "
              f"({ {k: round(v) for k, v in eager['fsdp_calls'].items()} } "
              f"calls); captured step ms "
              f"{[round(v, 1) for v in graph['step_ms']]}; parameters "
              f"{eager['params_gib']:.2f} GiB a rank = "
              f"{eager['params_share']:.4f} of one process's ((1, 4): "
              f"{mp['params_gib']:.2f}); peak eager "
              f"{eager['peak_gib']:.2f}, captured {graph['peak_gib']:.2f}, "
              f"(1, 4) {mp['peak_gib']:.2f} GiB")
    assert outs[0]["graph"]["stats"]["captures"] == 1
    print(f"[fsdp-nccl] cards {_card_lines()}")
