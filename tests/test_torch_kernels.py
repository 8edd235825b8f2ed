"""The port's kernel modules against the JAX package.

On the CPU each wrapper runs its kernel's plain PyTorch version; these
tests hold that version against the JAX Pallas kernel in interpret mode
and against the JAX ``ref.py`` oracle, on the same seeded numpy inputs.
Budgets are ``tests/conftest.py``'s per-dtype ones (fp32 1e-4, bf16
6e-2, rel-max over the reference's max magnitude).  The CUDA kernels
themselves are held against these plain versions on a card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
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
from repro.kernels.dense_mm import ops as jdmm_ops  # noqa: E402
from repro_torch import sparse as tsparse  # noqa: E402
from repro_torch.core.bsr import BlockSparseMatrix as TBSR  # noqa: E402
from repro_torch.kernels import contract as tcontract  # noqa: E402
from repro_torch.kernels.bsmm import ops as tbsmm_ops  # noqa: E402
from repro_torch.kernels.dense_mm import ops as tdmm_ops  # noqa: E402

TDTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _case(m, k, n, b, density, seed, empty):
    mask = jmasks.random_block_mask(m, k, b, density, seed=seed)
    if empty:
        mask[0] = False
        mask[-1] = False
    rng = np.random.default_rng(seed)
    nnz = int(mask.sum())
    vals = rng.standard_normal((nnz, b, b)).astype(np.float32)
    x = rng.standard_normal((n, k)).astype(np.float32)
    return mask, vals, x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b", [4, 16])
@pytest.mark.parametrize("empty", [False, True], ids=["full", "empty_rows"])
def test_bsmm_plain_matches_jax(dtype, b, empty):
    m, k, n = 64, 128, 24
    mask, vals, x = _case(m, k, n, b, 0.25, 3 + b, empty)
    jb = JBSR.from_mask(mask, b).with_values(
        jnp.asarray(vals, JDTYPE[dtype]))
    jx = jnp.asarray(x, JDTYPE[dtype])
    tm, tk, _ = jbsmm_ops._pick_tiles(m, k, n, b)
    meta = jpart.plan_packing(jb.row_idx, jb.col_idx, (m, k), b, tm, tk)
    want_kernel = np.asarray(jbsmm_ops.bsmm_from_plan(
        meta, jb.values, jx.T, interpret=True).T.astype(jnp.float32))
    want_ref = np.asarray(bsmm_ref(jb, jx.T).T.astype(jnp.float32))

    tb = TBSR.from_mask(mask, b, values=torch.from_numpy(vals).to(
        TDTYPE[dtype]))
    plan = tsparse.plan(tb, n, device="cpu",
                        ctx=tsparse.PlanContext(mode="static"))
    assert plan.route == "static_torch"
    tiles = plan.pack(tb.values)
    got = tbsmm_ops.bsmm_nt(torch.from_numpy(x).to(TDTYPE[dtype]), tiles,
                            plan.row_ptr, plan.tile_cols, plan.tile_rows, m)
    assert got.dtype == TDTYPE[dtype] and got.shape == (n, m)
    assert_close_for_dtype(got.float(), want_kernel, dtype, "bsmm vs pallas")
    assert_close_for_dtype(got.float(), want_ref, dtype, "bsmm vs ref")
    if empty:
        assert torch.all(got[:, :b] == 0) and torch.all(got[:, -b:] == 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spmm_api_matches_jax_plan(dtype):
    from repro import sparse as jsparse
    m, k, n, b = 64, 128, 16, 16
    mask, vals, x = _case(m, k, n, b, 0.25, 21, False)
    jb = JBSR.from_mask(mask, b).with_values(
        jnp.asarray(vals, JDTYPE[dtype]))
    want = np.asarray(jsparse.spmm(jb, jnp.asarray(x.T, JDTYPE[dtype])
                                   ).astype(jnp.float32))
    tb = TBSR.from_mask(mask, b, values=torch.from_numpy(vals).to(
        TDTYPE[dtype]))
    xt = torch.from_numpy(x).to(TDTYPE[dtype])
    assert_close_for_dtype(tsparse.spmm(tb, xt.t()).float(), want, dtype,
                           "spmm")
    # activation-major form on a 3-D input
    got_nt = tsparse.spmm_nt(tb, xt.reshape(2, n // 2, k))
    assert_close_for_dtype(got_nt.reshape(n, m).float(), want.T, dtype,
                           "spmm_nt")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,k,d", [(24, 64, 48), (4, 128, 32)])
def test_dense_mm_plain_matches_jax(dtype, n, k, d):
    rng = np.random.default_rng(n + k + d)
    x = rng.standard_normal((n, k)).astype(np.float32)
    w = rng.standard_normal((k, d)).astype(np.float32)
    want = np.asarray(jdmm_ops.dense_mm(
        jnp.asarray(x, JDTYPE[dtype]), jnp.asarray(w, JDTYPE[dtype]),
        interpret=True).astype(jnp.float32))
    tx = torch.from_numpy(x).to(TDTYPE[dtype])
    tw = torch.from_numpy(w).to(TDTYPE[dtype])
    got = tdmm_ops.dense_mm(tx, tw)
    assert got.dtype == TDTYPE[dtype]
    assert_close_for_dtype(got.float(), want, dtype, "dense_mm")
    # the plan API's matmul takes the same route on the CPU
    assert_close_for_dtype(tsparse.matmul(tx[None], tw)[0].float(), want,
                           dtype, "matmul")


# dense_mm.walk at qwen3-moe's attention projections: (name, k, d) ->
# the walk's initial and its K slices at N in WALK_NS, bf16 then fp32
# ("d" decode, "w" wgmma, "f" ffma); 64-row tiles where 128-row ones fill
# under half the card, K split where the tiles fill under a quarter
WALK_NS = (1, 4, 16, 17, 64, 256, 1008, 4096)
WALKS = {
    ("q", 2048, 4096): ("w1 w1 w1 w1 w1 w1 w1 w1",
                        "d8 d8 d8 f3 f3 f1 f1 f1"),
    ("k/v", 2048, 512): ("d8 d8 w8 w8 w8 w5 w1 w1",
                         "d8 d8 d8 f8 f8 f5 f2 f1"),
    ("o", 4096, 2048): ("w5 w5 w5 w5 w5 w1 w1 w1",
                        "d8 d8 d8 f5 f5 f2 f1 f1"),
}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name,k,d", sorted(WALKS))
def test_dense_mm_walk_selection(name, k, d, dtype):
    want = WALKS[(name, k, d)][dtype == "float32"].split()
    got = [tdmm_ops.walk(n, k, d, dtype) for n in WALK_NS]
    assert [f"{w.name[0]}{w.slices}" for w in got] == want
    for n, w in zip(WALK_NS, got):
        if w.name == "wgmma":
            big = (-(-n // 128)) * (-(-d // 128)) >= tdmm_ops.SMS // 2
            assert w.bm == w.bn == (128 if big else 64)
            assert w.blocks == (-(-n // w.bm)) * (-(-d // w.bn)) * w.slices
        if w.name == "decode":
            assert n <= tdmm_ops.DECODE_MAX_N and w.slices <= 8
        if n <= tdmm_ops.DECODE_MAX_N and dtype == "bfloat16":
            # the cheaper walk by the time model
            assert w.name == min(("decode", "wgmma"), key=lambda c: (
                tdmm_ops.walk_seconds(c, n, k, d, dtype)))


@pytest.mark.parametrize("n,k,d,walk", [
    (256, 333, 512, "ffma"), (256, 2048, 100, "ffma"),
    (4, 2048, 100, "decode"), (1008, 2048, 4096, "wgmma")])
def test_dense_mm_walk_without_tma(n, k, d, walk):
    """K or D not a multiple of 8 (row strides TMA cannot take) leaves
    the tensor-core walk in 16-bit types."""
    assert tdmm_ops.tma_ok(k, d, "bfloat16") == (k % 8 == 0 and d % 8 == 0)
    assert tdmm_ops.walk(n, k, d, torch.bfloat16).name == walk


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("k", [2048, 16384, 24576, 28672, 32768, 65536])
def test_dense_mm_decode_walk_fits_shared_memory(k, dtype):
    """The decode walk is picked only where its block holds x's fp32 K
    slice and the sums in 227 KB; past that, N <= 16 takes the tensor-core
    walk in 16-bit types and the FMA walk in fp32."""
    es = 4 if dtype == "float32" else 2
    for n in (1, 4, 8, 9, 16):
        w = tdmm_ops.walk(n, k, 1024, dtype)
        nt = 1 << (n - 1).bit_length()
        if w.name == "decode":
            kc = -(-k // w.slices)
            assert 4 * (nt * kc + 9 * nt * w.cl * 16 // es) <= 227 * 1024
        else:
            assert w.name == ("ffma" if dtype == "float32" else "wgmma")
    # N 16 at K 32768 cannot stage x on the decode walk
    assert tdmm_ops.walk(16, 32768, 1024, dtype).name != "decode"


def test_plan_cache_and_routes():
    tsparse.reset()
    mask = jmasks.random_block_mask(64, 64, 16, 0.5, seed=0)
    bsr = TBSR.from_mask(mask, 16)
    ctx = tsparse.PlanContext(mode="static")
    p1 = tsparse.plan(bsr, 8, device="cpu", ctx=ctx)
    p2 = tsparse.plan(TBSR.from_mask(mask, 16), 8, device="cpu", ctx=ctx)
    assert p1 is p2 and p1.route == "static_torch"
    # a verdict depends on the token count: another n is another plan
    p3 = tsparse.plan(bsr, 32, device="cpu", ctx=ctx)
    assert p3 is not p1 and p3.route == "static_torch"
    w = torch.zeros(64, 32)
    pd = tsparse.plan(w, 4, device="cpu")
    assert pd.route == "dense_torch" and pd.kind == "dense"
    assert pd.source == "forced"
    stats = tsparse.cache_stats()
    assert stats["plans_built"] == 3 and stats["plan_hits"] == 1
    assert p1.packing.tm == p1.packing.tk == 16
    assert p1.row_ptr.tolist() == p1.packing.row_ptr().tolist()
    tsparse.reset()
    assert tsparse.cache_stats()["cached"] == 0


def test_plan_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    bsr = TBSR.from_mask(np.ones((2, 2), bool), 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsparse.plan(bsr, 4)


def test_cuda_wrappers_reject_cpu_tensors():
    x = torch.zeros(4, 32)
    with pytest.raises(ValueError, match="CUDA"):
        tdmm_ops.dense_mm_cuda(x, torch.zeros(32, 8))
    tiles = torch.zeros(2, 16, 16)
    with pytest.raises(ValueError, match="CUDA"):
        tbsmm_ops.bsmm_nt_cuda(x, tiles, torch.tensor([0, 1, 2],
                                                      dtype=torch.int32),
                               torch.tensor([0, 1], dtype=torch.int32), 32)


@pytest.mark.parametrize("bad, msg", [
    (dict(tiles=torch.zeros(2, 16, 8)), "square tiles"),
    (dict(tiles=torch.zeros(2, 12, 12)), "square tiles"),
    (dict(m=40), "multiples"),
    (dict(tiles=torch.zeros(2, 16, 16, dtype=torch.float64)), "dtypes"),
    (dict(row_ptr=torch.tensor([0, 2], dtype=torch.int32)), "row_ptr has"),
    (dict(tile_cols=torch.tensor([0, 1])), "int32"),
])
def test_bsmm_wrapper_validates(bad, msg):
    args = dict(x=torch.zeros(4, 32), tiles=torch.zeros(2, 16, 16),
                row_ptr=torch.tensor([0, 1, 2], dtype=torch.int32),
                tile_cols=torch.tensor([0, 1], dtype=torch.int32), m=32)
    args.update(bad)
    with pytest.raises(ValueError, match=msg):
        tbsmm_ops.bsmm_nt_cuda(**args)


def test_contracts_name_routes_and_reference():
    reg = tcontract.load_all()
    assert set(reg) == {"bs_attn", "bsmm", "bsmm_balanced", "dense_mm",
                        "dsmm", "gmm", "sddmm"}
    assert tcontract.contract_for_route("static_cuda").kernel == "bsmm"
    assert tcontract.contract_for_route("dense_cuda").kernel == "dense_mm"
    assert tcontract.contract_for_route("sddmm_cuda").kernel == "sddmm"
    assert (tcontract.contract_for_route("static_balanced_cuda").kernel
            == "bsmm_balanced")
    for route in ("dynamic_cuda", "dynamic_grouped_cuda",
                  "dynamic_grouped_balanced_cuda"):
        assert tcontract.contract_for_route(route).kernel == "dsmm"
    assert reg["sddmm"].admits(8192, 2048, 2048, 16, "bfloat16") is None
    assert "fails" in reg["sddmm"].admits(64, 64, 4, 12)
    bsmm = reg["bsmm"]
    assert bsmm.admits(8192, 2048, 4, 16, "bfloat16") is None
    assert "outside" in bsmm.admits(64, 64, 4, 128)
    assert "fails" in bsmm.admits(64, 64, 4, 12)
    assert reg["dense_mm"].admits(2048, 512, 3, 1, "float16") is None
    for c in reg.values():
        assert c.replaces.startswith("src/repro/kernels/")


def test_build_hashes_the_headers_a_source_includes(tmp_path, monkeypatch):
    """A kernel library is keyed by its source and every header it
    includes (through other headers too), so an edit to a shared header
    rebuilds each source that includes it; the tensor-core sources share
    ``hopper.cuh``."""
    from repro_torch.kernels import _build
    for name in ("dense_mm", "bs_attn", "gmm"):
        src = _build._target(name)[0]
        assert [p.rsplit("/", 1)[1] for p in _build.includes(src)] == [
            "hopper.cuh"]
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <x.h>\n')
    monkeypatch.setitem(_build.SOURCES, "probe", str(tmp_path / "k.cu"))
    assert [p.rsplit("/", 1)[1] for p in _build.includes(
        str(tmp_path / "k.cu"))] == ["a.cuh", "b.cuh"]
    before = _build._target("probe")[1]
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    assert _build._target("probe")[1] != before
    (tmp_path / "k.cu").write_text('#include "missing.cuh"\n')
    with pytest.raises(FileNotFoundError, match="missing.cuh"):
        _build._target("probe")
