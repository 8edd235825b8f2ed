"""The dry-run (``repro_torch.launch.dryrun``), its report and the configs'
shape-only specs, against the JAX package's on the CPU.

* ``input_specs`` / ``param_specs``: every leaf's shape and dtype equal
  to the reference's ``ShapeDtypeStruct`` (``jax.eval_shape``), through
  ``LM.jax_leaves`` names, for all 10 architectures x 4 shape cells.
* Each kernel's meta branch (``kernels/meta.py``) gives the plain
  version's output shape, dtype and strides at a ``[kernel]`` shape of
  ``chip_smoke.py``, counts its work and launches nothing.
* A meta plan takes the analytic route ``dispatch.decide`` gives for
  the card's routes, and the card's walks.
* A smoke config's dry-run on fake meshes (1, 1), (1, 2) and (2, 2)
  reports, for the traced rank, the argument bytes of the same rank's
  CPU build on the same fake mesh, to the byte.
* A cell that cannot fit is listed and the CLI exits 1.
* The port's ``report.table`` prints the reference's text on records in
  the reference's layout (the reference module imports no JAX).
"""
import dataclasses
import importlib
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.analysis import report as jreport  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import sparse as tsparse  # noqa: E402
from repro_torch.analysis import report as treport  # noqa: E402
from repro_torch.core import dispatch, masks  # noqa: E402
from repro_torch.core.bsr import BlockSparseMatrix  # noqa: E402
from repro_torch.kernels import meta as kmeta  # noqa: E402
from repro_torch.kernels.bs_attn import ops as bs_ops  # noqa: E402
from repro_torch.kernels.bs_attn.ref import attend_plain  # noqa: E402
from repro_torch.kernels.bsmm import balanced as bal_ops  # noqa: E402
from repro_torch.kernels.bsmm import ops as bsmm_ops  # noqa: E402
from repro_torch.kernels.dense_mm import ops as dmm_ops  # noqa: E402
from repro_torch.kernels.dsmm import ops as dsmm_ops  # noqa: E402
from repro_torch.kernels.gmm import ops as gmm_ops  # noqa: E402
from repro_torch.kernels.gmm.ref import gmm_ref  # noqa: E402
from repro_torch.kernels.sddmm import ops as sddmm_ops  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.model import LM as TLM  # noqa: E402
from repro_torch.train.step import init_train_state  # noqa: E402

plan_mod = importlib.import_module("repro_torch.sparse.plan")

META = torch.device("meta")


# ---------------------------------------------------------------------------
# input_specs / param_specs against the reference's ShapeDtypeStructs
# ---------------------------------------------------------------------------

def _dt(x) -> str:
    return str(x.dtype).replace("torch.", "")


class _Abstract:
    """A ``ShapeDtypeStruct``'s shape and dtype that ``LM.jax_leaves``
    can unstack (``[r]`` drops the leading axis)."""

    def __init__(self, shape, dtype):
        self.shape, self.dtype = shape, dtype

    def __getitem__(self, r):
        return _Abstract(self.shape[1:], self.dtype)


def _cache_leaves(cfg, tree):
    """The reference's stacked caches (groups x period positions, each
    leaf ``[repeat, ...]``) as ``{(layer, key): (shape, dtype)}`` in
    execution order, as the port lists one dict a layer."""
    out, li = {}, 0
    for (period, rep), group in zip(cfg.groups, tree):
        for r in range(rep):
            for si in range(len(period)):
                for k, v in group[si].items():
                    out[(li + r * len(period) + si, k)] = (
                        tuple(v.shape[1:]), str(v.dtype))
        li += rep * len(period)
    return out


@pytest.mark.parametrize("shape", list(tconfigs.SHAPES))
@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_input_and_param_specs_match_reference(arch, shape):
    jkind, jkw = jconfigs.input_specs(arch, shape)
    tkind, tkw = tconfigs.input_specs(arch, shape)
    assert tkind == jkind
    tcfg = tconfigs.get(arch)
    if tkind == "train":
        jkw, tkw = jkw["batch"], tkw["batch"]
    if tkind == "decode":
        assert tkw["retained"] == jkw["retained"]
        jc = _cache_leaves(jconfigs.get(arch), jkw.pop("caches"))
        tc = {(i, k): (tuple(v.shape), _dt(v))
              for i, c in enumerate(tkw.pop("caches")) for k, v in c.items()}
        assert tc == jc
        jkw.pop("retained")
        tkw.pop("retained")
    assert set(tkw) == set(jkw)
    for k, v in tkw.items():
        assert v.device.type == "meta"
        assert (tuple(v.shape), _dt(v)) == (tuple(jkw[k].shape),
                                            str(jkw[k].dtype)), k
    if shape != "train_4k":
        return
    # the parameters, once an architecture
    jp = jax.tree.map(lambda v: _Abstract(tuple(v.shape), str(v.dtype)),
                      jconfigs.param_specs(arch))
    tp = tconfigs.param_specs(arch)
    lm = TLM(tcfg, device="meta")
    want = {n: (v.shape, v.dtype) for n, v in lm.jax_leaves(jp).items()}
    got = {n: (tuple(v.shape), _dt(v)) for n, v in tp.items()}
    assert got == want
    assert all(v.device.type == "meta" for v in tp.values())


# ---------------------------------------------------------------------------
# the kernels' meta branches
# ---------------------------------------------------------------------------

def _same_layout(got, want):
    """Shape, dtype and strides of the plain version's output; every
    kernel writes its output row-major, as the plain versions do but for
    attention's, a transposed view of its ``[B, H, S, dh]`` product (its
    row-major strides are compared)."""
    assert got.device.type == "meta"
    assert (tuple(got.shape), got.dtype, got.stride()) == \
        (tuple(want.shape), want.dtype, want.contiguous().stride())


def _static_plan(m, k, b, density, n, dev, mode="auto", seed=1):
    mask = masks.random_block_mask(m, k, b, density, seed=seed)
    nnz = int(mask.sum())
    vals = torch.zeros((nnz, b, b), dtype=torch.bfloat16, device=dev)
    bsr = BlockSparseMatrix.from_mask(mask, b, values=vals)
    p = tsparse.plan(bsr, n, device=dev,
                     ctx=tsparse.PlanContext(mode=mode))
    return bsr, vals, p


def _empty(shape, dt=torch.bfloat16):
    return torch.empty(shape, dtype=dt, device=META)


def _launches():
    mods = (bs_ops, bsmm_ops, bal_ops, dmm_ops, dsmm_ops, gmm_ops,
            sddmm_ops)
    return [m.COUNTER.launches for m in mods]


def _case_dense_mm():
    x, w = _empty((256, 2048)), _empty((2048, 512))
    return "dense_mm", dmm_ops.dense_mm(x, w), dmm_ops.dense_mm_plain(x, w)


def _case_bsmm():
    _, vals, p = _static_plan(8192, 2048, 16, 1 / 8, 256, META)
    x = _empty((256, 2048))
    return "bsmm", p.run_packed(p.pack(vals), x), bsmm_ops.bsmm_nt_plain(
        x, p.pack(vals), p.tile_rows.long(), p.tile_cols.long(), 8192)


def _case_bsmm_balanced():
    _, vals, p = _static_plan(4096, 4096, 16, 1 / 32, 256, META,
                              mode="static_balanced")
    x = _empty((256, 4096))
    vr, vc, vs = p.visit
    return "bsmm_balanced", p.run_packed(p.pack(vals), x), \
        bal_ops.bsmm_balanced_plain(x, p.pack(vals), vr, vc, vs, 4096)


def _case_sddmm():
    _, vals, p = _static_plan(8192, 2048, 16, 1 / 8, 2048, META)
    dy, x = _empty((2048, 8192)), _empty((2048, 2048))
    g = p.grad
    return "sddmm", sddmm_ops.sddmm(dy, x, g.block_row_ptr, g.col_idx,
                                    g.row_idx, 16), \
        sddmm_ops.sddmm_plain(dy, x, g.row_idx.long(), g.col_idx.long(), 16)


def _case_dsmm():
    s = 2048
    vals = _empty((s, 16, 16))
    rows = torch.empty((s,), dtype=torch.int32, device=META)
    cols = torch.empty((s,), dtype=torch.int32, device=META)
    x = _empty((256, 2048))
    return "dsmm", dsmm_ops.dsmm_slots(x, vals, rows, cols, 8192), \
        dsmm_ops.dsmm_plain(x, vals, rows, cols, 8192)


def _case_gmm():
    e, c, d, f = 128, 80, 2048, 768
    tm = plan_mod.batched_row_tile(c, gmm_ops.tma_ok(d, f, torch.bfloat16))
    x, w = _empty((e * c, d)), _empty((e, d, f))
    ids = torch.empty((e * c // tm,), dtype=torch.int32, device=META)
    return "gmm", gmm_ops.gmm(x, w, ids, tm=tm), gmm_ref(x, w, ids, tm=tm)


def _case_bs_attn():
    from repro_torch.models import attention as attn
    s, h, kvh, dh = 512, 32, 8, 64
    q = _empty((4, s, h, dh))
    k, v = _empty((4, s, kvh, dh)), _empty((4, s, kvh, dh))
    spec = attn.attn_spec(s, s, dh)
    return "bs_attn", attn._attend_forward(q, k, v, spec), attend_plain(
        q, k, v, spec.element_mask(META), scale=spec.scale)


KERNEL_CASES = [_case_dense_mm, _case_bsmm, _case_bsmm_balanced,
                _case_sddmm, _case_dsmm, _case_gmm, _case_bs_attn]


@pytest.mark.parametrize("case", KERNEL_CASES, ids=lambda c: c.__name__[6:])
def test_kernel_meta_branch_matches_plain_layout(case):
    kmeta.reset()
    before = _launches()
    name, got, want = case()
    _same_layout(got, want)
    work = kmeta.totals()
    assert work[name]["calls"] >= 1
    assert work[name]["flops"] > 0 and work[name]["bytes"] > 0
    assert sum(w["calls"] for w in work.values()) == work[name]["calls"]
    assert _launches() == before


def test_meta_branch_is_reached_by_meta_tensors_only():
    """A CPU tensor runs the plain version (no meta work counted); the
    CUDA entry points refuse a CPU tensor."""
    kmeta.reset()
    x, w = torch.randn(4, 8), torch.randn(8, 16)
    assert torch.allclose(dmm_ops.dense_mm(x, w), x @ w, atol=1e-5)
    assert kmeta.totals()["dense_mm"]["calls"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        dmm_ops.dense_mm_cuda(x, w)


# ---------------------------------------------------------------------------
# plans on the meta device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [4, 256, 2048])
def test_meta_plan_takes_the_cards_analytic_route(n):
    bsr, _, p = _static_plan(8192, 2048, 16, 1 / 8, n, META)
    spec = p.spec
    ctx = tsparse.PlanContext()
    pkey = plan_mod.pattern_key(bsr.row_idx, bsr.col_idx)
    skew, counts = plan_mod._pattern_info(pkey, bsr.row_idx, bsr.col_idx,
                                          spec)
    cands = plan_mod._admissible(dispatch._candidates("static", "auto",
                                                      "cuda"), spec, ctx)
    dec = dispatch.decide(spec, "cuda", counts=counts, skew=skew,
                          candidates=cands)
    assert p.route == dec.route and p.route.endswith("_cuda")
    assert p.source == "analytic"
    # the card's walks: bsmm's tensor-core schedule at b 16 in bf16
    assert p.mma is not None and p.grad.mma is not None
    assert p.grad_routes["dvalues"].endswith("_cuda")
    # a dense projection plans as the card's too
    d = tsparse.plan(tsparse.OpSpec(kind="dense", m=512, k=2048, n=n,
                                    dtype="bfloat16"), device=META)
    assert d.route == "dense_cuda"


def test_meta_plan_refuses_a_measured_race():
    mask = masks.random_block_mask(256, 256, 16, 0.25, seed=2)
    vals = torch.zeros((int(mask.sum()), 16, 16), dtype=torch.bfloat16,
                       device=META)
    bsr = BlockSparseMatrix.from_mask(mask, 16, values=vals)
    with pytest.raises(ValueError, match="measured route race"):
        tsparse.plan(bsr, 64, device=META,
                     ctx=tsparse.PlanContext(measure=True))


# ---------------------------------------------------------------------------
# the dry-run of a smoke config on fake meshes
# ---------------------------------------------------------------------------

def _smoke_cfg():
    return tconfigs.sparsify_ffn(tconfigs.smoke("llama3.2-1b"), 0.5)


@pytest.mark.parametrize("sizes", [(1, 1), (1, 2), (2, 2)])
def test_dryrun_argument_bytes_equal_cpu_build(tmp_path, sizes):
    cfg = _smoke_cfg()
    names = ("data", "model")
    rec = dryrun.run_cell("llama3.2-1b", "train_4k", cfg=cfg,
                          mesh_shape=(sizes, names),
                          sh=dict(batch=4, seq=32), save=True,
                          verbose=False, out_dir=str(tmp_path))
    rank = rec["rank"]
    with dryrun.fake_mesh(sizes, names, rank) as mesh:
        lm = TLM(cfg, device="cpu", mesh=mesh)
        state = init_train_state(lm, mesh=mesh)
        cpu = dryrun.state_tensors(lm, state)
        cpu_bytes = dryrun.tensor_bytes(cpu)
        cell = dryrun.build_cell("llama3.2-1b", "train_4k", mesh, cfg=cfg,
                                 sh=dict(batch=4, seq=32))
        meta_args = {k: v for k, v in cell.args.items()
                     if not k.startswith("batch.")}
    assert {k: (tuple(v.shape), v.dtype) for k, v in meta_args.items()} \
        == {k: (tuple(v.shape), v.dtype) for k, v in cpu.items()}
    assert dryrun.tensor_bytes(meta_args, round_up=False) == \
        dryrun.tensor_bytes(cpu, round_up=False)
    by_rank = rec["memory"]["argument_bytes_by_rank"]
    assert by_rank["max"] == cpu_bytes
    # the smoke shapes race to the card's dense kernel: dense_mm and
    # bs_attn launch, each plan on a card's route
    assert rec["fits"] and rec["kernels"]["dense_mm"]["calls"] > 0
    assert rec["kernels"]["bs_attn"]["calls"] > 0
    assert {p["route"] for p in rec["plans"]} <= \
        set(plan_mod.PLAN_ROUTES["cuda"]) | {"static_tp_shardmap"}
    if sizes[1] > 1:
        assert rec["cost"]["collective_bytes_by_axis"].get("model", 0) > 0
    if sizes[0] > 1:
        assert rec["cost"]["collective_bytes_by_axis"].get("data", 0) > 0
    saved = json.loads(next(tmp_path.glob("*.json")).read_text())
    assert saved["memory"]["argument_mb"] == rec["memory"]["argument_mb"]


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "long_500k"])
def test_dryrun_serving_cells_trace(shape):
    cfg = _smoke_cfg()
    rec = dryrun.run_cell("llama3.2-1b", shape, cfg=cfg, save=False,
                          verbose=False,
                          mesh_shape=((1, 2), ("data", "model")),
                          sh=dict(batch=2, seq=64))
    assert rec["fits"] and rec["memory"]["output_mb"] > 0
    assert rec["cost"]["flops"] > 0 and rec["plans"]
    assert all(p["route"].endswith("_cuda") or p["route"].startswith(
        "static_tp") for p in rec["plans"])


def test_gemma2_production_cell_traces_with_whole_heads():
    """gemma2-2b's 8 query heads do not split over the (16, 16) mesh's 16
    model ranks: its GQA runs whole on every rank, and the cell reports a
    rank's bytes, not an error."""
    rec = dryrun.run_cell("gemma2-2b", "decode_32k", save=False,
                          verbose=False)
    assert "error" not in rec
    assert rec["memory"]["argument_mb"] > 0 and rec["memory"]["peak_gib"] > 0
    assert rec["devices"] == 256 and rec["kernels"]


def test_cell_that_cannot_fit_is_listed_and_exits_1(tmp_path, capsys):
    with pytest.raises(SystemExit) as ex:
        dryrun.main(["--arch", "glm4-9b", "--shape", "decode_32k",
                     "--mesh-shape", "1,1", "--out", str(tmp_path)])
    assert ex.value.code == 1
    out = capsys.readouterr().out
    assert "FAIL" in out and "glm4-9b" in out and "does NOT fit" in out
    rec = json.loads((tmp_path / "glm4_9b__decode_32k__1x1.json")
                     .read_text())
    assert rec["fits"] is False and rec["memory"]["peak_gib"] > 74.5
    treport.main(["--dir", str(tmp_path)])
    assert f"do not fit: {rec['arch']} x decode_32k on 1x1" in \
        capsys.readouterr().out


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------

def _ref_records():
    rng = np.random.default_rng(0)
    recs = []
    for arch in ("llama3.2-1b", "gemma2-2b"):
        for shape in ("train_4k", "decode_32k"):
            tc, tm, tl = rng.uniform(1e-4, 1e-1, 3)
            ro = dict(t_compute=tc, t_memory=tm, t_collective=tl,
                      dominant=max(("compute", tc), ("memory", tm),
                                   ("collective", tl),
                                   key=lambda kv: kv[1])[0],
                      bound_seconds=max(tc, tm, tl),
                      useful_flop_frac=float(rng.uniform()),
                      roofline_frac=float(rng.uniform()))
            recs.append(dict(arch=arch, shape=shape, mesh="16x16",
                             roofline=ro))
    return recs


@pytest.mark.parametrize("fmt", ["md", "txt"])
def test_report_table_prints_the_references_text(fmt):
    recs = _ref_records()
    assert treport.table(recs, fmt=fmt) == jreport.table(recs, fmt=fmt)
    assert treport.interesting_cells(recs) == jreport.interesting_cells(recs)
    # the port's records add fits and peak after the reference's columns
    port = [dict(r, fits=i % 2 == 0, memory={"peak_gib": 10.0 * i})
            for i, r in enumerate(recs)]
    got = treport.table(port, fmt="md").splitlines()
    want = jreport.table(recs, fmt="md").splitlines()
    assert got[0] == want[0][:-1] + "| fits | peak_GiB |"
    for g, w, r in zip(got[2:], want[2:], port):
        assert g == w[:-1] + (f"| {'yes' if r['fits'] else 'NO'} | "
                              f"{r['memory']['peak_gib']:.2f} |")


def test_report_lists_raised_cells(tmp_path, capsys):
    recs = _ref_records()
    for i, r in enumerate(recs):
        r = dict(r, fits=True, memory={"peak_gib": 1.0},
                 cost={"collective_bytes_by_axis": {"model": 2e9}})
        (tmp_path / f"a{i}__{r['shape']}__16x16.json").write_text(
            json.dumps(r))
    (tmp_path / "b__train_4k__16x16.json").write_text(json.dumps(dict(
        arch="GEMMA", shape="train_4k", mesh="16x16", devices=256,
        error="NotImplementedError('8 query heads')", fits=False)))
    treport.main(["--dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "raised: GEMMA x train_4k on 16x16" in out
    # the fit table: a row an architecture, every shape's meshes a cell
    treport.main(["--dir", str(tmp_path), "--fit"])
    rows = capsys.readouterr().out.splitlines()
    assert rows[0] == "| arch | decode_32k | train_4k |"
    assert "| GEMMA | - | 16x16: raises NotImplementedError(" in rows[2]
    assert "16x16: 1.00, " in rows[3] and ", model 2 |" in rows[3]
    assert len(treport.load_records(directory=str(tmp_path))) == 5
    with pytest.raises(FileNotFoundError):
        treport.load_records(directory=str(tmp_path / "missing"))


def test_dataclass_configs_agree():
    """The port's configs equal the reference's field by field (the specs
    above rest on it)."""
    for arch in tconfigs.ARCH_IDS:
        assert dataclasses.asdict(tconfigs.get(arch)) == \
            dataclasses.asdict(jconfigs.get(arch))
    assert jax is not None
