"""The MoE slice against the JAX package: the gmm kernel's plain version,
``sparse.batched_matmul``, ``moe_apply`` and qwen3-moe-30b-a3b's smoke
config (two layers, 8 experts top-2, QK-norm) end to end, on seeded
numpy inputs given to both packages, in fp32 unless a case says.

Budgets: rel-max over the JAX output's max magnitude.  gmm and
batched_matmul 1e-4 in fp32 (the products differ only by summation
order), 2e-2 in bf16 (one rounding of each fp32-accumulated output);
``moe_apply`` and the LM's logits 2e-4 (the slice budget of the llama and
gemma2 slices); ``aux_loss`` and ``z_loss`` 1e-5 (fp32 sums over the
experts and tokens in another order).  ``dropped_frac`` of one
``moe_apply`` is compared for equality with the reference run eagerly:
both multiply the kept count by the fp32 reciprocal of T * k.  Under
``jit`` XLA fuses ``1 - kept * (1 / (T k))`` further (a zero-drop layer
reports -1.5e-8 there), so the LM's summed ``dropped_frac`` is held
within 1e-6 absolute, and its drop count (``dropped_frac * T * k``) is
the same integer.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import sparse as jsparse  # noqa: E402
from repro.kernels.gmm import ops as jgmm_ops  # noqa: E402
from repro.kernels.gmm.ref import gmm_ref as jgmm_ref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import sparse as tsparse  # noqa: E402
from repro_torch.kernels import gmm as tgmm  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.attention import GQA  # noqa: E402
from repro_torch.models.model import LM as TLM  # noqa: E402
from repro_torch.serve import Engine, Request  # noqa: E402

TOL = 2e-4
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
METRIC_TOL = 1e-5
VOCAB = 512


def _rel(got, want):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-6)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _smoke(port: bool, **moe_over):
    cfg = (tconfigs.smoke("qwen3-moe-30b-a3b") if port
           else jconfigs.smoke("qwen3_moe_30b_a3b"))
    cfg = dataclasses.replace(cfg, dtype="float32")
    if moe_over:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **moe_over))
    return cfg


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

def test_config_copy_matches_reference():
    assert dataclasses.asdict(tconfigs.get("qwen3-moe-30b-a3b")) == \
        dataclasses.asdict(jconfigs.get("qwen3_moe_30b_a3b"))
    assert dataclasses.asdict(tconfigs.smoke("qwen3_moe_30b_a3b")) == \
        dataclasses.asdict(jconfigs.smoke("qwen3_moe_30b_a3b"))


@pytest.mark.parametrize("tokens", [1, 4, 40, 511, 1023, 4096])
def test_capacity_and_flops_match_reference(tokens):
    cfg = tconfigs.get("qwen3-moe-30b-a3b")
    jcfg = jconfigs.get("qwen3_moe_30b_a3b")
    assert tmoe._capacity(tokens, cfg) == jmoe._capacity(tokens, jcfg)
    assert tmoe._capacity(tokens, cfg) % 8 == 0
    assert tmoe.moe_flops_per_token(cfg) == jmoe.moe_flops_per_token(jcfg)


# ---------------------------------------------------------------------------
# gmm: the plain version against the Pallas kernel (interpret) and gmm_ref
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,tm", [(4, 32), (8, 64)])
def test_gmm_matches_jax(e, tm, dtype):
    """``tests/test_kernels.py``'s cases (T 256, D 128, F 96, random
    non-monotone ids) and their bf16 twins."""
    rng = np.random.default_rng(e * 100 + tm)
    t, d, f = 256, 128, 96
    x = rng.standard_normal((t, d)).astype(np.float32)
    w = rng.standard_normal((e, d, f)).astype(np.float32)
    ids = rng.integers(0, e, size=t // tm).astype(np.int32)
    jdt = jnp.dtype(dtype)
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    want_kernel = jgmm_ops.gmm(jx, jw, jnp.asarray(ids), tm=tm,
                               interpret=True)
    want_ref = jgmm_ref(jx, jw, jnp.asarray(ids), tm=tm)
    tdt = getattr(torch, dtype)
    got = tgmm.gmm(torch.as_tensor(x).to(tdt), torch.as_tensor(w).to(tdt),
                   torch.as_tensor(ids), tm=tm)
    assert got.dtype == tdt and got.shape == (t, f)
    assert _rel(got, _np(want_kernel)) <= KERNEL_TOL[dtype]
    assert _rel(got, _np(want_ref)) <= KERNEL_TOL[dtype]


def test_gmm_out_of_range_ids_give_zero_rows():
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.standard_normal((32, 16)).astype(np.float32))
    w = torch.as_tensor(rng.standard_normal((3, 16, 8)).astype(np.float32))
    ids = torch.tensor([0, 3, -1, 2], dtype=torch.int32)
    got = tgmm.gmm(x, w, ids, tm=8)
    assert torch.all(got[8:24] == 0)
    assert torch.allclose(got[:8], x[:8] @ w[0], atol=1e-5)
    assert torch.allclose(got[24:], x[24:] @ w[2], atol=1e-5)


@pytest.mark.parametrize("bad,msg", [
    (dict(tm=5), "not divisible"),
    (dict(expert_ids=torch.zeros(3, dtype=torch.int32)), "one entry"),
    (dict(tf=7), "must divide"),
    (dict(w=torch.zeros(2, 8, 12, dtype=torch.bfloat16)), "dtypes"),
    (dict(w=torch.zeros(2, 9, 12)), "takes x"),
])
def test_gmm_validates(bad, msg):
    args = dict(x=torch.zeros(32, 8), w=torch.zeros(2, 8, 12),
                expert_ids=torch.zeros(4, dtype=torch.int32), tm=8)
    args.update(bad)
    with pytest.raises(ValueError, match=msg):
        tgmm.gmm(**args)


def test_gmm_cuda_refuses_cpu_tensors():
    """gmm_cuda never runs the plain version: a CPU tensor is refused at
    every row tile, the kernel's widest (128) included."""
    x, w = torch.zeros(128, 8), torch.zeros(1, 8, 8)
    ids = torch.zeros(1, dtype=torch.int32)
    for tm, plan in ((128, None), (64, tgmm.Walk("ffma")),
                     (128, tgmm.Walk("wgmma", bn=64))):
        with pytest.raises(ValueError, match="CUDA"):
            tgmm.gmm_cuda(x, w, ids[:128 // tm], tm=tm, plan=plan)


# ---------------------------------------------------------------------------
# batched_matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("a_dt,b_dt", [("float32", "float32"),
                                       ("bfloat16", "bfloat16"),
                                       ("bfloat16", "float32")])
@pytest.mark.parametrize("lead", [(8,), (2, 3)])
def test_batched_matmul_matches_jax(lead, a_dt, b_dt):
    rng = np.random.default_rng(len(lead))
    a = rng.standard_normal(lead + (40, 64)).astype(np.float32)
    b = rng.standard_normal(lead + (64, 48)).astype(np.float32)
    want = jsparse.batched_matmul(jnp.asarray(a, jnp.dtype(a_dt)),
                                  jnp.asarray(b, jnp.dtype(b_dt)))
    got = tsparse.batched_matmul(
        torch.as_tensor(a).to(getattr(torch, a_dt)),
        torch.as_tensor(b).to(getattr(torch, b_dt)))
    assert str(got.dtype).replace("torch.", "") == jnp.dtype(
        want.dtype).name
    assert tuple(got.shape) == want.shape
    worst = "bfloat16" if "bfloat16" in (a_dt, b_dt) else "float32"
    assert _rel(got, _np(want)) <= KERNEL_TOL[worst]


def test_batched_matmul_plans_once_per_slice_problem():
    tsparse.reset()
    a, b = torch.zeros(4, 40, 16), torch.zeros(4, 16, 24)
    for _ in range(3):
        tsparse.batched_matmul(a, b)
    tsparse.batched_matmul(torch.zeros(6, 40, 16), torch.zeros(6, 16, 24))
    st = tsparse.cache_stats()
    assert st["plans_built"] == 1 and st["plan_hits"] == 3
    p = tsparse.plan(tsparse.OpSpec(kind="dense", m=40, k=16, n=24,
                                    op="batched_matmul"), device="cpu")
    assert p.route == "dense_torch"
    with pytest.raises(ValueError, match="leading"):
        tsparse.batched_matmul(torch.zeros(4, 40, 16),
                               torch.zeros(3, 16, 24))


@pytest.mark.parametrize("c,tm", [(8, 8), (40, 40), (72, 72), (80, 80),
                                  (128, 128), (12, 12), (0 + 96, 96),
                                  (200, 40), (264, 88), (129, 43)])
def test_batched_row_tile(c, tm):
    """On the tensor-core walk C <= 128 is one row tile (each expert's
    weights streamed once per column tile); above it a divisor <= 128, a
    multiple of 8 where one divides C."""
    from repro_torch.sparse.plan import batched_row_tile
    assert batched_row_tile(c) == tm
    assert tgmm.CONTRACT.admits(c, 2048, 768, tm, "bfloat16") is None


@pytest.mark.parametrize("c,tm", [(8, 8), (40, 40), (72, 24), (80, 40),
                                  (128, 64), (12, 12), (96, 48)])
def test_batched_row_tile_ffma(c, tm):
    """On the FMA walk (fp32, shapes TMA cannot load) row tiles stay at
    64 rows or fewer, where its blocks are fastest."""
    from repro_torch.sparse.plan import batched_row_tile
    assert batched_row_tile(c, tensor_cores=False) == tm


@pytest.mark.parametrize("tm,d,f,dtype,name,bn", [
    (80, 2048, 768, "bfloat16", "wgmma", 128),
    (8, 768, 2048, "float16", "wgmma", 128),
    (128, 72, 64, "bfloat16", "wgmma", 64),
    (80, 2048, 768, "float32", "ffma", 64),
    (8, 100, 64, "bfloat16", "ffma", 64),
    (8, 64, 100, "bfloat16", "ffma", 64)])
def test_gmm_walk_selection(tm, d, f, dtype, name, bn):
    """16-bit types with D and F multiples of 8 take the tensor-core
    walk (128-column blocks unless F fits 64); fp32 and shapes TMA
    cannot load take the FMA walk; tm past 128 is refused."""
    wk = tgmm.walk(tm, d, f, getattr(torch, dtype))
    assert (wk.name, wk.bn) == (name, bn)
    with pytest.raises(ValueError, match="outside"):
        tgmm.walk(129, d, f, getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,tm", [(4, 80), (3, 128)])
def test_gmm_wide_row_tiles_match_jax(e, tm, dtype):
    """Row tiles past 64 rows (MoE's C 80 prefill, the 128 limit) on
    random non-monotone ids, against the Pallas kernel in interpret mode
    and its reference."""
    rng = np.random.default_rng(e * 100 + tm)
    t, d, f = 4 * tm, 64, 72
    x = rng.standard_normal((t, d)).astype(np.float32)
    w = rng.standard_normal((e, d, f)).astype(np.float32)
    ids = rng.integers(0, e, size=t // tm).astype(np.int32)
    jdt = jnp.dtype(dtype)
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    want_kernel = jgmm_ops.gmm(jx, jw, jnp.asarray(ids), tm=tm, tf=72,
                               td=64, interpret=True)
    tdt = getattr(torch, dtype)
    got = tgmm.gmm(torch.as_tensor(x).to(tdt), torch.as_tensor(w).to(tdt),
                   torch.as_tensor(ids), tm=tm)
    assert got.dtype == tdt and got.shape == (t, f)
    assert _rel(got, _np(want_kernel)) <= KERNEL_TOL[dtype]


# ---------------------------------------------------------------------------
# moe_apply against the JAX moe_apply (eager)
# ---------------------------------------------------------------------------

def _moe_pair(jcfg, seed=0):
    params = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg,
                           dtype=jnp.float32)
    mod = tmoe.MoE(_port_cfg(jcfg), dtype=torch.float32, device="cpu")
    with torch.no_grad():
        for name, p in mod.named_parameters():
            leaf = params
            for part in name.split("."):
                leaf = leaf[part]
            p.copy_(torch.as_tensor(np.array(leaf, np.float32)))
    return params, mod


def _port_cfg(jcfg):
    from repro_torch.models.config import LayerSpec, ModelCfg, MoECfg
    d = dataclasses.asdict(jcfg)
    d["moe"] = MoECfg(**d["moe"])
    d["groups"] = tuple((tuple(LayerSpec(**s) for s in period), rep)
                        for period, rep in d["groups"])
    for f in ("ssm",):
        assert d[f] is None
    return ModelCfg(**d)


MOE_VARIANTS = {"base": {}, "drop": dict(capacity_factor=0.25),
                "shared": dict(num_shared=1, d_ff_shared=64)}


@pytest.mark.parametrize("variant", sorted(MOE_VARIANTS))
@pytest.mark.parametrize("score", ["softmax", "sigmoid"])
@pytest.mark.parametrize("ranking", ["cumsum", "sort"])
def test_moe_apply_matches_jax(ranking, score, variant):
    jcfg = _smoke(False, ranking=ranking, router_score=score,
                  **MOE_VARIANTS[variant])
    params, mod = _moe_pair(jcfg)
    x = np.random.default_rng(7).standard_normal(
        (2, 48, jcfg.d_model)).astype(np.float32)
    want, wm = jmoe.moe_apply(params, jcfg, jnp.asarray(x))
    tsparse.reset_telemetry()
    got, gm = tmoe.moe_apply(mod, mod.cfg, torch.as_tensor(x))
    assert _rel(got, want) <= TOL
    assert _rel(gm.aux_loss, wm.aux_loss) <= METRIC_TOL
    assert _rel(gm.z_loss, wm.z_loss) <= METRIC_TOL
    assert float(gm.dropped_frac) == float(wm.dropped_frac)
    if variant == "drop":
        assert float(gm.dropped_frac) > 0.25
    stream = tsparse.capacity_report()["per_plan"]["moe_dispatch"]
    assert stream["calls"] == 1
    assert stream["max_dropped_frac"] == round(float(wm.dropped_frac), 6)


@pytest.mark.parametrize("num_shared", [0, 1])
def test_moe_init_draws_the_reference_scales(num_shared):
    """``moe_init`` fills every parameter from one seeded generator at
    the reference's scales: N(0, 1/d) router (fp32) and gate/up, N(0,
    1/d_ff_expert) down, in the model dtype."""
    cfg = _smoke(True, num_shared=num_shared, d_ff_shared=64)
    a = tmoe.moe_init(cfg, dtype=torch.bfloat16, device="cpu", seed=3)
    b = tmoe.moe_init(cfg, dtype=torch.bfloat16, device="cpu", seed=3)
    assert a.router.w.dtype == torch.float32
    assert a.w_gate.dtype == torch.bfloat16
    assert (a.shared is None) == (num_shared == 0)
    for (name, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), name
    d, f = cfg.d_model, cfg.moe.d_ff_expert
    for p, std in ((a.router.w, d ** -0.5), (a.w_up, d ** -0.5),
                   (a.w_down, f ** -0.5)):
        assert abs(float(p.float().std()) / std - 1) < 0.05
    assert not torch.equal(a.w_gate[0], a.w_gate[1])


@pytest.mark.parametrize("cf", [1.25, 0.25])
def test_route_and_rank_matches_jax(cf):
    jcfg = _smoke(False, capacity_factor=cf)
    params, mod = _moe_pair(jcfg, seed=2)
    x = np.random.default_rng(8).standard_normal(
        (96, jcfg.d_model)).astype(np.float32)
    cap = jmoe._capacity(96, jcfg)
    want = jmoe._route_and_rank(jnp.asarray(x), params["router"]["w"],
                                jcfg, cap)
    for ranking in ("sort", "cumsum"):
        got = tmoe._route_and_rank(torch.as_tensor(x), mod.router.w,
                                   mod.cfg, cap, ranking=ranking)
        for i in (0, 2):           # token_for_slot, counts
            assert np.array_equal(got[i].numpy(), np.asarray(want[i]))
        assert _rel(got[1], want[1]) <= 1e-6
        assert float(got[3]) == float(want[3])
        assert _rel(got[4], want[4]) <= METRIC_TOL
        assert _rel(got[5], want[5]) <= METRIC_TOL


def test_record_dropped_folds_host_values_and_resets():
    tsparse.reset_telemetry()
    for frac in (0.0, 0.25, torch.tensor(0.5), np.float32(0.0)):
        tsparse.record_dropped("moe_dispatch", frac)
    rep = tsparse.capacity_report()["per_plan"]["moe_dispatch"]
    assert rep["calls"] == 4 and rep["overflow_calls"] == 2
    assert rep["max_dropped_frac"] == 0.5
    assert rep["mean_dropped_frac"] == 0.1875
    assert rep["tiles_dropped_total"] == 0
    tsparse.reset_telemetry()
    assert "moe_dispatch" not in tsparse.capacity_report()["per_plan"]


def test_dropped_history_keeps_one_value_per_call_in_order():
    """Per-call values of a stream, in call order, beside the folded
    report; host values recorded after pending ones keep their place."""
    tsparse.reset_telemetry()
    fracs = [0.0, 0.25, 0.5, 0.125]
    for frac in fracs:
        tsparse.record_dropped("moe_dispatch", torch.tensor(frac))
    assert tsparse.dropped_history("moe_dispatch") == fracs
    tsparse.record_dropped("moe_dispatch", 0.75)
    assert tsparse.dropped_history("moe_dispatch") == fracs + [0.75]
    assert tsparse.capacity_report()["per_plan"]["moe_dispatch"][
        "calls"] == 5
    assert tsparse.dropped_history("other") == []
    tsparse.reset_telemetry()
    assert tsparse.dropped_history("moe_dispatch") == []


# ---------------------------------------------------------------------------
# QK-norm: the port's q/k projection, norm and rope against the JAX GQA
# ---------------------------------------------------------------------------

def test_qk_norm_projection_matches_jax():
    """qwen3's per-head q/k RMS norm (eps 1e-6, before rope, over the head
    dim) with non-unit scales, and the full GQA forward."""
    jcfg = _smoke(False)
    tcfg = _smoke(True)
    assert jcfg.qk_norm and tcfg.qk_norm
    params = jattn.gqa_init(jax.random.PRNGKey(4), jcfg, dtype=jnp.float32)
    rng = np.random.default_rng(4)
    for name in ("q_norm", "k_norm"):
        params[name]["scale"] = jnp.asarray(
            rng.uniform(0.5, 1.5, jcfg.head_dim).astype(np.float32))
    gqa = GQA(tcfg, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        for name, p in gqa.named_parameters():
            mod, leaf = name.split(".")
            p.copy_(torch.as_tensor(np.array(params[mod][leaf], np.float32)))
    x = rng.standard_normal((2, 64, jcfg.d_model)).astype(np.float32) * 3
    pos = np.arange(64)[None, :]
    want = jattn._project_qkv(params, jcfg, jnp.asarray(x), jnp.asarray(pos))
    got = gqa.project_qkv(torch.as_tensor(x), torch.as_tensor(pos))
    for g, w_ in zip(got, want):
        assert _rel(g, w_) <= 1e-6
    want = jattn.gqa_train(params, jcfg, jnp.asarray(x),
                           positions=jnp.asarray(pos))
    assert _rel(gqa(torch.as_tensor(x), torch.as_tensor(pos)), want) <= TOL


# ---------------------------------------------------------------------------
# the qwen3 smoke LM end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["experts", "shared"])
def pair(request):
    over = ({} if request.param == "experts"
            else dict(num_shared=1, d_ff_shared=64))
    jcfg, tcfg = _smoke(False, **over), _smoke(True, **over)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jlm = JLM(jcfg)
    params = jlm.init(jax.random.PRNGKey(1))
    tlm = TLM(tcfg, device="cpu").load_jax_params(
        jax.tree.map(np.asarray, params))
    return jlm, params, tlm


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, VOCAB, size=shape
                                                ).astype(np.int32)


def test_load_jax_params_carries_the_moe_tree(pair):
    jlm, params, tlm = pair
    n_jax = sum(int(np.asarray(x).size) for x in jax.tree.leaves(params))
    assert n_jax == sum(p.numel() for p in tlm.parameters())
    ffn = params["stack"][0][0]["ffn"]
    assert np.array_equal(tlm.layers[1].ffn.w_down.numpy(),
                          np.asarray(ffn["w_down"][1]))
    assert np.array_equal(tlm.layers[0].ffn.router.w.numpy(),
                          np.asarray(ffn["router"]["w"][0]))
    assert tlm.layers[0].ffn.router.w.dtype == torch.float32
    if "shared" in ffn:
        assert np.array_equal(tlm.layers[1].ffn.shared.gate.w.numpy(),
                              np.asarray(ffn["shared"]["gate"]["w"][1]))
    else:
        assert tlm.layers[0].ffn.shared is None


def test_forward_and_metrics_match_jax(pair):
    jlm, params, tlm = pair
    toks = _tokens((2, 80), 1)
    want, wm = jax.jit(jlm.forward)(params, jnp.asarray(toks))
    got, gm = tlm.forward(toks, return_metrics=True)
    assert got.shape == (2, 80, VOCAB)
    assert _rel(got, want) <= TOL
    assert torch.equal(tlm.forward(toks), got)
    for name in ("aux_loss", "z_loss"):
        assert _rel(gm[name], wm[name]) <= METRIC_TOL, name
    assert abs(float(gm["dropped_frac"]) - float(wm["dropped_frac"])) <= 1e-6
    # the drop count per assignment is an integer: the same on both sides
    tk = 2 * 80 * tlm.cfg.moe.top_k
    assert round(float(gm["dropped_frac"]) * tk) == \
        round(float(wm["dropped_frac"]) * tk)


def test_prefill_and_decode_match_jax(pair):
    """Padded prefill with ``last_index``, then three decode steps (T = B
    tokens a step: capacity 8)."""
    jlm, params, tlm = pair
    max_len = 80
    toks = _tokens((2, 70), 2)
    lengths = np.asarray([37, 55], np.int32)
    padded = toks[:, :64].copy()
    for row, n in enumerate(lengths):
        padded[row, n:] = 0
    jpre = jax.jit(jlm.prefill, static_argnames=("max_len",))
    want, jc = jpre(params, jnp.asarray(padded), max_len=max_len,
                    last_index=jnp.asarray(lengths - 1))
    got, tc = tlm.prefill(padded, max_len=max_len, last_index=lengths - 1)
    assert _rel(got, want) <= TOL
    jdec = jax.jit(jlm.decode_step)
    pos = lengths.copy()
    for step in range(3):
        tok = toks[:, 64 + step:65 + step]
        want, jc = jdec(params, jnp.asarray(tok), jc, jnp.asarray(pos))
        got, tc = tlm.decode_step(tok, tc, pos)
        assert _rel(got, want) <= TOL, step
        pos = pos + 1


def test_loss_waits_for_moe_training(pair):
    """MoE training is ported: ``loss`` of the MoE config equals the JAX
    ``LM.loss`` (cross entropy plus the weighted router losses) with its
    metrics.  A config with ``long_attention="block_sparse"`` (read
    nowhere in the reference) builds and gives the same logits as
    ``"full"`` and as the JAX LM."""
    jlm, params, tlm = pair
    toks = _tokens((2, 17), 3)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    want, wm = jax.jit(jlm.loss)(params, jax.tree.map(jnp.asarray, batch))
    with torch.no_grad():
        got, gm = tlm.loss(batch["tokens"], batch["targets"])
    assert abs(float(got) - float(want)) <= 1e-4 * abs(float(want))
    assert set(gm) == set(wm) == {"aux_loss", "z_loss", "dropped_frac",
                                  "xent"}
    for name in ("aux_loss", "z_loss", "xent"):
        assert _rel(gm[name], wm[name]) <= 1e-4, name
    blm = TLM(dataclasses.replace(tlm.cfg, long_attention="block_sparse"),
              device="cpu").load_jax_params(jax.tree.map(np.asarray, params))
    want, _ = jax.jit(jlm.forward)(params, jnp.asarray(toks))
    with torch.no_grad():
        got = blm.forward(toks)
        assert _rel(got, tlm.forward(toks)) <= TOL
    assert _rel(got, want) <= TOL


def test_engine_tokens_match_jax(pair):
    """Greedy tokens through both engines on the reference's bucket
    ladder.  The ladders may differ: the reference prices padding with
    its calibrated TPU cost model (``dispatch.price_tokens``), the port
    with its H100 model of dense_mm, so the port is handed the
    reference's ladder; the pricing inputs are held equal below."""
    jlm, params, tlm = pair
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, VOCAB, size=n).astype(np.int32)
               for n in (20, 45, 70)]
    jeng = JEngine(jlm, params, batch=2, max_len=96)
    jreqs = [JRequest(uid=i, prompt=p, max_new_tokens=4)
             for i, p in enumerate(prompts)]
    jeng.run(jreqs)
    eng = Engine(tlm, batch=2, max_len=96, device="cpu",
                 buckets=jeng.buckets)
    assert eng.buckets == tuple(jeng.buckets)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=4)
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    for j, t in zip(jreqs, reqs):
        assert t.done and len(t.output) == 4
        assert t.output == j.output, t.uid
        assert t.bucket == j.bucket


# qwen3's bucket ladders as they stand: both run the reference's
# algorithm, the port priced by its H100 model of dense_mm at the model's
# dtype, the reference by its TPU cost model, so they differ at the served
# max_len and agree at the smoke one; a change to either shows here.
# (smoke, max_len) -> (port's, reference's)
QWEN3_LADDERS = {
    (False, 1024): ((16, 1008, 1023), (16, 512, 1008, 1023)),
    (True, 96): ((16, 80, 95), (16, 80, 95)),
}


@pytest.mark.parametrize("smoke,max_len", sorted(QWEN3_LADDERS))
def test_bucket_ladders_pinned(smoke, max_len):
    from repro.serve import engine as jengine
    from repro_torch.serve import engine as tengine
    cfg = (tconfigs.smoke if smoke else tconfigs.get)("qwen3-moe-30b-a3b")
    jcfg = (jconfigs.smoke if smoke else jconfigs.get)("qwen3_moe_30b_a3b")
    port, ref = QWEN3_LADDERS[(smoke, max_len)]
    assert tengine._auto_buckets(max_len - 1, tengine._stack_shapes(cfg),
                                 0.75, dtype=cfg.dtype) == port
    assert jengine._auto_buckets(max_len - 1, jengine._stack_shapes(jcfg),
                                 0.75) == ref
    assert (port != ref) == (not smoke)


def test_engine_ladder_is_the_pinned_one(pair):
    """The port's Engine with no ``buckets=`` builds the pinned ladder."""
    _, _, tlm = pair
    eng = Engine(tlm, batch=2, max_len=96, device="cpu")
    assert eng.buckets == QWEN3_LADDERS[(True, 96)][0]


@pytest.mark.parametrize("smoke", [False, True])
def test_stack_shapes_match_jax(smoke):
    """The matmul stack that prices admission and the ladder, MoE arm
    included (router + top-k expert FFNs), equals the reference's; the
    port's ladder is the H100-priced one."""
    from repro.serve import engine as jengine
    from repro_torch.serve import engine as tengine
    cfg = (tconfigs.smoke if smoke else tconfigs.get)("qwen3-moe-30b-a3b")
    jcfg = (jconfigs.smoke if smoke else jconfigs.get)("qwen3_moe_30b_a3b")
    shapes = tengine._stack_shapes(cfg)
    assert shapes == jengine._stack_shapes(jcfg)
    m = cfg.moe
    assert (m.num_experts, cfg.d_model) in shapes
    assert (2 * m.top_k * m.d_ff_expert, cfg.d_model) in shapes
    assert tengine._auto_buckets(1023, shapes, 0.75, dtype=cfg.dtype) == \
        QWEN3_LADDERS[(False, 1024)][0]
