"""Long context against the JAX package, on the CPU: the retained
local + global ring cache (``LM._ring_slot``, ``LM.decode_step(
retained=True)`` through GQA's global and local layers and MLA, the
serving ``Engine(retained=True)``), the shape cells (``SHAPES``,
``is_native_long``), the ``long_attention`` field the reference reads
nowhere, and the reference's convenience shims over the plan
(``core/static_sparse.py`` ``spmm`` .. ``spmm_cached``,
``core/dispatch.py`` ``spmm`` .. ``format_explain``).

Smoke configs in fp32 with a small ring (``retained_prefix`` 8,
``retained_window`` 32: 40 slots), weights from the JAX ``LM.init``,
every input from numpy with a seed.  Budgets, rel-max over the
reference's max magnitude: logits and caches 2e-4 (the slice budget of
``tests/test_torch_model.py``); the shims fp32 1e-4 and bf16 2e-2 (the
conftest's per-dtype kernel budgets).

On a stack without local layers, decoding past the ring's wrap is the
causal forward in which every layer keeps the window ``w`` and the
prefix ``g``: at position ``p`` the ring holds ``[0, g) U [p - w + 1,
p]``, bs_attn's ``(r - c < w) | (c < g)``.  The prefill-then-decode
test holds the ring against that windowed forward of the port as well.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import dispatch as jdispatch  # noqa: E402
from repro.core import dynamic_sparse as jdsp  # noqa: E402
from repro.core import static_sparse as jss  # noqa: E402
from repro.core.bsr import BlockSparseMatrix as JBSR  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import sparse as tsparse  # noqa: E402
from repro_torch.core import dispatch as tdispatch  # noqa: E402
from repro_torch.core import dynamic_sparse as tdsp  # noqa: E402
from repro_torch.core import static_sparse as tss  # noqa: E402
from repro_torch.core.bsr import BlockSparseMatrix as TBSR  # noqa: E402
from repro_torch.models.config import LayerSpec as TLayerSpec  # noqa: E402
from repro_torch.models.config import ModelCfg as TModelCfg  # noqa: E402
from repro_torch.models.model import LM as TLM  # noqa: E402
from repro_torch.serve import Engine, Request  # noqa: E402

TOL = 2e-4
SHIM_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
VOCAB = 512
PREFIX, WINDOW = 8, 32
RING = PREFIX + WINDOW


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float32), np.float32)


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-6)


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, VOCAB, size=shape).astype(
        np.int32)


def _sparse_groups(cfg):
    return tuple((tuple(dataclasses.replace(s, ffn="sparse")
                        for s in period), rep) for period, rep in cfg.groups)


def _cfg(port: bool, arch: str, **kw):
    """``arch``'s smoke config in fp32 with the small ring; llama's FFNs
    block-sparse at d = 1/4 (the long-context cell's sparse FFN)."""
    cfg = (tconfigs if port else jconfigs).smoke(arch)
    if arch == "llama3_2_1b":
        cfg = dataclasses.replace(cfg, groups=_sparse_groups(cfg),
                                  ffn_density=0.25)
    return dataclasses.replace(cfg, dtype="float32", retained_prefix=PREFIX,
                               retained_window=WINDOW, **kw)


def _pair(arch: str, **kw):
    jcfg, tcfg = _cfg(False, arch, **kw), _cfg(True, arch, **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jlm = JLM(jcfg)
    params = jlm.init(jax.random.PRNGKey(3))
    tlm = TLM(tcfg, device="cpu").load_jax_params(
        jax.tree.map(np.asarray, params))
    return jlm, params, tlm


@pytest.fixture(scope="module")
def llama():
    return _pair("llama3_2_1b")


# gemma2's smoke local window cut to 16, under the ring's 40 slots, so
# the window filter would hide slots a retained decode must see
@pytest.fixture(scope="module")
def gemma2():
    return _pair("gemma2_2b", local_window=16)


@pytest.fixture(scope="module")
def deepseek():
    return _pair("deepseek_v2_lite_16b")


def _jdecode(jlm):
    return jax.jit(jlm.decode_step, static_argnames=("retained",))


def _exec_order(jc):
    """The JAX stack caches (per group, per period position a tree with a
    leading ``repeat`` axis) in the port's execution order."""
    out = []
    for group in jc:
        per = [{name: np.asarray(v, np.float32) for name, v in c.items()}
               for c in group]
        reps = next(iter(per[0].values())).shape[0]
        for r in range(reps):
            for c in per:
                out.append({name: v[r] for name, v in c.items()})
    return out


# ---------------------------------------------------------------------------
# the ring slot
# ---------------------------------------------------------------------------

def _tiny(port: bool):
    """``tests/test_attention.py::test_gqa_cache_ring_buffer``'s config
    (prefix 4, window 8)."""
    if port:
        cfg = TModelCfg(name="t", family="dense", d_model=64,
                        vocab_size=128, num_heads=2, num_kv_heads=2,
                        head_dim=32, d_ff=128,
                        groups=(((TLayerSpec(),), 1),), retained_prefix=4,
                        retained_window=8, attn_tile_q=32, attn_tile_kv=32)
        return TLM(cfg, device="cpu")
    from repro.models.config import LayerSpec, ModelCfg
    cfg = ModelCfg(name="t", family="dense", d_model=64, vocab_size=128,
                   num_heads=2, num_kv_heads=2, head_dim=32, d_ff=128,
                   groups=(((LayerSpec(),), 1),), retained_prefix=4,
                   retained_window=8, attn_tile_q=32, attn_tile_kv=32)
    return JLM(cfg)


RING_CASES = {
    "prefix4_window8": ([3, 4, 11, 12, 20, 27, 100], "tiny"),
    "defaults_near_500k": ([0, 1023, 5119, 5120, 9215, 9216, 524286,
                            524287], "llama"),
}


@pytest.mark.parametrize("case", sorted(RING_CASES))
def test_ring_slot_matches_jax(case):
    pos, which = RING_CASES[case]
    if which == "tiny":
        jlm, tlm = _tiny(False), _tiny(True)
        assert jlm._ring_slot(jnp.asarray(pos[:5], jnp.int32)).tolist() == \
            [3, 4, 11, 4 + (12 - 4) % 8, 4 + (20 - 4) % 8]
    else:
        jcfg = jconfigs.smoke("llama3_2_1b")
        tcfg = tconfigs.smoke("llama3_2_1b")
        assert (tcfg.retained_prefix, tcfg.retained_window) == (1024, 4096)
        jlm, tlm = JLM(jcfg), TLM(tcfg, device="cpu")
    want = np.asarray(jlm._ring_slot(jnp.asarray(pos, jnp.int32)))
    got = tlm._ring_slot(torch.as_tensor(pos, dtype=torch.long))
    assert got.dtype == torch.long
    assert got.tolist() == want.tolist()
    g, w = tlm.cfg.retained_prefix, tlm.cfg.retained_window
    assert all(0 <= s < g + w for s in got.tolist())


# ---------------------------------------------------------------------------
# decode_step(retained=True)
# ---------------------------------------------------------------------------

def test_decode_step_retained_matches_jax(llama):
    """``tests/test_models.py::test_retained_decode_runs``'s positions
    (0, 5, 39, 40, 100, 5000 against a 40-slot ring), batch 2, a new
    seeded token each step: logits and every cache slot against JAX."""
    jlm, params, tlm = llama
    jc = jlm.init_cache(2, RING)
    tc = tlm.init_cache(2, RING)
    jdec = _jdecode(jlm)
    toks = _tokens((6, 2, 1), 11)
    for i, pos in enumerate((0, 5, 39, 40, 100, 5000)):
        p = np.full((2,), pos, np.int32)
        want, jc = jdec(params, jnp.asarray(toks[i]), jc, jnp.asarray(p),
                        retained=True)
        got, tc = tlm.decode_step(toks[i], tc, p, retained=True)
        assert np.isfinite(_np(got)).all()
        assert _rel(got, want) <= TOL, pos
        for t, j in zip(tc, _exec_order(jc)):
            for name in t:
                assert _rel(t[name], j[name]) <= TOL, (pos, name)
    # the last three positions wrapped onto slot 8, 36 and 8
    slots = tlm._ring_slot(torch.as_tensor([40, 100, 5000]))
    assert slots.tolist() == [8, 36, 8]


def test_rows_before_and_past_the_wrap(llama):
    """Two rows at different positions in one step: row 0 before the
    wrap (its causal length masks the slots past it), row 1 past it
    (every slot visible, its new K/V on a ring slot)."""
    jlm, params, tlm = llama
    toks = _tokens((2, 30), 12)
    jpre = jax.jit(jlm.prefill, static_argnames=("max_len",))
    _, jc = jpre(params, jnp.asarray(toks), max_len=RING)
    _, tc = tlm.prefill(toks, max_len=RING)
    jdec = _jdecode(jlm)
    step = _tokens((4, 2, 1), 13)
    for i, pos in enumerate(([30, 44], [31, 45], [32, 71], [33, 72])):
        p = np.asarray(pos, np.int32)
        want, jc = jdec(params, jnp.asarray(step[i]), jc, jnp.asarray(p),
                        retained=True)
        got, tc = tlm.decode_step(step[i], tc, p, retained=True)
        assert _rel(got, want) <= TOL, pos
    for t, j in zip(tc, _exec_order(jc)):
        for name in t:
            assert _rel(t[name], j[name]) <= TOL, name


def _windowed(cfg):
    """``cfg`` with every attention layer local, window ``w`` and prefix
    ``g``: the forward a ring decode equals on a stack without local
    layers."""
    groups = tuple((tuple(dataclasses.replace(s, mixer="attn_local")
                          for s in period), rep)
                   for period, rep in cfg.groups)
    return dataclasses.replace(cfg, groups=groups,
                               local_window=cfg.retained_window,
                               global_prefix=cfg.retained_prefix)


def test_prefill_then_decode_past_the_wrap(llama):
    """A 40-token prompt fills the ring; 24 greedy-free decode steps
    (seeded tokens) write slots 8..31 over the oldest window positions.
    Logits against JAX's prefill + ``decode_step(retained=True)`` and
    against the port's windowed forward over the whole sequence."""
    jlm, params, tlm = llama
    n, steps = RING, 24
    toks = _tokens((1, n + steps), 14)
    wlm = TLM(_windowed(tlm.cfg), device="cpu").load_jax_params(
        jax.tree.map(np.asarray, params))
    full = wlm.forward(toks)
    jpre = jax.jit(jlm.prefill, static_argnames=("max_len",))
    want, jc = jpre(params, jnp.asarray(toks[:, :n]), max_len=RING)
    got, tc = tlm.prefill(toks[:, :n], max_len=RING)
    assert _rel(got, want) <= TOL
    assert _rel(got, full[:, n - 1]) <= TOL
    jdec = _jdecode(jlm)
    for i in range(steps):
        pos = n + i
        p = np.asarray([pos], np.int32)
        tok = toks[:, pos:pos + 1]
        want, jc = jdec(params, jnp.asarray(tok), jc, jnp.asarray(p),
                        retained=True)
        got, tc = tlm.decode_step(tok, tc, p, retained=True)
        assert _rel(got, want) <= TOL, pos
        assert _rel(got, full[:, pos]) <= TOL, pos
    # without the ring (a cache long enough for every position) the
    # decode is the plain causal one, which sees the evicted positions
    plain = tlm.forward(toks)
    assert _rel(full[:, -1], plain[:, -1]) > TOL


def test_gemma2_local_layers_unfiltered(gemma2):
    """gemma2's local layers (window 16 here) attend to every retained
    slot under ``retained``: the reference's ``window_filter=False``.
    Prefill 24 tokens, decode to position 60 (past the wrap at 40)."""
    jlm, params, tlm = gemma2
    assert any(s.mixer == "attn_local" for period, _ in tlm.cfg.groups
               for s in period)
    n, steps = 24, 37
    toks = _tokens((2, n + steps), 15)
    jpre = jax.jit(jlm.prefill, static_argnames=("max_len",))
    want, jc = jpre(params, jnp.asarray(toks[:, :n]), max_len=RING)
    got, tc = tlm.prefill(toks[:, :n], max_len=RING)
    assert _rel(got, want) <= TOL
    jdec = _jdecode(jlm)
    filtered = None
    for i in range(steps):
        pos = n + i
        p = np.full((2,), pos, np.int32)
        tok = toks[:, pos:pos + 1]
        if i == 8:
            # the same step with the window filter on (retained off at a
            # position inside the cache) differs: the filter matters here
            tc2 = [{k: v.clone() for k, v in c.items()} for c in tc]
            filtered, _ = tlm.decode_step(tok, tc2, p)
        want, jc = jdec(params, jnp.asarray(tok), jc, jnp.asarray(p),
                        retained=True)
        got, tc = tlm.decode_step(tok, tc, p, retained=True)
        assert _rel(got, want) <= TOL, pos
        if i == 8:
            assert _rel(filtered, got) > TOL


def test_mla_ring_slot(deepseek):
    """deepseek's MLA layers write the latent and the roped key at the
    ring slot (RoPE at the true position): prefill 30 tokens, decode to
    position 55; logits and the ``{latent, k_rope}`` caches against
    JAX."""
    jlm, params, tlm = deepseek
    n, steps = 30, 26
    toks = _tokens((2, n + steps), 16)
    jpre = jax.jit(jlm.prefill, static_argnames=("max_len",))
    want, jc = jpre(params, jnp.asarray(toks[:, :n]), max_len=RING)
    got, tc = tlm.prefill(toks[:, :n], max_len=RING)
    assert _rel(got, want) <= TOL
    jdec = _jdecode(jlm)
    for i in range(steps):
        pos = n + i
        p = np.full((2,), pos, np.int32)
        tok = toks[:, pos:pos + 1]
        want, jc = jdec(params, jnp.asarray(tok), jc, jnp.asarray(p),
                        retained=True)
        got, tc = tlm.decode_step(tok, tc, p, retained=True)
        assert _rel(got, want) <= TOL, pos
    for t, j in zip(tc, _exec_order(jc)):
        assert set(t) == {"latent", "k_rope"}
        for name in t:
            assert _rel(t[name], j[name]) <= TOL, name


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3_2_1b", "gemma2_2b"])
def test_engine_retained_tokens_match_jax(arch, llama, gemma2):
    """Greedy tokens through both engines with ``retained=True`` and
    ``max_len`` the ring (40), on the reference's bucket ladder.  Both
    stop a request at position ``max_len - 1``."""
    jlm, params, tlm = llama if arch == "llama3_2_1b" else gemma2
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, VOCAB, size=n).astype(np.int32)
               for n in (10, 25, 31)]
    jeng = JEngine(jlm, params, batch=2, max_len=RING, retained=True)
    jreqs = [JRequest(uid=i, prompt=p, max_new_tokens=12)
             for i, p in enumerate(prompts)]
    jeng.run(jreqs)
    eng = Engine(tlm, batch=2, max_len=RING, retained=True, device="cpu",
                 buckets=jeng.buckets, graphs=False)
    assert eng.retained and eng.buckets == tuple(jeng.buckets)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=12)
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    for j, t in zip(jreqs, reqs):
        assert t.done and t.output == j.output, t.uid
        assert t.bucket == j.bucket
    # the 31-token prompt stops at max_len - 1, before its 12 tokens
    assert len(reqs[2].output) == RING - 1 - 31 + 1 < 12


def test_serve_launcher_takes_retained(capsys):
    from repro_torch.launch import serve as tserve
    eng = tserve.main(["--smoke", "--device", "cpu", "--density", "0.25",
                       "--retained", "--requests", "2", "--new-tokens",
                       "3", "--max-len", "48"])
    assert eng.retained
    assert "retained=True" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the shape cells
# ---------------------------------------------------------------------------

def test_shapes_match_reference():
    assert tconfigs.SHAPES == jconfigs.SHAPES
    assert tconfigs.SHAPES["long_500k"]["long"] is True


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_is_native_long_matches_reference(arch):
    for get in ("get", "smoke"):
        tcfg = getattr(tconfigs, get)(arch)
        jcfg = getattr(jconfigs, get)(arch)
        assert tconfigs.is_native_long(tcfg) == jconfigs.is_native_long(jcfg)
    assert tconfigs.is_native_long(tconfigs.get(arch)) == (
        arch in ("mamba2_130m", "jamba_v0_1_52b"))


# ---------------------------------------------------------------------------
# long_attention: read nowhere, so "block_sparse" runs as "full"
# ---------------------------------------------------------------------------

def test_long_attention_block_sparse_matches_full_and_jax(llama):
    jlm, params, tlm = llama
    cfg = dataclasses.replace(tlm.cfg, long_attention="block_sparse")
    blm = TLM(cfg, device="cpu").load_jax_params(
        jax.tree.map(np.asarray, params))
    toks = _tokens((2, 24), 18)
    jcfg = dataclasses.replace(jlm.cfg, long_attention="block_sparse")
    want, _ = jax.jit(JLM(jcfg).forward)(params, jnp.asarray(toks))
    got = blm.forward(toks)
    assert _rel(got, want) <= TOL
    assert _rel(got, tlm.forward(toks)) <= TOL


# ---------------------------------------------------------------------------
# the convenience shims over the plan
# ---------------------------------------------------------------------------

M, K, N, B, DENSITY = 128, 256, 64, 16, 0.25


def _bsr_pair(dtype="float32", seed=0):
    jbsr = JBSR.random(jax.random.PRNGKey(seed), M, K, B, DENSITY,
                       dtype=getattr(jnp, dtype), pattern_seed=seed)
    tbsr = TBSR(torch.as_tensor(np.array(jbsr.values, np.float32)).to(
        getattr(torch, dtype)), np.asarray(jbsr.row_idx, np.int32),
        np.asarray(jbsr.col_idx, np.int32), tuple(jbsr.shape),
        jbsr.block_size)
    return jbsr, tbsr


def _arr(shape, seed, dtype):
    x = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)
    return (jnp.asarray(x).astype(getattr(jnp, dtype)),
            torch.as_tensor(x).to(getattr(torch, dtype)))


@pytest.fixture(autouse=True)
def _fresh_decisions():
    jdispatch.clear_cache()
    yield
    jdispatch.clear_cache()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_static_sparse_spmm_shims_match_jax(backend, dtype):
    jbsr, tbsr = _bsr_pair(dtype)
    jx, tx = _arr((K, N), 1, dtype)
    tol = SHIM_TOL[dtype]
    kw = {"interpret": True} if backend == "pallas" else {}
    want = jss.spmm(jbsr, jx, backend=backend, **kw)
    got = tss.spmm(tbsr, tx, backend=backend, **kw)
    assert got.dtype == getattr(torch, dtype)
    assert _rel(got, want) <= tol
    ja, ta = _arr((3, 5, K), 2, dtype)
    want = jss.spmm_nt(jbsr, ja, backend=backend, **kw)
    got = tss.spmm_nt(tbsr, ta, backend=backend, **kw)
    assert tuple(got.shape) == (3, 5, M) and _rel(got, want) <= tol
    with pytest.raises(ValueError, match="backend"):
        tss.spmm(tbsr, tx, backend="bogus")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_static_sparse_transpose_sddmm_and_cached_match_jax(dtype):
    jbsr, tbsr = _bsr_pair(dtype, seed=1)
    tol = SHIM_TOL[dtype]
    jdy, tdy = _arr((M, N), 3, dtype)
    jx, tx = _arr((K, N), 4, dtype)
    assert _rel(tss.spmm_t(tbsr, tdy), jss.spmm_t(jbsr, jdy)) <= tol
    got = tss.sddmm(tbsr, tdy, tx)
    assert tuple(got.shape) == (len(tbsr.row_idx), B, B)
    assert _rel(got, jss.sddmm(jbsr, jdy, jx)) <= tol
    assert _rel(tss.spmm_cached(tbsr, tx), jss.spmm_cached(jbsr, jx)) <= tol


def test_static_sparse_spmm_shim_gradients_match_jax():
    """The shim is differentiable in the values and x, through the plan's
    backward (the bsmm walk on ``W^T`` and the sddmm)."""
    jbsr, tbsr = _bsr_pair()
    jx, tx = _arr((K, N), 5, "float32")

    def jloss(v, x):
        return (jss.spmm(jbsr.with_values(v), x) ** 2).sum()
    jdv, jdx = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(jbsr.values), jx)
    v = tbsr.values.clone().requires_grad_(True)
    x = tx.clone().requires_grad_(True)
    (tss.spmm(dataclasses.replace(tbsr, values=v), x) ** 2).sum().backward()
    assert _rel(v.grad, jdv) <= SHIM_TOL["float32"]
    assert _rel(x.grad, jdx) <= SHIM_TOL["float32"]


@pytest.mark.parametrize("kind", ["dense", "static", "dynamic"])
def test_dispatch_spmm_shim_matches_jax(kind):
    jbsr, tbsr = _bsr_pair(seed=2)
    jx, tx = _arr((K, N), 6, "float32")
    if kind == "dense":
        jop, top = jnp.asarray(jbsr.to_dense()), tbsr.to_dense()
    elif kind == "static":
        jop, top = jbsr, tbsr
    else:
        nnz = len(tbsr.row_idx) + 4
        jop = jdsp.encode_from_bsr(jbsr, nnz_max=nnz)
        top = tdsp.encode_from_bsr(tbsr, nnz_max=nnz)
    want = jdispatch.spmm(jop, jx)
    got = tdispatch.spmm(top, tx)
    assert _rel(got, want) <= SHIM_TOL["float32"]
    ja, ta = _arr((3, 5, K), 7, "float32")
    if kind != "dynamic":
        assert _rel(tdispatch.spmm_nt(top, ta),
                    jdispatch.spmm_nt(jop, ja)) <= SHIM_TOL["float32"]
    with pytest.raises(ValueError):
        tdispatch.spmm(top, tx[:-1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dispatch_matmul_shims_match_jax(dtype):
    tol = SHIM_TOL[dtype]
    jx, tx = _arr((4, 8, 32), 8, dtype)
    jw, tw = _arr((32, 16), 9, dtype)
    assert _rel(tdispatch.matmul(tx, tw), jdispatch.matmul(jx, jw)) <= tol
    ja, ta = _arr((3, 8, 16), 10, dtype)
    jb, tb = _arr((3, 16, 24), 11, dtype)
    got = tdispatch.batched_matmul(ta, tb)
    assert got.dtype == getattr(torch, dtype)
    assert _rel(got, jdispatch.batched_matmul(ja, jb)) <= tol


def test_dispatch_explain_keeps_the_reference_keys():
    tsparse.reset()
    jbsr, tbsr = _bsr_pair(seed=3)
    want = jdispatch.explain(jbsr, N)
    rep = tdispatch.explain(tbsr, N, device="cpu")
    assert set(rep) == set(want)
    assert set(rep["problem"]) == set(want["problem"])
    for key in ("kind", "m", "k", "n", "block_size", "density",
                "density_bucket", "dtype"):
        assert rep["problem"][key] == want["problem"][key], key
    # the skew is the port's: work per tile-row of its bsmm walk, not per
    # 128-wide tile of the reference's TPU walk
    imb, cv = tdispatch.pattern_balance(tbsr)
    assert (rep["problem"]["imbalance"], rep["problem"]["cv"]) == (
        round(imb, 3), round(cv, 3))
    assert rep["mode"] == want["mode"] == "auto"
    # on the CPU the candidates are the plain versions
    assert rep["pallas_admissible"] is False
    assert set(rep["candidates"]) >= {"static_torch", "dense_torch"}
    assert rep["chosen"] in rep["candidates"]
    assert rep["cached"] is False and rep["source"] == "analytic"
    assert tdispatch.explain(tbsr, N, device="cpu")["cached"] is True
    text = tdispatch.format_explain(rep)
    assert text.splitlines()[0].startswith("dispatch static (128x256)")
    assert f"-> {rep['chosen']}" in text
    assert text.splitlines()[0] == jdispatch.format_explain(
        want).splitlines()[0]
