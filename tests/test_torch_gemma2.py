"""The gemma2 slice end to end against the JAX package: gemma2-2b's smoke
config (two layers, local window 64, attention tiles 64, soft-caps,
pre+post norms, embedding scale) with the dense ``mlp`` FFN and with
every FFN block-sparse (d=1/4, b=16), in fp32, the JAX params carried
over with ``LM.load_jax_params``.  Prompts run past window + tile (128
tokens), so the window cuts tiles.  Budget: rel-max 2e-4 over the JAX
logits' max magnitude, as for the llama slice.

The JAX ``SparseFFN`` gates with silu whatever ``cfg.act`` is
(``core/sparse_layers.py:244``); the port mirrors that, so the sparse
gemma2 gates its FFN with silu on both sides.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import assert_close_for_dtype, grad_tol  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models.model import LM as TLM  # noqa: E402
from repro_torch.serve import Engine, Request  # noqa: E402

TOL = 2e-4
VOCAB = 512


def _rel(got, want):
    got, want = (x.float() if isinstance(x, torch.Tensor) else x
                 for x in (got, want))
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / max(
        float(np.abs(want).max()), 1e-6)


def _cfg(port: bool, ffn: str, dtype: str = "float32", periods: int = 1):
    """gemma2's smoke config in ``dtype``, every FFN ``ffn``, its
    (local, global) period repeated ``periods`` times; the JAX sparse arm
    is built by hand (its helper lives in the benchmark suite)."""
    if port:
        cfg = tconfigs.smoke("gemma2-2b")
        if ffn == "sparse":
            cfg = tconfigs.sparsify_ffn(cfg, 0.25)
    else:
        cfg = jconfigs.smoke("gemma2_2b")
        if ffn == "sparse":
            groups = tuple((tuple(dataclasses.replace(s, ffn="sparse")
                                  for s in period), rep)
                           for period, rep in cfg.groups)
            cfg = dataclasses.replace(cfg, groups=groups, ffn_density=0.25)
    groups = tuple((period, periods) for period, _ in cfg.groups)
    return dataclasses.replace(cfg, dtype=dtype, groups=groups)


def _pair(ffn: str, dtype: str = "float32", periods: int = 1):
    jcfg = _cfg(False, ffn, dtype, periods)
    tcfg = _cfg(True, ffn, dtype, periods)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jlm = JLM(jcfg)
    params = jlm.init(jax.random.PRNGKey(1))
    tlm = TLM(tcfg, device="cpu").load_jax_params(
        jax.tree.map(np.asarray, params))
    return jlm, params, tlm


@pytest.fixture(scope="module", params=["mlp", "sparse"])
def pair(request):
    return _pair(request.param)


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, VOCAB, size=shape
                                                ).astype(np.int32)


def test_config_copy_matches_reference():
    assert dataclasses.asdict(tconfigs.get("gemma2-2b")) == \
        dataclasses.asdict(jconfigs.get("gemma2_2b"))
    assert dataclasses.asdict(tconfigs.smoke("gemma2_2b")) == \
        dataclasses.asdict(jconfigs.smoke("gemma2_2b"))
    cfg = tconfigs.sparsify_ffn(tconfigs.get("gemma2-2b"), 1 / 8)
    specs = [s for period, rep in cfg.groups for _ in range(rep)
             for s in period]
    assert len(specs) == 26 and all(s.ffn == "sparse" for s in specs)
    assert [s.mixer for s in specs[:2]] == ["attn_local", "attn"]


def test_load_jax_params_carries_every_leaf(pair):
    jlm, params, tlm = pair
    n_jax = sum(int(np.asarray(x).size) for x in jax.tree.leaves(params))
    assert n_jax == sum(p.numel() for p in tlm.parameters())
    post = np.asarray(params["stack"][0][1]["post_norm2"]["scale"][0])
    assert np.array_equal(tlm.layers[1].post_norm2.scale.numpy(), post)
    assert tlm.layers[0].local and not tlm.layers[1].local
    assert tlm.layers[0].norm1.plus_one and tlm.final_norm.plus_one


def test_forward_matches_jax(pair):
    jlm, params, tlm = pair
    toks = _tokens((2, 160), 1)
    want, _ = jax.jit(jlm.forward)(params, jnp.asarray(toks))
    got = tlm.forward(toks)
    assert got.shape == (2, 160, VOCAB)
    assert _rel(got, want) <= TOL


def test_prefill_and_decode_match_jax(pair):
    """Padded prefill with ``last_index`` past window + tile, then three
    decode steps whose local layers drop keys out of the window."""
    jlm, params, tlm = pair
    max_len = 176
    toks = _tokens((2, 170), 2)
    lengths = np.asarray([137, 150], np.int32)
    padded = toks[:, :160].copy()
    for row, n in enumerate(lengths):
        padded[row, n:] = 0
    jpre = jax.jit(jlm.prefill, static_argnames=("max_len",))
    want, jc = jpre(params, jnp.asarray(padded), max_len=max_len,
                    last_index=jnp.asarray(lengths - 1))
    got, tc = tlm.prefill(padded, max_len=max_len, last_index=lengths - 1)
    assert _rel(got, want) <= TOL
    for li, cache in enumerate(tc):
        for name in ("k", "v"):
            jk = np.asarray(jc[0][li % 2][name][li // 2])
            assert cache[name].shape == jk.shape
            assert _rel(cache[name], jk) <= TOL, (li, name)

    jdec = jax.jit(jlm.decode_step)
    pos = lengths.copy()
    for step in range(3):
        tok = toks[:, 160 + step:161 + step]
        want, jc = jdec(params, jnp.asarray(tok), jc, jnp.asarray(pos))
        got, tc = tlm.decode_step(tok, tc, pos)
        assert _rel(got, want) <= TOL, step
        pos = pos + 1


def test_exact_prefill_at_an_odd_length_matches_jax(pair):
    """137 tokens: the attention tiles halve from 64 down to 1."""
    jlm, params, tlm = pair
    toks = _tokens((1, 137), 3)
    want, _ = jax.jit(jlm.prefill, static_argnames=("max_len",))(
        params, jnp.asarray(toks), max_len=144)
    got, _ = tlm.prefill(toks, max_len=144)
    assert _rel(got, want) <= TOL


def test_decode_consistent_with_forward(pair):
    _, _, tlm = pair
    toks = _tokens((1, 150), 4)
    full = tlm.forward(toks)
    logits, caches = tlm.prefill(toks[:, :140], max_len=160)
    assert _rel(logits, full[:, 139]) <= TOL
    for pos in range(140, 150):
        logits, caches = tlm.decode_step(toks[:, pos:pos + 1], caches,
                                         np.asarray([pos]))
        assert _rel(logits, full[:, pos]) <= TOL, pos


def test_engine_tokens_match_jax(pair):
    jlm, params, tlm = pair
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, VOCAB, size=n).astype(np.int32)
               for n in (70, 135, 150)]
    jeng = JEngine(jlm, params, batch=2, max_len=192, buckets=(80, 160))
    jreqs = [JRequest(uid=i, prompt=p, max_new_tokens=5)
             for i, p in enumerate(prompts)]
    jeng.run(jreqs)
    eng = Engine(tlm, batch=2, max_len=192, device="cpu", buckets=(80, 160))
    reqs = [Request(uid=i, prompt=p, max_new_tokens=5)
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    for j, t in zip(jreqs, reqs):
        assert t.done and len(t.output) == 5
        assert t.output == j.output, t.uid
        assert t.bucket == j.bucket


def _decode_run(jlm, params, tlm, toks, n, steps):
    """Both packages' forward, then prefill of ``toks[:, :n]`` and
    ``steps`` decode steps: ``(jax_forward, port_forward, [(jax_logits,
    port_logits)] for the prefill and each step)``."""
    jfwd, _ = jax.jit(jlm.forward)(params, jnp.asarray(toks))
    tfwd = tlm.forward(toks)
    jc = None
    want, jc = jax.jit(jlm.prefill, static_argnames=("max_len",))(
        params, jnp.asarray(toks[:, :n]), max_len=n + steps + 8)
    got, tc = tlm.prefill(toks[:, :n], max_len=n + steps + 8)
    out = [(want, got)]
    jdec = jax.jit(jlm.decode_step)
    for pos in range(n, n + steps):
        tok = toks[:, pos:pos + 1]
        want, jc = jdec(params, jnp.asarray(tok), jc, jnp.asarray([pos]))
        got, tc = tlm.decode_step(tok, tc, np.asarray([pos]))
        out.append((want, got))
    return jfwd, tfwd, out


@pytest.mark.parametrize("ffn", ["mlp", "sparse"])
def test_bf16_matches_jax(ffn):
    """The served dtype: the smoke config in bf16 (embedding scale cast,
    plus_one pre and post norms, soft-caps, window past window + tile),
    forward, prefill and three decode steps against the JAX LM on the
    same params, within the bf16 budget."""
    jlm, params, tlm = _pair(ffn, "bfloat16")
    assert tlm.layers[0].attn.wq.w.dtype == torch.bfloat16
    toks = _tokens((1, 143), 6)
    jfwd, tfwd, steps = _decode_run(jlm, params, tlm, toks, 140, 3)
    assert_close_for_dtype(tfwd.float(), jfwd, "bfloat16", "forward")
    for i, (want, got) in enumerate(steps):
        assert_close_for_dtype(got.float(), want, "bfloat16", f"step {i}")


@pytest.mark.parametrize("ffn", ["mlp", "sparse"])
def test_bf16_decode_gap_at_gemma2_depth_is_the_reference_s_own(ffn):
    """At gemma2-2b's depth (13 local/global periods, 26 layers) with
    the smoke widths and random init, the bf16 model amplifies its
    roundings: the JAX LM's own decode logits depart from its own
    forward's by more than the bf16 budget, and the port's by no more
    than the reference's.  In fp32 the two packages agree within the
    slice budget at that depth, so the gap is the dtype's, not the
    port's."""
    n, steps = 140, 3
    toks = _tokens((1, n + steps), 7)
    gaps = {}
    for dtype in ("float32", "bfloat16"):
        jlm, params, tlm = _pair(ffn, dtype, periods=13)
        jfwd, tfwd, out = _decode_run(jlm, params, tlm, toks, n, steps)
        gaps[dtype] = dict(
            jax=max(_rel(w, jfwd[:, n - 1 + i]) for i, (w, _) in
                    enumerate(out)),
            port=max(_rel(g, tfwd[:, n - 1 + i]) for i, (_, g) in
                     enumerate(out)),
            port_vs_jax=max(_rel(g, w) for w, g in out))
    print(f"decode-vs-forward gaps at 26 layers ({ffn}): {gaps}")
    assert gaps["float32"]["port_vs_jax"] <= TOL
    assert gaps["float32"]["jax"] <= TOL and gaps["float32"]["port"] <= TOL
    assert gaps["bfloat16"]["jax"] > grad_tol("bfloat16")
    assert gaps["bfloat16"]["port"] <= gaps["bfloat16"]["jax"]
