"""The slice end to end against the JAX package: llama3.2-1b's smoke
config with every FFN block-sparse (d=1/4, b=16), in fp32, the JAX
params carried over with ``LM.load_jax_params``.  Budget: rel-max 2e-4
over the JAX logits' max magnitude (fp32 summation-order noise through
two layers, the attention's one-pass vs online softmax, and the unembed).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models.model import LM as TLM  # noqa: E402

TOL = 2e-4


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / max(
        float(np.abs(want).max()), 1e-6)


def _cfg(port: bool):
    """The smoke config with every FFN sparse at d=1/4, in fp32; the JAX
    side is built by hand (its helper lives in the benchmark suite)."""
    if port:
        cfg = tconfigs.sparsify_ffn(tconfigs.smoke("llama3_2_1b"), 0.25)
    else:
        cfg = jconfigs.smoke("llama3_2_1b")
        groups = tuple((tuple(dataclasses.replace(s, ffn="sparse")
                              for s in period), rep)
                       for period, rep in cfg.groups)
        cfg = dataclasses.replace(cfg, groups=groups, ffn_density=0.25)
    return dataclasses.replace(cfg, dtype="float32")


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = _cfg(False), _cfg(True)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jlm = JLM(jcfg)
    params = jlm.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    tlm = TLM(tcfg, device="cpu").load_jax_params(tree)
    return jlm, params, tlm


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 512, size=shape).astype(
        np.int32)


def test_config_copy_matches_reference():
    assert dataclasses.asdict(tconfigs.get("llama3_2_1b")) == \
        dataclasses.asdict(jconfigs.get("llama3_2_1b"))
    assert dataclasses.asdict(tconfigs.smoke("llama3.2-1b")) == \
        dataclasses.asdict(jconfigs.smoke("llama3_2_1b"))
    with pytest.raises(ValueError, match="unknown architecture"):
        tconfigs.get("no_such_arch")


def test_load_jax_params_carries_every_leaf(pair):
    jlm, params, tlm = pair
    n_jax = sum(int(np.asarray(x).size) for x in jax.tree.leaves(params))
    assert n_jax == sum(p.numel() for p in tlm.parameters())
    up = np.asarray(params["stack"][0][0]["ffn"]["up"]["values"][1])
    assert np.array_equal(tlm.layers[1].ffn.up.values.numpy(), up)


def test_load_jax_params_rejects_mismatch(pair):
    jlm, params, tlm = pair
    tree = jax.tree.map(np.asarray, params)
    del tree["stack"][0][0]["attn"]["wq"]
    with pytest.raises(ValueError, match="only in the port"):
        TLM(_cfg(True), device="cpu").load_jax_params(tree)


def test_forward_matches_jax(pair):
    jlm, params, tlm = pair
    toks = _tokens((2, 12), 1)
    want, _ = jax.jit(jlm.forward)(params, jnp.asarray(toks))
    got = tlm.forward(toks)
    assert got.shape == (2, 12, 512)
    assert _rel(got, want) <= TOL


def test_prefill_and_decode_match_jax(pair):
    jlm, params, tlm = pair
    max_len = 24
    toks = _tokens((2, 20), 2)
    lengths = np.asarray([9, 13], np.int32)
    padded = toks[:, :16].copy()
    padded[0, 9:] = 0
    padded[1, 13:] = 0
    jpre = jax.jit(jlm.prefill, static_argnames=("max_len",))
    want, jc = jpre(params, jnp.asarray(padded), max_len=max_len,
                    last_index=jnp.asarray(lengths - 1))
    got, tc = tlm.prefill(padded, max_len=max_len, last_index=lengths - 1)
    assert _rel(got, want) <= TOL
    for li, cache in enumerate(tc):
        for name in ("k", "v"):
            jk = np.asarray(jc[0][0][name][li])
            assert cache[name].shape == jk.shape
            assert _rel(cache[name], jk) <= TOL, (li, name)

    jdec = jax.jit(jlm.decode_step)
    pos = lengths.copy()
    for step in range(3):
        tok = toks[:, 14 + step:15 + step]
        want, jc = jdec(params, jnp.asarray(tok), jc, jnp.asarray(pos))
        got, tc = tlm.decode_step(tok, tc, pos)
        assert _rel(got, want) <= TOL, step
        pos = pos + 1
    assert _rel(tc[1]["k"], np.asarray(jc[0][0]["k"][1])) <= TOL


def test_decode_consistent_with_forward(pair):
    _, _, tlm = pair
    toks = _tokens((1, 10), 3)
    full = tlm.forward(toks)
    logits, caches = tlm.prefill(toks[:, :8], max_len=16)
    assert _rel(logits, full[:, 7]) <= TOL
    for pos in (8, 9):
        logits, caches = tlm.decode_step(toks[:, pos:pos + 1], caches,
                                         np.asarray([pos]))
        assert _rel(logits, full[:, pos]) <= TOL


def test_lm_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TLM(_cfg(True))


@pytest.mark.parametrize("field, value", [("long_attention",
                                           "block_sparse")])
def test_lm_rejects_unported_features(pair, field, value):
    """No config field is refused any more: ``long_attention`` is read
    nowhere in the reference, so ``"block_sparse"`` builds and runs as
    ``"full"`` there, and the port does the same."""
    jlm, params, tlm = pair
    cfg = dataclasses.replace(_cfg(True), **{field: value})
    lm = TLM(cfg, device="cpu").load_jax_params(
        jax.tree.map(np.asarray, params))
    toks = _tokens((2, 12), 21)
    jcfg = dataclasses.replace(_cfg(False), **{field: value})
    want, _ = jax.jit(JLM(jcfg).forward)(params, jnp.asarray(toks))
    got = lm.forward(toks)
    assert _rel(got, want) <= TOL
    assert _rel(got, tlm.forward(toks)) <= TOL


def test_lm_builds_the_encoder_it_is_given():
    """``encoder_layers`` is ported: a config with it gets a bidirectional
    encoder of that depth and ``enc_norm``, and a decoder without cross
    layers does not read its memory."""
    cfg = dataclasses.replace(_cfg(True), encoder_layers=2)
    lm = TLM(cfg, device="cpu")
    assert len(lm.encoder) == 2 and lm.enc_norm is not None
    assert not any(layer.attn.causal for layer in lm.encoder)
    toks = _tokens((1, 6), 4)
    frames = np.random.default_rng(0).standard_normal(
        (1, 5, cfg.d_model)).astype(np.float32)
    assert torch.equal(lm.forward(toks, enc_frames=frames), lm.forward(toks))


def test_bf16_model_runs_on_cpu():
    cfg = tconfigs.sparsify_ffn(tconfigs.smoke("llama3_2_1b"), 1 / 8)
    lm = TLM(cfg, device="cpu", seed=1)
    assert lm.layers[0].ffn.up.values.dtype == torch.bfloat16
    logits = lm.forward(_tokens((1, 6), 4))
    assert logits.dtype == torch.bfloat16
    assert bool(torch.isfinite(logits.float()).all())
