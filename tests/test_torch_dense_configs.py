"""qwen2-1.5b and glm4-9b against the JAX package: the two dense configs
with biased q/k/v projections, at their smoke configs in fp32.

``gqa_init`` makes the biases zeros, so a parity test on a fresh init
would hold nothing; every test below sets the bias leaves of the numpy
params tree to seeded non-zero values and loads that tree into both
models.  The full configs' GQA groups (qwen2 12 / 2 = 6, glm4 32 / 2 =
16) are not the smoke configs' (4 / 2), so ``attend_train`` is also held
at those groups.  Budget: rel-max 2e-4 over the JAX output's max
magnitude (the slice budget of ``tests/test_torch_model.py``: fp32
summation order through two layers and the unembed).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.model import LM as TLM  # noqa: E402

TOL = 2e-4
VOCAB = 512
ARCHS = {"qwen2_1_5b": "qwen2-1.5b", "glm4_9b": "glm4-9b"}
BIASES = ("wq", "wk", "wv")


def _rel(got, want):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-6)


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, VOCAB, size=shape).astype(
        np.int32)


def _with_biases(tree, seed):
    """The numpy params tree with every q/k/v bias leaf set to seeded
    values of the order of the projections' outputs."""
    rng = np.random.default_rng(seed)
    for group in tree["stack"]:
        for pos in group:
            for name in BIASES:
                b = pos["attn"][name]["b"]
                pos["attn"][name]["b"] = rng.standard_normal(
                    b.shape).astype(np.float32) * 0.5
    return tree


_PAIRS = {}


def _pair(arch):
    """``(jlm, params, tlm)``: the JAX LM's init with seeded biases, the
    port's LM holding the same weights; built once per process."""
    if arch not in _PAIRS:
        jcfg = dataclasses.replace(jconfigs.smoke(arch), dtype="float32")
        tcfg = dataclasses.replace(tconfigs.smoke(arch), dtype="float32")
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        jlm = JLM(jcfg)
        tree = _with_biases(jax.tree.map(
            np.asarray, jlm.init(jax.random.PRNGKey(0))), seed=7)
        params = jax.tree.map(jnp.asarray, tree)
        tlm = TLM(tcfg, device="cpu").load_jax_params(tree)
        _PAIRS[arch] = (jlm, params, tlm)
    return _PAIRS[arch]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_config_copy_matches_reference(arch):
    for name in (arch, ARCHS[arch]):
        assert dataclasses.asdict(tconfigs.get(name)) == \
            dataclasses.asdict(jconfigs.get(arch))
        assert dataclasses.asdict(tconfigs.smoke(name)) == \
            dataclasses.asdict(jconfigs.smoke(arch))
    assert arch in tconfigs.ARCH_IDS and tconfigs.get(arch).qkv_bias


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_load_jax_params_carries_the_biases(arch):
    jlm, params, tlm = _pair(arch)
    n_jax = sum(int(np.asarray(x).size) for x in jax.tree.leaves(params))
    assert n_jax == sum(p.numel() for p in tlm.parameters())
    for name in BIASES:
        want = np.asarray(params["stack"][0][0]["attn"][name]["b"][1])
        got = getattr(tlm.layers[1].attn, name).b.detach().numpy()
        assert np.abs(want).max() > 0.1
        assert np.array_equal(got, want), name


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_matches_jax(arch):
    jlm, params, tlm = _pair(arch)
    toks = _tokens((2, 12), 1)
    want, _ = jax.jit(jlm.forward)(params, jnp.asarray(toks))
    got = tlm.forward(toks)
    assert got.shape == (2, 12, VOCAB)
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_the_biases_matter(arch):
    """The same port model with its q/k/v biases zeroed is far from the
    JAX model's logits: the parity above holds the biases."""
    jlm, params, tlm = _pair(arch)
    toks = _tokens((2, 12), 1)
    want, _ = jax.jit(jlm.forward)(params, jnp.asarray(toks))
    saved = {}
    with torch.no_grad():
        for i, layer in enumerate(tlm.layers):
            for name in BIASES:
                b = getattr(layer.attn, name).b
                saved[i, name] = b.clone()
                b.zero_()
    try:
        assert _rel(tlm.forward(toks), want) > 50 * TOL
    finally:
        with torch.no_grad():
            for (i, name), b in saved.items():
                getattr(tlm.layers[i].attn, name).b.copy_(b)
    assert _rel(tlm.forward(toks), want) <= TOL


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_and_decode_match_jax(arch):
    jlm, params, tlm = _pair(arch)
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
            assert _rel(cache[name], np.asarray(jc[0][0][name][li])) <= TOL

    jdec = jax.jit(jlm.decode_step)
    pos = lengths.copy()
    for step in range(3):
        tok = toks[:, 14 + step:15 + step]
        want, jc = jdec(params, jnp.asarray(tok), jc, jnp.asarray(pos))
        got, tc = tlm.decode_step(tok, tc, pos)
        assert _rel(got, want) <= TOL, step
        pos = pos + 1
    for name in ("k", "v"):
        assert _rel(tc[1][name], np.asarray(jc[0][0][name][1])) <= TOL


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_decode_consistent_with_forward(arch):
    _, _, tlm = _pair(arch)
    toks = _tokens((1, 10), 3)
    full = tlm.forward(toks)
    logits, caches = tlm.prefill(toks[:, :8], max_len=16)
    assert _rel(logits, full[:, 7]) <= TOL
    for pos in (8, 9):
        logits, caches = tlm.decode_step(toks[:, pos:pos + 1], caches,
                                         np.asarray([pos]))
        assert _rel(logits, full[:, pos]) <= TOL


# the full configs' groups: qwen2 12 heads over 2 kv heads, glm4 32 over 2
@pytest.mark.parametrize("heads", [12, 32])
def test_attend_train_at_the_full_configs_groups(heads):
    """``attend_train`` (the kernel's plain version here) against the
    JAX one at GQA groups 6 and 16 (2 kv heads, dh 32, S 96 in tiles of
    32), causal."""
    rng = np.random.default_rng(heads)
    q = rng.standard_normal((2, 96, heads, 32)).astype(np.float32)
    k, v = (rng.standard_normal((2, 96, 2, 32)).astype(np.float32)
            for _ in range(2))
    want = jattn.attend_train(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), tile_q=32, tile_kv=32)
    got = tattn.attend_train(torch.as_tensor(q), torch.as_tensor(k),
                             torch.as_tensor(v), tile_q=32, tile_kv=32)
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_full_config_geometry(arch):
    """The full configs' attention as served: q/k/v biases of their
    widths, and the port's parameter count the reference's."""
    cfg = tconfigs.get(arch)
    qd, kvd = cfg.attn_dims
    assert (qd, kvd) == (cfg.num_heads * 128, 2 * 128)
    assert cfg.num_heads // cfg.num_kv_heads == {"qwen2_1_5b": 6,
                                                 "glm4_9b": 16}[arch]
    assert cfg.param_count() == jconfigs.get(arch).param_count()
