"""MLA and deepseek-v2-lite-16b against the JAX package, on the CPU.

The ``MLA`` module's entry points (``forward``, ``prefill``, ``decode``,
``cache_init``) against ``mla_train``, ``mla_prefill``, ``mla_decode``
and ``mla_cache_init``, with and without ``q_lora_rank``, and its
gradients against ``jax.grad`` of ``mla_train``; deepseek's smoke
``LM`` (one dense layer, then two MoE layers of 4 experts top-2 with a
shared expert) end to end (forward, prefill / decode_step, ``loss`` with
the router losses and its gradients, the engine's tokens); the bs_attn
plain version against the Pallas kernel in interpret mode at MLA's q.k
head dim 192.  Weights come from the JAX init (norm scales, ones there,
set to seeded values where a module test loads them), every input from
numpy with a seed, fp32 throughout.

Budgets, rel-max over the reference's max magnitude: the module's and
the LM's outputs and caches 2e-4 (the slice budget of
``tests/test_torch_model.py``); gradients and the loss 1e-4
(``MODEL_TOL`` of ``tests/test_torch_train.py``); bs_attn the conftest's
per-dtype budget (fp32 1e-4, bf16 6e-2).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import assert_close_for_dtype  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.kernels.bs_attn import ops as jbs_ops  # noqa: E402
from repro.kernels.bs_attn.ref import bs_attn_ref as jbs_attn_ref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels.bs_attn import ops as tbs_ops  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.model import LM as TLM  # noqa: E402
from repro_torch.models.model import _copy_into, _flatten  # noqa: E402
from repro_torch.serve import Engine, Request  # noqa: E402

TOL = 2e-4
MODEL_TOL = 1e-4
VOCAB = 512
ARCH = "deepseek_v2_lite_16b"
# the module variants: Lite's (one q projection) and DeepSeek-V2's
# low-rank query
Q_LORA = {"lite": None, "q_lora": 24}


def _rel(got, want):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-6)


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, VOCAB, size=shape).astype(
        np.int32)


def _cfg(port: bool, q_lora=None):
    cfg = tconfigs.smoke(ARCH) if port else jconfigs.smoke(ARCH)
    return dataclasses.replace(cfg, dtype="float32", q_lora_rank=q_lora)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_config_copy_matches_reference():
    for name in (ARCH, "deepseek-v2-lite-16b"):
        assert dataclasses.asdict(tconfigs.get(name)) == \
            dataclasses.asdict(jconfigs.get(ARCH))
        assert dataclasses.asdict(tconfigs.smoke(name)) == \
            dataclasses.asdict(jconfigs.smoke(ARCH))
    cfg = tconfigs.get(ARCH)
    assert cfg.attn_impl == "mla" and cfg.q_lora_rank is None
    assert [(len(p), r, p[0].ffn) for p, r in cfg.groups] == [
        (1, 1, "mlp"), (1, 26, "moe")]
    assert cfg.param_count() == jconfigs.get(ARCH).param_count()


# ---------------------------------------------------------------------------
# the MLA module
# ---------------------------------------------------------------------------

_MODULES = {}


def _module(variant):
    """``(jcfg, params, mla)``: ``mla_init``'s params with seeded norm
    scales, and the port's ``MLA`` holding them (copied by leaf name)."""
    if variant not in _MODULES:
        jcfg = _cfg(False, Q_LORA[variant])
        tcfg = _cfg(True, Q_LORA[variant])
        tree = jax.tree.map(np.asarray, jattn.mla_init(
            jax.random.PRNGKey(3), jcfg, dtype=jnp.float32))
        rng = np.random.default_rng(11)
        norms = [tree["kv_norm"]] + ([tree["q"]["norm"]]
                                     if jcfg.q_lora_rank else [])
        for norm in norms:
            norm["scale"] = (1.0 + 0.3 * rng.standard_normal(
                norm["scale"].shape)).astype(np.float32)
        mla = tattn.MLA(tcfg, dtype=torch.float32, device="cpu")
        _copy_into(dict(mla.named_parameters()), _flatten(tree), "MLA")
        _MODULES[variant] = (jcfg, jax.tree.map(jnp.asarray, tree), mla)
    return _MODULES[variant]


@pytest.mark.parametrize("variant", sorted(Q_LORA))
def test_mla_parameter_names_are_the_reference_leaves(variant):
    jcfg, params, mla = _module(variant)
    names = set(dict(mla.named_parameters()))
    assert names == set(_flatten(jax.tree.map(np.asarray, params)))
    want = {"kv_a.w", "kv_norm.scale", "kv_b.w", "wo.w"} | (
        {"q.a.w", "q.norm.scale", "q.b.w"} if jcfg.q_lora_rank
        else {"q.w.w"})
    assert names == want


@pytest.mark.parametrize("variant", sorted(Q_LORA))
def test_mla_forward_matches_jax(variant):
    jcfg, params, mla = _module(variant)
    x = _np((2, 24, jcfg.d_model), 1, 0.5)
    pos = np.arange(24)[None, :]
    want = jattn.mla_train(params, jcfg, jnp.asarray(x),
                           positions=jnp.asarray(pos))
    got = mla(torch.as_tensor(x), torch.as_tensor(pos))
    assert got.shape == (2, 24, jcfg.d_model)
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("variant", sorted(Q_LORA))
def test_mla_prefill_and_decode_match_jax(variant):
    """``prefill`` (output, latent and roped-key caches padded to
    ``max_len``), then decode steps at per-row positions (row 1 rewrites
    an earlier slot), the caches updated in place."""
    jcfg, params, mla = _module(variant)
    max_len, s = 20, 10
    x = _np((2, s, jcfg.d_model), 2, 0.5)
    pos = np.arange(s)[None, :]
    want, jc = jattn.mla_prefill(params, jcfg, jnp.asarray(x),
                                 positions=jnp.asarray(pos), max_len=max_len)
    got, tc = mla.prefill(torch.as_tensor(x), torch.as_tensor(pos),
                          max_len=max_len)
    assert _rel(got, want) <= TOL
    assert set(tc) == set(jc) == {"latent", "k_rope"}
    for name in tc:
        assert tuple(tc[name].shape) == jc[name].shape
        assert _rel(tc[name], jc[name]) <= TOL, name
    assert not tc["latent"][:, s:].any()

    positions = np.asarray([s, 7])
    for step in range(3):
        xt = _np((2, 1, jcfg.d_model), 10 + step, 0.5)
        want, jc = jattn.mla_decode(params, jcfg, jnp.asarray(xt), jc,
                                    positions=jnp.asarray(positions))
        got, tc2 = mla.decode(torch.as_tensor(xt), tc,
                              torch.as_tensor(positions))
        assert tc2 is tc
        assert _rel(got, want) <= TOL, step
        for name in tc:
            assert _rel(tc[name], jc[name]) <= TOL, (step, name)
        positions = positions + 1


@pytest.mark.parametrize("variant", sorted(Q_LORA))
def test_mla_cache_init_matches_jax(variant):
    jcfg, _, _ = _module(variant)
    want = jattn.mla_cache_init(jcfg, 3, 16, dtype=jnp.float32)
    got = tattn.mla_cache_init(_cfg(True, Q_LORA[variant]), 3, 16,
                               dtype=torch.float32, device="cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    assert not any(v.any() for v in got.values())


@pytest.mark.parametrize("variant", sorted(Q_LORA))
def test_mla_grads_match_jax(variant):
    """``sum(mla_train(x) * gy)`` differentiated in x and every
    parameter, ``jax.grad`` against autograd through bs_attn's plain
    recompute."""
    jcfg, params, mla = _module(variant)
    x = _np((2, 16, jcfg.d_model), 4, 0.5)
    gy = _np((2, 16, jcfg.d_model), 5)
    pos = np.arange(16)[None, :]

    def f(p, xx):
        y = jattn.mla_train(p, jcfg, xx, positions=jnp.asarray(pos))
        return jnp.sum(y * jnp.asarray(gy))

    jgp, jgx = jax.grad(f, argnums=(0, 1))(params, jnp.asarray(x))
    want = _flatten(jax.tree.map(np.asarray, jgp))
    named = list(mla.named_parameters())
    mla.requires_grad_(True)
    try:
        tx = torch.as_tensor(x).requires_grad_(True)
        y = mla(tx, torch.as_tensor(pos))
        grads = torch.autograd.grad((y * torch.as_tensor(gy)).sum(),
                                    [tx] + [p for _, p in named])
    finally:
        mla.requires_grad_(False)
    assert _rel(grads[0], jgx) <= MODEL_TOL
    worst = {n: _rel(g, want[n]) for (n, _), g in zip(named, grads[1:])}
    assert max(worst.values()) <= MODEL_TOL, worst


# ---------------------------------------------------------------------------
# deepseek's smoke LM
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = _cfg(False), _cfg(True)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jlm = JLM(jcfg)
    params = jlm.init(jax.random.PRNGKey(0))
    tlm = TLM(tcfg, device="cpu").load_jax_params(
        jax.tree.map(np.asarray, params))
    return jlm, params, tlm


def test_load_jax_params_carries_every_leaf(pair):
    """Both groups: the dense layer's MLP and the MoE layers' experts,
    router and shared expert, with every MLA leaf."""
    jlm, params, tlm = pair
    n_jax = sum(int(np.asarray(x).size) for x in jax.tree.leaves(params))
    assert n_jax == sum(p.numel() for p in tlm.parameters())
    names = dict(tlm.named_parameters())
    assert "layers.0.ffn.up.w" in names
    assert not any(n.startswith("layers.0.ffn.w_") for n in names)
    assert any(n.startswith("layers.2.ffn.shared.") for n in names)
    moe = params["stack"][1][0]
    assert np.array_equal(names["layers.2.attn.kv_b.w"].numpy(),
                          np.asarray(moe["attn"]["kv_b"]["w"][1]))
    assert np.array_equal(names["layers.2.ffn.w_up"].numpy(),
                          np.asarray(moe["ffn"]["w_up"][1]))
    dense = params["stack"][0][0]
    assert np.array_equal(names["layers.0.attn.kv_a.w"].numpy(),
                          np.asarray(dense["attn"]["kv_a"]["w"][0]))


def test_forward_matches_jax(pair):
    jlm, params, tlm = pair
    toks = _tokens((2, 12), 1)
    want, wm = jax.jit(jlm.forward)(params, jnp.asarray(toks))
    got, gm = tlm.forward(toks, return_metrics=True)
    assert got.shape == (2, 12, VOCAB)
    assert _rel(got, want) <= TOL
    for name in ("aux_loss", "z_loss"):
        assert _rel(gm[name], wm[name]) <= 1e-5, name


def test_prefill_and_decode_match_jax(pair):
    """Bucketed prefill (right-padded rows read at their last token) and
    three decode steps; each group's latent and roped-key caches."""
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

    def jax_cache(caches, li):
        """Layer ``li``'s cache out of the reference's per-group stacks
        (group 0: layer 0; group 1: layers 1 and 2)."""
        g, i = (0, li) if li < 1 else (1, li - 1)
        return {k: np.asarray(v[i]) for k, v in caches[g][0].items()}

    for li, cache in enumerate(tc):
        want_c = jax_cache(jc, li)
        assert set(cache) == set(want_c) == {"latent", "k_rope"}
        for name in cache:
            assert cache[name].shape == want_c[name].shape
            assert _rel(cache[name], want_c[name]) <= TOL, (li, name)

    jdec = jax.jit(jlm.decode_step)
    pos = lengths.copy()
    for step in range(3):
        tok = toks[:, 14 + step:15 + step]
        want, jc = jdec(params, jnp.asarray(tok), jc, jnp.asarray(pos))
        got, tc = tlm.decode_step(tok, tc, pos)
        assert _rel(got, want) <= TOL, step
        pos = pos + 1
    for li in range(3):
        for name, want_c in jax_cache(jc, li).items():
            assert _rel(tc[li][name], want_c) <= TOL, (li, name)


def test_loss_and_grads_match_jax(pair):
    """``LM.loss`` with the router losses and its gradient in every
    parameter against ``jax.value_and_grad`` of the JAX ``LM.loss``."""
    jlm, params, tlm = pair
    rng = np.random.default_rng(5)
    toks = rng.integers(0, VOCAB, size=(2, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:].copy()}
    batch["targets"][0, -3:] = -1
    jb = jax.tree.map(jnp.asarray, batch)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss(p, jb), has_aux=True))(params)
    want = tlm.jax_leaves(jax.tree.map(np.asarray, jgrads))
    tlm.requires_grad_(True)
    try:
        loss, metrics = tlm.loss(batch["tokens"], batch["targets"])
        named = list(tlm.named_parameters())
        grads = torch.autograd.grad(loss, [p for _, p in named])
    finally:
        tlm.requires_grad_(False)
    assert set(metrics) == {"aux_loss", "z_loss", "dropped_frac", "xent"}
    assert _rel(loss, jloss) <= MODEL_TOL
    for name in ("aux_loss", "z_loss", "xent"):
        assert _rel(metrics[name], jm[name]) <= MODEL_TOL, name
    assert abs(float(metrics["dropped_frac"])
               - float(jm["dropped_frac"])) <= 1e-6
    worst = {n: _rel(g, want[n]) for (n, _), g in zip(named, grads)}
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:3]
    assert max(worst.values()) <= MODEL_TOL, top


def test_engine_tokens_match_jax(pair):
    """Greedy tokens through both engines on the reference's bucket
    ladder (the port prices its own ladder on the H100 model, so it is
    handed the reference's)."""
    jlm, params, tlm = pair
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, VOCAB, size=n).astype(np.int32)
               for n in (20, 45, 70)]
    jeng = JEngine(jlm, params, batch=2, max_len=96)
    jreqs = [JRequest(uid=i, prompt=p, max_new_tokens=4)
             for i, p in enumerate(prompts)]
    jeng.run(jreqs)
    eng = Engine(tlm, batch=2, max_len=96, device="cpu",
                 buckets=jeng.buckets, graphs=False)
    assert eng.buckets == tuple(jeng.buckets)
    assert all(set(c) == {"latent", "k_rope"} for c in eng.caches)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=4)
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    for j, t in zip(jreqs, reqs):
        assert t.done and len(t.output) == 4
        assert t.output == j.output, t.uid
        assert t.bucket == j.bucket


# ---------------------------------------------------------------------------
# bs_attn at MLA's head dim
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pattern", ["causal", "full"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bs_attn_plain_matches_jax_at_dh_192(pattern, dtype):
    """The kernel's plain version against the Pallas kernel in
    interpret mode and its oracle at dh 192 (S 256, tiles of 128)."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    q, k, v = (_np((2, 256, 192), i, 0.3 if i < 2 else 1.0)
               for i in range(3))
    bm = np.ones((2, 2), bool)
    causal = pattern == "causal"
    if causal:
        bm = np.tril(bm)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    want_ref = jbs_attn_ref(jq, jk, jv, bm, causal=causal)
    want_kernel = jbs_ops.bs_attn(jq, jk, jv, bm, causal=causal,
                                  interpret=True)
    got = tbs_ops.bs_attn(*(torch.as_tensor(a).to(tdt) for a in (q, k, v)),
                          bm, causal=causal)
    assert got.shape == (2, 256, 192)
    assert_close_for_dtype(got.float(), np.asarray(want_ref, np.float32),
                           dtype, "vs bs_attn_ref")
    assert_close_for_dtype(got.float(), np.asarray(want_kernel, np.float32),
                           dtype, "vs bs_attn (interpret)")


def test_bs_attn_takes_dh_192():
    assert 192 in tbs_ops.HEAD_DIMS
    q = torch.zeros((1, 64, 2, 192))
    walk = tbs_ops.make_walk(np.ones((1, 1), bool), 64, 64, "cpu")
    # the head dim is admitted: only the device is refused here
    with pytest.raises(ValueError, match="CUDA tensors"):
        tbs_ops.bs_attn_cuda(q, q, q, walk, scale=1.0)
    with pytest.raises(ValueError, match="head dims"):
        tbs_ops.bs_attn_cuda(q[..., :160], q[..., :160], q[..., :160],
                             walk, scale=1.0)
