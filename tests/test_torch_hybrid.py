"""mamba2-130m and the jamba-v0.1 hybrid against the JAX package, on the
CPU.

The config copies (full and smoke), the weight carry-over (``mixer.*``
leaves, layers without ``norm2``), and the smoke ``LM``s end to end:
``forward``, ``prefill(last_index=)`` with decode steps, ``loss`` and its
gradients (``jax.grad``), the engine's greedy tokens at exact-length
prefill (both stacks are pad-unsafe: no buckets), ``_stack_shapes`` of
the full configs; jamba's attention layers (no rope, the first port
config without it) against the reference's in prefill and decode; and
decode after 1- and 2-token prompts against the port's own ``forward``
(the reference's engine cannot take them: ``ROADMAP.md`` §3).  Weights
from the JAX init (the mixers' constant leaves seeded), inputs from
numpy with a seed, fp32.

Budgets, rel-max over the reference's max magnitude: outputs and caches
2e-4 (the slice budget of ``tests/test_torch_model.py``); the loss and
gradients 1e-4 (``MODEL_TOL`` of ``tests/test_torch_train.py``).
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
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.model import LM as TLM  # noqa: E402
from repro_torch.models.model import _copy_into, _flatten  # noqa: E402
from repro_torch.serve import Engine, Request  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402

TOL = 2e-4
MODEL_TOL = 1e-4
VOCAB = 512
ARCHS = {"mamba2_130m": "mamba2-130m", "jamba_v0_1_52b": "jamba-v0.1-52b"}


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


def _cfg(port: bool, arch: str):
    cfg = tconfigs.smoke(arch) if port else jconfigs.smoke(arch)
    return dataclasses.replace(cfg, dtype="float32")


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_config_copy_matches_reference(arch):
    for name in (arch, ARCHS[arch]):
        assert dataclasses.asdict(tconfigs.get(name)) == \
            dataclasses.asdict(jconfigs.get(arch))
        assert dataclasses.asdict(tconfigs.smoke(name)) == \
            dataclasses.asdict(jconfigs.smoke(arch))
    assert tconfigs.get(arch).param_count() == \
        jconfigs.get(arch).param_count()
    # no dense MLP FFN everywhere: --density does not apply
    assert not tconfigs.dense_ffns(tconfigs.get(arch))
    assert tconfigs.dense_ffns(tconfigs.get("llama3_2_1b"))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_stack_shapes_match_reference(arch):
    """The engine prices a mamba layer at its in/out projections, as the
    reference does, and neither stack may be padded."""
    for get in ("get", "smoke"):
        tcfg = getattr(tconfigs, get)(arch)
        jcfg = getattr(jconfigs, get)(arch)
        assert tengine._stack_shapes(tcfg) == jengine._stack_shapes(jcfg)
        assert tengine._pad_safe(tcfg) is False
        assert jengine._pad_safe(jcfg) is False
    d = tconfigs.get(arch).d_model
    assert (2 * 2 * d, d) in tengine._stack_shapes(tconfigs.get(arch))


# ---------------------------------------------------------------------------
# the smoke LMs
# ---------------------------------------------------------------------------

_PAIRS = {}


def _seed_mixer_leaves(tree, seed):
    """Seeded values for the leaves ``ssm_init`` sets to constants (norm
    scale, conv bias, dt bias, D), in every mamba layer's stacked
    params."""
    rng = np.random.default_rng(seed)
    for group in tree["stack"]:
        for pos in group:
            mix = pos.get("mixer")
            if mix is None:
                continue
            for leaf, base, scale in (("conv_b", 0.0, 0.2),
                                      ("dt_bias", 0.0, 0.5),
                                      ("D", 1.0, 0.3)):
                mix[leaf] = (base + scale * rng.standard_normal(
                    mix[leaf].shape)).astype(np.float32)
            mix["norm"]["scale"] = (1.0 + 0.3 * rng.standard_normal(
                mix["norm"]["scale"].shape)).astype(np.float32)
    return tree


def _pair(arch):
    """``(jlm, params, tlm)`` on the smoke config in fp32."""
    if arch not in _PAIRS:
        jcfg, tcfg = _cfg(False, arch), _cfg(True, arch)
        jlm = JLM(jcfg)
        tree = _seed_mixer_leaves(jax.tree.map(
            np.asarray, jlm.init(jax.random.PRNGKey(0))), 7)
        tlm = TLM(tcfg, device="cpu").load_jax_params(tree)
        _PAIRS[arch] = (jlm, jax.tree.map(jnp.asarray, tree), tlm)
    return _PAIRS[arch]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_load_jax_params_carries_every_leaf(arch):
    jlm, params, tlm = _pair(arch)
    n_jax = sum(int(np.asarray(x).size) for x in jax.tree.leaves(params))
    assert n_jax == sum(p.numel() for p in tlm.parameters())
    names = dict(tlm.named_parameters())
    mixer = {"in_proj.w", "conv_w", "conv_b", "dt_bias", "A_log", "D",
             "norm.scale", "out_proj.w"}
    assert {n[len("layers.0.mixer."):] for n in names
            if n.startswith("layers.0.mixer.")} == mixer
    first = params["stack"][0][0]
    r = 1 if arch == "mamba2_130m" else 0
    li = 1 if arch == "mamba2_130m" else 0
    assert np.array_equal(names[f"layers.{li}.mixer.in_proj.w"].numpy(),
                          np.asarray(first["mixer"]["in_proj"]["w"][r]))
    assert np.array_equal(names[f"layers.{li}.mixer.dt_bias"].numpy(),
                          np.asarray(first["mixer"]["dt_bias"][r]))
    if arch == "mamba2_130m":
        assert not any("norm2" in n or ".ffn." in n for n in names)
        assert tlm.layers[0].norm2 is None and tlm.layers[0].ffn is None
    else:
        # the period: mamba+mlp, mamba+moe, attn+mlp, mamba+moe
        assert [type(layer.ffn).__name__ for layer in tlm.layers] == [
            "MLP", "MoE", "MLP", "MoE"]
        assert tlm.layers[2].ssm is False and hasattr(tlm.layers[2], "attn")
        assert np.array_equal(names["layers.2.attn.wq.w"].numpy(),
                              np.asarray(params["stack"][0][2]["attn"]["wq"]
                                         ["w"][0]))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_matches_jax(arch):
    """37 tokens: an odd length, so every mixer runs chunks of 1."""
    jlm, params, tlm = _pair(arch)
    for n, seed in ((37, 1), (64, 2)):
        toks = _tokens((2, n), seed)
        want, wm = jax.jit(jlm.forward)(params, jnp.asarray(toks))
        got, gm = tlm.forward(toks, return_metrics=True)
        assert got.shape == (2, n, VOCAB)
        assert _rel(got, want) <= TOL, n
        assert _rel(gm["aux_loss"], wm["aux_loss"]) <= 1e-5


def _jax_cache(cfg, caches, li):
    """Layer ``li``'s cache out of the reference's per-group stacks."""
    for (period, rep), group in zip(cfg.groups, caches):
        n = len(period) * rep
        if li < n:
            r, si = divmod(li, len(period))
            return {k: np.asarray(v[r]) for k, v in group[si].items()}
        li -= n
    raise IndexError(li)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_and_decode_match_jax(arch):
    """An exact-length prefill of 13 tokens with the logits gathered at
    ``last_index`` (12 and 7), each layer's cache (``{state, conv}`` of a
    mamba layer, ``{k, v}`` of an attention layer), then three decode
    steps and the caches after them."""
    jlm, params, tlm = _pair(arch)
    cfg = jlm.cfg
    max_len, s = 24, 13
    toks = _tokens((2, s + 3), 3)
    last = np.asarray([s - 1, 7], np.int32)
    jpre = jax.jit(jlm.prefill, static_argnames=("max_len",))
    want, jc = jpre(params, jnp.asarray(toks[:, :s]), max_len=max_len,
                    last_index=jnp.asarray(last))
    got, tc = tlm.prefill(toks[:, :s], max_len=max_len, last_index=last)
    assert _rel(got, want) <= TOL
    for li, cache in enumerate(tc):
        want_c = _jax_cache(cfg, jc, li)
        assert set(cache) == set(want_c)
        assert set(cache) == ({"k", "v"} if "k" in want_c
                              else {"state", "conv"})
        for name in cache:
            assert cache[name].shape == want_c[name].shape, (li, name)
            assert _rel(cache[name], want_c[name]) <= TOL, (li, name)

    jdec = jax.jit(jlm.decode_step)
    pos = np.asarray([s, s], np.int32)
    for step in range(3):
        tok = toks[:, s + step:s + step + 1]
        want, jc = jdec(params, jnp.asarray(tok), jc, jnp.asarray(pos))
        got, tc2 = tlm.decode_step(tok, tc, pos)
        assert tc2 is tc
        assert _rel(got, want) <= TOL, step
        pos = pos + 1
    for li, cache in enumerate(tc):
        for name, want_c in _jax_cache(cfg, jc, li).items():
            assert _rel(cache[name], want_c) <= TOL, (li, name)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_loss_and_grads_match_jax(arch):
    """``LM.loss`` (jamba's with the router losses) and its gradient in
    every parameter against ``jax.value_and_grad`` of the JAX
    ``LM.loss``, over two SSD chunks of the smoke chunk (S 64)."""
    jlm, params, tlm = _pair(arch)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, VOCAB, size=(2, 65)).astype(np.int32)
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
    # the port reports the router metrics of an MoE config only (the
    # reference's are zeros without one)
    assert set(metrics) == (set(jm) if jlm.cfg.moe else {"xent"})
    for name in metrics:
        assert _rel(metrics[name], jm[name]) <= MODEL_TOL or \
            abs(float(metrics[name]) - float(jm[name])) <= 1e-6, name
    assert _rel(loss, jloss) <= MODEL_TOL
    worst = {n: _rel(g, want[n]) for (n, _), g in zip(named, grads)}
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:3]
    assert max(worst.values()) <= MODEL_TOL, top


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_engine_tokens_match_jax(arch):
    """Greedy tokens through both engines: no buckets, every prompt
    prefilled at its exact length (odd and even, 3 tokens or more: the
    reference's engine cannot write a shorter conv tail) and counted in
    ``exact_prefills``; every cache of a mamba layer is ``{state,
    conv}``."""
    jlm, params, tlm = _pair(arch)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, VOCAB, size=n).astype(np.int32)
               for n in (3, 20, 37)]
    jeng = JEngine(jlm, params, batch=2, max_len=64)
    jreqs = [JRequest(uid=i, prompt=p, max_new_tokens=4)
             for i, p in enumerate(prompts)]
    jeng.run(jreqs)
    eng = Engine(tlm, batch=2, max_len=64, device="cpu", graphs=False)
    assert eng.buckets == tuple(jeng.buckets) == ()
    assert eng.bucket_for(20) is None
    kinds = {frozenset(c) for c in eng.caches}
    assert frozenset({"state", "conv"}) in kinds
    assert kinds <= {frozenset({"state", "conv"}), frozenset({"k", "v"})}
    reqs = [Request(uid=i, prompt=p, max_new_tokens=4)
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    for j, t in zip(jreqs, reqs):
        assert t.done and len(t.output) == 4
        assert t.output == j.output, t.uid
        assert t.bucket is None and j.bucket is None
    assert eng.stats()["admission"]["exact_prefills"] == len(prompts) == \
        jeng.stats()["admission"]["exact_prefills"]


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("n", [1, 2])
def test_decode_after_a_short_prompt_equals_forward(arch, n):
    """A 1- or 2-token prompt prefilled, then decode steps: the logits
    equal ``forward`` over the whole sequence (the conv tail is padded
    with the conv's own zeros).  One row: ``forward``'s MoE capacity (8
    slots an expert) then holds all of its 6 tokens, so no assignment
    drops there or in decode."""
    _, _, tlm = _pair(arch)
    toks = _tokens((1, n + 4), 8)
    full = tlm.forward(toks)
    logits, caches = tlm.prefill(toks[:, :n], max_len=16)
    got = [logits]
    pos = np.full(1, n, np.int64)
    for t in range(n, n + 3):
        step, caches = tlm.decode_step(toks[:, t:t + 1], caches, pos)
        got.append(step)
        pos = pos + 1
    assert _rel(torch.stack(got, dim=1), full[:, n - 1:n + 3]) <= TOL


def test_bf16_gap_at_mamba2_depth_is_the_dtype_s():
    """At mamba2-130m's depth (24 SSD layers, the smoke widths, random
    init) fp32 decode equals forward, and the port's forward the JAX
    package's, within the slice budget; in bf16 the two packages'
    forwards on the same weights and tokens depart by more than the bf16
    budget: the depth amplifies one-ulp differences of the roundings, so
    a bf16 decode-vs-forward gap at that depth is the dtype's, not the
    port's (``chip_smoke.py`` holds bf16 layer by layer)."""
    n = 60
    toks = _tokens((1, n + 2), 9)
    gaps = {}
    for dtype in ("float32", "bfloat16"):
        pair = []
        for port, conf in ((False, jconfigs), (True, tconfigs)):
            cfg = conf.smoke("mamba2_130m")
            pair.append(dataclasses.replace(
                cfg, dtype=dtype, groups=((cfg.groups[0][0], 24),)))
        jlm = JLM(pair[0])
        params = jlm.init(jax.random.PRNGKey(0))
        tlm = TLM(pair[1], device="cpu").load_jax_params(
            jax.tree.map(np.asarray, params))
        jf, _ = jax.jit(jlm.forward)(params, jnp.asarray(toks))
        tf = tlm.forward(toks).float()
        logits, caches = tlm.prefill(toks[:, :n], max_len=n + 2)
        got = [logits]
        for i in range(2):
            step, caches = tlm.decode_step(toks[:, n + i:n + i + 1], caches,
                                           np.asarray([n + i]))
            got.append(step)
        gaps[dtype] = dict(
            port=_rel(torch.stack(got, dim=1), tf[:, n - 1:]),
            port_vs_jax=_rel(tf, jf))
    print(f"gaps at 24 layers: {gaps}")
    assert gaps["float32"]["port"] <= TOL
    assert gaps["float32"]["port_vs_jax"] <= TOL
    assert gaps["bfloat16"]["port_vs_jax"] > 6e-2


# ---------------------------------------------------------------------------
# jamba's attention layers: GQA without rope
# ---------------------------------------------------------------------------

def test_jamba_attention_without_rope_matches_jax():
    """The attention module of jamba's smoke config (``use_rope=False``,
    GQA 4 / 2): prefill (output and the K/V caches) and decode steps at
    per-row positions, against ``gqa_prefill`` / ``gqa_decode``."""
    jcfg = _cfg(False, "jamba_v0_1_52b")
    tcfg = _cfg(True, "jamba_v0_1_52b")
    assert not jcfg.use_rope and not tcfg.use_rope
    tree = jax.tree.map(np.asarray, jattn.gqa_init(
        jax.random.PRNGKey(4), jcfg, dtype=jnp.float32))
    gqa = tattn.GQA(tcfg, dtype=torch.float32, device="cpu")
    _copy_into(dict(gqa.named_parameters()), _flatten(tree), "GQA")
    params = jax.tree.map(jnp.asarray, tree)
    max_len, s = 20, 11
    x = _np((2, s, jcfg.d_model), 9, 0.5)
    pos = np.arange(s)[None, :]
    want, jc = jattn.gqa_prefill(params, jcfg, jnp.asarray(x),
                                 positions=jnp.asarray(pos), max_len=max_len)
    got, tc = gqa.prefill(torch.as_tensor(x), torch.as_tensor(pos),
                          max_len=max_len)
    assert _rel(got, want) <= TOL
    for name in ("k", "v"):
        assert _rel(tc[name], jc[name]) <= TOL, name
    positions = np.asarray([s, 6])
    for step in range(2):
        xt = _np((2, 1, jcfg.d_model), 30 + step, 0.5)
        want, jc = jattn.gqa_decode(params, jcfg, jnp.asarray(xt), jc,
                                    positions=jnp.asarray(positions))
        got, _ = gqa.decode(torch.as_tensor(xt), tc,
                            torch.as_tensor(positions))
        assert _rel(got, want) <= TOL, step
        positions = positions + 1
