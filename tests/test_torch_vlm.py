"""internvl2-1b, the VLM, against the JAX package on the CPU: the config
copies, the parameter map, ``LM.forward`` / ``LM.loss`` / gradients with
the vision frontend's patch rows prepended, ``prefill(frontend=)`` and
``decode_step`` at frontend-offset positions, two train steps on a batch
that carries ``frontend``, and the serving engine on text alone (tokens
equal the reference engine's, which takes no frontend either).

The smoke config (2 layers, d 128, GQA 4/2 of 32, 8 patch rows) in fp32,
its weights from the JAX ``LM.init`` with the q/k/v biases set to seeded
non-zero values (``gqa_init`` makes them zeros), every input from numpy
with a seed.  Budgets, rel-max over the reference's max magnitude: 2e-4
for logits (``TOL``), ``GRAD_TOLS["float32"]`` (1e-4) for the loss, its
gradients and the train step (``MODEL_TOL``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import GRAD_TOLS  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.models.model import LM as TLM  # noqa: E402
from repro_torch.serve import Engine, Request  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.train.program import TrainProgram  # noqa: E402

ARCH, NAME = "internvl2_1b", "internvl2-1b"
TOL = 2e-4
MODEL_TOL = GRAD_TOLS["float32"]
VOCAB = 512
F = 8               # the smoke config's frontend_len: patch rows per row


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else x, np.float32)


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-6)


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, VOCAB, size=shape).astype(
        np.int32)


def _patches(b, seed, f=F, d=128):
    return np.random.default_rng(seed).standard_normal(
        (b, f, d)).astype(np.float32)


_PAIR = {}


def _pair():
    """``(jlm, params, tlm)``: the JAX LM's fp32 smoke init with seeded
    q/k/v biases and the port's LM holding the same weights."""
    if not _PAIR:
        jcfg = dataclasses.replace(jconfigs.smoke(ARCH), dtype="float32")
        tcfg = dataclasses.replace(tconfigs.smoke(ARCH), dtype="float32")
        jlm = JLM(jcfg)
        tree = jax.tree.map(np.asarray, jlm.init(jax.random.PRNGKey(0)))
        rng = np.random.default_rng(7)
        for pos in tree["stack"][0]:
            for name in ("wq", "wk", "wv"):
                b = pos["attn"][name]["b"]
                pos["attn"][name]["b"] = rng.standard_normal(
                    b.shape).astype(np.float32) * 0.5
        params = jax.tree.map(jnp.asarray, tree)
        tlm = TLM(tcfg, device="cpu").load_jax_params(tree)
        _PAIR["pair"] = (jlm, params, tlm)
    return _PAIR["pair"]


def test_config_copy_matches_reference():
    for name in (ARCH, NAME):
        assert dataclasses.asdict(tconfigs.get(name)) == \
            dataclasses.asdict(jconfigs.get(ARCH))
        assert dataclasses.asdict(tconfigs.smoke(name)) == \
            dataclasses.asdict(jconfigs.smoke(ARCH))
    cfg = tconfigs.get(ARCH)
    assert (cfg.frontend, cfg.frontend_len, cfg.qkv_bias) == \
        ("vision", 256, True)
    assert cfg.param_count() == jconfigs.get(ARCH).param_count()


def test_load_jax_params_carries_every_leaf():
    jlm, params, tlm = _pair()
    n_jax = sum(int(np.asarray(x).size) for x in jax.tree.leaves(params))
    assert n_jax == sum(p.numel() for p in tlm.parameters())
    assert tlm.encoder is None and tlm.lm_head is None
    want = np.asarray(params["stack"][0][0]["attn"]["wk"]["b"][1])
    assert np.abs(want).max() > 0.1
    assert np.array_equal(tlm.layers[1].attn.wk.b.numpy(), want)


def test_forward_matches_jax():
    jlm, params, tlm = _pair()
    toks = _tokens((2, 12), 1)
    patches = _patches(2, 2)
    want, _ = jax.jit(jlm.forward)(params, jnp.asarray(toks),
                                   frontend=jnp.asarray(patches))
    got = tlm.forward(toks, frontend=patches)
    assert got.shape == (2, 12, VOCAB)
    assert _rel(got, want) <= TOL
    # the patch rows matter; without them the model is the text model
    assert _rel(tlm.forward(toks), want) > 100 * TOL
    text, _ = jax.jit(jlm.forward)(params, jnp.asarray(toks))
    assert _rel(tlm.forward(toks), text) <= TOL


def test_loss_and_grads_match_jax():
    """``LM.loss`` with the frontend and its gradient in every parameter
    against ``jax.value_and_grad`` of the JAX ``LM.loss`` (the targets
    cover the text positions only)."""
    jlm, params, tlm = _pair()
    toks = _tokens((2, 13), 3)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:].copy(),
             "frontend": _patches(2, 4)}
    batch["targets"][0, -3:] = -1
    jb = jax.tree.map(jnp.asarray, batch)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss(p, jb), has_aux=True))(params)
    want = tlm.jax_leaves(jax.tree.map(np.asarray, jgrads))
    tlm.requires_grad_(True)
    try:
        loss, _ = tlm.loss(batch["tokens"], batch["targets"],
                           frontend=batch["frontend"])
        named = list(tlm.named_parameters())
        grads = torch.autograd.grad(loss, [p for _, p in named])
    finally:
        tlm.requires_grad_(False)
    assert _rel(loss, jloss) <= MODEL_TOL
    worst = {n: _rel(g, want[n]) for (n, _), g in zip(named, grads)}
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:3]
    assert max(worst.values()) <= MODEL_TOL, top


def test_prefill_and_decode_match_jax():
    """``prefill(frontend=)`` of right-padded prompts (``last_index`` and
    ``max_len`` count the F patch rows), then three ``decode_step``s at
    positions offset by F, against the JAX LM."""
    jlm, params, tlm = _pair()
    max_len = F + 24
    toks = _tokens((2, 20), 5)
    patches = _patches(2, 6)
    lengths = np.asarray([9, 13], np.int32)
    padded = toks[:, :16].copy()
    padded[0, 9:] = 0
    padded[1, 13:] = 0
    last = F + lengths - 1
    jpre = jax.jit(jlm.prefill, static_argnames=("max_len",))
    want, jc = jpre(params, jnp.asarray(padded), max_len=max_len,
                    frontend=jnp.asarray(patches),
                    last_index=jnp.asarray(last))
    got, tc = tlm.prefill(padded, max_len=max_len, frontend=patches,
                          last_index=last)
    assert _rel(got, want) <= TOL
    for li, cache in enumerate(tc):
        for name in ("k", "v"):
            assert _rel(cache[name], np.asarray(jc[0][0][name][li])) <= TOL
    jdec = jax.jit(jlm.decode_step)
    pos = F + lengths
    for step in range(3):
        tok = toks[:, 14 + step:15 + step]
        want, jc = jdec(params, jnp.asarray(tok), jc, jnp.asarray(pos))
        got, tc = tlm.decode_step(tok, tc, pos)
        assert _rel(got, want) <= TOL, step
        pos = pos + 1


def test_decode_consistent_with_forward():
    _, _, tlm = _pair()
    toks = _tokens((1, 10), 7)
    patches = _patches(1, 8)
    full = tlm.forward(toks, frontend=patches)
    logits, caches = tlm.prefill(toks[:, :7], max_len=F + 16,
                                 frontend=patches)
    assert _rel(logits, full[:, 6]) <= TOL
    for pos in (7, 8, 9):
        logits, caches = tlm.decode_step(toks[:, pos:pos + 1], caches,
                                         np.asarray([F + pos]))
        assert _rel(logits, full[:, pos]) <= TOL


def test_prefill_counts_the_frontend_against_max_len():
    _, _, tlm = _pair()
    tlm.prefill(_tokens((1, 8), 1), max_len=F + 8, frontend=_patches(1, 1))
    with pytest.raises(ValueError, match=f"{F + 9} positions"):
        tlm.prefill(_tokens((1, 9), 1), max_len=F + 8,
                    frontend=_patches(1, 1))


def test_train_steps_match_jax():
    """Two AdamW steps on batches that carry ``frontend``, through the
    port's ``TrainProgram`` (its float buffer), against the reference's
    ``make_train_step``: loss, grad norm, then every fp32 master."""
    jlm, params, tlm0 = _pair()
    hp = jstep.TrainHParams(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    state = jstep.TrainState(jnp.zeros((), jnp.int32), params,
                             jstep.adamw_init(params), None)
    tlm = TLM(tlm0.cfg, device="cpu")
    tstate = tlm.load_jax_train_state(jax.tree.map(np.asarray, state))
    jfn = jax.jit(jstep.make_train_step(jlm, hp))
    prog = TrainProgram(tlm, tstate, tstep.TrainHParams(**hp._asdict()),
                        batch=4, seq=16, floats={"frontend": (4, F, 128)})
    pipe = TokenPipeline(VOCAB, 4, 16)
    for step in range(2):
        batch = dict(pipe.get_batch(step), frontend=_patches(4, 50 + step))
        state, jm = jfn(state, jax.tree.map(jnp.asarray, batch))
        prog.load(batch)
        tm = prog()
        for key in ("loss", "grad_norm", "xent"):
            assert _rel(tm[key], jm[key]) <= MODEL_TOL, (step, key)
    want = tlm.jax_leaves(jax.tree.map(np.asarray, state.opt.master))
    worst = {n: _rel(t, want[n]) for n, t in prog.state.opt.master.items()}
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:3]
    assert max(worst.values()) <= MODEL_TOL, top


def test_engine_serves_text_as_the_reference_does():
    """Greedy tokens through both engines on the reference's bucket
    ladder: text only, as the reference's engine serves a VLM (it takes
    no frontend)."""
    jlm, params, tlm = _pair()
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, VOCAB, size=n).astype(np.int32)
               for n in (20, 45, 70)]
    jeng = JEngine(jlm, params, batch=2, max_len=96)
    jreqs = [JRequest(uid=i, prompt=p, max_new_tokens=4)
             for i, p in enumerate(prompts)]
    jeng.run(jreqs)
    eng = Engine(tlm, batch=2, max_len=96, device="cpu",
                 buckets=jeng.buckets)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=4)
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    for j, t in zip(jreqs, reqs):
        assert t.done and t.output == j.output, t.uid
