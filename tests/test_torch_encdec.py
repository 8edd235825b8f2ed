"""seamless-m4t-medium, the encoder-decoder, against the JAX package on
the CPU: the config copies, the parameter map (``encoder.*``,
``enc_norm``, ``cross.*``, ``norm_x``), the bidirectional GQA of the
encoder, cross attention at prefill (S x T) and at decode (1 x T),
``LM.forward`` / ``LM.loss`` / their gradients with ``enc_frames``,
``init_cache(memory_len=)``, ``prefill`` + ``decode_step``, two train
steps, ``TrainProgram``'s float entries, and the serving engine's
refusal of a cross stack.

The smoke config (2 encoder + 2 decoder layers, d 128, 4 heads of 32,
16 frames) in fp32, its weights from the JAX ``LM.init`` and every
input from numpy with a seed.  Budgets, rel-max over the reference's
max magnitude: 2e-4 for logits and attention (``TOL``, the slice budget
of ``tests/test_torch_model.py``), ``GRAD_TOLS["float32"]`` (1e-4) for
the loss, its gradients and the train step (``MODEL_TOL``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import GRAD_TOLS  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.model import LM as TLM  # noqa: E402
from repro_torch.serve import Engine  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.train.program import TrainProgram  # noqa: E402

ARCH, NAME = "seamless_m4t_medium", "seamless-m4t-medium"
TOL = 2e-4
MODEL_TOL = GRAD_TOLS["float32"]
VOCAB = 512
T = 16              # the smoke config's frontend_len: frames per row


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


def _frames(b, seed, t=T, d=128):
    return np.random.default_rng(seed).standard_normal(
        (b, t, d)).astype(np.float32)


_PAIR = {}


def _pair():
    """``(jlm, params, tlm)``: the JAX LM's fp32 smoke init and the port's
    LM holding the same weights; built once per process."""
    if not _PAIR:
        jcfg = dataclasses.replace(jconfigs.smoke(ARCH), dtype="float32")
        tcfg = dataclasses.replace(tconfigs.smoke(ARCH), dtype="float32")
        jlm = JLM(jcfg)
        params = jlm.init(jax.random.PRNGKey(0))
        tlm = TLM(tcfg, device="cpu").load_jax_params(
            jax.tree.map(np.asarray, params))
        _PAIR["pair"] = (jlm, params, tlm)
    return _PAIR["pair"]


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------

def test_config_copy_matches_reference():
    for name in (ARCH, NAME):
        assert dataclasses.asdict(tconfigs.get(name)) == \
            dataclasses.asdict(jconfigs.get(ARCH))
        assert dataclasses.asdict(tconfigs.smoke(name)) == \
            dataclasses.asdict(jconfigs.smoke(ARCH))
    cfg = tconfigs.get(ARCH)
    assert (cfg.encoder_layers, cfg.frontend_len, cfg.d_model) == \
        (12, 1024, 1024)
    assert cfg.param_count() == jconfigs.get(ARCH).param_count()


def test_registry_covers_every_reference_architecture():
    assert sorted(tconfigs.ARCH_IDS) == sorted(jconfigs.ARCH_IDS)
    assert tconfigs.ALIASES == jconfigs.ALIASES
    for arch in tconfigs.ARCH_IDS:
        assert dataclasses.asdict(tconfigs.smoke(arch)) == \
            dataclasses.asdict(jconfigs.smoke(arch)), arch


def test_load_jax_params_carries_every_leaf():
    jlm, params, tlm = _pair()
    n_jax = sum(int(np.asarray(x).size) for x in jax.tree.leaves(params))
    assert n_jax == sum(p.numel() for p in tlm.parameters())
    names = dict(tlm.named_parameters())
    assert len(tlm.encoder) == 2 and len(tlm.layers) == 2
    for i in range(2):
        for leaf in ("cross.wq.w", "cross.wk.w", "cross.wv.w", "cross.wo.w",
                     "norm_x.scale"):
            assert f"layers.{i}.{leaf}" in names
            assert f"encoder.{i}.{leaf}" not in names
        assert f"encoder.{i}.attn.wq.w" in names
    assert "enc_norm.scale" in names
    # no biases on the cross projections
    assert not any(n.startswith("layers.0.cross") and n.endswith(".b")
                   for n in names)
    want = np.asarray(params["encoder"][0][0]["ffn"]["up"]["w"][1])
    assert np.array_equal(tlm.encoder[1].ffn.up.w.numpy(), want)
    want = np.asarray(params["stack"][0][0]["cross"]["wk"]["w"][1])
    assert np.array_equal(tlm.layers[1].cross.wk.w.numpy(), want)


def test_only_long_attention_is_refused():
    """Nothing is refused any more: the port has no ``_UNSUPPORTED``
    table, and ``long_attention="block_sparse"`` (read nowhere in the
    reference) runs seamless as ``"full"`` does, and as the JAX LM."""
    from repro_torch.models import model as tmodel
    assert not hasattr(tmodel, "_UNSUPPORTED")
    jlm, params, tlm = _pair()
    cfg = dataclasses.replace(tlm.cfg, long_attention="block_sparse")
    blm = TLM(cfg, device="cpu").load_jax_params(
        jax.tree.map(np.asarray, params))
    toks = _tokens((2, 8), 41)
    frames = _frames(2, 42)
    jcfg = dataclasses.replace(jlm.cfg, long_attention="block_sparse")
    want, _ = jax.jit(JLM(jcfg).forward)(params, jnp.asarray(toks),
                                         enc_frames=jnp.asarray(frames))
    got = blm.forward(toks, enc_frames=frames)
    assert _rel(got, want) <= TOL
    assert _rel(got, tlm.forward(toks, enc_frames=frames)) <= TOL


# ---------------------------------------------------------------------------
# the attention pieces
# ---------------------------------------------------------------------------

# (S, Skv): the encoder's T x T, tiles that halve to odd lengths, an S
# that is not a multiple of the tile, and decode's single row
@pytest.mark.parametrize("s,skv", [(64, 64), (96, 160), (37, 128), (1, 96),
                                   (300, 256)])
@pytest.mark.parametrize("kv", [4, 2], ids=["mha", "gqa"])
def test_attend_train_non_causal_matches_jax(s, skv, kv):
    """``attend_train(causal=False)`` (the kernel's plain version here)
    against the JAX one at S != Skv, on the reference's tile halving from
    tiles of 64."""
    rng = np.random.default_rng(s * 7 + skv + kv)
    q = rng.standard_normal((2, s, 4, 32)).astype(np.float32)
    k, v = (rng.standard_normal((2, skv, kv, 32)).astype(np.float32)
            for _ in range(2))
    want = jattn.attend_train(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=False, tile_q=64, tile_kv=64)
    got = tattn.attend_train(torch.as_tensor(q), torch.as_tensor(k),
                             torch.as_tensor(v), causal=False, tile_q=64,
                             tile_kv=64)
    assert _rel(got, want) <= 1e-4


def test_encoder_gqa_is_bidirectional_and_matches_jax():
    """An encoder layer's GQA against ``gqa_train(causal=False)`` on its
    own weights: RoPE at positions 0..T-1 and no causal mask (the first
    row sees the last key)."""
    jlm, params, tlm = _pair()
    x = _frames(2, 3)
    pos = np.arange(T)[None, :]
    p = jax.tree.map(lambda a: a[0], params["encoder"][0][0]["attn"])
    ecfg = jlm._encoder_cfg()
    want = jattn.gqa_train(p, ecfg, jnp.asarray(x), positions=jnp.asarray(pos),
                           causal=False)
    gqa = tlm.encoder[0].attn
    got = gqa(torch.as_tensor(x), torch.as_tensor(pos))
    assert _rel(got, want) <= TOL
    # the same weights in a causal GQA see only the keys before each row
    causal_gqa = tattn.GQA(gqa.cfg, dtype=torch.float32, device="cpu")
    causal_gqa.load_state_dict(gqa.state_dict())
    causal = causal_gqa(torch.as_tensor(x), torch.as_tensor(pos))
    assert _rel(causal, want) > 100 * TOL
    assert not gqa.causal and tlm.layers[0].attn.causal


@pytest.mark.parametrize("s", [11, 1], ids=["prefill", "decode"])
def test_cross_attention_matches_jax(s):
    """``CrossAttention`` against ``cross_kv`` + ``cross_apply`` on layer
    1's weights: S queries (prefill) or one (decode) over T memory rows."""
    jlm, params, tlm = _pair()
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, 128)).astype(np.float32)
    memory = _frames(2, 4)
    p = jax.tree.map(lambda a: a[1], params["stack"][0][0]["cross"])
    jk, jv = jattn.cross_kv(p, jlm.cfg, jnp.asarray(memory))
    want = jattn.cross_apply(p, jlm.cfg, jnp.asarray(x), jk, jv)
    cross = tlm.layers[1].cross
    k, v = cross.kv(torch.as_tensor(memory))
    assert k.shape == (2, T, 4, 32)
    assert _rel(k, jk) <= TOL and _rel(v, jv) <= TOL
    got = cross(torch.as_tensor(x), k, v)
    assert got.shape == (2, s, 128)
    assert _rel(got, want) <= TOL


# ---------------------------------------------------------------------------
# the LM
# ---------------------------------------------------------------------------

def test_forward_matches_jax():
    jlm, params, tlm = _pair()
    toks = _tokens((2, 12), 1)
    frames = _frames(2, 5)
    want, _ = jax.jit(jlm.forward)(params, jnp.asarray(toks),
                                   enc_frames=jnp.asarray(frames))
    got = tlm.forward(toks, enc_frames=frames)
    assert got.shape == (2, 12, VOCAB)
    assert _rel(got, want) <= TOL
    # the memory matters: other frames give other logits
    other = tlm.forward(toks, enc_frames=_frames(2, 6))
    assert _rel(other, want) > 100 * TOL


def test_a_cross_stack_needs_frames_and_a_decoder_only_takes_none():
    _, _, tlm = _pair()
    with pytest.raises(ValueError, match="enc_frames"):
        tlm.forward(_tokens((1, 4), 1))
    llama = TLM(dataclasses.replace(tconfigs.smoke("llama3_2_1b"),
                                    dtype="float32"), device="cpu")
    with pytest.raises(ValueError, match="no encoder"):
        llama.forward(_tokens((1, 4), 1), enc_frames=_frames(1, 1))


def test_frames_are_cast_to_the_model_dtype():
    """The port casts ``enc_frames`` to the model's dtype before the
    encoder (the reference feeds them uncast): fp32 frames into a bf16
    model give exactly what frames rounded to bf16 first give, and in
    fp32 the cast is the identity (``test_forward_matches_jax``)."""
    cfg = tconfigs.smoke(ARCH)
    assert cfg.dtype == "bfloat16"
    lm = TLM(cfg, device="cpu", seed=3)
    toks = _tokens((2, 6), 2)
    frames = _frames(2, 7)
    got = lm.forward(toks, enc_frames=frames)
    rounded = torch.as_tensor(frames).to(torch.bfloat16)
    assert torch.equal(got, lm.forward(toks, enc_frames=rounded))
    assert torch.isfinite(got.float()).all()


def test_loss_and_grads_match_jax():
    """``LM.loss`` with ``enc_frames`` and its gradient in every
    parameter, the encoder's, ``enc_norm``, ``cross.*`` and ``norm_x``
    among them, against ``jax.value_and_grad`` of the JAX ``LM.loss``."""
    jlm, params, tlm = _pair()
    toks = _tokens((2, 13), 7)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:].copy(),
             "enc_frames": _frames(2, 8)}
    batch["targets"][1, -2:] = -1
    jb = jax.tree.map(jnp.asarray, batch)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss(p, jb), has_aux=True))(params)
    want = tlm.jax_leaves(jax.tree.map(np.asarray, jgrads))
    tlm.requires_grad_(True)
    try:
        loss, metrics = tlm.loss(batch["tokens"], batch["targets"],
                                 enc_frames=batch["enc_frames"])
        named = list(tlm.named_parameters())
        grads = torch.autograd.grad(loss, [p for _, p in named])
    finally:
        tlm.requires_grad_(False)
    assert _rel(loss, jloss) <= MODEL_TOL
    assert _rel(metrics["xent"], jm["xent"]) <= MODEL_TOL
    worst = {n: _rel(g, want[n]) for (n, _), g in zip(named, grads)}
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:3]
    assert max(worst.values()) <= MODEL_TOL, top
    for leaf in ("encoder.0.attn.wq.w", "encoder.1.ffn.down.w",
                 "enc_norm.scale", "layers.0.cross.wk.w",
                 "layers.1.cross.wo.w", "layers.1.norm_x.scale"):
        assert np.abs(want[leaf]).max() > 0, leaf


def test_init_cache_holds_the_memory():
    _, _, tlm = _pair()
    caches = tlm.init_cache(3, 20, memory_len=T)
    assert len(caches) == 2
    for c in caches:
        assert set(c) == {"k", "v", "xk", "xv"}
        assert c["k"].shape == (3, 20, 4, 32)
        assert c["xk"].shape == c["xv"].shape == (3, T, 4, 32)
        assert c["xk"].dtype == torch.float32
    assert tlm.init_cache(1, 8)[0]["xk"].shape == (1, 0, 4, 32)
    llama = TLM(tconfigs.smoke("llama3_2_1b"), device="cpu")
    assert set(llama.init_cache(1, 8, memory_len=T)[0]) == {"k", "v"}


def test_prefill_and_decode_match_jax():
    """``prefill(S - 1, enc_frames=)`` on right-padded prompts, then
    three ``decode_step``s, each step's logits and the caches (the
    memory's K/V ``xk`` / ``xv`` among them) against the JAX LM's."""
    jlm, params, tlm = _pair()
    max_len = 24
    toks = _tokens((2, 20), 2)
    frames = _frames(2, 9)
    lengths = np.asarray([9, 13], np.int32)
    padded = toks[:, :16].copy()
    padded[0, 9:] = 0
    padded[1, 13:] = 0
    jpre = jax.jit(jlm.prefill, static_argnames=("max_len",))
    want, jc = jpre(params, jnp.asarray(padded), max_len=max_len,
                    enc_frames=jnp.asarray(frames),
                    last_index=jnp.asarray(lengths - 1))
    got, tc = tlm.prefill(padded, max_len=max_len, enc_frames=frames,
                          last_index=lengths - 1)
    assert _rel(got, want) <= TOL
    for li, cache in enumerate(tc):
        assert set(cache) == {"k", "v", "xk", "xv"}
        for name in ("k", "v", "xk", "xv"):
            assert _rel(cache[name], np.asarray(jc[0][0][name][li])) <= TOL
    jdec = jax.jit(jlm.decode_step)
    pos = lengths.copy()
    for step in range(3):
        tok = toks[:, 14 + step:15 + step]
        want, jc = jdec(params, jnp.asarray(tok), jc, jnp.asarray(pos))
        got, tc = tlm.decode_step(tok, tc, pos)
        assert _rel(got, want) <= TOL, step
        pos = pos + 1


def test_decode_consistent_with_forward():
    _, _, tlm = _pair()
    toks = _tokens((2, 10), 3)
    frames = _frames(2, 10)
    full = tlm.forward(toks, enc_frames=frames)
    logits, caches = tlm.prefill(toks[:, :7], max_len=16, enc_frames=frames)
    assert _rel(logits, full[:, 6]) <= TOL
    for pos in (7, 8, 9):
        logits, caches = tlm.decode_step(toks[:, pos:pos + 1], caches,
                                         np.asarray([pos, pos]))
        assert _rel(logits, full[:, pos]) <= TOL


def test_prefill_counts_the_prompt_against_max_len():
    _, _, tlm = _pair()
    with pytest.raises(ValueError, match="exceeds"):
        tlm.prefill(_tokens((1, 9), 1), max_len=8, enc_frames=_frames(1, 1))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _batch(step, b=4, s=16):
    batch = TokenPipeline(VOCAB, b, s).get_batch(step)
    return dict(batch, enc_frames=_frames(b, 100 + step))


@pytest.mark.parametrize("accum", [1, 2])
def test_train_steps_match_jax(accum):
    """Two AdamW steps on batches that carry ``enc_frames`` (split into
    microbatches with the tokens under ``accum``): loss, grad norm, lr,
    then every fp32 master weight against the reference's
    ``make_train_step``."""
    jlm, params, _ = _pair()
    hp = jstep.TrainHParams(peak_lr=1e-3, warmup_steps=1, total_steps=10,
                            accum=accum)
    state = jstep.TrainState(jnp.zeros((), jnp.int32), params,
                             jstep.adamw_init(params), None)
    tlm = TLM(dataclasses.replace(tconfigs.smoke(ARCH), dtype="float32"),
              device="cpu")
    tstate = tlm.load_jax_train_state(jax.tree.map(np.asarray, state))
    assert "encoder.0.attn.wq.w" in tstate.opt.master
    jfn = jax.jit(jstep.make_train_step(jlm, hp))
    tfn = tstep.make_train_step(tlm, tstep.TrainHParams(**hp._asdict()))
    for step in range(2):
        batch = _batch(step)
        state, jm = jfn(state, jax.tree.map(jnp.asarray, batch))
        tstate, tm = tfn(tstate, batch)
        assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-7)
        for key in ("loss", "grad_norm", "xent"):
            assert _rel(tm[key], jm[key]) <= MODEL_TOL, (step, key)
    want = tlm.jax_leaves(jax.tree.map(np.asarray, state.opt.master))
    worst = {n: _rel(t, want[n]) for n, t in tstate.opt.master.items()}
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:3]
    assert max(worst.values()) <= MODEL_TOL, top


def test_train_program_takes_the_float_entries():
    """``TrainProgram`` with ``floats={"enc_frames": ...}`` on the CPU:
    the frames land in its float buffer in the model's dtype and two
    steps equal ``make_train_step`` on the same batches to the bit; a
    batch without the entry, or with another shape, is refused, and a
    program without float entries refuses a batch that has one."""
    cfg = dataclasses.replace(tconfigs.smoke(ARCH), dtype="float32")
    hp = tstep.TrainHParams(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    runs = []
    for use_program in (True, False):
        lm = TLM(cfg, device="cpu", seed=4)
        state = tstep.init_train_state(lm, hp=hp)
        losses = []
        if use_program:
            prog = TrainProgram(lm, state, hp, batch=4, seq=16,
                                floats={"enc_frames": (4, T, 128)})
            assert prog.program.fio.shape == (4 * T * 128,)
            assert prog.program.fio.dtype == torch.float32
            for step in range(2):
                prog.load(_batch(step))
                assert torch.equal(prog.program.fio.view(4, T, 128),
                                   torch.as_tensor(_batch(step)
                                                   ["enc_frames"]))
                losses.append(float(prog()["loss"]))
            state = prog.state
        else:
            fn = tstep.make_train_step(lm, hp)
            for step in range(2):
                state, m = fn(state, _batch(step))
                losses.append(float(m["loss"]))
        runs.append((losses, {n: p.detach().clone()
                              for n, p in state.params.items()}))
    assert runs[0][0] == runs[1][0]
    for n, p in runs[0][1].items():
        assert torch.equal(p, runs[1][1][n]), n
    tokens_only = TokenPipeline(VOCAB, 4, 16).get_batch(0)
    with pytest.raises(ValueError, match="enc_frames"):
        prog.load(tokens_only)
    with pytest.raises(ValueError, match="shape"):
        prog.load(dict(tokens_only, enc_frames=_frames(4, 1, t=8)))
    lm = TLM(cfg, device="cpu")
    plain = TrainProgram(lm, tstep.init_train_state(lm, hp=hp), hp,
                         batch=4, seq=16)
    assert plain.program.fio is None
    with pytest.raises(ValueError, match="enc_frames"):
        plain.load(_batch(0))
    with pytest.raises(ValueError, match="first axis"):
        TrainProgram(lm, plain.state, hp, batch=4, seq=16,
                     floats={"enc_frames": (2, T, 128)})


def test_train_loop_feeds_the_float_inputs():
    """``launch.train.train_loop(float_inputs=)`` trains the smoke
    encoder-decoder on the CPU on seeded frames: finite losses, and the
    same losses as a second run (the frames are the step's own)."""
    from repro_torch.launch.train import train_loop
    cfg = dataclasses.replace(tconfigs.smoke(ARCH), dtype="float32")
    hp = tstep.TrainHParams(peak_lr=1e-3, warmup_steps=1, total_steps=3)

    def frames(step):
        return {"enc_frames": _frames(2, 200 + step)}

    runs = [train_loop(cfg, steps=3, batch_per_shard=2, seq=8,
                       ckpt_dir=None, hp=hp, device="cpu", log_every=99,
                       float_inputs=frames)[1] for _ in range(2)]
    assert runs[0] == runs[1] and all(np.isfinite(runs[0]))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_engine_refuses_a_cross_stack():
    """The serving engine takes no frames, so it refuses a stack with
    cross layers when it is built (the reference's engine fails later,
    in ``cross_kv(None)``); seamless is served through ``prefill`` and
    ``decode_step``."""
    _, _, tlm = _pair()
    with pytest.raises(NotImplementedError, match="enc_frames"):
        Engine(tlm, batch=2, max_len=32, device="cpu")
