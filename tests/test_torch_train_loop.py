"""The port's training loop against the JAX package, on the CPU: AdamW,
the schedule, the token pipeline, one ``make_train_step`` step, and
checkpoint save / resume.

Inputs come from numpy with a seed and go to both packages.  The train
step runs llama3.2-1b's smoke config with every FFN sparse (d = 1/4,
b = 16) in fp32; its budget is rel-max 1e-4 (``MODEL_TOL``) on loss,
grad norm and the fp32 master weights -- the gradients' fp32
summation-order noise, carried through one clipped AdamW update.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data import TokenPipeline as JPipe  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim.schedule import warmup_cosine as jwarmup  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import (Checkpointer, latest_step,  # noqa: E402
                                    restore, save)
from repro_torch.data import TokenPipeline as TPipe  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.models.model import LM as TLM  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim.schedule import warmup_cosine as twarmup  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

MODEL_TOL = 1e-4


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / max(
        float(np.abs(want).max()), 1e-6)


# -- schedule, pipeline, optimizer --------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(peak_lr=1e-3, warmup_steps=3, total_steps=30),
    dict(peak_lr=3e-4, warmup_steps=0, total_steps=10, final_frac=0.0),
    dict(peak_lr=2e-3, warmup_steps=100, total_steps=50),
], ids=["warm3", "nowarm", "warm_past_total"])
def test_warmup_cosine_matches_jax(kw):
    for s in range(0, kw["total_steps"] + 5):
        want = float(jwarmup(s, **kw))
        got = twarmup(s, **kw)
        assert isinstance(got, float)
        # 2 fp32 ulps of peak_lr: numpy's and XLA's fp32 cosines may
        # round one ulp apart (of 1 + cos, which is at most 2)
        assert abs(got - want) <= 2.4e-7 * kw["peak_lr"], (s, got, want)


@pytest.mark.parametrize("shards", [1, 3])
def test_token_pipeline_matches_jax(shards):
    for shard in range(shards):
        jp = JPipe(97, 2, 12, num_shards=shards, shard_id=shard, seed=5)
        tp = TPipe(97, 2, 12, num_shards=shards, shard_id=shard, seed=5)
        for step in (0, 1, 7):
            jb, tb = jp.get_batch(step), tp.get_batch(step)
            for k in ("tokens", "targets"):
                assert tb[k].dtype == jb[k].dtype
                assert np.array_equal(tb[k], jb[k]), (shard, step, k)
        assert tp.state(4) == jp.state(4)
        assert TPipe.resume_step(tp.state(4)) == 4


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((5, 3)).astype(np.float32),
            "b": rng.standard_normal((7,)).astype(np.float32)}


@pytest.mark.parametrize("clip", [100.0, 0.5], ids=["no_clip", "clipped"])
def test_adamw_steps_match_jax(clip):
    params, grads = _tree(0), [_tree(1), _tree(2), _tree(3)]
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jadamw.adamw_init(jp)
    tp = {k: torch.as_tensor(v.copy()) for k, v in params.items()}
    ts = tadamw.adamw_init(tp)
    assert ts.master["a"].data_ptr() != tp["a"].data_ptr()
    for i, g in enumerate(grads):
        lr = 1e-2 * (i + 1)
        jg, jn = jadamw.clip_by_global_norm(
            {k: jnp.asarray(v) for k, v in g.items()}, clip)
        jp, js = jadamw.adamw_update(jg, js, jp, lr=lr)
        tg, tn = tadamw.clip_by_global_norm(
            {k: torch.as_tensor(v) for k, v in g.items()}, clip)
        tp2, ts = tadamw.adamw_update(tg, ts, tp, lr=lr)
        assert tp2 is tp
        assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
    assert ts.count == int(js.count) == 3
    for k in params:
        for got, want in ((tp[k], jp[k]), (ts.master[k], js.master[k]),
                          (ts.mu[k], js.mu[k]), (ts.nu[k], js.nu[k])):
            assert _rel(got.numpy(), want) <= 1e-6, k


def test_adamw_writes_rounded_master_into_bf16_params():
    p = {"w": torch.full((4,), 1.0, dtype=torch.bfloat16)}
    st = tadamw.adamw_init(p)
    tadamw.adamw_update({"w": torch.ones(4, dtype=torch.bfloat16)}, st, p,
                        lr=1e-3, weight_decay=0.0)
    assert p["w"].dtype == torch.bfloat16
    assert torch.equal(p["w"], st.master["w"].to(torch.bfloat16))
    assert float(st.master["w"][0]) == pytest.approx(1.0 - 1e-3, rel=1e-5)


def test_global_norm_matches_jax():
    t = _tree(9)
    want = float(jadamw.global_norm({k: jnp.asarray(v) for k, v in
                                     t.items()}))
    got = float(tadamw.global_norm({k: torch.as_tensor(v) for k, v in
                                    t.items()}))
    assert abs(got - want) <= 1e-6 * want


# -- one train step against the JAX step ----------------------------------------------

def _cfgs():
    tcfg = dataclasses.replace(
        tconfigs.sparsify_ffn(tconfigs.smoke("llama3_2_1b"), 0.25),
        dtype="float32")
    jcfg = jconfigs.smoke("llama3_2_1b")
    groups = tuple((tuple(dataclasses.replace(s, ffn="sparse")
                          for s in period), rep)
                   for period, rep in jcfg.groups)
    jcfg = dataclasses.replace(jcfg, groups=groups, ffn_density=0.25,
                               dtype="float32")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _prewarm(jcfg, params, n):
    """Build the JAX sparse FFN's plans outside any trace (see
    ``tests/test_torch_train.py`` ``prewarm_jax_sparse_plans``), after
    dropping the reference's in-memory plans: one an earlier test of the
    same process built inside a trace would be the cache hit."""
    from repro import sparse as jsparse
    from repro.models import transformer as jtfm
    jsparse.reset()
    ffn = jtfm._sparse_ffn(jcfg)
    layer0 = jax.tree.map(lambda a: a[0], params["stack"][0][0]["ffn"])
    ffn.apply(layer0, jnp.zeros((n, jcfg.d_model), jnp.float32))


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(accum):
    jcfg, tcfg = _cfgs()
    hp = jstep.TrainHParams(peak_lr=1e-3, warmup_steps=1, total_steps=10,
                            accum=accum)
    thp = tstep.TrainHParams(**hp._asdict())
    jlm = JLM(jcfg)
    state = jstep.init_train_state(jlm, jax.random.PRNGKey(0), hp=hp)
    pipe = JPipe(jcfg.vocab_size, 4, 16)
    _prewarm(jcfg, state.params, 4 * 16 // accum)

    tlm = TLM(tcfg, device="cpu")
    tstate = tlm.load_jax_train_state(jax.tree.map(np.asarray, state))
    assert tstate.step == 0 and tstate.opt.count == 0
    assert all(p.requires_grad for p in tlm.parameters())
    jfn = jax.jit(jstep.make_train_step(jlm, hp))
    tfn = tstep.make_train_step(tlm, thp)
    # two steps: lr is 0 at step 0 of the warmup, so the second moves
    # the weights
    for step in range(2):
        batch = pipe.get_batch(step)
        state, jm = jfn(state, jax.tree.map(jnp.asarray, batch))
        tstate, tm = tfn(tstate, batch)
        assert tstate.step == int(state.step) == step + 1
        assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-7)
        for key in ("loss", "grad_norm", "xent"):
            assert abs(float(tm[key]) - float(jm[key])) <= \
                MODEL_TOL * abs(float(jm[key])), (step, key)
    want = tlm.jax_leaves(jax.tree.map(np.asarray, state.opt.master))
    worst = {n: _rel(tstate.opt.master[n].numpy(), want[n])
             for n in tstate.opt.master}
    assert max(worst.values()) <= MODEL_TOL, sorted(
        worst.items(), key=lambda kv: -kv[1])[:3]
    for n, p in tlm.named_parameters():
        assert torch.equal(p.detach(), tstate.opt.master[n].to(p.dtype)), n


def test_grad_accumulation_matches_full_batch():
    tcfg = tconfigs.sparsify_ffn(tconfigs.smoke("llama3_2_1b"), 0.25)
    tcfg = dataclasses.replace(tcfg, dtype="float32")
    batch = TPipe(tcfg.vocab_size, 4, 8).get_batch(0)
    grads = {}
    for accum in (1, 4):
        lm = TLM(tcfg, device="cpu", seed=1)
        state = tstep.init_train_state(lm)
        loss, _, g = tstep.microbatch_grads(tstep.lm_grad_fn(lm),
                                            state.params, batch, accum)
        grads[accum] = (float(loss), g)
    assert grads[1][0] == pytest.approx(grads[4][0], rel=1e-5)
    for n, g in grads[1][1].items():
        assert grads[4][1][n].dtype == torch.float32
        assert _rel(grads[4][1][n].numpy(), g.numpy()) <= 1e-4, n


def test_grad_compress_not_ported():
    """``grad_compress=True`` trains (it was refused before the
    compression module was ported): the state starts with a zero fp32
    residual per parameter, as the reference's ``ef_init`` does, and a
    step leaves the residuals the quantisation lost, each at most half
    an int8 step of its leaf group."""
    _, tcfg = _cfgs()
    lm = TLM(tcfg, device="cpu")
    hp = tstep.TrainHParams(grad_compress=True)
    st = tstep.init_train_state(lm, hp=hp)
    assert set(st.ef.residual) == {n for n, _ in lm.named_parameters()}
    assert all(r.dtype == torch.float32 and not r.any()
               for r in st.ef.residual.values())
    assert tstep.init_train_state(lm).ef is None
    fn = tstep.make_train_step(lm, hp)
    st, m = fn(st, TPipe(tcfg.vocab_size, 2, 8).get_batch(0))
    assert np.isfinite(float(m["loss"])) and int(st.step) == 1
    assert any(r.any() for r in st.ef.residual.values())


# -- checkpoints and the loop ----------------------------------------------------------

def test_checkpoint_atomicity_and_gc(tmp_path):
    tree = {"a": torch.arange(8.0),
            "b": {"c": torch.ones((2, 3), dtype=torch.bfloat16)},
            "n": 7}
    p = str(tmp_path)
    for s in (1, 2, 3):
        save(p, tree, step=s, extra={"data": {"step": s}})
    assert latest_step(p) == 3
    got, extra, step = restore(p)
    assert torch.equal(got["a"], torch.arange(8.0))
    assert got["b"]["c"].dtype == torch.bfloat16
    assert got["n"] == 7 and extra["data"]["step"] == 3 and step == 3
    like = {"a": torch.zeros(8, dtype=torch.float64),
            "b": {"c": torch.zeros((2, 3))}, "n": 0}
    got, _, _ = restore(p, like, step=2)
    assert got["a"].dtype == torch.float64 and got["n"] == 7
    with pytest.raises(ValueError, match="shape"):
        restore(p, {"a": torch.zeros(3), "b": {"c": torch.zeros((2, 3))},
                    "n": 0})
    # a stale .tmp directory is ignored
    os.makedirs(os.path.join(p, "step_9.tmp"))
    assert latest_step(p) == 3
    ck = Checkpointer(p, keep=2)
    ck.save_async(tree, step=4, extra={})
    ck.wait()
    assert sorted(d for d in os.listdir(p) if not d.endswith(".tmp")) == \
        ["step_3", "step_4"]
    assert latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path / "none"))


def test_resume_is_exact(tmp_path):
    """Train 10; train 6, stop, resume to 10: identical final loss."""
    cfg = tconfigs.smoke("llama3_2_1b")
    hp = tstep.TrainHParams(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    kw = dict(batch_per_shard=2, seq=16, hp=hp, log_every=100,
              ckpt_every=3, device="cpu")
    _, l_straight = train_loop(cfg, steps=10, ckpt_dir=None, **kw)
    d = str(tmp_path / "ck")
    _, l_first = train_loop(cfg, steps=6, ckpt_dir=d, **kw)
    assert latest_step(d) == 6
    seen = []
    _, l_resumed = train_loop(cfg, steps=10, ckpt_dir=d,
                              on_step=lambda s, m, p: seen.append(s), **kw)
    assert seen == [6, 7, 8, 9]
    assert l_first == l_straight[:6]
    assert l_resumed[-1] == l_straight[-1]


def test_train_main_sparse_smoke_on_cpu(capsys):
    losses = train_main(["--smoke", "--density", "0.25", "--device", "cpu",
                         "--steps", "3", "--batch", "2", "--seq", "16",
                         "--log-every", "1"])
    assert len(losses) == 3 and all(np.isfinite(losses))
    out = capsys.readouterr().out
    assert "[train] step 2" in out and "done" in out


def test_sigterm_writes_a_final_checkpoint(tmp_path):
    """The SIGTERM handler stops the loop after the current step with a
    checkpoint of it; a rerun resumes from there."""
    import signal
    cfg = tconfigs.smoke("llama3_2_1b")
    d = str(tmp_path / "ck")
    kw = dict(batch_per_shard=2, seq=8, log_every=100, ckpt_every=100,
              device="cpu", ckpt_dir=d)

    def preempt(step, metrics, program):
        if step == 2:
            handler = signal.getsignal(signal.SIGTERM)
            assert callable(handler), "train_loop installs a handler"
            handler(signal.SIGTERM, None)

    _, losses = train_loop(cfg, steps=8, on_step=preempt, **kw)
    assert len(losses) == 3 and latest_step(d) == 3
    assert not callable(signal.getsignal(signal.SIGTERM)) or \
        signal.getsignal(signal.SIGTERM).__name__ != "on_sigterm"
    _, rest = train_loop(cfg, steps=5, **kw)
    assert len(rest) == 2 and latest_step(d) == 5


def test_async_save_failure_surfaces_on_wait(tmp_path):
    """A save that fails on the writer thread raises at the next wait(),
    and leaves no checkpoint behind."""
    ck = Checkpointer(str(tmp_path))
    ck.save_async({"ok": torch.ones(2), "bad": (i for i in range(3))},
                  step=1)
    with pytest.raises(TypeError):
        ck.wait()
    assert latest_step(str(tmp_path)) is None
    ck.wait()                                   # the error is reported once
