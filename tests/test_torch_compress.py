"""Error-feedback int8 gradient compression of the port against the JAX
package's ``optim/compress.py``, on the CPU.

Inputs come from numpy with a seed and go to both packages.  Budgets:
``compress_grads`` bit-equal in fp32 (both quantise with one division by
the same fp32 scale, round half to even and clip); the train step with
``grad_compress=True`` rel-max 1e-4 (``MODEL_TOL`` of
``tests/test_torch_train_loop.py``) on loss, grad norm and xent, and on
the fp32 master weights but for the int8 codes that sit on a rounding
boundary: fp32 summation noise flips those by one grid step, which moves
the residual by one step and the element's AdamW step by up to lr (at
most 0.01 % of the elements, each within 2 lr; at most 5 % of the
residuals past MODEL_TOL of a step, each within one step).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compress as jcompress  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.checkpoint import restore, save  # noqa: E402
from repro_torch.data import TokenPipeline as TPipe  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.models.model import LM as TLM  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import compress as tcompress  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.train.program import TrainProgram  # noqa: E402

from test_torch_train_loop import (JLM, JPipe, MODEL_TOL, _cfgs,  # noqa: E402
                                   _prewarm)

SHAPES = {"w": (33, 17), "b": (17,), "v": (4, 16, 16), "s": ()}


def _grads(rng, scale=1.0):
    return {n: (rng.standard_normal(s) * scale).astype(np.float32)
            for n, s in SHAPES.items()}


@pytest.mark.parametrize("scale", [1.0, 1e-30], ids=["unit", "tiny"])
def test_compress_grads_bit_equal_over_steps(scale):
    """Five steps on seeded gradients: the dequantised gradients and the
    residuals equal the JAX package's bit for bit (``tiny`` reaches the
    1e-12 floor of the scale)."""
    rng = np.random.default_rng(0)
    params = {n: np.zeros(s, np.float32) for n, s in SHAPES.items()}
    jef = jcompress.ef_init({n: jnp.asarray(v) for n, v in params.items()})
    tef = tcompress.ef_init({n: torch.as_tensor(v)
                             for n, v in params.items()})
    for n, r in tef.residual.items():
        assert r.dtype == torch.float32 and r.shape == SHAPES[n]
    for step in range(5):
        g = _grads(rng, scale)
        jd, jef = jcompress.compress_grads(
            {n: jnp.asarray(v) for n, v in g.items()}, jef)
        td, tef2 = tcompress.compress_grads(
            {n: torch.as_tensor(v) for n, v in g.items()}, tef)
        assert tef2 is tef
        for n in SHAPES:
            assert td[n].dtype == torch.float32
            assert np.array_equal(td[n].numpy(), np.asarray(jd[n])), \
                (step, n)
            assert np.array_equal(tef.residual[n].numpy(),
                                  np.asarray(jef.residual[n])), (step, n)


def test_quantize_matches_jax():
    x = np.random.default_rng(3).standard_normal(1000).astype(np.float32)
    jq, js = jcompress._quantize(jnp.asarray(x))
    tq, ts = tcompress._quantize(torch.as_tensor(x))
    assert tq.dtype == torch.int8 and int(tq.abs().max()) == 127
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    assert np.array_equal(tcompress._dequantize(tq, ts).numpy(),
                          np.asarray(jcompress._dequantize(jq, js)))


def test_wire_bytes_matches_jax():
    g = _grads(np.random.default_rng(1))
    want = jcompress.wire_bytes({n: jnp.asarray(v) for n, v in g.items()})
    got = tcompress.wire_bytes({n: torch.as_tensor(v) for n, v in g.items()})
    assert got == want
    one = tcompress.wire_bytes({"w": torch.zeros(1000)})
    assert one["fp32"] == 4000 and one["int8"] < one["fp32"] / 3.5


def test_error_feedback_converges_like_fp32():
    """The reference's least-squares case (``tests/test_optim.py``):
    int8 with error feedback tracks the uncompressed AdamW trajectory,
    and both the port's runs equal the JAX package's within 1e-5."""
    key = jax.random.PRNGKey(0)
    X = np.array(jax.random.normal(key, (64, 8)))
    w_true = np.arange(1.0, 9.0, dtype=np.float32)
    y = X @ w_true

    def run_jax(compressed):
        params = {"w": jnp.zeros((8,))}
        state = jadamw.adamw_init(params)
        ef = jcompress.ef_init(params)
        for _ in range(200):
            g = jax.grad(lambda p: ((jnp.asarray(X) @ p["w"]
                                     - jnp.asarray(y)) ** 2).mean())(params)
            if compressed:
                g, ef = jcompress.compress_grads(g, ef)
            params, state = jadamw.adamw_update(g, state, params, lr=0.05,
                                                weight_decay=0.0)
        return np.asarray(params["w"])

    def run_torch(compressed):
        w = torch.zeros(8, requires_grad=True)
        params = {"w": w}
        state = tadamw.adamw_init(params)
        ef = tcompress.ef_init(params)
        Xt, yt = torch.as_tensor(X), torch.as_tensor(y)
        for _ in range(200):
            (g,) = torch.autograd.grad(((Xt @ w - yt) ** 2).mean(), [w])
            grads = {"w": g}
            if compressed:
                grads, ef = tcompress.compress_grads(grads, ef)
            tadamw.adamw_update(grads, state, params, lr=0.05,
                                weight_decay=0.0)
        return w.detach().numpy()

    w_fp, w_q = run_torch(False), run_torch(True)
    np.testing.assert_allclose(w_q, w_true, atol=0.2)
    np.testing.assert_allclose(w_q, w_fp, atol=0.15)
    np.testing.assert_allclose(w_q, run_jax(True), rtol=0, atol=1e-5)
    np.testing.assert_allclose(w_fp, run_jax(False), rtol=0, atol=1e-5)


# -- the train step --------------------------------------------------------

def _jax_and_port_states(hp):
    jcfg, tcfg = _cfgs()
    jlm = JLM(jcfg)
    state = jstep.init_train_state(jlm, jax.random.PRNGKey(0), hp=hp)
    _prewarm(jcfg, state.params, 4 * 16 // hp.accum)
    tlm = TLM(tcfg, device="cpu")
    tstate = tlm.load_jax_train_state(jax.tree.map(np.asarray, state))
    return jlm, state, tlm, tstate


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_with_compression_matches_jax(accum):
    """Two steps of ``make_train_step`` with ``grad_compress=True`` from
    the same JAX state: loss, grad norm and xent, then the fp32 master
    weights and the residuals of every parameter (one scale per leaf of
    the reference's tree: ``LM.leaf_groups``)."""
    hp = jstep.TrainHParams(peak_lr=1e-3, warmup_steps=1, total_steps=10,
                            accum=accum, grad_compress=True)
    jlm, state, tlm, tstate = _jax_and_port_states(hp)
    assert tstate.ef is not None
    assert set(tstate.ef.residual) == set(tstate.params)
    jfn = jax.jit(jstep.make_train_step(jlm, hp))
    tfn = tstep.make_train_step(tlm, tstep.TrainHParams(**hp._asdict()))
    pipe = JPipe(tlm.cfg.vocab_size, 4, 16)
    for step in range(2):
        batch = pipe.get_batch(step)
        state, jm = jfn(state, jax.tree.map(jnp.asarray, batch))
        tstate, tm = tfn(tstate, batch)
        for key in ("loss", "grad_norm", "xent"):
            assert abs(float(tm[key]) - float(jm[key])) <= \
                MODEL_TOL * abs(float(jm[key])), (step, key)
    master = tlm.jax_leaves(jax.tree.map(np.asarray, state.opt.master))
    resid = tlm.jax_leaves(jax.tree.map(np.asarray, state.ef.residual))
    total = flipped = off = 0
    for n in master:
        # an int8 code whose x / scale sits on a rounding boundary flips
        # under fp32 summation noise: its residual then differs by one
        # grid step (twice the largest residual), its AdamW step by up
        # to lr; every other element agrees within MODEL_TOL
        d_m = np.abs(tstate.opt.master[n].numpy() - master[n])
        s_m = max(float(np.abs(master[n]).max()), 1e-6)
        d_r = np.abs(tstate.ef.residual[n].numpy() - resid[n])
        step_r = 2 * float(np.abs(resid[n]).max())
        assert float(d_m.max()) <= 2 * hp.peak_lr, n
        assert float(d_r.max()) <= 1.01 * step_r + 1e-30, n
        total += d_m.size
        flipped += int((d_m > MODEL_TOL * s_m).sum())
        off += int((d_r > MODEL_TOL * step_r).sum())
    assert flipped <= 1e-4 * total, (flipped, total)
    assert off <= 0.05 * total, (off, total)


@pytest.mark.parametrize("arch", ["llama3_2_1b", "seamless-m4t-medium"])
def test_leaf_groups_are_the_reference_leaves(arch):
    """``LM.leaf_groups`` has one group per leaf of the JAX parameter
    tree, of the same element count (the layers a stacked leaf holds)."""
    from repro import configs as jconfigs
    from repro_torch import configs as tconfigs
    jlm = JLM(jconfigs.smoke(arch))
    leaves = jax.tree.leaves(jax.eval_shape(jlm.init,
                                            jax.random.PRNGKey(0)))
    tlm = TLM(tconfigs.smoke(arch), device="cpu")
    groups = tlm.leaf_groups()
    sizes = dict(tlm.named_parameters())
    assert sorted(n for g in groups for n in g) == sorted(sizes)
    assert sorted(sum(sizes[n].numel() for n in g) for g in groups) == \
        sorted(int(np.prod(leaf.shape)) for leaf in leaves)


def test_compression_residuals_survive_a_checkpoint(tmp_path):
    """``state_tree`` carries the residuals; ``load_state_tree`` copies
    them back in place, and a state without them refuses a checkpoint
    that has them."""
    _, tcfg = _cfgs()
    hp = tstep.TrainHParams(peak_lr=1e-3, warmup_steps=1, total_steps=10,
                            grad_compress=True)
    lm = TLM(tcfg, device="cpu", seed=2)
    st = tstep.init_train_state(lm, hp=hp)
    fn = tstep.make_train_step(lm, hp)
    batch = TPipe(tcfg.vocab_size, 2, 16).get_batch(0)
    st, _ = fn(st, batch)
    assert any(float(r.abs().max()) > 0 for r in st.ef.residual.values())
    save(str(tmp_path), tstep.state_tree(st), step=1, extra={})

    lm2 = TLM(tcfg, device="cpu", seed=3)
    st2 = tstep.init_train_state(lm2, hp=hp)
    held = dict(st2.ef.residual)
    got, _, _ = restore(str(tmp_path), tstep.state_tree(st2))
    tstep.load_state_tree(st2, got)
    for n, r in st.ef.residual.items():
        assert st2.ef.residual[n] is held[n]
        assert torch.equal(st2.ef.residual[n], r), n
    # the next step from the restored state equals the original's
    batch = TPipe(tcfg.vocab_size, 2, 16).get_batch(1)
    st, m1 = fn(st, batch)
    st2, m2 = tstep.make_train_step(lm2, hp)(st2, batch)
    assert float(m1["loss"]) == float(m2["loss"])
    for n in st.ef.residual:
        assert torch.equal(st.ef.residual[n], st2.ef.residual[n]), n

    plain = tstep.init_train_state(TLM(tcfg, device="cpu", seed=3))
    with pytest.raises(ValueError, match="compression"):
        tstep.load_state_tree(plain, got)


def test_program_body_with_compression_equals_train_loop():
    """Three steps of ``TrainProgram``'s body with ``grad_compress``
    equal ``train_loop(graphs=False)`` bit for bit (losses, metrics,
    parameters and residuals), and the residuals are the state's own
    tensors, updated in place."""
    _, cfg = _cfgs()
    hp = tstep.TrainHParams(peak_lr=1e-3, warmup_steps=1, total_steps=10,
                            grad_compress=True)
    seen = []
    state, losses = train_loop(
        cfg, steps=3, batch_per_shard=2, seq=16, ckpt_dir=None, hp=hp,
        device="cpu", graphs=False, log_every=100,
        on_step=lambda s, m, p: seen.append(
            {k: float(v) for k, v in m.items() if k != "step_s"}))
    pipe = TPipe(cfg.vocab_size, 2, 16)
    lm = TLM(cfg, device="cpu", seed=0)
    prog = TrainProgram(lm, tstep.init_train_state(lm, hp=hp), hp, batch=2,
                        seq=16, graph=False)
    held = dict(prog.state.ef.residual)
    for i in range(3):
        prog.load(pipe.get_batch(i))
        got = {k: float(v) for k, v in prog().items()}
        assert got == seen[i], i
        assert got["loss"] == losses[i]
    for n, r in state.ef.residual.items():
        assert prog.state.ef.residual[n] is held[n]
        assert torch.equal(prog.state.ef.residual[n], r), n
    for n, p in state.params.items():
        assert torch.equal(prog.state.params[n], p), n


def test_first_residual_is_the_quantisation_error():
    """The state holds residuals exactly with ``grad_compress``, and a
    first step's residual is the quantisation error of the gradient,
    at most half a step of the int8 grid."""
    _, cfg = _cfgs()
    batch = TPipe(cfg.vocab_size, 2, 16).get_batch(0)
    for flag in (False, True):
        hp = tstep.TrainHParams(peak_lr=1e-3, warmup_steps=1,
                                total_steps=10, grad_compress=flag)
        lm = TLM(cfg, device="cpu", seed=4)
        st = tstep.init_train_state(lm, hp=hp)
        assert (st.ef is None) != flag
        _, _, grads = tstep.microbatch_grads(
            tstep.lm_grad_fn(lm), st.params, batch, 1)
        if flag:
            deq, ef = tcompress.compress_grads(
                grads, tcompress.ef_init(st.params))
            for n, g in grads.items():
                assert torch.equal(ef.residual[n], g.float() - deq[n]), n
                assert float((g.float() - deq[n]).abs().max()) <= \
                    float(g.abs().max()) / 254 * (1 + 1e-6), n
