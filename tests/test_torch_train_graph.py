"""The captured train step's pieces against the JAX package, on the CPU:
the schedule on a device step, AdamW with a device count and rate, three
``make_train_step`` steps from a JAX state (llama3.2-1b's smoke config
with a sparse FFN, and qwen3-moe's), the device counters through
``load_jax_train_state`` and a checkpoint, and ``TrainProgram``'s body
(``train/program.py``) against ``train_loop(graphs=False)``.  The
capture itself needs a card (``tests/test_torch_cuda.py``); here the
program runs eagerly, and a second step must read nothing back to the
host.

Inputs come from numpy with a seed and go to both packages.  Budgets:
the schedule 2 fp32 ulps of ``peak_lr`` (XLA's and torch's fp32 cosines
may round apart: up to 5 ulps of the rate itself late in the decay, where
``1 + cos`` cancels); AdamW's fp32 master and moments rel-max 1e-6 and
its bf16 parameters one bf16 ulp (2^-8, the master rounded once); the
train step rel-max 1e-4 (``MODEL_TOL`` of ``tests/test_torch_train.py``)
on loss, grad norm and the fp32 master weights.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim.schedule import warmup_cosine as jwarmup  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import sparse as tsparse  # noqa: E402
from repro_torch.checkpoint import restore, save  # noqa: E402
from repro_torch.data import TokenPipeline as TPipe  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.models.model import LM as TLM  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim.schedule import warmup_cosine as twarmup  # noqa: E402
from repro_torch.serve import graphs as tgraphs  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.train.program import TrainProgram  # noqa: E402

MODEL_TOL = 1e-4
ADAM_TOL = 1e-6
LR_ULPS = 2.4e-7          # 2 fp32 ulps of 1, times peak_lr
SCHEDULES = {
    "smoke": dict(peak_lr=1e-3, warmup_steps=2, total_steps=10),
    "warm3": dict(peak_lr=1e-3, warmup_steps=3, total_steps=30),
    "nowarm": dict(peak_lr=3e-4, warmup_steps=0, total_steps=10,
                   final_frac=0.0),
    "warm_past_total": dict(peak_lr=2e-3, warmup_steps=30, total_steps=20),
}
HP = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)


def _rel(got, want):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / max(
        float(np.abs(want).max()), 1e-6)


# -- the schedule on a device step -------------------------------------------

@pytest.mark.parametrize("name,step", [
    (name, s) for name, kw in SCHEDULES.items()
    for s in range(kw["total_steps"] + 3)])
def test_warmup_cosine_on_a_tensor_step_matches_jax(name, step):
    kw = SCHEDULES[name]
    want = float(jwarmup(jnp.int32(step), **kw))
    s = torch.tensor(step, dtype=torch.int32)
    got = twarmup(s, **kw)
    assert isinstance(got, torch.Tensor)
    assert got.dim() == 0 and got.dtype == torch.float32
    assert got.device == s.device
    assert abs(float(got) - want) <= LR_ULPS * kw["peak_lr"], (float(got),
                                                                want)
    assert twarmup(step, **kw) == float(got)      # an int takes one path


# -- AdamW with a device count and rate ---------------------------------------

def test_adamw_device_count_and_lr_match_jax():
    """Three clipped AdamW steps on bf16 parameters with an fp32 master:
    the count is one tensor, advanced in place; the rate is a device
    tensor from the schedule."""
    rng = np.random.default_rng(0)
    shapes = {"a": (5, 3), "b": (7,), "c": (2, 4, 4)}
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in init.items()}
    js = jadamw.adamw_init(jp)
    tp = {k: torch.as_tensor(v).to(torch.bfloat16) for k, v in init.items()}
    ts = tadamw.adamw_init(tp)
    count = ts.count
    assert count.dtype == torch.int32 and count.dim() == 0
    assert int(count) == 0
    kw = SCHEDULES["smoke"]
    for i in range(3):
        g = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
        jg, _ = jadamw.clip_by_global_norm(
            {k: jnp.asarray(v, jnp.bfloat16) for k, v in g.items()}, 1.0)
        tg, _ = tadamw.clip_by_global_norm(
            {k: torch.as_tensor(v).to(torch.bfloat16) for k, v in g.items()},
            1.0)
        jlr = jwarmup(jnp.int32(i + 1), **kw)
        tlr = twarmup(torch.tensor(i + 1, dtype=torch.int32), **kw)
        jp, js = jadamw.adamw_update(jg, js, jp, lr=jlr)
        out, ts2 = tadamw.adamw_update(tg, ts, tp, lr=tlr)
        assert out is tp and ts2 is ts and ts.count is count
    assert int(count) == int(js.count) == 3
    for k in shapes:
        for got, want in ((ts.master[k], js.master[k]), (ts.mu[k], js.mu[k]),
                          (ts.nu[k], js.nu[k])):
            assert _rel(got, want) <= ADAM_TOL, k
        assert tp[k].dtype == torch.bfloat16
        assert torch.equal(tp[k], ts.master[k].to(torch.bfloat16)), k
        assert _rel(tp[k], np.asarray(jp[k], np.float32)) <= 2 ** -8, k


def test_adamw_takes_an_int_count():
    """A count given as an int (a state built by hand) becomes a device
    tensor at the first update, and the update is the same."""
    p1 = {"w": torch.ones(4)}
    p2 = {"w": torch.ones(4)}
    s1 = tadamw.adamw_init(p1)
    s2 = tadamw.AdamState(0, {"w": torch.ones(4)}, {"w": torch.zeros(4)},
                          {"w": torch.zeros(4)})
    assert isinstance(s2.count, torch.Tensor)
    s2.count = 0
    g = {"w": torch.full((4,), 0.5)}
    tadamw.adamw_update(g, s1, p1, lr=1e-2)
    tadamw.adamw_update(g, s2, p2, lr=torch.tensor(1e-2))
    assert isinstance(s2.count, torch.Tensor) and int(s2.count) == 1
    assert torch.equal(p1["w"], p2["w"])


# -- three train steps from a JAX state ---------------------------------------

def _llama_cfgs():
    tcfg = dataclasses.replace(
        tconfigs.sparsify_ffn(tconfigs.smoke("llama3_2_1b"), 0.25),
        dtype="float32")
    jcfg = jconfigs.smoke("llama3_2_1b")
    groups = tuple((tuple(dataclasses.replace(s, ffn="sparse")
                          for s in period), rep)
                   for period, rep in jcfg.groups)
    jcfg = dataclasses.replace(jcfg, groups=groups, ffn_density=0.25,
                               dtype="float32")
    return jcfg, tcfg


def _qwen3_cfgs():
    return (dataclasses.replace(jconfigs.smoke("qwen3_moe_30b_a3b"),
                                dtype="float32"),
            dataclasses.replace(tconfigs.smoke("qwen3-moe-30b-a3b"),
                                dtype="float32"))


CFGS = {"llama-sparse": _llama_cfgs, "qwen3": _qwen3_cfgs}


def _prewarm(jcfg, params, n):
    """Build the JAX sparse FFN's plans outside any trace (see
    ``tests/test_torch_train.py`` ``prewarm_jax_sparse_plans``), after
    dropping the reference's in-memory plans: one an earlier test of the
    same process built inside a trace would be the cache hit."""
    from repro import sparse as jsparse
    from repro.models import transformer as jtfm
    jsparse.reset()
    if jcfg.moe is not None:
        return
    ffn = jtfm._sparse_ffn(jcfg)
    layer0 = jax.tree.map(lambda a: a[0], params["stack"][0][0]["ffn"])
    ffn.apply(layer0, jnp.zeros((n, jcfg.d_model), jnp.float32))


@pytest.mark.parametrize("arch", sorted(CFGS))
def test_three_train_steps_match_jax(arch):
    """``make_train_step`` against the JAX step under ``jax.jit`` for
    three steps from one state: step, count and rate are device tensors
    equal to the reference's (the same step and count tensors
    throughout); loss and grad norm each step, and the fp32 master
    weights after, within ``MODEL_TOL``."""
    jcfg, tcfg = CFGS[arch]()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    hp = jstep.TrainHParams(**HP)
    jlm = JLM(jcfg)
    state = jstep.init_train_state(jlm, jax.random.PRNGKey(0), hp=hp)
    pipe = TPipe(tcfg.vocab_size, 4, 16)
    _prewarm(jcfg, state.params, 4 * 16)
    tlm = TLM(tcfg, device="cpu")
    tstate = tlm.load_jax_train_state(jax.tree.map(np.asarray, state))
    step_t, count_t = tstate.step, tstate.opt.count
    jfn = jax.jit(jstep.make_train_step(jlm, hp))
    tfn = tstep.make_train_step(tlm, tstep.TrainHParams(**HP))
    for i in range(3):
        batch = pipe.get_batch(i)
        state, jm = jfn(state, jax.tree.map(jnp.asarray, batch))
        tstate, tm = tfn(tstate, batch)
        assert tstate.step is step_t and tstate.opt.count is count_t
        for t in (step_t, count_t):
            assert t.dtype == torch.int32 and t.dim() == 0
        assert int(step_t) == int(state.step) == i + 1
        assert int(count_t) == int(state.opt.count) == i + 1
        for key in tm:
            assert isinstance(tm[key], torch.Tensor), key
        assert tm["lr"].dtype == torch.float32 and tm["lr"].dim() == 0
        assert abs(float(tm["lr"]) - float(jm["lr"])) <= \
            LR_ULPS * HP["peak_lr"], i
        for key in ("loss", "grad_norm", "xent"):
            assert _rel(tm[key], jm[key]) <= MODEL_TOL, (i, key)
    want = tlm.jax_leaves(jax.tree.map(np.asarray, state.opt.master))
    worst = max(_rel(tstate.opt.master[n], want[n])
                for n in tstate.opt.master)
    assert worst <= MODEL_TOL


# -- the counters through load_jax_train_state and a checkpoint ---------------

def test_load_jax_train_state_counters_on_device():
    """A JAX state at step 5 / count 5: the port's counters are 0-dim
    int32 tensors on the model's device holding 5."""
    jcfg, tcfg = _qwen3_cfgs()
    jlm = JLM(jcfg)
    state = jstep.init_train_state(jlm, jax.random.PRNGKey(2))
    state = state._replace(step=jnp.int32(5), opt=state.opt._replace(
        count=jnp.int32(5)))
    tlm = TLM(tcfg, device="cpu")
    ts = tlm.load_jax_train_state(jax.tree.map(np.asarray, state))
    for t in (ts.step, ts.opt.count):
        assert isinstance(t, torch.Tensor) and t.dim() == 0
        assert t.dtype == torch.int32 and t.device == tlm.device
        assert int(t) == 5


def test_checkpoint_round_trip_keeps_the_state_tensors(tmp_path):
    """A state after two steps, saved and restored into a state from
    another seed: the counters and every tensor equal, copied into the
    restored state's own tensors (a captured step reads them there); a
    checkpoint that stored the counters as ints restores too."""
    cfg = tconfigs.sparsify_ffn(tconfigs.smoke("llama3_2_1b"), 0.25)
    hp = tstep.TrainHParams(**HP)
    pipe = TPipe(cfg.vocab_size, 2, 16)
    lm = TLM(cfg, device="cpu", seed=0)
    st = tstep.init_train_state(lm, hp=hp)
    fn = tstep.make_train_step(lm, hp)
    for i in range(2):
        st, _ = fn(st, pipe.get_batch(i))
    save(str(tmp_path / "a"), tstep.state_tree(st), step=2, extra={})
    lm2 = TLM(cfg, device="cpu", seed=3)
    st2 = tstep.init_train_state(lm2, hp=hp)
    held = (st2.step, st2.opt.count, dict(st2.params),
            dict(st2.opt.master))
    tree, _, _ = restore(str(tmp_path / "a"), tstep.state_tree(st2))
    assert tstep.load_state_tree(st2, tree) is st2
    assert st2.step is held[0] and st2.opt.count is held[1]
    assert int(st2.step) == int(st2.opt.count) == 2
    assert all(st2.params[n] is t for n, t in held[2].items())
    assert all(st2.opt.master[n] is t for n, t in held[3].items())
    for a, b in ((st.params, st2.params), (st.opt.master, st2.opt.master),
                 (st.opt.mu, st2.opt.mu), (st.opt.nu, st2.opt.nu)):
        for n in a:
            assert torch.equal(a[n], b[n]), n
    _, m1 = fn(st, pipe.get_batch(2))
    _, m2 = tstep.make_train_step(lm2, hp)(st2, pipe.get_batch(2))
    assert float(m1["loss"]) == float(m2["loss"])
    # the counters stored as numbers, as a checkpoint of ints holds them
    tree = tstep.state_tree(st)
    tree["step"], tree["opt"]["count"] = 7, 7
    save(str(tmp_path / "b"), tree, step=7, extra={})
    got, _, _ = restore(str(tmp_path / "b"), tstep.state_tree(st2))
    tstep.load_state_tree(st2, got)
    assert int(st2.step) == int(st2.opt.count) == 7


# -- the program's body --------------------------------------------------------

def _smoke_cfg(arch):
    if arch == "qwen3":
        return tconfigs.smoke("qwen3-moe-30b-a3b")
    return tconfigs.sparsify_ffn(tconfigs.smoke("llama3_2_1b"), 0.25)


@pytest.mark.parametrize("arch", sorted(CFGS))
def test_program_body_equals_train_loop(arch):
    """Three steps of ``TrainProgram``'s body, each batch through
    ``load`` and the input buffer, equal ``train_loop(graphs=False)`` and
    ``make_train_step`` on the host batches, bit for bit: losses, every
    metric and the parameters after."""
    cfg = _smoke_cfg(arch)
    hp = tstep.TrainHParams(**HP)
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
    lm2 = TLM(cfg, device="cpu", seed=0)
    st2 = tstep.init_train_state(lm2, hp=hp)
    fn = tstep.make_train_step(lm2, hp)
    for i in range(3):
        batch = pipe.get_batch(i)
        prog.load(batch)
        n = 2 * 16
        assert np.array_equal(prog.program.io[:n].view(2, 16).numpy(),
                              batch["tokens"])
        assert np.array_equal(prog.program.io[n:].view(2, 16).numpy(),
                              batch["targets"])
        got = {k: float(v) for k, v in prog().items()}
        st2, m2 = fn(st2, batch)
        assert got == seen[i] == {k: float(v) for k, v in m2.items()}, i
        assert got["loss"] == losses[i]
    assert prog.program.stats()["captures"] == 0
    for n, p in state.params.items():
        assert torch.equal(prog.state.params[n], p), n
        assert torch.equal(st2.params[n], p), n
    assert int(prog.state.step) == int(state.step) == 3


@pytest.mark.parametrize("arch", sorted(CFGS))
def test_program_body_reads_nothing_on_the_host(arch, monkeypatch):
    """Once warmed (plans built), a step of the body runs to its end with
    every host read of a tensor's value refused: ``item``, ``tolist``,
    ``float``, ``int`` and ``bool``."""
    cfg = _smoke_cfg(arch)
    hp = tstep.TrainHParams(**HP)
    lm = TLM(cfg, device="cpu", seed=0)
    prog = TrainProgram(lm, tstep.init_train_state(lm, hp=hp), hp, batch=2,
                        seq=16, graph=False)
    pipe = TPipe(cfg.vocab_size, 2, 16)
    prog.load(pipe.get_batch(0))
    prog()
    prog.load(pipe.get_batch(1))
    reads = []

    def refuse(name):
        def read(self, *args, **kwargs):
            reads.append(name)
            raise RuntimeError(f"host read: Tensor.{name}")
        return read

    for name in ("item", "tolist", "__float__", "__int__", "__bool__"):
        monkeypatch.setattr(torch.Tensor, name, refuse(name))
    metrics = prog()
    monkeypatch.undo()
    assert reads == []
    assert int(prog.state.step) == 2 and np.isfinite(float(metrics["loss"]))


def test_program_runs_under_the_ambient_context():
    """A train program runs every step under the ``sparse.use_ctx``
    context that was ambient when it was made."""
    cfg = _smoke_cfg("llama-sparse")
    lm = TLM(cfg, device="cpu", seed=0)
    ctx = tsparse.PlanContext(mode="static")
    with tsparse.use_ctx(ctx):
        prog = TrainProgram(lm, tstep.init_train_state(lm), batch=2, seq=8,
                            graph=False)
    assert prog.program.ctx is ctx
    other = TrainProgram(lm, prog.state, batch=2, seq=8, graph=False)
    assert other.program.ctx is tsparse.current_ctx()


def test_graphs_on_the_cpu_raise():
    cfg = _smoke_cfg("llama-sparse")
    with pytest.raises(ValueError, match="card"):
        train_loop(cfg, steps=1, batch_per_shard=2, seq=8, ckpt_dir=None,
                   device="cpu", graphs=True)
    lm = TLM(cfg, device="cpu", seed=0)
    with pytest.raises(ValueError, match="card"):
        TrainProgram(lm, tstep.init_train_state(lm), batch=2, seq=8,
                     graph=True)


@pytest.mark.parametrize("updates_state", [False, True],
                         ids=["serving", "train"])
def test_program_runs_a_state_updating_body_once_per_call(monkeypatch,
                                                          updates_state):
    """``Program``'s calls with the capture faked on the CPU (a "graph"
    that replays by running the body): a serving program warms up, then
    replays on the call that captures; a state-updating one returns its
    warm-up's outputs there and replays only on later calls, so every
    call runs its body once."""
    runs = []

    class FakeGraph:
        def __init__(self, prog):
            self.prog = prog

        def replay(self):
            self.prog.outputs = self.prog.run_eager()

    def fake_capture(self):
        warm = self.run_eager()
        self.graph = FakeGraph(self)
        self.captures += 1
        return warm if self.updates_state else None

    monkeypatch.setattr(tgraphs.Program, "_capture", fake_capture)
    monkeypatch.setattr(tgraphs.Program, "capture",
                        lambda self: self._capture())

    def body(io):
        runs.append(int(io[0]))
        return {"seen": io.clone()}

    prog = tgraphs.Program("t", body, 1, device=torch.device("cpu"),
                           graph=True, ctx=tsparse.PlanContext(),
                           stream=object(), updates_state=updates_state)
    for i in range(3):
        prog.load(np.array([i]))
        out = prog()
        assert int(out["seen"][0]) == i
    assert runs == ([0, 1, 2] if updates_state else [0, 0, 1, 2])
    assert prog.captures == 1
