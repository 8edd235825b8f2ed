"""MoE training against the JAX package, on the CPU: gradients through
``moe_apply``'s routing, ``LM.loss`` with the router losses,
``make_train_step`` from a JAX training state, ``batched_matmul``'s
backward, a MoE training state's checkpoint and the launcher.

qwen3-moe-30b-a3b's smoke config (two layers, d 128, 8 experts top-2)
in fp32, its weights from the JAX ``LM.init`` and every input from numpy
with a seed; the JAX side differentiates with ``jax.grad``.  Budgets,
rel-max over the reference's max magnitude: ``moe_apply`` 2e-4 (``TOL``,
``tests/test_torch_moe.py``), the LM's loss, metrics and gradients and
the train step 1e-4 (``MODEL_TOL``, ``tests/test_torch_train.py``).
Capacity drops are set by the config on both sides: the default
capacity factor 1.25 drops about half of the assignments of the alike
hidden states below, a factor of 4 gives every expert room for every
token.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import sparse as jsparse  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import sparse as tsparse  # noqa: E402
from repro_torch.checkpoint import restore, save  # noqa: E402
from repro_torch.data import TokenPipeline as TPipe  # noqa: E402
from repro_torch.kernels.gmm import ops as gmm_ops  # noqa: E402
from repro_torch.kernels.gmm.ref import gmm_ref  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.model import LM as TLM  # noqa: E402
from repro_torch.models.model import _flatten  # noqa: E402
from repro_torch.sparse.plan import (  # noqa: E402
    MatmulPlan, _grad_report, batched_row_tile)
from repro_torch.train import step as tstep  # noqa: E402

TOL = 2e-4
MODEL_TOL = 1e-4
VOCAB = 512
# the config variants: default (drops), room for every assignment (no
# drops), and two shared experts with a z-loss weight
VARIANTS = {"drops": {}, "no_drops": dict(capacity_factor=4.0),
            "shared_z": dict(num_shared=2, d_ff_shared=32,
                             router_z_weight=1e-3)}


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else x, np.float32)


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-6)


def _smoke(port: bool, **moe_over):
    cfg = (tconfigs.smoke("qwen3-moe-30b-a3b") if port
           else jconfigs.smoke("qwen3_moe_30b_a3b"))
    cfg = dataclasses.replace(cfg, dtype="float32")
    if moe_over:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **moe_over))
    return cfg


_PAIRS = {}


def _pair(variant):
    """``(jcfg, jlm, params, tcfg, tlm)`` of one variant, the port's LM
    holding the JAX init's weights; built once per process."""
    if variant not in _PAIRS:
        over = VARIANTS[variant]
        jcfg, tcfg = _smoke(False, **over), _smoke(True, **over)
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        jlm = JLM(jcfg)
        params = jlm.init(jax.random.PRNGKey(1))
        tlm = TLM(tcfg, device="cpu").load_jax_params(
            jax.tree.map(np.asarray, params))
        _PAIRS[variant] = (jcfg, jlm, params, tcfg, tlm)
    return _PAIRS[variant]


def _batch(b, s, seed, pad=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, VOCAB, size=(b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:].copy()}
    if pad:
        batch["targets"][0, -pad:] = -1
    return batch


def _worst(got: dict, want: dict):
    assert set(got) == set(want)
    worst = {n: _rel(g, want[n]) for n, g in got.items()}
    return max(worst.values()), sorted(worst.items(),
                                       key=lambda kv: -kv[1])[:3]


# ---------------------------------------------------------------------------
# moe_apply: output, metrics and gradients through the routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_moe_apply_grads_match_jax(variant):
    """``sum(y * gy) + 0.3 aux + 0.05 z`` differentiated in x, the router
    and every expert (and shared) weight, on alike hidden states (a
    common row plus noise, as at random init, so the router crowds a few
    experts)."""
    jcfg, _, params, tcfg, tlm = _pair(variant)
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((1, 1, 128))
         + 0.3 * rng.standard_normal((2, 40, 128))).astype(np.float32)
    gy = rng.standard_normal((2, 40, 128)).astype(np.float32)
    lp = jax.tree.map(lambda a: a[0], params["stack"][0][0]["ffn"])

    def jf(p, xx):
        y, m = jmoe.moe_apply(p, jcfg, xx)
        return jnp.sum(y * gy) + 0.3 * m.aux_loss + 0.05 * m.z_loss, (y, m)

    (_, (jy, jm)), (jgp, jgx) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(lp, jnp.asarray(x))

    mod = tlm.layers[0].ffn
    mod.requires_grad_(True)
    try:
        tx = torch.as_tensor(x).requires_grad_(True)
        y, m = tmoe.moe_apply(mod, tcfg, tx)
        loss = (y * torch.as_tensor(gy)).sum() + 0.3 * m.aux_loss \
            + 0.05 * m.z_loss
        named = list(mod.named_parameters())
        gs = torch.autograd.grad(loss, [tx] + [p for _, p in named])
    finally:
        mod.requires_grad_(False)
    assert _rel(y, jy) <= TOL
    for name in ("aux_loss", "z_loss"):
        assert _rel(getattr(m, name), getattr(jm, name)) <= TOL, name
    assert float(m.dropped_frac) == float(jm.dropped_frac)
    assert (float(m.dropped_frac) > 0.2) == (variant != "no_drops")
    assert _rel(gs[0], jgx) <= TOL
    want = _flatten(jax.tree.map(np.asarray, jgp))
    worst, top = _worst({n: g for (n, _), g in zip(named, gs[1:])}, want)
    assert worst <= TOL, top
    assert ("shared.up.w" in want) == (variant == "shared_z")


def test_dropped_slots_get_exactly_zero_gradient():
    """An assignment over capacity and an empty slot (token 0 gathered at
    combine weight 0) add nothing to any gradient, as in the reference:
    a token whose every assignment dropped gets exactly zero gradient
    through ``y`` (its router probabilities reach only ``aux``), and an
    expert no token reached, whose slots all hold token 0, gets exactly
    zero weight gradients."""
    _, _, _, tcfg, tlm = _pair("drops")
    mod = tlm.layers[0].ffn
    rng = np.random.default_rng(4)
    x = torch.as_tensor((rng.standard_normal((1, 1, 128))
                         + 0.3 * rng.standard_normal((1, 80, 128))
                         ).astype(np.float32)).requires_grad_(True)
    xf = x.detach().reshape(80, 128)
    cap = tmoe._capacity(80, tcfg)
    tfs, w_slot, counts, *_ = tmoe._route_and_rank(
        xf, mod.router.w, tcfg, cap, ranking=tcfg.moe.ranking)
    kept = sorted(set(tfs[w_slot > 0].tolist()))
    dropped = sorted(set(range(80)) - set(kept))
    empty = [e for e in range(tcfg.moe.num_experts) if counts[e] == 0]
    assert dropped and empty, "the alike tokens must crowd a few experts"
    mod.requires_grad_(True)
    try:
        y, _ = tmoe.moe_apply(mod, tcfg, x)
        gx, *gw = torch.autograd.grad(
            y.sum(), [x, mod.w_gate, mod.w_up, mod.w_down])
    finally:
        mod.requires_grad_(False)
    assert torch.all(y[0, dropped] == 0) and torch.all(gx[0, dropped] == 0)
    assert float(gx[0, kept].abs().max()) > 0
    for g in gw:
        assert torch.all(g[empty] == 0)
        assert float(g.abs().max()) > 0


# ---------------------------------------------------------------------------
# LM.loss: value, metrics and every parameter's gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [1024, 4], ids=["one_chunk", "chunked"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_loss_and_param_grads_match_jax(variant, chunk):
    jcfg, jlm, params, tcfg, tlm = _pair(variant)
    batch = _batch(2, 16, 5, pad=3)
    jb = jax.tree.map(jnp.asarray, batch)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss(p, jb, loss_chunk=chunk), has_aux=True))(params)
    want = tlm.jax_leaves(jax.tree.map(np.asarray, jgrads))
    tlm.requires_grad_(True)
    try:
        loss, metrics = tlm.loss(batch["tokens"], batch["targets"],
                                 loss_chunk=chunk)
        named = list(tlm.named_parameters())
        grads = torch.autograd.grad(loss, [p for _, p in named])
    finally:
        tlm.requires_grad_(False)
    assert set(metrics) == {"aux_loss", "z_loss", "dropped_frac", "xent"}
    assert not any(v.requires_grad for v in metrics.values())
    assert _rel(loss, jloss) <= MODEL_TOL
    for name in ("aux_loss", "z_loss", "xent"):
        assert _rel(metrics[name], jm[name]) <= MODEL_TOL, name
    assert abs(float(metrics["dropped_frac"])
               - float(jm["dropped_frac"])) <= 1e-6
    # the loss is xent plus the weighted router terms, as the reference's
    m = tcfg.moe
    assert float(loss.detach()) == pytest.approx(
        float(metrics["xent"]) + m.router_aux_weight
        * float(metrics["aux_loss"]) + m.router_z_weight
        * float(metrics["z_loss"]), rel=1e-6)
    worst, top = _worst({n: g for (n, _), g in zip(named, grads)}, want)
    assert worst <= MODEL_TOL, top


def test_dense_loss_keeps_its_metrics():
    """A dense config's ``loss`` returns ``{"xent"}`` alone, its loss the
    cross entropy."""
    cfg = dataclasses.replace(tconfigs.smoke("llama3_2_1b"),
                              dtype="float32")
    lm = TLM(cfg, device="cpu")
    batch = _batch(1, 8, 2)
    loss, metrics = lm.loss(batch["tokens"], batch["targets"])
    assert set(metrics) == {"xent"}
    assert float(loss) == float(metrics["xent"])


# ---------------------------------------------------------------------------
# make_train_step from a JAX training state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant,accum", [("drops", 1), ("drops", 2),
                                           ("shared_z", 1)])
def test_train_step_matches_jax(variant, accum):
    """Two AdamW steps from the same state: loss, grad norm, lr and the
    microbatch-averaged MoE metrics, then every fp32 master weight (the
    fp32 router, the [E, D, F] expert stacks and the shared experts among
    them)."""
    jcfg, jlm, params, tcfg, _ = _pair(variant)
    hp = jstep.TrainHParams(peak_lr=1e-3, warmup_steps=1, total_steps=10,
                            accum=accum)
    thp = tstep.TrainHParams(**hp._asdict())
    state = jstep.TrainState(jnp.zeros((), jnp.int32), params,
                             jstep.adamw_init(params), None)
    tlm = TLM(tcfg, device="cpu")
    tstate = tlm.load_jax_train_state(jax.tree.map(np.asarray, state))
    router = "layers.0.ffn.router.w"
    assert tstate.params[router].dtype == torch.float32
    assert tstate.opt.master[router].data_ptr() != \
        tstate.params[router].data_ptr()
    assert tstate.opt.master["layers.1.ffn.w_gate"].shape == (8, 128, 64)
    jfn = jax.jit(jstep.make_train_step(jlm, hp))
    tfn = tstep.make_train_step(tlm, thp)
    pipe = TPipe(tcfg.vocab_size, 4, 16)
    for step in range(2):
        batch = pipe.get_batch(step)
        state, jm = jfn(state, jax.tree.map(jnp.asarray, batch))
        tstate, tm = tfn(tstate, batch)
        assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-7)
        for key in ("loss", "grad_norm", "xent", "aux_loss", "z_loss"):
            assert _rel(tm[key], jm[key]) <= MODEL_TOL, (step, key)
        assert abs(float(tm["dropped_frac"])
                   - float(jm["dropped_frac"])) <= 1e-6, step
    want = tlm.jax_leaves(jax.tree.map(np.asarray, state.opt.master))
    worst, top = _worst(dict(tstate.opt.master), want)
    assert worst <= MODEL_TOL, top
    for n, p in tlm.named_parameters():
        assert torch.equal(p.detach(), tstate.opt.master[n].to(p.dtype)), n


def test_adamw_groups_cover_every_leaf(monkeypatch):
    """``adamw_update`` over groups of a few elements at a time gives the
    same state as one group for all: the grouping bounds the fp32
    temporaries, not the arithmetic."""
    from repro_torch.optim import adamw as tadamw
    _, _, _, tcfg, _ = _pair("drops")
    out = {}
    for limit in (1 << 40, 1 << 14):
        monkeypatch.setattr(tadamw, "UPDATE_GROUP_ELEMS", limit)
        lm = TLM(tcfg, device="cpu", seed=3)
        st = tstep.init_train_state(lm)
        grads = {n: torch.full_like(p, 0.01) * (i + 1)
                 for i, (n, p) in enumerate(st.params.items())}
        tadamw.adamw_update(grads, st.opt, st.params, lr=1e-2)
        out[limit] = st
    big, small = out.values()
    for n in big.params:
        for table in ("master", "mu", "nu"):
            assert torch.equal(getattr(big.opt, table)[n],
                               getattr(small.opt, table)[n]), (n, table)
    groups = list(tadamw._groups(list(big.params), {
        n: p.numel() for n, p in big.params.items()}, 1 << 14))
    assert sum(len(g) for g in groups) == len(big.params)
    assert [n for g in groups for n in g] == list(big.params)


# ---------------------------------------------------------------------------
# batched_matmul's backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lead", [(4,), (2, 3)], ids=["E4", "2x3"])
def test_batched_matmul_grads_match_jax(lead):
    """``dense_torch`` on the CPU: autograd through ``torch.matmul``
    against ``jax.grad`` of the reference's ``batched_matmul``."""
    rng = np.random.default_rng(len(lead))
    a = rng.standard_normal(lead + (16, 24)).astype(np.float32)
    b = rng.standard_normal(lead + (24, 40)).astype(np.float32)
    gy = rng.standard_normal(lead + (16, 40)).astype(np.float32)
    ja, jb = jax.grad(lambda x, w: jnp.sum(
        jsparse.batched_matmul(x, w) * gy), argnums=(0, 1))(
            jnp.asarray(a), jnp.asarray(b))
    ta = torch.as_tensor(a).requires_grad_(True)
    tb = torch.as_tensor(b).requires_grad_(True)
    (tsparse.batched_matmul(ta, tb) * torch.as_tensor(gy)).sum().backward()
    assert _rel(ta.grad, ja) <= 1e-5 and _rel(tb.grad, jb) <= 1e-5
    p = tsparse.plan(tsparse.OpSpec(kind="dense", m=16, k=24, n=40,
                                    dtype="float32", op="batched_matmul"),
                     device="cpu")
    assert p.route == "dense_torch"
    assert _grad_report(p)["mode"] == "planned"
    assert p.grad_routes == {"dx": "torch_matmul", "dw": "torch_matmul"}


def _gmm_plan(c, d, f):
    """A ``batched_matmul`` plan on the gmm route, held on the CPU (fp32
    arithmetic at the row tile of the bf16 card path)."""
    spec = tsparse.OpSpec(kind="dense", m=c, k=d, n=f, dtype="float32",
                          op="batched_matmul")
    p = MatmulPlan(kind="dense", route="dense_cuda", m=c, k=d, n=f,
                         dtype=torch.float32, device=torch.device("cpu"),
                         ctx=tsparse.PlanContext(), spec=spec)
    p.row_tile = batched_row_tile(c, gmm_ops.tma_ok(d, f, torch.bfloat16))
    p.artifacts = {"kernel": "gmm", "row_tile": p.row_tile}
    return p


@pytest.mark.parametrize("c,tm", [(160, 80), (8, 8)])
def test_batched_matmul_gmm_backward_formulation(monkeypatch, c, tm):
    """``_BatchedMatmulFn`` with the gmm launch replaced by its plain
    version (the card runs the kernel; ``tests/test_torch_cuda.py`` holds
    it there): the forward and dL/da are gmm launches, dL/da on each
    expert's ``b^T`` with the forward's ids and row tile; dL/db is
    ``torch.bmm``; all three equal ``torch.matmul``'s autograd.  At the
    card phase's C 160 the row tile is 80."""
    calls = []

    def fake_gmm(x, w, ids, *, tm, plan=None):
        calls.append((tuple(x.shape), tuple(w.shape), tm,
                      ids.tolist()))
        assert x.is_contiguous() and w.is_contiguous()
        return gmm_ref(x, w, ids, tm=tm)

    monkeypatch.setattr(gmm_ops, "gmm_cuda", fake_gmm)
    e, d, f = 3, 24, 40
    p = _gmm_plan(c, d, f)
    assert p.row_tile == tm
    rng = np.random.default_rng(c)
    a = torch.as_tensor(rng.standard_normal((e, c, d)).astype(np.float32))
    b = torch.as_tensor(rng.standard_normal((e, d, f)).astype(np.float32))
    gy = torch.as_tensor(rng.standard_normal((e, c, f)).astype(np.float32))
    ta, tb = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    y = p.batched_matmul(ta, tb)
    (y * gy).sum().backward()
    ra, rb = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    want = torch.matmul(ra, rb)
    (want * gy).sum().backward()
    assert _rel(y, want) <= 1e-5
    assert _rel(ta.grad, ra.grad) <= 1e-5 and _rel(tb.grad, rb.grad) <= 1e-5
    ids = np.repeat(np.arange(e), c // tm).tolist()
    assert calls == [((e * c, d), (e, d, f), tm, ids),
                     ((e * c, f), (e, f, d), tm, ids)]
    # no gradient asked for b: dL/da alone, still on gmm
    calls.clear()
    ta2 = a.clone().requires_grad_(True)
    (p.batched_matmul(ta2, b) * gy).sum().backward()
    assert len(calls) == 2 and _rel(ta2.grad, ra.grad) <= 1e-5


def test_gmm_plan_reports_a_planned_backward(monkeypatch):
    """``_grad_report``, ``explain``, ``format_plan`` and ``grad_routes``
    of a differentiable plan on the gmm route report the planned
    backward (dL/da on gmm, dL/db on ``torch.bmm``, forced); a plan built
    with ``differentiable=False`` reports none and refuses autograd."""
    p = _gmm_plan(160, 24, 40)
    want = {"mode": "planned",
            "dx": {"route": "gmm_cuda", "source": "forced"},
            "dvalues": {"route": "torch_bmm", "source": "forced"},
            "from_disk": False}
    assert _grad_report(p) == want
    assert p.grad_routes == {"dx": "gmm_cuda", "dvalues": "torch_bmm"}
    assert p.explain()["grad"] == want
    assert "grad: dx=gmm_cuda dvalues=torch_bmm (forced)" in \
        tsparse.format_plan(p)
    q = _gmm_plan(160, 24, 40)
    q.ctx = tsparse.PlanContext(differentiable=False)
    assert _grad_report(q) == {"mode": "unavailable"}
    assert q.explain()["grad"] is None
    monkeypatch.setattr(gmm_ops, "gmm_cuda", lambda x, w, ids, *, tm:
                        gmm_ref(x, w, ids, tm=tm))
    a = torch.zeros(2, 160, 24, requires_grad=True)
    with pytest.raises(ValueError, match="differentiable"):
        q.batched_matmul(a, torch.zeros(2, 24, 40))


# ---------------------------------------------------------------------------
# checkpoint and the launcher
# ---------------------------------------------------------------------------

def test_moe_train_state_checkpoint_round_trip(tmp_path):
    """A MoE state after one step, saved and restored into a model from
    another seed: every tensor equal (the fp32 router, the expert
    stacks, AdamW's master and moments), and the next step equal."""
    _, _, _, tcfg, _ = _pair("shared_z")
    hp = tstep.TrainHParams(peak_lr=1e-3, warmup_steps=0, total_steps=10)
    pipe = TPipe(tcfg.vocab_size, 2, 16)
    lm = TLM(tcfg, device="cpu", seed=1)
    st = tstep.init_train_state(lm, hp=hp)
    fn = tstep.make_train_step(lm, hp)
    st, _ = fn(st, pipe.get_batch(0))
    save(str(tmp_path), tstep.state_tree(st), step=1, extra={})
    lm2 = TLM(tcfg, device="cpu", seed=2)
    st2 = tstep.init_train_state(lm2, hp=hp)
    tree, _, step = restore(str(tmp_path), tstep.state_tree(st2))
    st2 = tstep.load_state_tree(st2, tree)
    assert step == 1 and st2.step == 1 and st2.opt.count == 1
    assert "layers.0.ffn.shared.gate.w" in st2.params
    for a, b in ((st.params, st2.params), (st.opt.master, st2.opt.master),
                 (st.opt.mu, st2.opt.mu), (st.opt.nu, st2.opt.nu)):
        for n in a:
            assert a[n].dtype == b[n].dtype and torch.equal(a[n], b[n]), n
    _, m1 = fn(st, pipe.get_batch(1))
    _, m2 = tstep.make_train_step(lm2, hp)(st2, pipe.get_batch(1))
    for key in ("loss", "aux_loss", "z_loss", "dropped_frac"):
        assert float(m1[key]) == float(m2[key]), key


def test_profile_train_cuts_depth_not_width():
    """``launch.profile_train --layers``: the first period repeated, the
    width as published (a two-layer period keeps whole periods)."""
    from repro_torch.launch.profile_train import cut_depth
    cfg = tconfigs.get("qwen3-moe-30b-a3b")
    cut = cut_depth(cfg, 4)
    assert cut.num_layers == 4 and cfg.num_layers == 48
    assert dataclasses.replace(cut, groups=cfg.groups) == cfg
    gemma = tconfigs.get("gemma2-2b")
    assert len(gemma.groups[0][0]) == 2
    assert cut_depth(gemma, 5).num_layers == 4
    assert cut_depth(gemma, 1).num_layers == 2


def test_train_main_moe_smoke_on_cpu(capsys):
    losses = train_main(["--arch", "qwen3-moe-30b-a3b", "--smoke",
                         "--device", "cpu", "--steps", "3", "--batch", "2",
                         "--seq", "16", "--log-every", "1"])
    assert len(losses) == 3 and all(np.isfinite(losses))
    out = capsys.readouterr().out
    assert "[train] step 2" in out and "done" in out
