"""Per-period rematerialisation (``cfg.remat``) of the port's layer stack.

The reference checkpoints each period of its scanned stack
(``models/transformer.py`` ``_remat_policy``; ``remat="full"`` is every
config's default).  The port checkpoints each period of ``cfg.groups``
(``models/transformer.py`` ``stack_apply``): on seeded fp32 smoke
configs -- llama (one-layer period, dense and with the sparse FFN),
gemma2 (a two-layer local + global period, repeated twice) and qwen3
(MoE, whose metrics the stack sums) -- the loss, the MoE metrics and
every gradient are bit-equal between ``"full"`` and ``"none"``, and
within ``MODEL_TOL`` = 1e-4 (rel-max, the fp32 budget of
``tests/test_torch_dp.py``) of ``jax.grad`` of the reference's loss on
the same weights.  Fewer tensors are saved for the backward under
``"full"`` (counted with ``torch.autograd.graph.saved_tensors_hooks``),
the recompute records no telemetry again, and ``"dots"`` raises.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import sparse as jsparse  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import sparse as tsparse  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.model import LM as TLM  # noqa: E402

MODEL_TOL = 1e-4
VOCAB = 512


def _rel(got, want):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-6)


def _cfg(mod, arch: str):
    """The fp32 smoke config of ``arch`` from the registry ``mod``:
    gemma2's two-layer period repeated twice, llama-sparse with every FFN
    block-sparse at density 1/2."""
    name = arch.replace("-sparse", "")
    cfg = dataclasses.replace(mod.smoke(name), dtype="float32")
    if name == "gemma2-2b":
        (period, _), = cfg.groups
        cfg = dataclasses.replace(cfg, groups=((period, 2),))
    if arch.endswith("-sparse"):
        groups = tuple((tuple(dataclasses.replace(s, ffn="sparse")
                              for s in period), rep)
                       for period, rep in cfg.groups)
        cfg = dataclasses.replace(cfg, groups=groups, ffn_density=0.5)
    return cfg


_PAIRS = {}


def _pair(arch):
    """``(jlm, params, tlm)``: the reference LM, its seeded weights, and
    the port's LM holding them (built once per process)."""
    if arch not in _PAIRS:
        jcfg = _cfg(jconfigs, arch)
        tcfg = _cfg(tconfigs, arch)
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        jlm = JLM(jcfg)
        params = jlm.init(jax.random.PRNGKey(3))
        jsparse.reset()
        tlm = TLM(tcfg, device="cpu").load_jax_params(
            jax.tree.map(np.asarray, params))
        _PAIRS[arch] = (jlm, params, tlm)
    return _PAIRS[arch]


def _batch(b=2, s=16, seed=5):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, VOCAB, size=(b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:].copy()}
    batch["targets"][0, -3:] = -1
    return batch


def _port_grads(tlm, batch, remat, count=None):
    """``(loss, metrics, {name: grad})`` of the port's loss at ``remat``;
    ``count`` (a list) collects one entry per tensor saved for the
    backward."""
    tlm.cfg = dataclasses.replace(tlm.cfg, remat=remat)
    for layer in tlm.layers:
        layer.cfg = dataclasses.replace(layer.cfg, remat=remat)
    tlm.requires_grad_(True)
    try:
        hooks = (torch.autograd.graph.saved_tensors_hooks(
            lambda t: count.append(1) or t, lambda t: t)
            if count is not None else torch.autograd.graph.
            saved_tensors_hooks(lambda t: t, lambda t: t))
        with hooks:
            loss, metrics = tlm.loss(batch["tokens"], batch["targets"])
        named = list(tlm.named_parameters())
        grads = torch.autograd.grad(loss, [p for _, p in named])
    finally:
        tlm.requires_grad_(False)
    return loss.detach(), metrics, {n: g for (n, _), g in zip(named, grads)}


ARCHS = ["llama3.2-1b", "llama3.2-1b-sparse", "gemma2-2b",
         "qwen3-moe-30b-a3b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_full_and_none_bit_equal_and_match_jax(arch):
    jlm, params, tlm = _pair(arch)
    batch = _batch()
    if arch.endswith("-sparse"):
        # the reference's sparse plans built outside any trace (its
        # ``_dx_closure`` caches a concrete perm at plan build; as
        # ``tests/test_torch_train.py`` ``prewarm_jax_sparse_plans``)
        ffn = jtfm._sparse_ffn(jlm.cfg)
        layer0 = jax.tree.map(lambda a: a[0], params["stack"][0][0]["ffn"])
        ffn.apply(layer0, jnp.zeros((32, jlm.cfg.d_model), jnp.float32))
    jb = jax.tree.map(jnp.asarray, batch)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jlm.loss(p, jb), has_aux=True)(params)
    want = tlm.jax_leaves(jax.tree.map(np.asarray, jgrads))
    full = _port_grads(tlm, batch, "full")
    none = _port_grads(tlm, batch, "none")
    assert torch.equal(full[0], none[0])
    assert set(full[1]) == set(none[1])
    for k in full[1]:
        assert torch.equal(full[1][k], none[1][k]), k
    for n, g in full[2].items():
        assert torch.equal(g, none[2][n]), n
    assert _rel(full[0], jloss) <= MODEL_TOL
    for k in ("aux_loss", "z_loss", "xent"):
        if k in full[1]:
            assert _rel(full[1][k], jm[k]) <= MODEL_TOL, k
    if "dropped_frac" in full[1]:
        assert abs(float(full[1]["dropped_frac"])
                   - float(jm["dropped_frac"])) <= 1e-6
    worst = max(_rel(g, want[n]) for n, g in full[2].items())
    assert worst <= MODEL_TOL


@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma2-2b",
                                  "qwen3-moe-30b-a3b"])
def test_full_saves_fewer_tensors(arch):
    _, _, tlm = _pair(arch)
    batch = _batch()
    saved = {}
    for remat in ("full", "none"):
        saved[remat] = []
        _port_grads(tlm, batch, remat, count=saved[remat])
    assert 0 < len(saved["full"]) < len(saved["none"]), \
        {k: len(v) for k, v in saved.items()}


def test_periods_follow_groups():
    """A period is a group's period, not a layer: gemma2's two layers,
    each repeat its own period."""
    _, _, tlm = _pair("gemma2-2b")
    per = ttfm.periods(tlm.layers)
    assert [len(p) for p in per] == [2, 2]
    assert [[layer.local for layer in p] for p in per] == [[True, False]] * 2


def test_recompute_records_no_telemetry_again():
    """The MoE layers record one routing drop a layer a forward; the
    recomputed forward records none."""
    _, _, tlm = _pair("qwen3-moe-30b-a3b")
    n_layers = len(tlm.layers)
    for remat in ("full", "none"):
        tsparse.reset_telemetry()
        _port_grads(tlm, _batch(), remat)
        assert len(tsparse.dropped_history("moe_dispatch")) == n_layers, \
            remat


def test_dots_raises_under_grad_only():
    _, _, tlm = _pair("llama3.2-1b")
    batch = _batch()
    with pytest.raises(NotImplementedError, match="11b.5"):
        _port_grads(tlm, batch, "dots")
    # serving (no gradients) never checkpoints: "dots" runs as "none"
    logits = tlm(batch["tokens"])
    assert torch.isfinite(logits).all()
    _port_grads(tlm, batch, "full")
