"""The port's sharding rules against the JAX package's, leaf by leaf.

Every one of the ten configs at full size, built from shapes only: the
reference's parameter, train-state and cache trees through
``jax.eval_shape``, the port's ``LM`` on the meta device.  A reference
leaf is mapped to the port's names through ``LM.jax_leaves`` (the map the
port's loaders use) and loses its stacked layer axis: the port's spec
must equal the reference's without that leading None, on the abstract
meshes ``(16, 16)``, ``(2, 16, 16)`` (with ``"pod"``), ``(1, 1)`` and
``(2, 4)``.  The reference's own cases (``tests/test_sharding.py``):
the divisibility fallback, the ``table`` rule, stacked dims, the batch
specs and the caches at batch >= dp and at batch 1.  Exact equality
throughout.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh as JMesh  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models.model import LM as TLM  # noqa: E402
from repro_torch.sharding import rules as trules  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "1x1": ((1, 1), ("data", "model")),
          "2x4": ((2, 4), ("data", "model"))}


def _jmesh(shape, names):
    try:
        return JMesh(shape, names)
    except TypeError:
        return JMesh(tuple(zip(names, shape)))


def _meshes(key):
    shape, names = MESHES[key]
    return _jmesh(shape, names), tmesh.AbstractMesh(shape, names)


class _Key(str):
    """A reference key path that ``jax_leaves`` may index like a stacked
    leaf (it unstacks ``[repeat, ...]`` leaves with ``v[r]``)."""

    def __getitem__(self, _):
        return self


def _keyed(tree):
    """``tree`` with each leaf replaced by its key path."""
    return jax.tree_util.tree_map_with_path(
        lambda p, _: _Key(jax.tree_util.keystr(p)), tree)


def _unstacked(spec, key):
    """The reference spec of a leaf without its stacked layer axis (the
    leaves under ``stack`` and ``encoder`` carry one)."""
    spec = tuple(spec)
    return spec[1:] if key.startswith(("['stack']", "['encoder']")) \
        else spec


@functools.lru_cache(maxsize=None)
def _pair(arch):
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    jsds = jconfigs.param_specs(arch, cfg=jcfg)
    tlm = TLM(tcfg, device="meta")
    return jcfg, jsds, tlm


def _spec_dict(specs):
    """Reference specs keyed by key path."""
    flat = jax.tree_util.tree_leaves_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {jax.tree_util.keystr(p): s for p, s in flat}


@pytest.mark.parametrize("mesh_key", sorted(MESHES))
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_param_specs_match_reference(arch, mesh_key):
    jmesh, tm = _meshes(mesh_key)
    _, jsds, tlm = _pair(arch)
    want = _spec_dict(jrules.param_specs(jsds, jmesh))
    keys = tlm.jax_leaves(_keyed(jsds))
    shapes = {n: tuple(p.shape) for n, p in tlm.named_parameters()}
    assert set(keys) == set(shapes)
    got = trules.param_specs(shapes, tm)
    jshapes = {jax.tree_util.keystr(p): l.shape for p, l in
               jax.tree_util.tree_leaves_with_path(jsds)}
    for name, key in keys.items():
        ref = _unstacked(want[key], key)
        stacked = _unstacked(jshapes[key], key)
        assert tuple(stacked) == shapes[name], name
        assert tuple(got[name]) == ref, (name, key, got[name], want[key])
        assert isinstance(got[name], trules.PartitionSpec)


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_train_state_specs_match_reference(arch):
    """``train_state_specs`` of the port's ``state_tree`` (with the
    compression residuals) equals the reference's of its ``TrainState``
    on every mesh: params, master, mu, nu and residual by the parameter
    rules, the step and the count replicated."""
    jcfg, jsds, tlm = _pair(arch)
    jlm = JLM(jcfg)
    hp = jstep.TrainHParams(grad_compress=True)
    state = jax.eval_shape(
        lambda: jstep.init_train_state(jlm, jax.random.PRNGKey(0), hp=hp))
    shapes = {n: tuple(p.shape) for n, p in tlm.named_parameters()}
    tree = {"step": (), "params": shapes,
            "opt": {"count": (), "master": shapes, "mu": shapes,
                    "nu": shapes},
            "ef": {"residual": shapes}}
    fields = {"params": state.params, "master": state.opt.master,
              "mu": state.opt.mu, "nu": state.opt.nu,
              "residual": state.ef.residual}
    for mesh_key in MESHES:
        jmesh, tm = _meshes(mesh_key)
        want = _spec_dict(jrules.train_state_specs(state, jmesh))
        got = trules.train_state_specs(tree, tm)
        assert tuple(got["step"]) == tuple(want[".step"]) == ()
        assert tuple(got["opt"]["count"]) == tuple(want[".opt.count"]) == ()
        for field, sub in fields.items():
            keys = tlm.jax_leaves(_keyed(sub))
            table = (got["params"] if field == "params" else
                     got["ef"]["residual"] if field == "residual" else
                     got["opt"][field])
            prefix = {"params": ".params", "residual": ".ef.residual"}.get(
                field, f".opt.{field}")
            for name, key in keys.items():
                ref = _unstacked(want[prefix + key], key)
                assert tuple(table[name]) == ref, (mesh_key, field, name)


@pytest.mark.parametrize("batch", [16, 1])
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_cache_specs_match_reference(arch, batch):
    """``cache_specs`` of the port's per-layer caches equals the
    reference's of its stacked caches (each layer the leaf of its period
    position without the stacked axis), at a batch the batch axes
    divide and at batch 1 (long context: the sequence over every axis)."""
    jcfg, _, tlm = _pair(arch)
    jlm = JLM(jcfg)
    memory_len = jcfg.frontend_len if jcfg.encoder_layers else 0
    jc = jax.eval_shape(lambda: jlm.init_cache(batch, 256,
                                               memory_len=memory_len))
    tc = tlm.init_cache(batch, 256, memory_len=memory_len)
    for mesh_key in MESHES:
        jmesh, tm = _meshes(mesh_key)
        want = jrules.cache_specs(jc, jmesh, batch=batch)
        got = trules.cache_specs(tc, tm, batch=batch)
        li = 0
        for (period, repeat), gw in zip(jcfg.groups, want):
            for r in range(repeat):
                for si in range(len(period)):
                    layer = got[li + r * len(period) + si]
                    assert set(layer) == set(gw[si]), (arch, li)
                    for k, spec in gw[si].items():
                        assert tuple(layer[k]) == tuple(spec)[1:], \
                            (mesh_key, arch, li, k, layer[k], spec)
            li += repeat * len(period)
        assert li == len(got)


def test_divisibility_fallback_and_table_rule():
    """The reference's ``test_divisibility_fallback``, ``test_table_rule``
    and ``test_stacked_leading_dims_are_replicated`` on the port."""
    big = tmesh.AbstractMesh((1, 16), ("data", "model"))
    assert trules.param_specs({"attn.wq.w": (100, 100)}, big)[
        "attn.wq.w"][1] is None
    assert trules.param_specs({"attn.wq.w": (128, 128)}, big)[
        "attn.wq.w"] == ("data", "model")
    assert trules.param_specs({"embed.table": (102400, 2048)}, big)[
        "embed.table"][0] == "model"
    s = trules.param_specs({"layers.3.attn.wq.w": (128, 128)},
                           tmesh.AbstractMesh((2, 4), ("data", "model")))
    assert s["layers.3.attn.wq.w"] == ("data", "model")
    assert trules.ref_path("layers.3.attn.wq.w") == \
        "['layers'][3]['attn']['wq']['w']"


def test_batch_specs_and_activation_mesh():
    """``test_train_batch_specs`` on the port, and the installed mesh."""
    big = tmesh.AbstractMesh((8, 2), ("data", "model"))
    specs = trules.train_batch_specs({"tokens": (16, 128),
                                      "targets": (16, 128)}, big)
    assert specs["tokens"] == ("data", None)
    assert trules.train_batch_specs({"tokens": (3, 128)},
                                    big)["tokens"][0] is None
    pod = tmesh.AbstractMesh((2, 4, 2), ("pod", "data", "model"))
    assert trules.train_batch_specs({"t": (16, 4)}, pod)["t"][0] == \
        ("pod", "data")
    assert trules.batch_axes(pod) == ("pod", "data")
    assert trules.current_mesh() is None
    with trules.activation_mesh(big):
        assert trules.current_mesh() is big
    assert trules.current_mesh() is None


def test_state_layout_off_a_concrete_mesh_is_whole():
    """On an abstract mesh the port's state is whole (one process): no
    ``ShardLayout``, and a block is the whole tensor."""
    cfg = dataclasses.replace(tconfigs.smoke("llama3_2_1b"),
                              dtype="float32")
    lm = TLM(cfg, device="cpu")
    st = tstep.init_train_state(
        lm, mesh=tmesh.AbstractMesh((2, 4), ("data", "model")))
    assert st.layout is None
    t = torch.arange(12.0).reshape(3, 4)
    assert torch.equal(tmesh.block(t, ("data", "model"), None), t)
    assert tmesh.axis_index(None, ("data",)) == (0, 1)
