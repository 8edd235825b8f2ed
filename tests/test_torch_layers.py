"""``SparseLinear``/``SparseFFN`` and the base layers of the port against
the JAX layers, with the JAX weights carried across.  fp32 throughout;
budget ``tests/conftest.py``'s fp32 1e-4 (rel-max)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import assert_close_for_dtype  # noqa: E402
from repro.core import sparse_layers as jsl  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.core import sparse_layers as tsl  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _load(param, value):
    with torch.no_grad():
        param.copy_(_t(value))


@pytest.mark.parametrize("b, density, bias", [(16, 0.25, False),
                                              (4, 0.1, True)])
def test_sparse_linear_matches_jax(b, density, bias):
    jl = jsl.SparseLinear.random_pattern(None, 64, 128, b, density, seed=9,
                                         use_bias=bias)
    params = jl.init(jax.random.PRNGKey(1))
    if bias:
        params["bias"] = jnp.linspace(-1.0, 1.0, 128)
    x = np.random.default_rng(2).standard_normal((2, 5, 64)).astype(
        np.float32)
    want = jl.apply(params, jnp.asarray(x))

    tl = tsl.SparseLinear.random_pattern(64, 128, b, density, seed=9,
                                         use_bias=bias, device="cpu")
    assert np.array_equal(tl.pattern, jl.pattern)
    assert np.array_equal(tl.row_idx, jl._indices()[0])
    _load(tl.values, params["values"])
    if bias:
        _load(tl.bias, params["bias"])
    got = tl(_t(x))
    assert got.shape == (2, 5, 128)
    assert_close_for_dtype(got, want, "float32", "SparseLinear")


def test_sparse_linear_repacks_when_values_change():
    tl = tsl.SparseLinear.random_pattern(32, 32, 16, 0.5, seed=0,
                                         device="cpu")
    tl.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(3, 32, generator=torch.Generator().manual_seed(1))
    y1 = tl(x)
    assert tl(x) is not y1 and torch.equal(tl(x), y1)   # cached pack
    with torch.no_grad():
        tl.values.mul_(2.0)
    assert torch.allclose(tl(x), 2.0 * y1)


@pytest.mark.parametrize("gated", [True, False])
def test_sparse_ffn_matches_jax(gated):
    jf = jsl.SparseFFN(d_model=64, d_ff=128, block_size=16, density=0.25,
                       gated=gated, seed=5)
    params = jf.init(jax.random.PRNGKey(3))
    x = np.random.default_rng(4).standard_normal((3, 7, 64)).astype(
        np.float32)
    want = jf.apply(params, jnp.asarray(x))

    tf = tsl.SparseFFN(64, 128, 16, 0.25, gated=gated, seed=5, device="cpu")
    names = ("up", "down", "gate") if gated else ("up", "down")
    for name, jlayer in zip(names, jf._layers()):
        tlayer = getattr(tf, name)
        assert np.array_equal(tlayer.pattern, jlayer.pattern), name
        _load(tlayer.values, params[name]["values"])
    assert (tf.gate is None) == (not gated)
    assert_close_for_dtype(tf(_t(x)), want, "float32", "SparseFFN")


def test_base_layers_match_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 6, 4, 32)).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    pos = np.arange(6)[None, :]
    assert_close_for_dtype(
        tlayers.rms_norm(_t(x), _t(scale), eps=1e-5),
        jlayers.rms_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                         eps=1e-5), "float32", "rms_norm")
    assert_close_for_dtype(
        tlayers.apply_rope(_t(x), torch.from_numpy(pos), theta=5e5),
        jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta=5e5),
        "float32", "rope")
    w = rng.standard_normal((32, 48)).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32)
    assert_close_for_dtype(
        tlayers.dense(_t(x), _t(w), _t(b)),
        jlayers.dense({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                      jnp.asarray(x)), "float32", "dense")
    table = rng.standard_normal((50, 32)).astype(np.float32)
    h = rng.standard_normal((2, 3, 32)).astype(np.float32)
    assert_close_for_dtype(
        tlayers.unembed(_t(table), _t(h), softcap=30.0),
        jlayers.unembed({"table": jnp.asarray(table)}, jnp.asarray(h),
                        softcap=30.0), "float32", "unembed")


@pytest.mark.parametrize("act", ["silu", "gelu", "gelu_plain"])
def test_mlp_matches_jax(act):
    params = jlayers.mlp_init(jax.random.PRNGKey(7), 32, 64, act=act,
                              dtype=jnp.float32)
    x = np.random.default_rng(8).standard_normal((4, 32)).astype(np.float32)
    want = jlayers.mlp(params, jnp.asarray(x), act=act)
    tm = tlayers.MLP(32, 64, act=act, dtype=torch.float32, device="cpu")
    for name in params:
        _load(getattr(tm, name).w, params[name]["w"])
    assert_close_for_dtype(tm(_t(x)), want, "float32", f"mlp {act}")
