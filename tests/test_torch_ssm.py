"""The Mamba-2 (SSD) mixer against the JAX package, on the CPU.

``ssd_scan`` against the JAX ``ssd_scan`` and against the token-by-token
recurrence (2e-4, as ``tests/test_ssm.py``), over chunkings that divide
the sequence and the degenerate chunk of 1 at an odd length, with one
and two head groups; ``ssm_train``, ``ssm_prefill`` (output, state and
conv tail) and ``ssm_decode`` against the JAX functions in fp32 (2e-4)
and bf16 (the conftest's 6e-2); ``ssm_cache_init``; the gradients
against ``jax.grad``; and the short-prompt conv tail, which the port
left-pads with zeros (the reference returns the short tail as it is;
``ROADMAP.md`` §3).  Weights come from ``ssm_init`` with seeded values
for the leaves it sets to constants (norm scale, conv bias, dt bias,
D), inputs from numpy with a seed.  Budgets are rel-max over the
reference's max magnitude.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import assert_close_for_dtype  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.model import _copy_into, _flatten  # noqa: E402

TOL = 2e-4
MODEL_TOL = 1e-4
ARCH = "mamba2_130m"
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _rel(got, want):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-6)


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _check(got, want, dtype, label=""):
    if dtype == "float32":
        assert _rel(got, want) <= TOL, label
    else:
        got = got.detach().float() if isinstance(got, torch.Tensor) else got
        assert_close_for_dtype(got, np.asarray(want, np.float32), dtype,
                               label)


# the reference's functions compiled once per shape (eager JAX dispatches
# op by op)
_scan = jax.jit(jssm.ssd_scan, static_argnames="chunk")
_train = jax.jit(jssm.ssm_train, static_argnums=1)
_prefill = jax.jit(jssm.ssm_prefill, static_argnums=1)
_decode = jax.jit(jssm.ssm_decode, static_argnums=1)


def _cfg(port: bool, dtype: str = "float32"):
    cfg = tconfigs.smoke(ARCH) if port else jconfigs.smoke(ARCH)
    return dataclasses.replace(cfg, dtype=dtype)


# ---------------------------------------------------------------------------
# the chunked scan
# ---------------------------------------------------------------------------

def _naive_recurrence(x, dt, A, B, C):
    """Token by token: ``h = h * exp(dt A) + dt B x``; ``y = C . h``
    (float64)."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    Bh = np.repeat(B, rep, axis=2).astype(np.float64)
    Ch = np.repeat(C, rep, axis=2).astype(np.float64)
    state = np.zeros((b, h, p, n), np.float64)
    ys = np.zeros((b, s, h, p), np.float64)
    for t in range(s):
        decay = np.exp(dt[:, t] * A)
        state = state * decay[..., None, None] + np.einsum(
            "bh,bhp,bhn->bhpn", dt[:, t], x[:, t], Bh[:, t])
        ys[:, t] = np.einsum("bhpn,bhn->bhp", state, Ch[:, t])
    return ys, state


def _scan_inputs(s, groups, seed=0):
    b, h, p, n = 2, 4, 8, 16
    x = _np((b, s, h, p), seed)
    dt = np.log1p(np.exp(_np((b, s, h), seed + 1))).astype(np.float32)
    A = (-np.exp(_np((h,), seed + 2, 0.5))).astype(np.float32)
    B = _np((b, s, groups, n), seed + 3, 0.5)
    C = _np((b, s, groups, n), seed + 4, 0.5)
    return x, dt, A, B, C


@pytest.mark.parametrize("s,chunk", [(32, 8), (48, 16), (37, 32)])
@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_scan_matches_jax_and_recurrence(s, chunk, groups):
    """(37, 32) halves the chunk down to 1: 37 chunks of one token."""
    args = _scan_inputs(s, groups)
    y, state = tssm.ssd_scan(*map(torch.as_tensor, args), chunk=chunk)
    jy, jstate = _scan(*map(jnp.asarray, args), chunk=chunk)
    ry, rstate = _naive_recurrence(*args)
    assert y.shape == jy.shape and state.shape == jstate.shape
    assert state.dtype == torch.float32
    assert _rel(y, jy) <= TOL and _rel(state, jstate) <= TOL
    np.testing.assert_allclose(y.numpy(), ry, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(state.numpy(), rstate, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("s,chunk,want", [(37, 32, 1), (48, 16, 16),
                                          (900, 256, 4), (899, 256, 1),
                                          (512, 256, 256), (16, 256, 16)])
def test_chunk_len_is_the_reference_rule(s, chunk, want):
    assert tssm.chunk_len(s, chunk) == want


# ---------------------------------------------------------------------------
# the mixer
# ---------------------------------------------------------------------------

_MODULES = {}


def _module(dtype):
    """``(jcfg, params, mixer)``: ``ssm_init``'s params (norm scale,
    conv bias, dt bias and D seeded) and the port's ``Mamba2`` holding
    them."""
    if dtype not in _MODULES:
        jdt, tdt = DTYPES[dtype]
        jcfg, tcfg = _cfg(False, dtype), _cfg(True, dtype)
        tree = jax.tree.map(np.asarray, jssm.ssm_init(
            jax.random.PRNGKey(5), jcfg, dtype=jdt))
        rng = np.random.default_rng(12)

        def seeded(a, scale, base=0.0):
            v = base + scale * rng.standard_normal(a.shape)
            return np.asarray(v.astype(np.float32)).astype(a.dtype)

        tree["norm"]["scale"] = seeded(tree["norm"]["scale"], 0.3, 1.0)
        tree["conv_b"] = seeded(tree["conv_b"], 0.2)
        tree["dt_bias"] = seeded(tree["dt_bias"], 0.5)
        tree["D"] = seeded(tree["D"], 0.3, 1.0)
        mod = tssm.Mamba2(tcfg, dtype=tdt, device="cpu")
        _copy_into(dict(mod.named_parameters()), _flatten(tree), "Mamba2")
        _MODULES[dtype] = (jcfg, jax.tree.map(jnp.asarray, tree), mod)
    return _MODULES[dtype]


def test_mamba2_parameters_are_the_reference_leaves():
    for dtype, (_, tdt) in DTYPES.items():
        jcfg, params, mod = _module(dtype)
        named = dict(mod.named_parameters())
        assert set(named) == set(_flatten(jax.tree.map(np.asarray, params)))
        assert set(named) == {"in_proj.w", "conv_w", "conv_b", "dt_bias",
                              "A_log", "D", "norm.scale", "out_proj.w"}
        for name, p in named.items():
            want = params
            for part in name.split("."):
                want = want[part]
            assert tuple(p.shape) == want.shape, name
            fp32 = name in ("dt_bias", "A_log", "D", "norm.scale")
            assert p.dtype == (torch.float32 if fp32 else tdt), name


def test_init_fills_as_ssm_init():
    """``A_log = log(linspace(1, 16, heads))``, ``D = 1``, ``dt_bias``
    and ``conv_b`` zero, the norm scale one (deterministic, equal to
    ``ssm_init``'s); ``conv_w`` seeded at ``1 / sqrt(d_conv)``."""
    cfg = _cfg(True, "bfloat16")
    mod = tssm.Mamba2(cfg, dtype=torch.bfloat16, device="cpu")
    for m in mod.modules():
        m.reset_parameters(torch.Generator().manual_seed(3))
    want = jax.tree.map(np.asarray, jssm.ssm_init(
        jax.random.PRNGKey(0), _cfg(False, "bfloat16")))
    for name in ("A_log", "D", "dt_bias", "conv_b"):
        np.testing.assert_allclose(getattr(mod, name).float().numpy(),
                                   np.asarray(want[name], np.float32),
                                   rtol=1e-6, atol=0)
    assert torch.equal(mod.norm.scale, torch.ones_like(mod.norm.scale))
    std = float(mod.conv_w.float().std())
    assert 0.35 < std < 0.65           # 1 / sqrt(4) = 0.5


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ssm_train_matches_jax(dtype):
    jcfg, params, mod = _module(dtype)
    jdt, tdt = DTYPES[dtype]
    x = _np((2, 40, jcfg.d_model), 1, 0.5)
    want = _train(params, jcfg, jnp.asarray(x, jdt))
    got = mod(torch.as_tensor(x).to(tdt))
    assert got.shape == (2, 40, jcfg.d_model) and got.dtype == tdt
    _check(got, want, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("s", [3, 24, 37])
def test_ssm_prefill_matches_jax(dtype, s):
    """Output, final state (fp32) and conv tail (model dtype); 37 is an
    odd length (chunks of 1)."""
    jcfg, params, mod = _module(dtype)
    jdt, tdt = DTYPES[dtype]
    x = _np((2, s, jcfg.d_model), 2, 0.5)
    want, jc = _prefill(params, jcfg, jnp.asarray(x, jdt))
    got, tc = mod.prefill(torch.as_tensor(x).to(tdt))
    _check(got, want, dtype, "out")
    assert set(tc) == set(jc) == {"state", "conv"}
    assert tc["state"].dtype == torch.float32 and tc["conv"].dtype == tdt
    for name in tc:
        assert tuple(tc[name].shape) == jc[name].shape, name
        _check(tc[name], jc[name], dtype, name)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ssm_decode_matches_jax(dtype):
    """Three steps after a prefill, the port writing its cache in
    place."""
    jcfg, params, mod = _module(dtype)
    jdt, tdt = DTYPES[dtype]
    x = _np((2, 10, jcfg.d_model), 3, 0.5)
    _, jc = _prefill(params, jcfg, jnp.asarray(x, jdt))
    _, tc = mod.prefill(torch.as_tensor(x).to(tdt))
    state, conv = tc["state"], tc["conv"]
    for step in range(3):
        xt = _np((2, 1, jcfg.d_model), 20 + step, 0.5)
        want, jc = _decode(params, jcfg, jnp.asarray(xt, jdt), jc)
        got, tc2 = mod.decode(torch.as_tensor(xt).to(tdt), tc)
        assert tc2 is tc
        assert tc["state"] is state and tc["conv"] is conv
        _check(got, want, dtype, f"step {step}")
        for name in tc:
            _check(tc[name], jc[name], dtype, f"{name} step {step}")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ssm_cache_init_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    want = jssm.ssm_cache_init(_cfg(False, dtype), 3, dtype=jdt)
    got = tssm.ssm_cache_init(_cfg(True, dtype), 3, dtype=tdt,
                              device="cpu")
    assert set(got) == set(want) == {"state", "conv"}
    for name, t in got.items():
        assert tuple(t.shape) == want[name].shape, name
        assert str(t.dtype).split(".")[-1] == want[name].dtype.name, name
        assert not t.any()


def test_ssm_grads_match_jax():
    """``sum(ssm_train(x) * gy)`` in x and every parameter: ``jax.grad``
    against autograd, fp32, at two chunks of the smoke chunk."""
    jcfg, params, mod = _module("float32")
    x = _np((2, 64, jcfg.d_model), 4, 0.5)
    gy = _np((2, 64, jcfg.d_model), 5)

    def f(p, xx):
        return jnp.sum(jssm.ssm_train(p, jcfg, xx) * jnp.asarray(gy))

    jgp, jgx = jax.jit(jax.grad(f, argnums=(0, 1)))(params,
                                                   jnp.asarray(x))
    want = _flatten(jax.tree.map(np.asarray, jgp))
    named = list(mod.named_parameters())
    mod.requires_grad_(True)
    try:
        tx = torch.as_tensor(x).requires_grad_(True)
        y = mod(tx)
        grads = torch.autograd.grad((y * torch.as_tensor(gy)).sum(),
                                    [tx] + [p for _, p in named])
    finally:
        mod.requires_grad_(False)
    assert _rel(grads[0], jgx) <= MODEL_TOL
    worst = {n: _rel(g, want[n]) for (n, _), g in zip(named, grads[1:])}
    assert max(worst.values()) <= MODEL_TOL, worst


@pytest.mark.parametrize("s", [1, 2])
def test_short_prompt_tail_is_zero_padded(s):
    """Below ``d_conv - 1`` tokens the tail is the prompt's conv rows
    left-padded with zeros (the reference's is 1 or 2 rows long), and
    decode after it equals the full-sequence block on the same tokens."""
    jcfg, params, mod = _module("float32")
    k = jcfg.ssm.d_conv - 1
    n = s + 4
    x = _np((2, n, jcfg.d_model), 6, 0.5)
    _, jc = _prefill(params, jcfg, jnp.asarray(x[:, :s]))
    assert jc["conv"].shape[1] == s             # the reference's short tail
    _, tc = mod.prefill(torch.as_tensor(x[:, :s]))
    assert tc["conv"].shape[1] == k
    assert not tc["conv"][:, :k - s].any()
    assert _rel(tc["conv"][:, k - s:], jc["conv"]) <= TOL
    assert _rel(tc["state"], jc["state"]) <= TOL
    full = mod(torch.as_tensor(x))
    steps = [mod.decode(torch.as_tensor(x[:, t:t + 1]), tc)[0]
             for t in range(s, n)]
    assert _rel(torch.cat(steps, dim=1), full[:, s:].detach()) <= TOL
