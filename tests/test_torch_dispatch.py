"""The serving engine's price on the H100 model, against the reference's
bucket algorithm, on the CPU.

The reference prices padding with its calibrated TPU model
(``repro.core.dispatch.price_tokens``); the port with an analytic model
of its own dense_mm kernel on the H100 (``repro_torch.core.dispatch``).
The cards differ, so the ladders differ from the TPU's; what holds is
that the reference's ``_auto_buckets``, handed the port's price, builds
the port's ladder, and that the engine prices its ladder and admission
with that model, at the model's dtype.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import dispatch as jdispatch  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import dispatch as tdispatch  # noqa: E402
from repro_torch.kernels.dense_mm import ops as dmm_ops  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402

# the served configurations (chip_smoke.py): model, FFN density, max_len
SERVED = {"llama3_2_1b": (1 / 8, 512), "gemma2_2b": (1 / 8, 8192),
          "qwen3_moe_30b_a3b": (None, 1024)}
SMOKE_MAX_LEN = 96


def _cfg(name, smoke):
    density, max_len = SERVED[name]
    cfg = (tconfigs.smoke if smoke else tconfigs.get)(name)
    if density is not None:
        cfg = tconfigs.sparsify_ffn(cfg, density)
    return cfg, SMOKE_MAX_LEN if smoke else max_len


@pytest.mark.parametrize("smoke", [False, True], ids=["served", "smoke"])
@pytest.mark.parametrize("name", sorted(SERVED))
def test_reference_algorithm_on_port_price_gives_port_ladder(
        monkeypatch, name, smoke):
    cfg, max_len = _cfg(name, smoke)
    shapes = tengine._stack_shapes(cfg)
    port = tengine._auto_buckets(max_len - 1, shapes, 0.75,
                                 dtype=cfg.dtype)
    monkeypatch.setattr(
        jdispatch, "price_tokens",
        lambda s, n, **kw: tdispatch.price_tokens(s, n, dtype=cfg.dtype))
    ref_alg = jengine._auto_buckets(max_len - 1, shapes, 0.75)
    assert ref_alg == port
    assert port[-1] == max_len - 1 and list(port) == sorted(set(port))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", sorted(SERVED))
def test_price_is_monotone_and_weight_bound_at_small_n(name, dtype):
    cfg, max_len = _cfg(name, smoke=False)
    shapes = tengine._stack_shapes(cfg)
    ns = list(range(1, 65)) + list(range(80, max_len, 48))
    prices = [tdispatch.price_tokens(shapes, n, dtype=dtype) for n in ns]
    assert all(b >= a for a, b in zip(prices, prices[1:])), (
        [(n, p) for n, p in zip(ns, prices)])
    # reading the weights dominates a short prefill: 16 tokens cost far
    # less than 16 single tokens
    assert prices[15] / prices[0] < 4
    assert tdispatch.price_tokens(shapes, 0, dtype=dtype) == 0.0


def test_estimate_follows_the_kernel_walk():
    """``_estimate`` is the time model of the walk dense_mm takes: its
    launch term plus the larger of its operations and its bytes over the
    walk's rates (the ffma walk computes whole 64-row tiles)."""
    for n, k, m, dtype in ((4, 2048, 4096, "bfloat16"),
                           (4, 2048, 512, "bfloat16"),
                           (1008, 2048, 4096, "bfloat16"),
                           (1008, 2048, 4096, "float32")):
        wk = dmm_ops.walk(n, k, m, dtype)
        es = 4 if dtype == "float32" else 2
        launch, rate, bw = dmm_ops.WALK_MODEL[(wk.name, es)]
        rows = -(-n // 64) * 64 if wk.name == "ffma" else n
        want = launch + max(2.0 * rows * k * m / rate,
                            (n * k + k * m + n * m) * es / bw)
        assert tdispatch._estimate("dense_cuda", m, k, n, dtype=dtype) == \
            pytest.approx(want)
    with pytest.raises(ValueError, match="no H100 model"):
        tdispatch._estimate("static_xla", 64, 64, 4)


def test_engine_prices_ladder_and_admission_with_the_card_model():
    cfg = dataclasses.replace(tconfigs.smoke("qwen3_moe_30b_a3b"),
                              dtype="float32")
    lm = LM(cfg, device="cpu", seed=0)
    eng = tengine.Engine(lm, batch=2, max_len=SMOKE_MAX_LEN, device="cpu")
    shapes = tengine._stack_shapes(cfg)
    assert eng.buckets == tengine._auto_buckets(SMOKE_MAX_LEN - 1, shapes,
                                                0.75, dtype="float32")
    for n in (1, 7, 33, 95):
        assert eng._price(n) == tdispatch.price_tokens(shapes, n,
                                                       dtype="float32")
    # admission: a prompt's bucket is the smallest holding it unless its
    # priced padding passes pad_max_frac
    for n in (1, 17, 40, 90):
        b = next(L for L in eng.buckets if L >= n)
        waste = 1.0 - eng._price(n) / eng._price(b)
        assert eng.bucket_for(n) == (b if waste <= 0.75 else None)
    assert np.isfinite(eng._price(SMOKE_MAX_LEN - 1))
