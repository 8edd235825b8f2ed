"""The port's serving engine: greedy tokens equal to the JAX engine's on
the same weights, and the engine's contracts (termination, oversize
rejection, bounded queue, stats, no silent CPU fallback)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.model import LM as TLM  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402
from repro_torch.serve import Engine, Request  # noqa: E402


def _tcfg():
    return dataclasses.replace(
        tconfigs.sparsify_ffn(tconfigs.smoke("llama3_2_1b"), 0.25),
        dtype="float32")


@pytest.fixture(scope="module")
def tlm():
    return TLM(_tcfg(), device="cpu", seed=0)


def _engine(lm, **kw):
    kw.setdefault("batch", 2)
    kw.setdefault("max_len", 32)
    return Engine(lm, device="cpu", **kw)


def test_engine_tokens_match_jax():
    cfg = _tcfg()
    jcfg = dataclasses.replace(jconfigs.smoke("llama3_2_1b"),
                               groups=cfg.groups, ffn_density=0.25,
                               dtype="float32")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    jlm = JLM(jcfg)
    params = jlm.init(jax.random.PRNGKey(3))
    lm = TLM(cfg, device="cpu").load_jax_params(
        jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 512, size=n).astype(np.int32)
               for n in (6, 7, 13)]
    jeng = JEngine(jlm, params, batch=2, max_len=32, buckets=(8, 16))
    jreqs = [JRequest(uid=i, prompt=p, max_new_tokens=5)
             for i, p in enumerate(prompts)]
    jeng.run(jreqs)
    eng = _engine(lm, buckets=(8, 16))
    reqs = [Request(uid=i, prompt=p, max_new_tokens=5)
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    for j, t in zip(jreqs, reqs):
        assert t.done and len(t.output) == 5
        assert t.output == j.output, t.uid
        assert t.bucket == j.bucket


def test_max_new_tokens_includes_prefill_token(tlm):
    eng = _engine(tlm, buckets=(8, 16))
    reqs = [Request(uid=0, prompt=np.arange(5), max_new_tokens=1),
            Request(uid=1, prompt=np.arange(9), max_new_tokens=4)]
    finished = []
    eng.run(reqs, on_finish=finished.append)
    assert [len(r.output) for r in reqs] == [1, 4]
    assert sorted(r.uid for r in finished) == [0, 1]
    assert reqs[0].bucket == 8 and reqs[1].bucket == 16
    st = eng.stats()
    assert st["admission"]["finished"] == 2 and st["steps"] == 3
    assert st["padding"]["pad_tokens"] == 3 + 7
    assert st["prefill_latency"]["count"] == 2


def test_eos_at_prefill_frees_slot(tlm):
    eng = _engine(tlm)
    probe = Request(uid=0, prompt=np.arange(6), max_new_tokens=8)
    eng.admit(probe)
    first = probe.output[0]
    eng = _engine(tlm)
    req = Request(uid=1, prompt=np.arange(6), max_new_tokens=8,
                  eos_id=first)
    eng.admit(req)
    assert req.done and req.output == [first]
    assert len(eng.free) == 2
    assert eng.stats()["admission"]["eos_at_prefill"] == 1


def test_padded_prefill_reads_true_last_token(tlm):
    prompt = np.random.default_rng(1).integers(0, 512, size=11)
    exact, _ = tlm.prefill(prompt[None], max_len=32)
    padded = np.zeros((1, 16), np.int64)
    padded[0, :11] = prompt
    got, _ = tlm.prefill(padded, max_len=32, last_index=[10])
    assert torch.allclose(got, exact, rtol=0, atol=1e-5)


def test_oversized_prompt_rejected(tlm):
    eng = _engine(tlm, max_len=16)
    with pytest.raises(ValueError, match="max_len=16"):
        eng.submit(Request(uid=0, prompt=np.arange(16)))
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(Request(uid=1, prompt=np.zeros(0, np.int64)))


def test_bounded_queue_drops_and_counts(tlm):
    eng = _engine(tlm, max_queue=2)
    reqs = [Request(uid=i, prompt=np.arange(4), max_new_tokens=2)
            for i in range(4)]
    eng.run(reqs)
    assert [r.dropped for r in reqs] == [False, False, True, True]
    adm = eng.stats()["admission"]
    assert adm["dropped"] == 2 and adm["dropped_frac"] == 0.5
    assert all(r.done for r in reqs[:2])


def test_auto_buckets_end_at_top_and_price_by_flops():
    cfg = tconfigs.sparsify_ffn(tconfigs.get("llama3_2_1b"), 1 / 8)
    shapes = tengine._stack_shapes(cfg)
    assert len(shapes) == 16 * 4 + 1
    assert shapes[2] == (2 * 1024, 2048)       # gated FFN at d=1/8
    ladder = tengine._auto_buckets(511, shapes, 0.75)
    assert ladder[0] == 16 and ladder[-1] == 511
    assert list(ladder) == sorted(set(ladder))
    # the price is the H100 model's (not FLOPs): a second token costs
    # less than the first, the weights are read once
    one, two = (tengine.price_tokens(shapes, n) for n in (1, 2))
    assert one < two < 2 * one


def test_engine_requires_matching_device(tlm):
    with pytest.raises(ValueError, match="model device"):
        Engine(tlm, batch=1, max_len=16, device="meta")


def test_engine_without_card_raises(tlm):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(tlm, batch=1, max_len=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--smoke"])


def test_launch_serve_on_cpu(capsys):
    eng = tserve.main(["--smoke", "--device", "cpu", "--density", "0.25",
                       "--requests", "3", "--batch", "2", "--max-len", "48",
                       "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "3 requests, 9 tokens" in out
    assert eng.stats()["admission"]["finished"] == 3
