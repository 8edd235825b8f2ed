import os
import sys

import numpy as np

# NOTE: do NOT set XLA_FLAGS device-count here -- smoke tests and benches
# must see the 1 real CPU device (the 512-device override is exclusively
# for launch/dryrun.py, per the brief).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


# ---------------------------------------------------------------------------
# Per-dtype tolerance helpers for the gradient-parity conformance sweep
# (tests/test_grad_parity.py) and any other numerics-vs-oracle check.
#
# The budgets are relative to the oracle's max magnitude (block-sparse
# products accumulate over nnz blocks, so per-element relative checks
# explode on near-zero entries): fp32 covers reassociation noise only;
# bf16 (8-bit mantissa) and fp16 (10-bit mantissa) budgets cover one
# round-trip through the forward product + one backward product.
# ---------------------------------------------------------------------------

GRAD_TOLS = {
    "float32": 1e-4,
    "bfloat16": 6e-2,
    "float16": 2e-2,
}


def grad_tol(dtype) -> float:
    import jax.numpy as jnp
    return GRAD_TOLS[jnp.dtype(dtype).name]


def assert_close_for_dtype(got, want, dtype, label: str = ""):
    """Max-norm relative comparison at the dtype's conformance budget."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max()) / scale
    tol = grad_tol(dtype)
    assert err <= tol, (f"{label or 'array'} diverges: rel-max err "
                        f"{err:.2e} > {tol:.0e} budget for {dtype}")


# ---------------------------------------------------------------------------
# Telemetry isolation: capacity_report()/plan_report() aggregate into
# process-wide registries (deliberately -- the serving engine wants
# lifetime totals), which made telemetry assertions order-dependent
# across tests.  Zero the aggregates around every test; plans, verdicts
# and disk caches survive (reset_telemetry never forgets decisions).
# ---------------------------------------------------------------------------

import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _reset_sparse_telemetry():
    from repro import sparse
    sparse.reset_telemetry()
    yield


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (the port's kernels on a "
                   "card); skips without one")
