"""Fit the H100 cost model's calibration from a committed corpus of card
runs.

``core.dispatch._estimate_raw`` prices each route with the hand-tuned
H100 model of the walk its kernel takes (``walk_seconds`` beside each
kernel's ``walk()``, the skew knees ``SKEW_KNEES``).  This module closes
the loop against measurements, as the JAX package's
``analysis/calibrate.py`` does for its TPU model: it replays every
(route, problem, time) observation of the committed corpus
(``baselines/H100_*.json``, trimmed ``chip_smoke.py --out`` runs) plus
any extra ``chip_smoke.py --out`` JSON through the *uncalibrated* model
and fits a per-route affine correction

    t_cal = scale[route] * t_raw + fixed_us[route]

by ordinary least squares (a median-ratio scale alone when a route has
too few observations for a stable intercept, and no correction at all
below ``MIN_SCALE_OBS``), plus the ``_skew_factor``
slopes from the observations on skewed patterns.  The result is written
to ``baselines/cost_coeffs.json``; ``dispatch`` reads it at import and
mixes its content digest into every decision key, plan fingerprint and
disk key, so a refit orphans stale verdicts.

Each observation carries every input ``_estimate_raw`` needs (shape,
``n``, block, density, dtype, kind, the pattern's imbalance and cv and
its walk counts), so the raw model is replayed on the CPU exactly as the
card's race priced it; the model times a run printed are the installed
model's outputs and are never fitted.

Design constraints, in order:

* **Tie stability.**  The corpus contains exact route ties
  (``static_pallas == dense_pallas`` on pallas-off grids) whose
  resolution is dict-insertion order.  Fitted corrections within noise
  of identity are snapped *to* identity (``SCALE_SNAP`` /
  ``FIXED_SNAP_US``) so calibration never perturbs an exact tie into a
  spurious crossover.  On the card the noise is the corpus's own: a
  scale within twice its standard error of 1 snaps too (``_fit_route``;
  the H100's static and balanced walks are within 1-2 % of each other
  at the 16-bit prefill shapes, and a 5 % correction inside that noise
  turned every such near-tie into a balanced verdict).
* **Idempotence.**  The fit always runs against the identity model
  (``_identity_model`` swaps it in), never against the currently
  installed coefficients — refitting from an unchanged corpus emits a
  byte-identical file.
* **Determinism.**  No RNG, no wall clock: the corpus is the only
  input, so `calibrate --update` is reproducible in CI (and repro-lint
  R005 has nothing to suppress here).

CLI::

    PYTHONPATH=src python -m repro_torch.analysis.calibrate          # dry run
    PYTHONPATH=src python -m repro_torch.analysis.calibrate --update
    PYTHONPATH=src python -m repro_torch.analysis.calibrate \\
        --corpus results.json --report fit.json

A new corpus file comes from a card: ``python3 chip_smoke.py --out
x.json``, then ``--trim x.json`` writes its corpus section as
``baselines/H100_<name>.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
import json
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import dispatch
from repro_torch.sparse.spec import ADMISSIBLE

BASELINE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "baselines")
DEFAULT_OUT = os.path.join(BASELINE_DIR, "cost_coeffs.json")

COEFFS_VERSION = 1

# fit guard rails: a corpus glitch must not produce a model that
# reorders every race
SCALE_BOUNDS = (0.25, 4.0)
FIXED_BOUNDS_US = (0.0, 100.0)
SLOPE_BOUNDS = (0.0, 2.0)
# snap-to-identity tolerances (see module docstring: tie stability)
SCALE_SNAP = 0.02
FIXED_SNAP_US = 1.0
SLOPE_SNAP_REL = 0.05
MIN_AFFINE_OBS = 3          # fewer -> median-ratio scale, no intercept
MIN_SCALE_OBS = 3           # fewer -> the identity: no fit at all
MIN_SPREAD_REL = 0.05       # x-range below this -> intercept unidentifiable


@dataclasses.dataclass(frozen=True)
class Observation:
    """One (route, problem) -> measured-microseconds corpus point, with
    the raw model's inputs: ``kind`` and ``counts`` (a
    ``dispatch.WalkCounts`` as a dict; None for the dense kind) are the
    port's additions to the reference's fields."""

    fig: str
    route: str
    m: int
    k: int
    n: int
    b: int
    density: float
    dtype: str = "float32"
    imbalance: float = 1.0
    cv: float = 0.0
    measured_us: float = 0.0
    source: str = ""
    kind: str = "static"
    counts: Optional[dict] = None


# ---------------------------------------------------------------------------
# The raw model's inputs of a problem (what a corpus record carries)
# ---------------------------------------------------------------------------

def static_model_inputs(rows, cols, m: int, k: int, n: int, b: int,
                        dtype) -> dict:
    """``_estimate_raw``'s inputs for ``W [m, k]`` of block pattern
    (``rows``, ``cols``) at ``n`` tokens: its skew (``row_balance``) and
    walk counts (``static_counts``), as the plan prices it."""
    rows = np.asarray(rows, np.int32)
    cols = np.asarray(cols, np.int32)
    imb, cv = dispatch.row_balance(rows, m, k, b)
    counts = dispatch.static_counts(rows, cols, m, k, b)
    grid = max(1, -(-m // b) * -(-k // b))
    return {"kind": "static", "m": int(m), "k": int(k), "n": int(n),
            "b": int(b), "density": len(rows) / grid,
            "dtype": str(dtype).replace("torch.", ""),
            "imbalance": float(imb), "cv": float(cv),
            "counts": dataclasses.asdict(counts)}


def plan_model_inputs(p) -> dict:
    """The raw model's inputs of a plan's forward problem, as its race
    priced them."""
    s = p.spec
    if s.kind == "static":
        rows, cols = p.pattern
        return static_model_inputs(rows, cols, s.m, s.k, s.n,
                                   s.block_size, s.dtype)
    out = {"kind": s.kind, "m": s.m, "k": s.k, "n": s.n,
           "b": s.block_size, "density": float(s.density),
           "dtype": s.dtype, "imbalance": 1.0, "cv": 0.0, "counts": None}
    if s.kind == "dynamic":
        out["counts"] = dataclasses.asdict(dispatch.dynamic_counts(
            s.m, s.k, s.block_size, s.density,
            headroom=p.ctx.resolved_headroom(),
            policy=p.ctx.capacity_policy))
    return out


def grad_model_inputs(p) -> Dict[str, dict]:
    """The raw model's inputs of a static plan's backward products:
    dL/dx over the transposed ``[k, m]`` problem, dL/dvalues (the SDDMM
    routes) over ``W``'s pattern."""
    s = p.spec
    rows, cols = p.pattern
    dx = static_model_inputs(cols, rows, s.k, s.m, s.n, s.block_size,
                             s.dtype)
    dv = static_model_inputs(rows, cols, s.m, s.k, s.n, s.block_size,
                             s.dtype)
    dv["imbalance"], dv["cv"] = 1.0, 0.0       # the SDDMM is not skewed
    return {"dx": dx, "dvalues": dv}


def corpus_record(inputs: dict, measured_seconds: Dict[str, float]
                  ) -> dict:
    """One corpus record: a problem's raw-model inputs and each raced
    route's measured time (ms, as ``chip_smoke.py`` prints them)."""
    return {"model": dict(inputs),
            "measured_ms": {r: float(v) * 1e3
                            for r, v in measured_seconds.items()}}


def price(inputs: dict, routes: Sequence[str],
          coeffs: Optional[dispatch.CostCoeffs] = None
          ) -> Dict[str, float]:
    """Seconds of each route on the problem ``inputs`` under ``coeffs``
    (the active calibration when None): the plan layer's analytic race."""
    counts = inputs.get("counts")
    wc = dispatch.WalkCounts(**counts) if counts else None
    return {r: dispatch._estimate(
        r, inputs["m"], inputs["k"], inputs["n"], inputs["b"],
        inputs["density"], inputs["dtype"], imbalance=inputs["imbalance"],
        cv=inputs["cv"], counts=wc, kind=inputs["kind"], coeffs=coeffs)
        for r in routes}


# ---------------------------------------------------------------------------
# Corpus extraction (one extractor per figure of the corpus section)
# ---------------------------------------------------------------------------

_KNOWN_FAMILIES = frozenset(ADMISSIBLE["static"]) | frozenset(
    dispatch.SDDMM_FAMILIES)


def _candidate_obs(rec: dict, fig: str, source: str) -> List[Observation]:
    out = []
    mi = rec["model"]
    for route, ms in (rec.get("measured_ms") or {}).items():
        if not route.endswith("_cuda") or \
                dispatch.family(route) not in _KNOWN_FAMILIES:
            continue
        out.append(Observation(
            fig=fig, route=route, m=int(mi["m"]), k=int(mi["k"]),
            n=int(mi["n"]), b=int(mi["b"]), density=float(mi["density"]),
            dtype=mi["dtype"], imbalance=float(mi["imbalance"]),
            cv=float(mi["cv"]), measured_us=float(ms) * 1e3,
            source=source, kind=mi["kind"], counts=mi.get("counts")))
    return out


def _extract_race(rec: dict, source: str) -> List[Observation]:
    """``[race]``: every candidate of each Table 3 cell."""
    return _candidate_obs(rec, "race", source)


def _extract_race_serve(rec: dict, source: str) -> List[Observation]:
    """The race-serve phase: every candidate ``remeasure_plan`` timed
    for a served llama plan."""
    return _candidate_obs(rec, "race_serve", source)


def _extract_grad(rec: dict, source: str) -> List[Observation]:
    """``[race] backward``: the dL/dx candidates on the transposed
    problem and the dL/dvalues ones."""
    return _candidate_obs(rec, "grad", source)


def _extract_skewed(rec: dict, source: str) -> List[Observation]:
    """The skew grid: the uniform and balanced walks on skewed masks."""
    return _candidate_obs(rec, "skewed_patterns", source)


EXTRACTORS = {
    "race": _extract_race,
    "race_serve": _extract_race_serve,
    "grad": _extract_grad,
    "skewed_patterns": _extract_skewed,
}


def load_corpus(paths: Optional[Sequence[str]] = None,
                ) -> List[Observation]:
    """Observations from the committed corpus plus ``paths`` extras.

    Each file is a ``chip_smoke.py --out`` JSON or its trimmed copy: its
    ``corpus`` section is ``{fig: [records]}``; figures without an
    extractor are ignored.
    """
    files = sorted(glob.glob(os.path.join(BASELINE_DIR, "H100_*.json")))
    for p in paths or ():
        hits = sorted(glob.glob(p))
        if not hits:
            raise FileNotFoundError(f"corpus glob matched nothing: {p}")
        files.extend(hits)
    obs: List[Observation] = []
    for path in files:
        with open(path) as f:
            blob = json.load(f)
        src = os.path.basename(path)
        for fig, recs in (blob.get("corpus") or {}).items():
            extract = EXTRACTORS.get(fig)
            if extract is not None:
                for rec in recs:
                    obs.extend(extract(rec, src))
    return obs


def trim(run_json: str, out: str) -> str:
    """Write the corpus section of a ``chip_smoke.py --out`` run, with
    the card's name and power limit and the torch and CUDA versions, as
    a corpus file."""
    with open(run_json) as f:
        blob = json.load(f)
    keep = {"header": {k: blob.get(k) for k in ("card", "torch", "cuda")},
            "corpus": blob["corpus"]}
    with open(out, "w") as f:
        json.dump(keep, f, indent=1, sort_keys=True)
        f.write("\n")
    return out


# ---------------------------------------------------------------------------
# Fitting
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _identity_model():
    """Evaluate ``_estimate_raw`` under the hand-tuned constants so a
    refit never compounds on the previously fitted coefficients."""
    prev = dispatch.cost_coeffs()
    dispatch.set_cost_coeffs(dispatch.IDENTITY_COEFFS)
    try:
        yield
    finally:
        dispatch.set_cost_coeffs(prev)


def _raw_us(o: Observation, *, skewless: bool = False) -> float:
    imb, cv = (1.0, 0.0) if skewless else (o.imbalance, o.cv)
    counts = dispatch.WalkCounts(**o.counts) if o.counts else None
    return dispatch._estimate_raw(
        o.route, o.m, o.k, o.n, o.b, o.density, o.dtype,
        imbalance=imb, cv=cv, counts=counts, kind=o.kind,
        coeffs=dispatch.IDENTITY_COEFFS) * 1e6


def _snap(value: float, target: float, tol: float) -> float:
    return target if abs(value - target) <= tol else value


def _ratio_noise(xs: np.ndarray, ys: np.ndarray) -> float:
    """Twice the standard error of the median of ``ys / xs`` (1.2533
    sigma / sqrt(n)): the noise on a scale fitted as that median."""
    if len(xs) < 2:
        return 0.0
    r = ys / xs
    return 2.0 * 1.2533 * float(np.std(r, ddof=1)) / float(np.sqrt(len(r)))


def _fit_route(xs: np.ndarray, ys: np.ndarray) -> Tuple[float, float]:
    """(scale, fixed_us) for one route: least squares of the relative
    error when the corpus identifies an intercept, median-ratio scale
    otherwise; a scale within the corpus's noise of 1 snaps to 1 (and
    the intercept is then refitted alone).

    The reference fits the absolute microseconds.  A card corpus spans a
    decode launch (~10 us) to Table 3's fp32 products (~40 ms), where an
    unweighted fit is the largest problems' alone: on the first H100
    corpus its intercepts (33 us dense, 60 us static_balanced) left the
    served plans' median error at 56-68 %.  Each point is weighed by
    ``1 / measured``, so every problem counts by its relative error.
    The noise is twice the scale's standard error: the weighted fit's
    (from its residuals), or the median ratio's (``_ratio_noise``).
    Below ``MIN_SCALE_OBS`` points a route keeps the identity (the
    reference fits their median ratio): two ratios leave one degree of
    freedom, too few for the noise test to mean anything."""
    n = len(xs)
    if n < MIN_SCALE_OBS:
        return 1.0, 0.0
    spread = (xs.max() - xs.min()) / max(xs.mean(), 1e-12)
    noise = _ratio_noise(xs, ys)
    scale, fixed = float(np.median(ys / xs)), 0.0
    if n >= MIN_AFFINE_OBS and spread >= MIN_SPREAD_REL:
        (s, f), cov = np.polyfit(xs, ys, 1, w=1.0 / ys, cov="unscaled")
        if FIXED_BOUNDS_US[0] <= f <= FIXED_BOUNDS_US[1]:
            rel = (ys - (s * xs + f)) / ys
            noise = 2.0 * float(np.sqrt(
                cov[0, 0] * np.sum(rel ** 2) / max(1, n - 2)))
            scale, fixed = float(s), float(f)
        # else a negative / absurd intercept: the median ratio, through
        # the origin
    scale = float(np.clip(scale, *SCALE_BOUNDS))
    fixed = float(np.clip(fixed, *FIXED_BOUNDS_US))
    snapped = _snap(scale, 1.0, max(SCALE_SNAP, noise))
    if snapped != scale and fixed:
        # the scale is noise: the intercept alone, fitted at scale 1
        w2 = 1.0 / ys ** 2
        fixed = float(np.clip(np.sum(w2 * (ys - xs)) / np.sum(w2),
                              *FIXED_BOUNDS_US))
    return snapped, _snap(fixed, 0.0, FIXED_SNAP_US)


def _fit_skew(obs: List[Observation],
              routes: Dict[str, dict]) -> Tuple[Dict[str, float], int]:
    """The least-squares ``_skew_factor`` imbalance slope from the
    observations on skewed patterns, and the number of observations it
    rests on (0: the slopes are ``SKEW_KNEES``'s).  Knees and cap stay
    at their hand-tuned values (the corpus does not sample the
    near-knee region densely enough to identify them).

    The reference fits the imbalance and cv slopes jointly.  The port's
    model prices skew by the row imbalance alone (its cv slope is 0),
    and on the card's skew grid the two signals move together (power
    law 32 / 3.1, DLMC-like 13 / 1.3), so a joint fit is not
    identified: the cv slope stays ``SKEW_KNEES``'s and the imbalance
    slope is fitted alone.  Cap-censored points are excluded."""
    d = dispatch.SKEW_KNEES
    skew = dict(d)
    xs, rhs = [], []
    for o in obs:
        if dispatch.family(o.route) not in dispatch._SKEW_SENSITIVE:
            continue
        x_imb = max(0.0, o.imbalance - skew["imb_knee"])
        if x_imb <= 0.0:
            continue
        c = routes.get(o.route, {})
        base = (c.get("scale", 1.0) * _raw_us(o, skewless=True)
                + c.get("fixed_us", 0.0))
        implied = o.measured_us / max(base, 1e-9)
        if implied >= skew["cap"] - 1e-6:     # censored at the cap
            continue
        xs.append(x_imb)
        rhs.append(implied - 1.0)
    if len(xs) >= 2:
        x, y = np.asarray(xs), np.asarray(rhs)
        s_imb = float(np.clip(np.dot(x, y) / np.dot(x, x), *SLOPE_BOUNDS))
        skew["imb_slope"] = _snap(
            s_imb, d["imb_slope"], SLOPE_SNAP_REL * d["imb_slope"])
    return skew, len(xs)


def fit(obs: List[Observation]) -> dict:
    """The full fit: per-route affine terms, then skew slopes, plus a
    per-route error report.  Returns the ``cost_coeffs.json`` blob."""
    if not obs:
        raise ValueError("empty corpus: nothing to fit")
    with _identity_model():
        by_route: Dict[str, List[Tuple[float, float]]] = {}
        for o in obs:
            by_route.setdefault(o.route, []).append(
                (_raw_us(o), o.measured_us))
        routes: Dict[str, dict] = {}
        all_rel: List[float] = []
        for route in sorted(by_route):
            pts = np.asarray(by_route[route], dtype=np.float64)
            scale, fixed = _fit_route(pts[:, 0], pts[:, 1])
            pred = scale * pts[:, 0] + fixed
            rel = np.abs(pred - pts[:, 1]) / np.maximum(pts[:, 1], 1e-9)
            all_rel.extend(rel.tolist())
            routes[route] = {
                "scale": round(scale, 6), "fixed_us": round(fixed, 6),
                "n_obs": int(len(pts)),
                "median_rel_err": round(float(np.median(rel)), 6),
            }
        skew, n_skew = _fit_skew(obs, routes)
        skew = {k: round(v, 6) for k, v in skew.items()}
    digest = dispatch.coeffs_digest(routes, skew, COEFFS_VERSION)
    return {
        "version": COEFFS_VERSION,
        "digest": digest,
        "corpus": {
            "files": sorted({o.source for o in obs}),
            "n_obs": len(obs),
            "n_routes": len(routes),
            "n_skew_obs": n_skew,
        },
        "routes": routes,
        "skew": skew,
        "fit_median_rel_err": round(float(np.median(all_rel)), 6),
    }


def write_coeffs(blob: dict, out: str = DEFAULT_OUT) -> str:
    with open(out, "w") as f:
        json.dump(blob, f, indent=1, sort_keys=True)
        f.write("\n")
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="fit the H100 cost model's calibration from the "
                    "corpus of card runs")
    ap.add_argument("--corpus", nargs="*", default=None, metavar="GLOB",
                    help="chip_smoke.py --out JSONs beyond baselines/")
    ap.add_argument("--update", action="store_true",
                    help=f"write {os.path.relpath(DEFAULT_OUT)}")
    ap.add_argument("--out", default=None,
                    help="write the fitted coefficients to this path")
    ap.add_argument("--report", default=None,
                    help="write the full fit blob (with diagnostics) here")
    ap.add_argument("--trim", nargs=2, default=None,
                    metavar=("RUN_JSON", "OUT"),
                    help="write a run's corpus section as a corpus file "
                         "and exit")
    args = ap.parse_args(argv)
    if args.trim:
        print(f"calibrate: corpus -> {trim(*args.trim)}")
        return 0

    obs = load_corpus(args.corpus)
    blob = fit(obs)
    print(f"calibrate: {blob['corpus']['n_obs']} observations from "
          f"{len(blob['corpus']['files'])} files, "
          f"{blob['corpus']['n_routes']} routes, "
          f"fit median rel err {blob['fit_median_rel_err']:.4%}")
    for route, c in blob["routes"].items():
        print(f"  {route:28s} scale={c['scale']:<8g} "
              f"fixed_us={c['fixed_us']:<8g} n={c['n_obs']:<3d} "
              f"err={c['median_rel_err']:.4%}")
    print(f"  skew: {blob['skew']} from {blob['corpus']['n_skew_obs']} "
          f"skewed observations"
          + ("" if blob["corpus"]["n_skew_obs"] else
             " (none: the knees and slopes stay SKEW_KNEES)")
          + f"  digest={blob['digest']}")
    out = args.out or (DEFAULT_OUT if args.update else None)
    if out:
        print(f"calibrate: wrote {write_coeffs(blob, out)}")
    else:
        print("calibrate: dry run (pass --update to write)")
    if args.report:
        with open(args.report, "w") as f:
            json.dump(blob, f, indent=1, sort_keys=True)
        print(f"calibrate: report -> {args.report}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
