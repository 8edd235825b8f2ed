"""Tabulate the dry-run's records: the roofline table, with each rank's
peak against its card.

    PYTHONPATH=src python -m repro_torch.analysis.report [--mesh 16x16]

Counterpart of the JAX package's ``analysis/report.py``, reading the
port's records (``launch/dryrun.py``, under ``experiments/dryrun_torch``).
The reference's columns come first, in its format; records that carry
the port's ``fits`` and peak add two columns, ``fits`` and ``peak_GiB``
(the rank's argument + resident + peak-transient bytes).  A cell whose
rank's program raised has a record with its ``error`` and a row of
dashes, bound ``error``.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

DRYRUN_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "experiments", "dryrun_torch")
MESH_NAMES = ("16x16", "2x16x16")


def load_records(mesh: str | None = None, tag: str = "",
                 directory: str | None = None):
    """Dry-run records matching ``mesh`` / ``tag`` from ``directory``
    (``DRYRUN_DIR`` by default).  A missing directory raises (an empty
    table would hide a wrong path or a dry-run not yet run); an existing
    one with no match returns []."""
    dryrun = os.path.normpath(directory or DRYRUN_DIR)
    if not os.path.isdir(dryrun):
        raise FileNotFoundError(
            f"dry-run records directory does not exist: {dryrun} -- "
            f"generate records first (python -m "
            f"repro_torch.launch.dryrun --all --mesh both) or check the "
            f"working tree layout")
    recs = []
    for path in sorted(glob.glob(os.path.join(dryrun, f"*{tag}.json"))):
        base = os.path.basename(path)[:-5]
        parts = base.split("__")
        if tag and not base.endswith(tag):
            continue
        if not tag and len(parts[2].split("_")) > 1 and parts[2] not in \
                MESH_NAMES:
            continue
        with open(path) as f:
            r = json.load(f)
        if mesh and r["mesh"] != mesh:
            continue
        recs.append(r)
    return recs


def _port_columns(recs) -> bool:
    return bool(recs) and all("fits" in r for r in recs)


def table(recs, *, fmt: str = "md") -> str:
    rows = []
    hdr = ["arch", "shape", "mesh", "t_comp(ms)", "t_mem(ms)",
           "t_coll(ms)", "bound", "useful_frac", "roofline_frac"]
    port = _port_columns(recs)
    if port:
        hdr += ["fits", "peak_GiB"]
    for r in recs:
        if "error" in r:
            rows.append([r["arch"], r["shape"], r["mesh"]] + ["-"] * 3
                        + ["error", "-", "-"] + (["NO", "-"] if port else []))
            continue
        ro = r["roofline"]
        row = [
            r["arch"], r["shape"], r["mesh"],
            f"{ro['t_compute']*1e3:.2f}", f"{ro['t_memory']*1e3:.2f}",
            f"{ro['t_collective']*1e3:.2f}", ro["dominant"],
            f"{ro.get('useful_flop_frac', 0):.3f}",
            f"{ro.get('roofline_frac', 0):.4f}"]
        if port:
            row += ["yes" if r["fits"] else "NO",
                    f"{r['memory']['peak_gib']:.2f}"]
        rows.append(row)
    if fmt == "md":
        out = ["| " + " | ".join(hdr) + " |",
               "|" + "---|" * len(hdr)]
        out += ["| " + " | ".join(map(str, row)) + " |" for row in rows]
        return "\n".join(out)
    w = [max(len(str(x)) for x in [h] + [row[i] for row in rows])
         for i, h in enumerate(hdr)]
    out = ["  ".join(h.ljust(w[i]) for i, h in enumerate(hdr))]
    out += ["  ".join(str(x).ljust(w[i]) for i, x in enumerate(row))
            for row in rows]
    return "\n".join(out)


def fit_table(recs) -> str:
    """One markdown row per architecture, one column per shape, each cell
    every mesh's record: the rank's peak GiB (``NO`` past its card), the
    dominant roofline term and the collective GB a step by mesh axis, and
    an MoE model's expert work a rank against the reference's
    (``dryrun.moe_buckets``; or the error a raising cell's rank program
    gave)."""
    meshes = sorted({r["mesh"] for r in recs}, key=len)
    shapes = list(dict.fromkeys(r["shape"] for r in sorted(
        recs, key=lambda r: r["shape"])))
    cells: dict = {}
    for r in recs:
        cells.setdefault(r["arch"], {})[(r["shape"], r["mesh"])] = r

    def one(r) -> str:
        if "error" in r:
            return f"raises {r['error']}"
        by_axis = r["cost"]["collective_bytes_by_axis"]
        coll = ", ".join(f"{a} {v / 1e9:.3g}" for a, v in
                         sorted(by_axis.items())) or "none"
        moe = (f", MoE work x{r['moe']['work_factor']:.3g}"
               if "moe" in r else "")
        return (f"{r['memory']['peak_gib']:.2f}"
                f"{'' if r['fits'] else ' NO'}, "
                f"{r['roofline']['dominant']}, {coll}{moe}")
    hdr = ["arch"] + shapes
    out = ["| " + " | ".join(hdr) + " |", "|" + "---|" * len(hdr)]
    for arch, by in sorted(cells.items()):
        row = [arch]
        for shape in shapes:
            row.append("; ".join(f"{m}: {one(by[(shape, m)])}"
                                 for m in meshes if (shape, m) in by)
                       or "-")
        out.append("| " + " | ".join(row) + " |")
    return "\n".join(out)


def interesting_cells(recs):
    """The cell furthest below its roofline and the most collective-bound
    one (the reference's two picks)."""
    recs = [r for r in recs if "roofline" in r]
    ranked = sorted((r for r in recs if "roofline_frac" in r["roofline"]),
                    key=lambda r: r["roofline"]["roofline_frac"])
    worst = ranked[0] if ranked else None
    coll = max(recs, key=lambda r: r["roofline"]["t_collective"] /
               max(r["roofline"]["bound_seconds"], 1e-12), default=None)
    return worst, coll


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--fmt", default="txt", choices=["md", "txt"])
    ap.add_argument("--tag", default="")
    ap.add_argument("--dir", default=None,
                    help=f"records directory (default {DRYRUN_DIR})")
    ap.add_argument("--fit", action="store_true",
                    help="one row per architecture, a column per shape: "
                         "each mesh's peak GiB against the card, bound, "
                         "collective GB by axis")
    args = ap.parse_args(argv)
    recs = load_records(args.mesh, tag=args.tag, directory=args.dir)
    if args.fit:
        print(fit_table(recs))
        return
    print(table(recs, fmt=args.fmt))
    if recs:
        worst, coll = interesting_cells(recs)
        if worst is not None:
            print(f"\nworst roofline frac: {worst['arch']} x "
                  f"{worst['shape']} "
                  f"({worst['roofline']['roofline_frac']:.4f})")
        if coll is not None:
            print(f"most collective-bound: {coll['arch']} x "
                  f"{coll['shape']}")
        over = [r for r in recs if r.get("fits") is False and "error" not in r]
        if over:
            print("do not fit: " + ", ".join(
                f"{r['arch']} x {r['shape']} on {r['mesh']} "
                f"({r['memory']['peak_gib']:.2f} GiB)" for r in over))
        raised = [r for r in recs if "error" in r]
        if raised:
            print("raised: " + "; ".join(
                f"{r['arch']} x {r['shape']} on {r['mesh']}: {r['error']}"
                for r in raised))


if __name__ == "__main__":
    main()
