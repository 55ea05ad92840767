"""Render the roofline table from step records (``repro.roofline.tables``):
the reference's dry-run records, or the port's one-card records
(``roofline/count.py``, mesh ``card``).

    python -m repro_torch.roofline.tables --dir build/roofline --mesh card
"""
from __future__ import annotations

import argparse
import json
import pathlib

from repro_torch.roofline.report import roofline_terms


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-6:
        return f"{x*1e9:.1f}ns"
    if x < 1e-3:
        return f"{x*1e6:.1f}us"
    if x < 1:
        return f"{x*1e3:.2f}ms"
    return f"{x:.2f}s"


def fmt_b(x: float) -> str:
    for unit, div in (("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if x >= div:
            return f"{x/div:.1f}{unit}"
    return f"{x:.0f}B"


def load(dir_: str, mesh: str = "pod", with_overrides: bool = False):
    recs = []
    for f in sorted(pathlib.Path(dir_).glob("*.json")):
        r = json.loads(f.read_text())
        if not r.get("ok") or r.get("mesh") != mesh:
            continue
        if bool(r.get("overrides")) != with_overrides:
            continue
        _refresh_model_flops(r)
        recs.append(r)
    return recs


def _refresh_model_flops(rec: dict) -> None:
    """Recompute the useful-work floor with the live formulas (the stored one
    is whatever the formula said when the record was made), for the cell the
    record ran: its smoke size where it says so, scaled to its batch."""
    if rec["arch"] == "triangle-stream":
        return
    from repro_torch.configs import cells

    if rec["arch"] not in cells.ALL_ARCHS or rec["shape"] not in cells.arch_shapes(rec["arch"]):
        return
    cell = cells.build_cell(rec["arch"], rec["shape"], smoke=rec.get("smoke", False))
    rec["model_flops"] = cell.model_flops * rec.get("batch_scale", 1.0)


def effective_flops(rec: dict) -> float:
    """Per-device flops: analytic (scan-corrected) when present, else counted."""
    fa = rec["cost"].get("flops_analytic_total")
    if fa:
        return fa / rec["chips"]
    return rec["cost"]["flops"]


def table(recs, use_analytic=True) -> str:
    head = (
        "| arch | shape | compute | memory | collective | bound | "
        "HBM/chip | useful/HLO | roofline frac |\n"
        "|---|---|---|---|---|---|---|---|---|\n"
    )
    rows = []
    for r in recs:
        r2 = dict(r)
        if use_analytic:
            r2["cost"] = dict(r["cost"], flops=effective_flops(r))
        t = roofline_terms(r2)
        mem = (
            r["memory"]["temp_bytes"]
            + r["memory"]["argument_bytes"]
            + r["memory"]["output_bytes"]
        )
        rows.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(t['compute_s'])} | "
            f"{fmt_s(t['memory_s'])} | {fmt_s(t['collective_s'])} | "
            f"**{t['bound']}** | {fmt_b(mem)} | "
            f"{t['useful_flop_ratio']:.2f} | {t['roofline_fraction']:.1%} |"
        )
    return head + "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="build/roofline")
    ap.add_argument("--mesh", default="card")
    args = ap.parse_args(argv)
    print(table(load(args.dir, args.mesh)))


if __name__ == "__main__":
    main()
