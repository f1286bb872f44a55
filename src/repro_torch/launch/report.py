"""Render the dry-run's tables from its JSON results.

    PYTHONPATH=src python -m repro_torch.launch.report dryrun_results.json

The counterpart of the reference's ``repro/launch/report.py``: the
summary, the per-mesh memory tables, with each rank's peak beside its
argument and temporary bytes (a fake-group dry-run: no card measured
them), and the roofline table of each probed cell (``launch/roofline.py``:
the H100's peaks against one rank's counted FLOPs, bytes and collective
bytes; the terms a card would take at its peaks, not times measured).
"""
from __future__ import annotations

import json
import sys
from typing import Dict, List


def _gib(b) -> str:
    return f"{b / 2**30:.2f}"


def dryrun_table(rows: List[Dict], mesh: str) -> str:
    out = ["| arch | shape | status | args GiB/dev | temp GiB/dev | "
           "peak GiB/dev | trace s | note |",
           "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["mesh"] != mesh:
            continue
        if r["status"] != "ok":
            note = r.get("reason", r.get("error", ""))
            out.append(f"| {r['arch']} | {r['shape']} | {r['status']} "
                       f"| — | — | — | — | {note[:60]} |")
            continue
        m = r["memory"]
        out.append(
            f"| {r['arch']} | {r['shape']} | ok "
            f"| {_gib(m['argument_bytes'])} | {_gib(m['temp_bytes'])} "
            f"| {_gib(m['peak_bytes'])} | {r['trace_s']} | {r['fsdp']} |")
    return "\n".join(out)


def roofline_table(rows: List[Dict], mesh: str = "single") -> str:
    out = ["| arch | shape | compute s | memory s | collective s | "
           "dominant | MODEL/counted flops | roofline frac |",
           "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["mesh"] != mesh or r["status"] != "ok" or "roofline" not in r:
            continue
        rf = r["roofline"]
        out.append(
            f"| {r['arch']} | {r['shape']} "
            f"| {rf['compute_s']:.4f} | {rf['memory_s']:.4f} "
            f"| {rf['collective_s']:.4f} | **{rf['dominant']}** "
            f"| {rf['useful_flop_ratio']:.2f} "
            f"| {rf['roofline_fraction']:.3f} |")
    return "\n".join(out)


def summary(rows: List[Dict]) -> str:
    ok = sum(1 for r in rows if r["status"] == "ok")
    sk = sum(1 for r in rows if r["status"] == "skipped")
    er = sum(1 for r in rows if r["status"] == "error")
    return (f"{len(rows)} cells: {ok} ok, {sk} skipped "
            f"(long_500k on full-attention archs), {er} errors")


def main() -> None:
    path = sys.argv[1] if len(sys.argv) > 1 else "dryrun_results.json"
    with open(path) as f:
        rows = json.load(f)
    rows.sort(key=lambda r: (r["arch"], r["shape"], r["mesh"]))
    print("## Summary\n")
    print(summary(rows))
    print("\n## Dry-run (single-pod 16x16 = 256 fake ranks)\n")
    print(dryrun_table(rows, "single"))
    print("\n## Dry-run (multi-pod 2x16x16 = 512 fake ranks)\n")
    print(dryrun_table(rows, "multi"))
    print("\n## Roofline on the H100 (single-pod, two-point probe)\n")
    print(roofline_table(rows, "single"))


if __name__ == "__main__":
    main()
