"""Render the dry-run's tables from its JSON results.

    PYTHONPATH=src python -m repro_torch.launch.report dryrun_results.json

The counterpart of the reference's ``repro/launch/report.py``: the
summary and the per-mesh memory tables, with each rank's peak beside its
argument and temporary bytes (a fake-group dry-run: no card measured
them).  The reference's roofline table waits for the port's roofline
(ROADMAP Queue 1, item 4f).
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


if __name__ == "__main__":
    main()
