"""One run of one cell: set-up, the measured window, the comparison with
the reference, and the result line.

:func:`run` is everything a run does after the check for a card, so the
tests drive it on the CPU with a small deployment and a program broken
underneath.
"""
from __future__ import annotations

import gc
import json
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from . import graphs
from .drivers import Record, open_program
from .queries import canonical_rows, shape_key
from .reference import Reference, row_difference
from .spec import ROOT, Cell, readers
from .trace import Profiler

__all__ = ["Window", "run", "report", "checks", "passed",
           "forbidden_modules", "FORBIDDEN"]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
# the caching allocator's counters printed for the window (diagnostics)
_ALLOC = ("num_alloc_retries", "num_device_alloc", "num_device_free")


@dataclass
class Window:
    """What a metric reader reads: the window's queries and the readings
    taken around it."""

    cell: Cell
    setup_s: float
    window_s: float
    records: List[Record]           # the window's queries, as completed
    server_before: Optional[dict]   # JoinServer.stats() at the opening
    server_after: Optional[dict]    # ... and at the close
    peak_bytes: int                 # allocator peak over the window
    trace: Optional[dict]           # trace.Profiler.summary(), traced runs

    @property
    def queries(self) -> int:
        return len(self.records)

    def ok(self) -> List[Record]:
        return [r for r in self.records if r.error is None]


def forbidden_modules() -> List[str]:
    """The loaded modules whose top-level name is one the benchmark's
    process must never hold."""
    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})


def _peak(device) -> int:
    import torch
    return (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)


def checks(cell: Cell, ref: Reference, records: List[Record],
           window: List[Record]) -> Dict[str, dict]:
    """Every answer due, against the reference: each count (or number of
    rows streamed), each kept row set, and the queries that failed.  Each
    number with its limit."""
    specs = {shape_key(q): q for q in cell.traffic["queries"]}
    wrong, wrong_sets, diff, checked = 0, 0, 0, 0
    for r in records:
        if r.error is not None:
            continue
        spec = specs[r.query.shape]
        if r.n != ref.count(spec) or r.overflow:
            wrong += 1
        if r.rows is not None:
            checked += 1
            d = row_difference(canonical_rows(r.query, r.order, r.rows),
                               ref.rows(spec), ref.nv)
            wrong_sets += d > 0
            diff += d
    out = {"wrong_answers": {"value": wrong, "limit": 0},
           "failed_queries": {"value": sum(r.error is not None
                                           for r in records), "limit": 0}}
    if cell.traffic.get("row_sample", 0) > 0:
        out["row_sets_checked"] = {"value": checked, "limit": 1,
                                   "at_least": True}
        out["wrong_row_sets"] = {"value": wrong_sets, "limit": 0}
        out["rows_differing"] = {"value": diff, "limit": 0}
    if not window:
        out["window_queries"] = {"value": 0, "limit": 1, "at_least": True}
    return out


def passed(chk: Dict[str, dict]) -> bool:
    return all(c["value"] >= c["limit"] if c.get("at_least")
               else c["value"] <= c["limit"] for c in chk.values())


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: Optional[float] = None) -> dict:
    """One run; returns the result line's object (``"checks"`` last)."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    g = cell.config["graph"]
    nv = graphs.vertices(g)
    raw = graphs.draw(g, seed)
    prog = open_program(cell, raw, seed, device)
    dev = prog.device
    mets = cell.per_layer if trace else cell.end_to_end
    read = readers(mets)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_peak = _peak(dev)
    before = prog.server_stats()
    alloc0 = torch.cuda.memory_stats(dev) if dev.type == "cuda" else {}
    with Profiler(trace, ROOT / "src" / "repro_torch" / "csrc") as prof:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        prof.mark("open")
        t_open = time.perf_counter()
        records = prog.window(seed, seconds)
        prog.sync()
        t_close = max((r.t_done for r in records),
                      default=time.perf_counter())
        prof.mark("close")
    window_peak = _peak(dev)
    print("portbench: window " + " ".join(
        f"{r.query.shape}:{r.latency_s:.3f}" for r in records),
        file=sys.stderr, flush=True)
    if dev.type == "cuda":
        stats = torch.cuda.memory_stats(dev)
        print("portbench: allocator " + " ".join(
            f"{k}={stats.get(k, 0) - alloc0.get(k, 0)}" for k in _ALLOC),
            file=sys.stderr, flush=True)
    after = prog.server_stats()
    summary = prof.summary()
    win = Window(cell=cell, setup_s=t_open - t_start,
                 window_s=t_close - t_open, records=records,
                 server_before=before, server_after=after,
                 peak_bytes=window_peak, trace=summary)
    metrics = {}
    for m in mets:
        value = read[m["name"]](win)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    warm = prog.warmup
    prog.close()
    del prog
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = Reference(raw, nv, bool(g.get("symmetrize", False)))
    chk = checks(cell, ref, warm + records, records)
    failed = sum(r.error is not None for r in records)
    device_out = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                  "kind": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"),
                  "count": cell.chips,
                  "memory_peak_bytes": max(setup_peak, window_peak)}
    if trace:
        device_out["busy_s"] = summary["busy_s"] if summary else 0.0
        device_out["window_s"] = win.window_s
    line = {"correct": passed(chk), "attempted": len(records),
            "failed": failed, "metrics": metrics, "device": device_out}
    if trace and summary:
        line["breakdown"] = summary["breakdown"]
    line["checks"] = chk
    return line


def report(line: dict) -> None:
    """The checks as the last lines of standard error, then the result
    line as the last line of standard output."""
    for name, c in line["checks"].items():
        rel = ">=" if c.get("at_least") else "<="
        print(f"check {name}: {c['value']} (limit {rel} {c['limit']})",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
