#!/usr/bin/env python3
"""Split the static pass's device time, idle time and host time by the
program's spans, on one NVIDIA GPU.

    python3 scripts/static_spans.py [--workload graph500.static-cycle4-count]
        [--seed N] [--passes 10]

The deployment is the benchmark cell's (``portbench/``: its configuration,
the graph drawn from ``--seed``, the program set up as a benchmark run
sets it up, with one warm-up pass).  Then ``repro_torch.core.trace`` is
turned on inside a ``torch.profiler`` session for ``--passes`` count
passes, and the raw kineto events are reduced by :func:`reduce`:

* ``span_device_s``: device seconds by the innermost ``ctj.*`` span the
  host was in when it launched each op (the op's runtime call, matched by
  correlation id), and ``span_ops_s``: the largest ops under each span;
* ``attributed_s``: the busy time some span covers;
* ``idle_span_s``: each gap between device ops by the launching thread's
  innermost span, ``"(no span)"`` outside all;
* ``span_host_s``: host seconds in each span, nested spans included.

The row counters of the profiled passes come from
``StaticCLFTJ.read_counters()``, and ``calls``, their launches by op and
path (``expand_calls_cuda``, ``tier2_insert_calls_cuda`` ...), from the
engine's ``stats``.  The script prints one JSON object, each
figure over all the passes.  A span's range that kineto records again on
the device timeline is not counted as a device op.
"""
from __future__ import annotations

import argparse
import bisect
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT / "src", ROOT / "portbench"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from harness.trace import _gaps, _innermost, union_length  # noqa: E402

PREFIX = "ctj."
NO_SPAN = "(no span)"
RUNTIME = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset")


def _lookup(pieces: List[Tuple[int, int, str]], t: int) -> Optional[str]:
    """The name of the piece (time-ordered, disjoint) that holds ``t``."""
    i = bisect.bisect_right([p[0] for p in pieces], t) - 1
    return pieces[i][2] if i >= 0 and t < pieces[i][1] else None


def _split(gaps, pieces, rest: str) -> Dict[str, float]:
    """Seconds of ``gaps`` under each name of ``pieces``; ``rest`` takes
    what no piece covers."""
    out: Dict[str, float] = {}
    for gs, ge in gaps:
        covered = 0
        for ps, pe, nm in pieces:
            ov = min(pe, ge) - max(ps, gs)
            if ov > 0:
                out[nm] = out.get(nm, 0.0) + ov / 1e9
                covered += ov
        if ge - gs > covered:
            out[rest] = out.get(rest, 0.0) + (ge - gs - covered) / 1e9
    return out


def reduce(events, t0: int, t1: int, top: int = 4) -> dict:
    """Reduce raw kineto events (``name``, ``start_ns``, ``duration_ns``,
    ``device_type``, ``start_thread_id``, ``correlation_id``) over the
    window ``[t0, t1)`` ns to the figures above."""
    from torch.autograd import DeviceType
    device: List[Tuple[int, int, int, str]] = []   # start, end, corr, name
    marked: Dict[int, list] = {}                  # spans by thread
    runtime: Dict[int, Tuple[int, int]] = {}      # corr -> (tid, start)
    launches: Dict[int, int] = {}
    for e in events:
        s, d, name = e.start_ns(), e.duration_ns(), e.name()
        if e.device_type() == DeviceType.CUDA:
            if d > 0 and not name.startswith(PREFIX):
                device.append((s, s + d, e.correlation_id(), name))
            continue
        tid = e.start_thread_id()
        if name.startswith(PREFIX):
            marked.setdefault(tid, []).append((s, s + max(d, 0), name))
        elif name.startswith(RUNTIME):
            runtime[e.correlation_id()] = (tid, s)
            launches[tid] = launches.get(tid, 0) + 1
    pieces = {t: sorted(_innermost(v)) for t, v in marked.items()}
    clipped = [(max(s, t0), min(e, t1), c, n) for s, e, c, n in device
               if e > t0 and s < t1]
    span_dev: Dict[str, float] = {}
    span_ops: Dict[str, Dict[str, float]] = {}
    covered = []
    for s, e, corr, name in clipped:
        at = runtime.get(corr)
        nm = _lookup(pieces.get(at[0], []), at[1]) if at else None
        key = nm or NO_SPAN
        ops = span_ops.setdefault(key, {})
        ops[name] = ops.get(name, 0.0) + (e - s) / 1e9
        if nm is not None:
            span_dev[nm] = span_dev.get(nm, 0.0) + (e - s) / 1e9
            covered.append((s, e))
    busy = [(s, e) for s, e, _, _ in clipped]
    tid = (max(launches, key=launches.get) if launches else
           max(marked, key=lambda k: len(marked[k]), default=None))
    host: Dict[str, float] = {}
    for s, e, nm in marked.get(tid, []):
        host[nm] = host.get(nm, 0.0) + max(0, min(e, t1) - max(s, t0)) / 1e9
    return {
        "window_s": (t1 - t0) / 1e9,
        "busy_s": union_length(busy) / 1e9,
        "attributed_s": union_length(covered) / 1e9,
        "span_device_s": span_dev,
        "idle_span_s": (_split(_gaps(busy, t0, t1), pieces.get(tid, []),
                               NO_SPAN) if busy else {}),
        "span_host_s": host,
        "span_ops_s": {k: sorted(v.items(), key=lambda kv: -kv[1])[:top]
                       for k, v in span_ops.items()},
    }


def profile_passes(cell, seed: int, passes: int, device: str) -> dict:
    """Set the cell's program up, then profile ``passes`` count passes
    with the program's spans and counters on."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from harness import graphs
    from harness.drivers import open_program
    from repro_torch.core import trace

    raw = graphs.draw(cell.config["graph"], seed)
    prog = open_program(cell, raw, seed, device)
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if prog.device.type == "cuda" else [])
    prog.static.read_counters()
    calls0 = dict(prog.static.stats)
    try:
        trace.enable(True)
        with profile(activities=acts) as prof:
            t0 = time.time_ns()
            recs = [prog._static_one() for _ in range(passes)]
            prog.sync()
            t1 = time.time_ns()
    finally:
        trace.enable(False)
    out = reduce(prof.profiler.kineto_results.events(), t0, t1)
    out.update(passes=passes, seed=seed, counts=[r.n for r in recs],
               errors=[r.error for r in recs],
               counters=prog.static.read_counters(),
               calls={k: n - calls0.get(k, 0)
                      for k, n in prog.static.stats.items() if "_calls_" in k})
    if prog.device.type == "cuda":
        out["device"] = torch.cuda.get_device_name(prog.device)
    prog.close()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="graph500.static-cycle4-count")
    ap.add_argument("--seed", type=int, default=3600000077)
    ap.add_argument("--passes", type=int, default=10)
    args = ap.parse_args(argv)
    import torch
    from harness import spec
    if not torch.cuda.is_available():
        print("static_spans: CUDA is not available", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    print(json.dumps(profile_passes(cell, args.seed, args.passes, "cuda")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
