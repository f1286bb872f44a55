"""Device time from a ``torch.profiler`` trace of the measured window.

The raw kineto events are read directly (``prof.key_averages()`` builds
the profiler's whole event tree first, which is slow on a window of many
thousands of launches); this follows ``chip_smoke.py::device_ops``.

* ``busy_s`` is the length of the union of the device ops' intervals (a
  copy that overlaps a kernel on another stream counts once);
* ``ops`` sums each device op's time by name;
* ``port_s`` is the time of the program's own CUDA kernels, those
  defined in ``src/repro_torch/csrc/*.cu`` (their names are read from
  the sources, so a kernel a later change adds counts here too), and
  ``other_s`` the time of every other device op: PyTorch's kernels,
  copies and memsets;
* ``idle_gaps`` says what the host was doing while the device was idle:
  the innermost host op (or ``python`` outside any op) of the thread
  that launched the most device work, summed by name.
"""
from __future__ import annotations

import re
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

__all__ = ["Profiler", "port_kernel_names", "kernel_id", "union_length"]

_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")


def port_kernel_names(csrc: Path) -> frozenset:
    """The names of the ``__global__`` kernels defined under ``csrc``."""
    names = set()
    for p in sorted(csrc.glob("*.cu")):
        names.update(_GLOBAL.findall(p.read_text()))
    return frozenset(names)


def kernel_id(name: str) -> str:
    """A device op's function name without its return type, namespace,
    template arguments and parameter list."""
    head = name.split("(", 1)[0].split("<", 1)[0].strip()
    return head.split()[-1].split("::")[-1] if head else name


def union_length(spans: List[Tuple[int, int]]) -> int:
    """Total length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _gaps(spans: List[Tuple[int, int]], t0: int, t1: int
          ) -> List[Tuple[int, int]]:
    out, at = [], t0
    for s, e in sorted(spans):
        if s > at:
            out.append((at, min(s, t1)))
        at = max(at, e)
        if at >= t1:
            break
    if at < t1:
        out.append((at, t1))
    return [(s, e) for s, e in out if e > s]


def _innermost(events) -> List[Tuple[int, int, str]]:
    """A thread's host ops as non-overlapping ``(start, end, name)``
    pieces, each piece named by the innermost op that covers it."""
    pieces: List[Tuple[int, int, str]] = []
    stack: List[Tuple[int, str]] = []   # (end, name)
    at = None
    for s, e, name in sorted(events, key=lambda t: (t[0], -t[1])):
        while stack and stack[-1][0] <= s:
            end, nm = stack.pop()
            if at is not None and end > at:
                pieces.append((at, end, nm))
            at = end if at is None else max(at, end)
        if stack and at is not None and s > at:
            pieces.append((at, s, stack[-1][1]))
        stack.append((e, name))
        at = s
    while stack:
        end, nm = stack.pop()
        if end > at:
            pieces.append((at, end, nm))
            at = end
    return pieces


class Profiler:
    """``torch.profiler`` around the window when ``on``; a no-op
    otherwise.  ``summary()`` reduces the trace once it has stopped."""

    def __init__(self, on: bool, csrc: Path):
        self.on = on
        self.csrc = csrc
        self.prof = None
        self.t0 = self.t1 = 0

    def __enter__(self) -> "Profiler":
        if self.on:
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
        return self

    def mark(self, which: str) -> None:
        """Note the window's opening or close on the trace's clock."""
        if which == "open":
            self.t0 = time.time_ns()
        else:
            self.t1 = time.time_ns()

    def __exit__(self, *exc) -> bool:
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    def summary(self) -> Optional[dict]:
        if self.prof is None:
            return None
        from torch.autograd import DeviceType
        port = port_kernel_names(self.csrc)
        ops: Dict[str, List[float]] = {}
        spans: List[Tuple[int, int]] = []
        port_ns = other_ns = 0
        host: Dict[int, list] = {}
        launches: Dict[int, int] = {}
        for e in self.prof.profiler.kineto_results.events():
            s, d = e.start_ns(), e.duration_ns()
            if e.device_type() == DeviceType.CUDA:
                if d <= 0:
                    continue
                name = e.name()
                spans.append((s, s + d))
                rec = ops.setdefault(name, [0.0, 0])
                rec[0] += d / 1e9
                rec[1] += 1
                if kernel_id(name) in port:
                    port_ns += d
                else:
                    other_ns += d
            else:
                tid = e.start_thread_id()
                name = e.name()
                host.setdefault(tid, []).append((s, s + max(d, 0), name))
                if name.startswith(("cudaLaunch", "cuLaunch",
                                    "cudaMemcpy", "cudaMemset")):
                    launches[tid] = launches.get(tid, 0) + 1
        t0 = self.t0 or min((s for s, _ in spans), default=0)
        t1 = self.t1 or max((e for _, e in spans), default=0)
        busy_ns = union_length([(max(s, t0), min(e, t1)) for s, e in spans
                                if e > t0 and s < t1])
        idle: Dict[str, float] = {}
        if launches:
            tid = max(launches, key=launches.get)
            pieces = _innermost([ev for ev in host[tid]
                                 if not ev[2].startswith(("cuda", "cu"))])
            j = 0
            for gs, ge in _gaps(spans, t0, t1):
                covered = 0
                while j < len(pieces) and pieces[j][1] <= gs:
                    j += 1
                k = j
                while k < len(pieces) and pieces[k][0] < ge:
                    ps, pe, nm = pieces[k]
                    ov = min(pe, ge) - max(ps, gs)
                    if ov > 0:
                        idle[nm] = idle.get(nm, 0.0) + ov / 1e9
                        covered += ov
                    k += 1
                idle["python"] = idle.get("python", 0.0) + (
                    ge - gs - covered) / 1e9
        top_ops = sorted(ops.items(), key=lambda kv: -kv[1][0])[:10]
        top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
        return {"busy_s": busy_ns / 1e9, "window_ns": (t0, t1),
                "port_s": port_ns / 1e9, "other_s": other_ns / 1e9,
                "ops": {k: (v[0], v[1]) for k, v in ops.items()},
                "breakdown": {
                    "device_ops": [[k[:160], v[0]] for k, v in top_ops],
                    "idle_gaps": [[k[:160], v] for k, v in top_idle]}}
