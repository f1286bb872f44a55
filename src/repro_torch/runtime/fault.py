"""Fault-tolerance runtime: preemption handling, straggler watch, retries.

A copy of the reference's ``repro/runtime/fault.py`` (it imports no JAX;
the port keeps its own copy), with ``PreemptionGuard.uninstall``, which
the training loop calls on its way out so that a process that trains
and goes on keeps its own SIGTERM handler.

On a real fleet this wraps the per-host training process: SIGTERM (the
standard preemption notice) triggers a final synchronous checkpoint; a
watchdog thread flags steps that exceed a multiple of the trailing median
step time (straggling host / hung collective) so the launcher can restart
the slow worker; ``retry`` wraps transient-failure-prone calls.
"""
from __future__ import annotations

import signal
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional


class PreemptionGuard:
    """Installs SIGTERM/SIGINT handlers that request a graceful stop."""

    def __init__(self):
        self._stop = threading.Event()
        self._orig = {}

    def install(self) -> "PreemptionGuard":
        for sig in (signal.SIGTERM,):
            try:
                self._orig[sig] = signal.signal(sig, self._handler)
            except ValueError:      # non-main thread (tests)
                pass
        return self

    def uninstall(self) -> None:
        """Put back the handlers that ``install`` replaced."""
        while self._orig:
            sig, handler = self._orig.popitem()
            signal.signal(sig, handler)

    def _handler(self, signum, frame):
        self._stop.set()

    def request_stop(self) -> None:
        self._stop.set()

    @property
    def should_stop(self) -> bool:
        return self._stop.is_set()


@dataclass
class StragglerWatch:
    """Flags steps slower than ``factor`` x trailing-median step time."""

    factor: float = 3.0
    window: int = 32
    history: List[float] = field(default_factory=list)
    flagged: int = 0
    on_flag: Optional[Callable[[float, float], None]] = None

    def observe(self, step_seconds: float) -> bool:
        hist = self.history[-self.window:]
        slow = False
        if len(hist) >= 8:
            med = sorted(hist)[len(hist) // 2]
            if step_seconds > self.factor * med:
                self.flagged += 1
                slow = True
                if self.on_flag:
                    self.on_flag(step_seconds, med)
        self.history.append(step_seconds)
        return slow


def retry(fn: Callable, attempts: int = 3, backoff_s: float = 0.5,
          exceptions=(RuntimeError, OSError)):
    """Retry transient failures with exponential backoff."""
    last = None
    for i in range(attempts):
        try:
            return fn()
        except exceptions as e:      # pragma: no cover - timing dependent
            last = e
            time.sleep(backoff_s * (2 ** i))
    raise last
