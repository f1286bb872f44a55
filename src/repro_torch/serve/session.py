"""Concurrent query sessions over one device-serial worker.

Many clients, one device: :class:`JoinServer` admits up to
``max_sessions`` in-flight sessions (submit past the bound raises
:class:`SessionRejected` carrying a load-derived ``retry_after_s``), and
a single worker thread executes admitted sessions FIFO — the engines are
host-stateful and the device is serial, so parallel execution would only
interleave destructively.  Concurrency that *does* pay lives elsewhere:
per-session result queues are bounded (a slow consumer back-pressures
the worker, not the device memory), result blocks leave the device
through ``evaluate_stream``'s async-copy queue, and every client thread
drains its own :class:`Session` independently.

Per-session accounting: a :class:`~repro_torch.core.hostsync.SyncCounter`
(thread-local, so only the worker's syncs land in it, never a client
thread's counter) and a :class:`~repro_torch.core.engine.CompileClock`
(the kernel build, if this session paid for it) wrap each execution,
engine counters are reported as per-query *deltas* (the plan-cached
engine accumulates across queries), and ``plan_cache_hit`` rides the
counters into :class:`~repro_torch.core.engine.Result`.

Reference: ``repro/serve/session.py``.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

from ..core.cq import CQ
from ..core.db import Database
from ..core.engine import CompileClock, Result
from ..core.hostsync import SyncCounter
from ..core.td import TreeDecomposition
from .plancache import PlanCache

__all__ = ["JoinServer", "Session", "SessionRejected"]

# engine counters that are levels, not monotonic totals — reported
# absolute in per-query deltas
_LEVELS = ("tier2_slab_rows", "tier2_slots")


class SessionRejected(RuntimeError):
    """Admission refused: the server is at its in-flight session bound.

    ``retry_after_s`` is the server's load-derived backoff hint (recent
    mean query latency × queue depth)."""

    def __init__(self, msg: str, retry_after_s: float):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


class _Cancelled(Exception):
    pass


class Session:
    """One admitted query: a bounded block queue the worker fills and the
    client drains (``blocks()``), plus the finished :class:`Result`
    (``result()``).  ``order`` is the *requester-facing* column order —
    the cached engine's canonical order relabeled back to the client's
    variable names."""

    _SENTINEL = object()

    def __init__(self, sid: int, q: CQ, mode: str,
                 td: Optional[TreeDecomposition],
                 order: Optional[Sequence[str]], block_queue: int):
        self.id = sid
        self.query = q
        self.mode = mode
        self.td_arg = td
        self.order_arg = order
        self.state = "queued"
        self.order: Optional[Tuple[str, ...]] = None
        self.plan_cache_hit: Optional[bool] = None
        self.sync: Optional[SyncCounter] = None
        self.op_runs: Optional[Dict[str, int]] = None
        self._blocks: "queue.Queue" = queue.Queue(maxsize=max(1, block_queue))
        self._done = threading.Event()
        self._order_ready = threading.Event()
        self._cancel = threading.Event()
        self._result: Optional[Result] = None
        self._error: Optional[BaseException] = None

    # -- client side ---------------------------------------------------
    def blocks(self) -> Iterator[np.ndarray]:
        """Yield result morsels (k, n int32, columns = ``order``) in
        production order; returns when the session completes.  Raises the
        session's error, if any, after the produced prefix."""
        while True:
            item = self._blocks.get()
            if item is self._SENTINEL:
                if self._error is not None:
                    raise self._error
                return
            yield item

    def result(self, timeout: Optional[float] = None) -> Result:
        """Block until the session finishes; raises its error if it
        failed.  For streaming sessions the result only lands once the
        worker has pushed every block, so a client must drain
        ``blocks()`` (or ``cancel()``) before/while waiting."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"session {self.id} still running")
        if self._error is not None:
            raise self._error
        assert self._result is not None
        return self._result

    def cancel(self) -> None:
        """Abandon the session: the worker stops producing at the next
        block boundary (engine stats still finalize) and the queue is
        drained so a blocked worker wakes up."""
        self._cancel.set()
        try:
            while True:
                self._blocks.get_nowait()
        except queue.Empty:
            pass

    def wait_order(self, timeout: Optional[float] = None
                   ) -> Tuple[str, ...]:
        """Block until the worker has resolved the plan (order known)."""
        if not self._order_ready.wait(timeout):
            raise TimeoutError(f"session {self.id} not yet planned")
        assert self.order is not None
        return self.order

    # -- worker side ---------------------------------------------------
    def _push(self, block: np.ndarray) -> None:
        while True:
            if self._cancel.is_set():
                raise _Cancelled()
            try:
                self._blocks.put(block, timeout=0.05)
                return
            except queue.Full:
                continue

    def _finish(self, result: Optional[Result],
                error: Optional[BaseException]) -> None:
        self._result = result
        self._error = error
        self.state = ("done" if error is None else
                      "cancelled" if isinstance(error, _Cancelled)
                      else "failed")
        self._order_ready.set()
        self._done.set()
        while True:  # sentinel must land even past a full queue
            if self._cancel.is_set():
                try:
                    while True:
                        self._blocks.get_nowait()
                except queue.Empty:
                    pass
            try:
                self._blocks.put(self._SENTINEL, timeout=0.05)
                return
            except queue.Full:
                continue


class JoinServer:
    """Long-lived query server: plan cache + persistent tier-2 tables +
    admission-bounded concurrent sessions.

    ``submit``/``evaluate_stream`` return a :class:`Session`;
    ``count``/``evaluate`` are synchronous conveniences.  ``config`` is a
    :class:`~repro_torch.configs.paper_clftj.JoinEngineConfig` (default
    ``GPU_SERVE``); engines live on ``device`` (the card unless the caller
    asks for the CPU).  ``save_snapshot``/``load_snapshot`` persist the
    warm tables across processes (:mod:`persist`)."""

    def __init__(self, db: Database, config=None, *,
                 max_sessions: int = 8, max_plans: int = 64,
                 block_queue: int = 64, device="cuda"):
        self.plan_cache = PlanCache(db, config, max_plans=max_plans,
                                    device=device)
        self.db = db
        self.max_sessions = int(max_sessions)
        self.block_queue = int(block_queue)
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._pending: "deque[Session]" = deque()
        self._exec_lock = threading.Lock()  # engines are single-threaded
        self._closed = False
        self._next_sid = 0
        self.in_flight = 0
        self.in_flight_high_water = 0
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.rejected = 0
        self._ewma_s: Optional[float] = None
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="join-server-worker")
        self._worker.start()

    # -- admission -----------------------------------------------------
    def submit(self, q: CQ, mode: str = "stream",
               td: Optional[TreeDecomposition] = None,
               order: Optional[Sequence[str]] = None) -> Session:
        """Admit one query session (``mode``: "stream" | "evaluate" |
        "count").  Raises :class:`SessionRejected` past the in-flight
        bound — in-flight means admitted and not yet finished, so slow
        *consumers* hold their slot (back-pressure reaches admission)."""
        if mode not in ("stream", "evaluate", "count"):
            raise ValueError(f"unknown session mode {mode!r}")
        with self._wake:
            if self._closed:
                raise RuntimeError("server is closed")
            if self.in_flight >= self.max_sessions:
                self.rejected += 1
                depth = self.in_flight + len(self._pending)
                retry = (self._ewma_s or 0.05) * max(1, depth)
                raise SessionRejected(
                    f"at capacity ({self.in_flight}/{self.max_sessions} "
                    f"sessions in flight); retry in ~{retry:.3f}s", retry)
            self.in_flight += 1
            self.in_flight_high_water = max(self.in_flight_high_water,
                                            self.in_flight)
            self.submitted += 1
            self._next_sid += 1
            sess = Session(self._next_sid, q, mode, td, order,
                           self.block_queue)
            self._pending.append(sess)
            self._wake.notify()
        return sess

    # -- synchronous conveniences --------------------------------------
    def count(self, q: CQ, td=None, order=None) -> Result:
        return self.submit(q, "count", td, order).result()

    def evaluate(self, q: CQ, td=None, order=None) -> Result:
        return self.submit(q, "evaluate", td, order).result()

    def evaluate_stream(self, q: CQ, td=None, order=None) -> Session:
        return self.submit(q, "stream", td, order)

    # -- persistence (serialized against query execution) --------------
    def save_snapshot(self, path: str) -> str:
        from .persist import save_snapshot

        with self._exec_lock:
            return save_snapshot(path, self.plan_cache)

    def load_snapshot(self, path: str) -> Dict[str, int]:
        from .persist import load_snapshot

        with self._exec_lock:
            return load_snapshot(path, self.plan_cache)

    # -- worker --------------------------------------------------------
    def _run(self) -> None:
        while True:
            with self._wake:
                while not self._pending and not self._closed:
                    self._wake.wait()
                if self._closed and not self._pending:
                    return
                sess = self._pending.popleft()
            self._execute(sess)

    def _execute(self, sess: Session) -> None:
        t0 = time.perf_counter()
        sess.state = "running"
        result: Optional[Result] = None
        error: Optional[BaseException] = None
        try:
            with self._exec_lock:
                entry, hit, pos = self.plan_cache.lookup(
                    sess.query, sess.td_arg, sess.order_arg)
                inv = {f"v{i}": v for v, i in pos.items()}
                sess.order = tuple(inv[c] for c in entry.order)
                sess.plan_cache_hit = hit
                sess._order_ready.set()
                eng = entry.engine
                entry.queries += 1
                s0 = dict(eng.stats)
                tuples = None
                sc = SyncCounter()
                cc = CompileClock()
                with cc, sc:
                    if sess.mode == "count":
                        n = eng.count()
                    elif sess.mode == "evaluate":
                        blocks = list(eng.evaluate())
                        tuples = (np.concatenate(blocks, axis=0) if blocks
                                  else np.zeros((0, len(entry.order)),
                                                np.int32))
                        n = tuples.shape[0]
                    else:
                        n = 0
                        gen = eng.evaluate_stream()
                        try:
                            for block in gen:
                                n += block.shape[0]
                                sess._push(block)
                        finally:
                            gen.close()  # always fold stats (_finalize)
                sess.sync = sc
                sess.op_runs = dict(getattr(eng, "last_executor", None)
                                    and eng.last_executor.op_runs or {})
                s1 = dict(eng.stats)
            counters = {k: v - s0.get(k, 0) for k, v in s1.items()
                        if isinstance(v, int) and k not in _LEVELS}
            counters.update({k: s1[k] for k in _LEVELS if k in s1})
            counters["plan_cache_hit"] = int(hit)
            t1 = time.perf_counter()
            # a miss paid the plan build inside this window (the lookup);
            # split it out the way the one-shot facade does, so cold/warm
            # latency decompositions stay comparable
            plan_s = 0.0 if hit else entry.build_s
            compile_s = cc.total
            wall = t1 - t0
            result = Result(
                count=n, tuples=tuples, algorithm="clftj",
                device=str(self.plan_cache.device),
                order=sess.order, td=entry.td, counters=counters,
                wall_s=wall, plan_s=plan_s, compile_s=compile_s,
                exec_s=max(0.0, wall - plan_s - compile_s))
        except BaseException as e:  # noqa: BLE001 — reported to the client
            error = e
        finally:
            with self._wake:
                self.in_flight -= 1
                if error is None or isinstance(error, _Cancelled):
                    self.completed += 1
                else:
                    self.failed += 1
                dt = time.perf_counter() - t0
                self._ewma_s = (dt if self._ewma_s is None
                                else 0.7 * self._ewma_s + 0.3 * dt)
            sess._finish(result, error)

    # -- lifecycle -----------------------------------------------------
    def stats(self) -> Dict[str, object]:
        with self._lock:
            out = {"submitted": self.submitted, "completed": self.completed,
                   "failed": self.failed, "rejected": self.rejected,
                   "in_flight": self.in_flight,
                   "in_flight_high_water": self.in_flight_high_water,
                   "queued": len(self._pending),
                   "max_sessions": self.max_sessions}
        out["plan_cache"] = self.plan_cache.stats()
        return out

    def close(self, timeout: Optional[float] = 30.0) -> None:
        """Drain pending sessions, then stop the worker."""
        with self._wake:
            self._closed = True
            self._wake.notify_all()
        self._worker.join(timeout)

    def __enter__(self) -> "JoinServer":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
