"""Deliberate device→host synchronization funnel + the async emit queue.

Every host sync on the join-engine hot path goes through :func:`device_get`
so it is a *counted event*: tests put a :class:`SyncCounter` around a query
and assert the executor stays under a fixed budget, and that it makes
exactly as many syncs as the reference engine.  The schedule executor
batches its admission checks so the count is O(ops), not O(chunks).

``device_get`` copies every tensor leaf of a pytree (dicts, lists, tuples)
to host numpy arrays; other leaves pass through unchanged.

**Async fetches.**  :func:`device_get_async` *issues* the device→host copy
and returns an :class:`AsyncFetch`: on a CUDA tensor a ``non_blocking``
copy into pinned host memory followed by a ``torch.cuda.Event`` recorded
on the current stream (so the event completes once the copy has landed);
on a CPU tensor an immediate copy.  :class:`AsyncFetchQueue` bounds how
many fetches are in flight and keeps FIFO arrival order.

Accounting rules:

* ``SyncCounter.count`` counts **blocking** syncs only;
* an async *issue* increments ``SyncCounter.async_count`` and rides
  ``events``/``label_counts`` under its own label;
* *completing* an async fetch (``AsyncFetch.get``) is not a counted event.

Counter scopes are thread-local: a ``SyncCounter`` only observes syncs
issued by the thread that entered it.
"""
from __future__ import annotations

import threading
from collections import Counter, deque
from typing import Any, Callable, Deque, Dict, Iterator, List, Tuple

import numpy as np
import torch

__all__ = ["SyncCounter", "device_get", "device_get_async", "AsyncFetch",
           "AsyncFetchQueue"]

_tls = threading.local()


def _active() -> List["SyncCounter"]:
    lst = getattr(_tls, "counters", None)
    if lst is None:
        lst = _tls.counters = []
    return lst


class SyncCounter:
    """Context manager counting device→host syncs made through this funnel.

    ``count`` is the number of blocking :func:`device_get` calls (each
    call may fetch a whole pytree: one batched fetch per op, not one per
    chunk); ``async_count`` the number of :func:`device_get_async`
    issues; ``events`` records the labels of both in order and
    ``label_counts`` aggregates them."""

    def __init__(self) -> None:
        self.count = 0
        self.async_count = 0
        self.events: List[str] = []
        self.label_counts: Counter = Counter()

    def __enter__(self) -> "SyncCounter":
        _active().append(self)
        return self

    def __exit__(self, *exc) -> bool:
        _active().remove(self)
        return False


def _tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if isinstance(tree, tuple):  # NamedTuple
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    return fn(tree)


def _to_host(tree: Any) -> Any:
    return _tree_map(
        lambda t: t.cpu().numpy() if isinstance(t, torch.Tensor) else t,
        tree)


def _record(label: str, blocking: bool) -> None:
    for c in _active():
        if blocking:
            c.count += 1
        else:
            c.async_count += 1
        c.events.append(label)
        c.label_counts[label] += 1


def device_get(tree: Any, label: str = "") -> Any:
    """Copy ``tree``'s tensors to host numpy (one counted event per call)."""
    _record(label, blocking=True)
    return _to_host(tree)


# ---------------------------------------------------------------------------
# Async fetches (streaming emit)
# ---------------------------------------------------------------------------


class AsyncFetch:
    """Handle for one issued device→host copy of a pytree.

    ``tree`` holds the host-side destinations: pinned CPU tensors filled
    by ``non_blocking`` copies (CUDA leaves) or finished copies (CPU
    leaves).  ``events`` are recorded after the copies were enqueued, so
    once they complete the host values are final."""

    __slots__ = ("tree", "label", "events")

    def __init__(self, tree: Any, label: str, events: List[Any]):
        self.tree = tree
        self.label = label
        self.events = events

    def ready(self) -> bool:
        """True once every copy of this fetch has landed (no blocking)."""
        return all(e.query() for e in self.events)

    def get(self) -> Any:
        """The host values (numpy), waiting for the copies to land."""
        for e in self.events:
            e.synchronize()
        return _to_host(self.tree)


def device_get_async(tree: Any, label: str = "") -> AsyncFetch:
    """Issue a non-blocking device→host copy of ``tree``; counted as an
    *async* event (``SyncCounter.async_count``), not a blocking sync."""
    devices = set()

    def issue(t: Any) -> Any:
        if not isinstance(t, torch.Tensor):
            return t
        if not t.is_cuda:
            return t.detach().clone()
        devices.add(t.device)
        dst = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        dst.copy_(t, non_blocking=True)
        return dst

    host = _tree_map(issue, tree)
    events = []
    for dev in devices:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        events.append(ev)
    _record(label, blocking=False)
    return AsyncFetch(host, label, events)


class AsyncFetchQueue:
    """Bounded FIFO of in-flight async fetches (the streaming emit queue).

    ``put`` issues a new fetch; when the bound is reached the *oldest*
    fetch is completed first (back-pressure: at most ``max_in_flight``
    blocks are in flight).  ``poll`` pops fetches whose copies have
    landed without blocking; ``drain`` completes everything.  All three
    return host pytrees in issue order.

    ``double_buffer=True`` makes completions land in a ring of host
    staging arrays per (shape, dtype), one slot per possible in-flight
    fetch, so repeated same-shape blocks stop allocating a fresh host
    array each.  The returned arrays are *recycled*: a consumer must copy
    what it keeps before issuing or completing further fetches of the
    same shape.

    :meth:`reset` rezeroes the per-pass accounting (``issued``,
    ``high_water``, ``labels``) so a reused queue reports each pass's
    issue counts alone."""

    def __init__(self, max_in_flight: int = 8, double_buffer: bool = False):
        if max_in_flight < 1:
            raise ValueError("max_in_flight must be >= 1")
        self.max_in_flight = int(max_in_flight)
        self.double_buffer = bool(double_buffer)
        self._q: Deque[AsyncFetch] = deque()
        self.issued = 0
        self.high_water = 0  # max simultaneous in-flight fetches observed
        self.labels: Counter = Counter()  # per-label issue counts (per pass)
        # (shape, dtype) -> ring of staging buffers; rotated per completion
        self._rings: Dict[Tuple, List[np.ndarray]] = {}
        self._ring_pos: Dict[Tuple, int] = {}

    @property
    def in_flight(self) -> int:
        return len(self._q)

    def reset(self) -> None:
        """Rezero the per-pass accounting; refuses while fetches are in
        flight (drain them first).  Staging rings are kept."""
        if self._q:
            raise RuntimeError(
                f"reset with {len(self._q)} fetches in flight; drain first")
        self.issued = 0
        self.high_water = 0
        self.labels.clear()

    def _complete(self, fetch: AsyncFetch) -> Any:
        host = fetch.get()
        if not self.double_buffer:
            return host
        return _tree_map(self._stage, host)

    def _stage(self, leaf: Any) -> Any:
        if not isinstance(leaf, np.ndarray) or leaf.ndim == 0:
            return leaf
        key = (leaf.shape, str(leaf.dtype))
        ring = self._rings.get(key)
        if ring is None:
            # one slot per possible in-flight fetch: a poll/drain batch can
            # complete up to max_in_flight same-shape blocks before the
            # consumer copies any of them out
            depth = max(2, self.max_in_flight)
            ring = self._rings[key] = [np.empty_like(leaf)
                                       for _ in range(depth)]
            self._ring_pos[key] = 0
        i = self._ring_pos[key]
        self._ring_pos[key] = (i + 1) % len(ring)
        np.copyto(ring[i], leaf)
        return ring[i]

    def put(self, tree: Any, label: str = "") -> List[Any]:
        """Issue one fetch; returns the host values of any fetches that had
        to be completed to stay under the in-flight bound (oldest first,
        possibly empty)."""
        done: List[Any] = []
        while len(self._q) >= self.max_in_flight:
            done.append(self._complete(self._q.popleft()))
        self._q.append(device_get_async(tree, label))
        self.issued += 1
        self.labels[label] += 1
        self.high_water = max(self.high_water, len(self._q))
        return done

    def poll(self) -> List[Any]:
        """Pop fetches from the head whose copies have landed.  FIFO: a
        ready fetch behind a still-flying one stays queued."""
        done: List[Any] = []
        while self._q and self._q[0].ready():
            done.append(self._complete(self._q.popleft()))
        return done

    def drain(self) -> Iterator[Any]:
        """Complete every remaining fetch, oldest first."""
        while self._q:
            yield self._complete(self._q.popleft())
