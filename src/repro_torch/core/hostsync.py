"""Deliberate device→host synchronization funnel.

Every host sync on the join-engine hot path goes through :func:`device_get`
so it is a *counted event*: tests put a :class:`SyncCounter` around a query
and assert the executor stays under a fixed budget, and that it makes
exactly as many syncs as the reference engine.  The schedule executor
batches its admission checks so the count is O(ops), not O(chunks).

``device_get`` copies every tensor leaf of a pytree (dicts, lists, tuples)
to host numpy arrays; other leaves pass through unchanged.  Counter scopes
are thread-local: a ``SyncCounter`` only observes syncs issued by the
thread that entered it.
"""
from __future__ import annotations

import threading
from collections import Counter
from typing import Any, List

import torch

__all__ = ["SyncCounter", "device_get"]

_tls = threading.local()


def _active() -> List["SyncCounter"]:
    lst = getattr(_tls, "counters", None)
    if lst is None:
        lst = _tls.counters = []
    return lst


class SyncCounter:
    """Context manager counting device→host syncs made through this funnel.

    ``count`` is the number of :func:`device_get` calls (each call may
    fetch a whole pytree: one batched fetch per op, not one per chunk);
    ``events`` records their labels in order and ``label_counts``
    aggregates them."""

    def __init__(self) -> None:
        self.count = 0
        self.events: List[str] = []
        self.label_counts: Counter = Counter()

    def __enter__(self) -> "SyncCounter":
        _active().append(self)
        return self

    def __exit__(self, *exc) -> bool:
        _active().remove(self)
        return False


def _to_host(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, tuple):  # NamedTuple
        return type(tree)(*(_to_host(v) for v in tree))
    return tree


def device_get(tree: Any, label: str = "") -> Any:
    """Copy ``tree``'s tensors to host numpy (one counted event per call)."""
    for c in _active():
        c.count += 1
        c.events.append(label)
        c.label_counts[label] += 1
    return _to_host(tree)
