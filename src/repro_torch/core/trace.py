"""Named spans of the static join, for a ``torch.profiler`` trace.

Tracing is off by default.  Off, :func:`span` returns one shared no-op
context and runs nothing else, so an untraced pass dispatches exactly the
ops it would without this module.  On (:func:`enable`), :func:`span`
returns ``torch.profiler.record_function(name)``: the span lands in the
profiler's own kineto trace beside the device ops the host launched inside
it, on the trace's clock, and the profiler keeps it in memory until it
stops.  Outside a profiler session a span records nothing.

Span names are fixed strings, ``ctj.<layer>.<what>``:

* ``ctj.initial_frontier`` — the engine's initial chunk, filled on the host
  and copied to the device;
* ``ctj.pass`` — one ``StaticCLFTJ`` pass; inside it ``ctj.tables`` (fresh
  tier-2 tables), and one span a schedule op: ``ctj.expand``, ``ctj.enter``
  (key packing) holding ``ctj.tier2.probe`` and ``ctj.tier1.dedup``,
  ``ctj.fold`` holding ``ctj.tier2.insert``, and ``ctj.emit``.

While tracing is on, ``schedule.execute_static`` also counts rows on the
device (``StaticCLFTJ.read_counters`` fetches them).
"""
from __future__ import annotations

import contextlib

__all__ = ["PREFIX", "enable", "enabled", "span"]

PREFIX = "ctj."
_NULL = contextlib.nullcontext()
_on = False


def enable(on: bool) -> None:
    """Turn the spans (and the static pass's row counters) on or off."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def span(name: str):
    """A context naming the work inside it ``name`` in a profiler trace;
    the shared no-op context while tracing is off."""
    if not _on:
        return _NULL
    from torch.profiler import record_function
    return record_function(name)
