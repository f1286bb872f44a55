"""Compile-once plan cache: one warm engine per canonical query shape.

The facade's one-shot calls build a fresh
:class:`~repro_torch.core.cached_frontier.CachedTrieJoin` per query, so
TD planning, trie construction *and the tier-2 tables* die with every
call.  :class:`PlanCache` keeps the engine: queries are keyed by
``(canonical CQ, canonical TD, canonical order, JoinEngineConfig)`` (see
:mod:`canonical`), isomorphic queries map to the same entry, and a hit
returns an engine whose device tables are warm from every earlier query
of that shape.

The cached engine is built over the canonical variable names ``v{i}``;
``lookup`` also returns the requester's variable mapping so the caller
can relabel the engine's output order back to its own names (the tuples
need no change; only the column names differ).

Eviction is LRU over entries with a ``max_plans`` bound (``max_plans=0``
disables caching: every lookup builds afresh, the cold regime).
Lookup and registration are lock-protected; *executing* a cached engine
is not thread-safe and must be serialized by the caller (the session
layer's single worker thread; the device is serial anyway).  Engines live
on ``device`` (the card unless the caller asks for the CPU).

Reference: ``repro/serve/plancache.py``.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.cached_frontier import CachedTrieJoin
from ..core.cq import CQ
from ..core.db import Database
from ..core.decompose import choose_plan
from ..core.frontier import resolve_device
from ..core.td import TreeDecomposition
from .canonical import canonical_cq, canonical_td, config_key

__all__ = ["CachedPlan", "PlanCache"]


@dataclass
class CachedPlan:
    """One resident plan: the canonical query/TD/order and the long-lived
    engine built for them (its ``cache`` manager is the cross-query
    tier-2 state that :mod:`persist` snapshots)."""

    key: Tuple[str, str, str, str]   # (q_key, td_key, order_key, cfg_key)
    cq: CQ                           # canonical query (v{i} names)
    td: TreeDecomposition            # canonical TD
    order: Tuple[str, ...]           # canonical order
    engine: CachedTrieJoin
    schedule_sig: str                # Schedule.signature() at build time
    build_s: float = 0.0             # planning + construction seconds
    hits: int = 0
    queries: int = 0


class PlanCache:
    """LRU cache of :class:`CachedPlan` entries for one database."""

    def __init__(self, db: Database, config=None, max_plans: int = 64,
                 device="cuda"):
        if config is None:
            from ..configs.paper_clftj import GPU_SERVE
            config = GPU_SERVE
        self.db = db
        self.config = config
        self.cfg_key = config_key(config)
        self.device = resolve_device(device)
        self.max_plans = int(max_plans)
        self._plans: "OrderedDict[tuple, CachedPlan]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    # -- key derivation ------------------------------------------------
    def _canonicalize(self, q: CQ, td: Optional[TreeDecomposition],
                      order: Optional[Sequence[str]]):
        canon_q, pos, q_key = canonical_cq(q)
        if td is not None:
            ctd, td_key = canonical_td(td, pos)
        else:
            ctd, td_key = None, "auto"
        if order is not None:
            corder = tuple(f"v{pos[v]}" for v in order)
            order_key = ",".join(corder)
        else:
            corder, order_key = None, "auto"
        key = (q_key, td_key, order_key, self.cfg_key)
        return canon_q, pos, ctd, corder, key

    def _register(self, key: tuple, entry: CachedPlan) -> None:
        with self._lock:
            if self.max_plans > 0:
                self._plans[key] = entry
                self._plans.move_to_end(key)
                while len(self._plans) > self.max_plans:
                    self._plans.popitem(last=False)

    # -- lookup --------------------------------------------------------
    def lookup(self, q: CQ, td: Optional[TreeDecomposition] = None,
               order: Optional[Sequence[str]] = None
               ) -> Tuple[CachedPlan, bool, Dict[str, int]]:
        """Resolve ``(q, td, order)`` to a plan entry.

        Returns ``(entry, hit, pos)`` where ``pos`` maps the requester's
        variable names to canonical indices (the requester's column for
        canonical ``v{i}`` is the variable with ``pos[var] == i``)."""
        canon_q, pos, ctd, corder, key = self._canonicalize(q, td, order)
        with self._lock:
            entry = self._plans.get(key)
            if entry is not None:
                self._plans.move_to_end(key)
                self.hits += 1
                entry.hits += 1
                return entry, True, pos
            self.misses += 1
        # build outside the lock; duplicate builds of one key race
        # benignly (the last registration wins)
        entry = self._build(canon_q, ctd, corder, key)
        self._register(key, entry)
        return entry, False, pos

    def restore(self, q: CQ, td: TreeDecomposition, order: Sequence[str],
                td_key: str, order_key: str) -> Tuple[CachedPlan, bool]:
        """Rebuild a snapshot's plan and register it under the *writer's*
        key components.

        The snapshot stores the explicit canonical TD and order (so the
        engine rebuilds without planning) and the original ``td_key`` /
        ``order_key``, which are ``"auto"`` when the writer's clients let
        the planner choose: registering under those makes a fresh
        process's first ``td=None`` query hit the loaded plan.  Returns
        ``(entry, already_resident)``."""
        canon_q, _pos, ctd, corder, key = self._canonicalize(q, td, order)
        key = (key[0], td_key, order_key, self.cfg_key)
        with self._lock:
            entry = self._plans.get(key)
            if entry is not None:
                self._plans.move_to_end(key)
                return entry, True
        entry = self._build(canon_q, ctd, corder, key)
        self._register(key, entry)
        return entry, False

    def _build(self, canon_q: CQ, ctd: Optional[TreeDecomposition],
               corder: Optional[Tuple[str, ...]], key: tuple) -> CachedPlan:
        cfg = self.config
        t0 = time.perf_counter()
        if ctd is None or corder is None:
            td_, order_ = choose_plan(canon_q, self.db.stats(),
                                      max_adhesion=cfg.max_adhesion,
                                      limit=cfg.td_limit)
            ctd = ctd if ctd is not None else td_
            corder = corder if corder is not None else tuple(order_)
        # building an engine builds no kernel (that happens at the first
        # launch, inside the session's CompileClock)
        engine = CachedTrieJoin(
            canon_q, ctd, corder, self.db, capacity=cfg.frontier_capacity,
            dedup=cfg.dedup, cache=cfg.cache_config(), device=self.device,
            emit_in_flight=cfg.emit_in_flight, impl=cfg.impl,
            expand_kernel=cfg.expand_kernel, fold_kernel=cfg.fold_kernel,
            emit_kernel=cfg.emit_kernel)
        return CachedPlan(key=key, cq=canon_q, td=ctd, order=tuple(corder),
                          engine=engine,
                          schedule_sig=engine.schedule.signature(),
                          build_s=time.perf_counter() - t0)

    # -- introspection -------------------------------------------------
    def entries(self) -> List[CachedPlan]:
        with self._lock:
            return list(self._plans.values())

    def __len__(self) -> int:
        with self._lock:
            return len(self._plans)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"plans": len(self._plans), "hits": self.hits,
                    "misses": self.misses, "max_plans": self.max_plans}
