"""Vectorized CLFTJ in PyTorch — adhesion-keyed memoization for the
frontier join (the paper's Figure 2):

* **Tier 1 — intra-chunk dedup.**  On entering TD node ``c`` the frontier rows
  sharing an adhesion key μ|α are collapsed to unique representatives; the
  subtree is expanded once per distinct key and the resulting per-rep counts
  are scattered back as factor multipliers.  This is the paper's reuse
  executed as sort/segment data-parallel work, with zero persistent memory.

* **Tier 2 — persistent bounded cache.**  A pluggable device table per TD
  node (``core/cache.py``) — the paper's *dynamic cache size* knob (Fig 10)
  plus its admission/eviction flexibility (§3.4): direct-mapped,
  set-associative-LRU, or cost-aware, with an optional sizing controller.
  Caching is optional, so correctness is unaffected.  Only adhesions of
  dimension <= 2 are cached (the packed int64 key limit).

Control flow lives in ``core/schedule.py``: the TD + order are lowered once
into a linear op schedule and this class only supplies the data plane.
``evaluate()`` runs the same schedule in materialization mode: tier-1
representatives are replayed as row blocks through ``orig`` (the paper
§3.4's factorized intermediates).  With
``cache=CacheConfig(cache_payloads=True)`` tier 2 serves evaluation too:
recurring adhesion keys splice their cached row blocks instead of
re-expanding the bag.  ``evaluate_stream()`` yields the same blocks with
their device→host copies issued asynchronously.
"""
from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np

from .cache import CacheConfig, CacheManager
from .clftj_ref import Plan
from .cq import CQ
from .db import Database
from .frontier import MAX_KEY_BITS, TrieJoin
from .schedule import CALL_COUNTERS, ScheduleExecutor, lower
from .td import TreeDecomposition

__all__ = ["CachedTrieJoin", "MAX_KEY_BITS"]

_TIER2 = ("hits", "misses", "probes", "inserts", "evictions", "resizes",
          "slots", "payload_flushes", "payload_skips", "payload_throttled",
          "slab_rows")


class CachedTrieJoin(TrieJoin):
    """CLFTJ over the frontier engine.

    Tier 2 is configured by ``cache`` (a :class:`CacheConfig`;
    ``slots=0`` disables tier 2).  ``dedup=False`` disables tier 1 (then
    it degenerates to vanilla LFTJ with per-subtree counting)."""

    def __init__(self, q: CQ, td: TreeDecomposition, order: Sequence[str],
                 db: Database, capacity: int = 1 << 17, dedup: bool = True,
                 cache: Optional[CacheConfig] = None, device="cuda",
                 emit_in_flight: int = 8, stream_interior: bool = True,
                 impl: str = "bsearch", expand_kernel: str = "fused",
                 fold_kernel: str = "fused", emit_kernel: str = "fused"):
        super().__init__(q, order, db, capacity=capacity, device=device,
                         emit_in_flight=emit_in_flight,
                         stream_interior=stream_interior, impl=impl,
                         expand_kernel=expand_kernel,
                         fold_kernel=fold_kernel, emit_kernel=emit_kernel)
        self.plan = Plan.build(td, order)
        self.td = td
        cache = cache if cache is not None else CacheConfig()
        self.dedup = dedup
        maxval = max((int(r.max()) if r.size else 0) for r in self.atom_rows)
        # keys that don't pack into int64 fields would alias distinct
        # adhesion assignments — both tiers must stay off (tier-1 dedup on
        # corrupted keys could merge rows that are not duplicates)
        self._keys_packable = maxval < (1 << MAX_KEY_BITS)
        self.cache_config = cache
        self.cache = CacheManager(cache, device=self.device)
        self.cache.expected_tables = sum(
            1 for v in range(td.num_nodes)
            if td.parent[v] >= 0 and self._node_cacheable(v))
        # the TD + order lowered ONCE into the shared op schedule
        self.schedule = lower(self.n, plan=self.plan,
                              cacheable=self._node_cacheable,
                              dedup=self.dedup)
        self.stats = {"tier1_rows_collapsed": 0, "subtree_launches": 0,
                      **{f"tier2_{k}": 0 for k in _TIER2},
                      "tier2_replay_hits": 0,
                      **dict.fromkeys(CALL_COUNTERS, 0)}

    # -----------------------------------------------------------------
    def _node_cacheable(self, v: int) -> bool:
        """Can node v's adhesion be keyed at all (tier 1 *or* tier 2)?
        Independent of the slot count: ``slots=0`` disables only
        tier 2, never tier-1 dedup."""
        if not self._keys_packable:
            return False
        en = self.cache_config.enabled_nodes
        if en is not None and v not in en:
            return False
        return len(self.plan.adhesion_idx[v]) <= 2

    def _finalize(self, ex: ScheduleExecutor) -> None:
        agg = self.cache.stats()
        for k in _TIER2:
            self.stats[f"tier2_{k}"] = agg[k]
        self.stats["tier2_replay_hits"] = agg["payload_hits"]
        self.stats["tier1_rows_collapsed"] += ex.t1_rows_collapsed()
        self.stats["subtree_launches"] += ex.subtree_launches
        for key, runs in ex.call_counts().items():
            self.stats[key] += runs

    # -----------------------------------------------------------------
    def count(self) -> int:
        ex = ScheduleExecutor(self, mode="count")
        self.last_executor = ex  # call_counts() reads its launches
        total = ex.count()
        self._finalize(ex)
        return total

    def evaluate(self) -> Iterator[np.ndarray]:
        """Yields (k, n) int32 blocks of result assignments (order cols).

        Materialization mode of the same schedule: tier-1 representatives
        are replayed back through ``orig`` at every FOLD.  With
        ``cache_payloads`` on, recurring adhesion keys splice their cached
        blocks (``stats["tier2_replay_hits"]`` counts the parent rows so
        served); count-only tables cannot replay tuples and are bypassed
        (optionality)."""
        ex = ScheduleExecutor(self, mode="evaluate")
        self.last_executor = ex
        yield from ex.evaluate()
        self._finalize(ex)

    def evaluate_stream(self) -> Iterator[np.ndarray]:
        """Streaming evaluation: the same blocks, in the same order, as
        :meth:`evaluate`, each block's device→host copy issued
        asynchronously as it is produced (at most ``emit_in_flight`` in
        flight).  Tier-2 behaviour is unchanged."""
        ex = ScheduleExecutor(self, mode="evaluate")
        self.last_executor = ex
        try:
            yield from ex.evaluate_stream()
        finally:
            # a stream abandoned early (break / close) still folds what
            # the executor did complete into stats — stale previous-pass
            # counters would read as current
            self._finalize(ex)
