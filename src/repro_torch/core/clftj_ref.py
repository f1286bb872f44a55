"""CLFTJ — the paper's Figure 2 (CachedTJCount) plus evaluation mode.

Faithful host implementation of the cached trie join: an ordered TD strongly
compatible with the variable order defines, per non-root bag ``v``, an
adhesion key ``μ|α``; entering ``v`` probes ``cache[v, μ|α]`` and a hit skips
the whole subtree interval, multiplying the carried factor; a miss proceeds
as vanilla LFTJ while maintaining ``intrmd(v)`` (children products), and may
insert on exit subject to a pluggable admission policy (paper §3.4).

Evaluation mode (paper §3.4 discussion) records subtree assignments (the
factorized intermediate) and replays them on a hit.

Reference: ``repro/core/clftj_ref.py`` (this module is a copy of it).
"""
from __future__ import annotations

import heapq
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from .cq import CQ
from .db import Counters, Database
from .td import TreeDecomposition
from .trie import AtomTrie, leapfrog_intersection


@dataclass
class CachePolicy:
    """Paper §3.4 / §5.3.3 cache controls.

    * ``support_threshold``: admit (v, key) only once it has been *probed* at
      least this many times (1 = cache every intermediate result, the paper's
      default configuration).
    * ``capacity``: max resident entries (Fig 10's dynamic cache size); when
      full, ``evict`` decides: "none" stops admitting, "lru" evicts the
      least-recently-used entry, "cost" evicts the cheapest resident entry
      — but only when the candidate is at least as valuable (its count, a
      proxy for the recomputation a future hit avoids).
    * ``enabled_nodes``: restrict caching to specific TD nodes (Fig 11's
      cache-structure experiments); None = all non-root nodes.
    """

    support_threshold: int = 1
    capacity: Optional[int] = None
    evict: str = "none"  # "none" | "lru" | "cost"
    enabled_nodes: Optional[frozenset] = None

    def node_enabled(self, v: int) -> bool:
        return self.enabled_nodes is None or v in self.enabled_nodes

    @classmethod
    def from_cache_config(cls, cfg) -> "CachePolicy":
        """Host-engine analogue of a device :class:`~.cache.CacheConfig`:
        bounded table, eviction flavor matched to the device policy."""
        cap = cfg.budget if cfg.budget is not None else cfg.slots
        return cls(capacity=int(cap),
                   evict="cost" if cfg.policy == "costaware" else "lru",
                   enabled_nodes=cfg.enabled_nodes)


class Cache:
    def __init__(self, policy: CachePolicy, counters: Counters):
        self.policy = policy
        self.counters = counters
        self.store: "OrderedDict[Tuple[int, Tuple[int, ...]], object]" = OrderedDict()
        self.support: Dict[Tuple[int, Tuple[int, ...]], int] = {}
        # "cost" eviction: lazy min-heap of (cost, key); stale entries
        # (evicted or re-inserted at a new cost) are dropped on pop
        self._cost_heap: List[Tuple[int, Tuple[int, Tuple[int, ...]]]] = []

    def probe(self, v: int, key: Tuple[int, ...]):
        self.counters.count_hash()
        k = (v, key)
        self.support[k] = self.support.get(k, 0) + 1
        if k in self.store:
            self.counters.cache_hits += 1
            if self.policy.evict == "lru":
                self.store.move_to_end(k)
            return self.store[k]
        self.counters.cache_misses += 1
        return None

    @staticmethod
    def _cost(value) -> int:
        """Recomputation-cost proxy: the count (or the number of recorded
        subtree assignments in evaluation mode)."""
        n = len(value) if isinstance(value, list) else int(value)
        return max(1, n)

    def _cheapest(self) -> Optional[Tuple[int, Tuple[int, Tuple[int, ...]]]]:
        """Peek the valid minimum-cost resident entry (amortized O(log n))."""
        while self._cost_heap:
            c, k = self._cost_heap[0]
            if k in self.store and self._cost(self.store[k]) == c:
                return c, k
            heapq.heappop(self._cost_heap)
        return None

    def put(self, v: int, key: Tuple[int, ...], value) -> None:
        if not self.policy.node_enabled(v):
            self.counters.cache_skipped += 1
            return
        k = (v, key)
        if self.support.get(k, 0) < self.policy.support_threshold:
            self.counters.cache_skipped += 1
            return
        if self.policy.capacity is not None and len(self.store) >= self.policy.capacity:
            if self.policy.capacity == 0:
                self.counters.cache_skipped += 1
                return
            if self.policy.evict == "lru":
                self.store.popitem(last=False)
            elif self.policy.evict == "cost":
                cheapest = self._cheapest()
                if cheapest is None or self._cost(value) < cheapest[0]:
                    self.counters.cache_skipped += 1
                    return
                heapq.heappop(self._cost_heap)
                del self.store[cheapest[1]]
            else:
                self.counters.cache_skipped += 1
                return
        self.counters.cache_inserts += 1
        self.counters.count_hash()
        self.store[k] = value
        if self.policy.evict == "cost":
            heapq.heappush(self._cost_heap, (self._cost(value), k))

    def __len__(self) -> int:
        return len(self.store)


@dataclass
class Plan:
    """Precomputed TD/order correspondence used by CLFTJ."""

    td: TreeDecomposition
    order: Tuple[str, ...]
    owner_of: List[int]          # depth -> owning node
    first_d: Dict[int, int]      # node -> first owned depth
    last_d: Dict[int, int]       # node -> last owned depth
    subtree_last: Dict[int, int]  # node -> last depth owned within t|v
    adhesion_idx: Dict[int, Tuple[int, ...]]  # node -> order positions of α

    @staticmethod
    def build(td: TreeDecomposition, order: Sequence[str]) -> "Plan":
        order = tuple(order)
        if not td.is_strongly_compatible(order):
            raise ValueError("TD must be strongly compatible with the order")
        owner = td.owners()
        pos = {x: i for i, x in enumerate(order)}
        owner_of = [owner[x] for x in order]
        first_d: Dict[int, int] = {}
        last_d: Dict[int, int] = {}
        for d, v in enumerate(owner_of):
            first_d.setdefault(v, d)
            last_d[v] = d
        for v in range(td.num_nodes):
            if v not in first_d:
                if td.parent[v] >= 0:
                    raise ValueError(
                        f"non-root bag {v} owns no variable; run "
                        "eliminate_redundant_bags() first")
                continue
            # owned depths must be contiguous (strong compatibility)
            owned = [d for d, o in enumerate(owner_of) if o == v]
            assert owned == list(range(first_d[v], last_d[v] + 1))
        subtree_last: Dict[int, int] = {}
        for v in reversed(td.preorder()):
            sl = last_d.get(v, -1)
            for c in td.children[v]:
                sl = max(sl, subtree_last[c])
            subtree_last[v] = sl
        adhesion_idx = {
            v: tuple(sorted(pos[x] for x in td.adhesion(v)))
            for v in range(td.num_nodes)}
        return Plan(td, order, owner_of, first_d, last_d, subtree_last,
                    adhesion_idx)


class CLFTJ:
    """Cached trie join (paper Fig 2).  ``mode``: "count" or "evaluate"."""

    def __init__(self, q: CQ, td: TreeDecomposition, order: Sequence[str],
                 db: Database, policy: Optional[CachePolicy] = None,
                 counters: Optional[Counters] = None):
        self.q = q
        self.plan = Plan.build(td, order)
        self.order = tuple(order)
        self.db = db
        self.counters = counters if counters is not None else Counters()
        self.policy = policy or CachePolicy()
        self.cache = Cache(self.policy, self.counters)
        self.tries = [AtomTrie.build(db, a.relation, a.vars, self.order)
                      for a in q.atoms]
        self.at_depth: List[List[Tuple[int, int]]] = []
        for x in self.order:
            parts = []
            for ai, at in enumerate(self.tries):
                if x in at.var_order:
                    parts.append((ai, at.level_of(x)))
            self.at_depth.append(parts)

    # ------------------------------------------------------------------
    def count(self) -> int:
        n = len(self.order)
        plan, td = self.plan, self.plan.td
        mu: List[int] = [0] * n
        ranges: List[Dict[int, Tuple[int, int]]] = [dict() for _ in range(n + 2)]
        ranges[0] = {ai: at.trie.full_range()
                     for ai, at in enumerate(self.tries)}
        intrmd: List[int] = [0] * td.num_nodes
        total = 0

        def rjoin(d: int, f: int) -> None:
            nonlocal total
            if d == n:
                total += f
                self.counters.tuples_emitted += 1
                return
            v = plan.owner_of[d]
            entering = d == 0 or plan.owner_of[d - 1] != v
            key: Optional[Tuple[int, ...]] = None
            if entering:
                intrmd[v] = 0
                if d > 0:  # paper lines 6-12
                    key = tuple(mu[i] for i in plan.adhesion_idx[v])
                    cached = self.cache.probe(v, key)
                    if cached is not None:
                        l = plan.subtree_last[v]
                        ranges[l + 1] = ranges[d]
                        rjoin(l + 1, f * cached)
                        intrmd[v] = cached
                        return
            parts = self.at_depth[d]
            iters = [(self.tries[ai].trie, lvl, *ranges[d][ai])
                     for ai, lvl in parts]
            children = td.children[v]
            for a, sub in leapfrog_intersection(iters, self.counters):
                mu[d] = a
                nxt = dict(ranges[d])
                for (ai, _lvl), (s, e) in zip(parts, sub):
                    nxt[ai] = (s, e)
                ranges[d + 1] = nxt
                rjoin(d + 1, f)
                if d == plan.last_d[v]:  # paper lines 16-18
                    prod = 1
                    for c in children:
                        prod *= intrmd[c]
                    intrmd[v] += prod
            if entering and d > 0:  # paper lines 20-22
                self.cache.put(v, key, intrmd[v])

        rjoin(0, 1)
        return total

    # ------------------------------------------------------------------
    def evaluate(self) -> Iterator[Tuple[int, ...]]:
        """Evaluation mode: caches store subtree assignment lists (the
        factorized intermediates of paper §3.4) and hits replay them."""
        n = len(self.order)
        plan, td = self.plan, self.plan.td
        mu: List[int] = [0] * n
        ranges: List[Dict[int, Tuple[int, int]]] = [dict() for _ in range(n + 2)]
        ranges[0] = {ai: at.trie.full_range()
                     for ai, at in enumerate(self.tries)}
        # active recorders: node -> list being filled (keyed per entry)
        recorders: Dict[int, List[Tuple[int, ...]]] = {}

        def rjoin(d: int) -> Iterator[Tuple[int, ...]]:
            if d == n:
                self.counters.tuples_emitted += 1
                yield tuple(mu)
                return
            v = plan.owner_of[d]
            entering = d == 0 or plan.owner_of[d - 1] != v
            key: Optional[Tuple[int, ...]] = None
            recording = False
            if entering and d > 0:
                key = tuple(mu[i] for i in plan.adhesion_idx[v])
                cached = self.cache.probe(v, key)
                l = plan.subtree_last[v]
                if cached is not None:
                    ranges[l + 1] = ranges[d]
                    for sub_assign in cached:
                        mu[d:l + 1] = list(sub_assign)
                        # ancestors recording an interval that ends exactly
                        # where this skip ends would miss their capture point
                        # (it sits inside the skipped region) — capture here.
                        for w, buf in recorders.items():
                            if plan.subtree_last[w] == l:
                                buf.append(tuple(mu[plan.first_d[w]:l + 1]))
                        yield from rjoin(l + 1)
                    return
                if self.policy.node_enabled(v) and v not in recorders:
                    recorders[v] = []
                    recording = True

            # boundary crossing: record arrivals for any recorder whose
            # subtree interval ends at d-1
            parts = self.at_depth[d]
            iters = [(self.tries[ai].trie, lvl, *ranges[d][ai])
                     for ai, lvl in parts]
            for a, sub in leapfrog_intersection(iters, self.counters):
                mu[d] = a
                nxt = dict(ranges[d])
                for (ai, _lvl), (s, e) in zip(parts, sub):
                    nxt[ai] = (s, e)
                ranges[d + 1] = nxt
                if d + 1 == n or plan.owner_of[d + 1] != v:
                    # leaving v's own vars: capture for recorders closing here
                    for w, buf in recorders.items():
                        if plan.subtree_last[w] == d:
                            buf.append(tuple(mu[plan.first_d[w]:d + 1]))
                yield from rjoin(d + 1)
            if recording:
                buf = recorders.pop(v)
                self.cache.put(v, key, buf)

        yield from rjoin(0)


def clftj_count(q: CQ, td: TreeDecomposition, order: Sequence[str],
                db: Database, policy: Optional[CachePolicy] = None,
                counters: Optional[Counters] = None) -> int:
    return CLFTJ(q, td, order, db, policy, counters).count()


def clftj_evaluate(q: CQ, td: TreeDecomposition, order: Sequence[str],
                   db: Database, policy: Optional[CachePolicy] = None,
                   counters: Optional[Counters] = None) -> List[Tuple[int, ...]]:
    return list(CLFTJ(q, td, order, db, policy, counters).evaluate())
