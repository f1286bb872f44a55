"""Vanilla LFTJ — the paper's Figure 1 (TJCount) plus evaluation mode.

Host (numpy-backed) implementation, the facade's ``backend="ref"``; the
device engine in ``frontier.py`` is validated against it.  Instrumented
with the memory-access proxy counters used for the paper's §1 analysis.

Reference: ``repro/core/lftj_ref.py`` (this module is a copy of it).
"""
from __future__ import annotations

import sys
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .cq import CQ
from .db import Counters, Database
from .trie import AtomTrie, leapfrog_intersection


class LFTJ:
    """Trie join over a fixed variable order (paper Fig 1 abstraction)."""

    def __init__(self, q: CQ, order: Sequence[str], db: Database,
                 counters: Optional[Counters] = None):
        self.q = q
        self.order = tuple(order)
        if sorted(self.order) != sorted(q.variables):
            raise ValueError("order must permute vars(q)")
        self.db = db
        self.counters = counters if counters is not None else Counters()
        self.tries = [AtomTrie.build(db, a.relation, a.vars, self.order)
                      for a in q.atoms]
        # per depth d: list of (atom index, trie level) of atoms binding x_d
        self.at_depth: List[List[Tuple[int, int]]] = []
        for x in self.order:
            participants = []
            for ai, at in enumerate(self.tries):
                if x in at.var_order:
                    participants.append((ai, at.level_of(x)))
            self.at_depth.append(participants)

    # -- execution ---------------------------------------------------------
    def count(self) -> int:
        total = 0
        for _ in self._scan(emit=False):
            total += 1
        return total

    def evaluate(self) -> Iterator[Tuple[int, ...]]:
        """Yields assignments as tuples in variable order."""
        yield from self._scan(emit=True)

    def _scan(self, emit: bool) -> Iterator[Tuple[int, ...]]:
        n = len(self.order)
        mu: List[int] = [0] * n
        ranges: List[Dict[int, Tuple[int, int]]] = [dict() for _ in range(n + 1)]
        ranges[0] = {ai: at.trie.full_range() for ai, at in enumerate(self.tries)}
        sys.setrecursionlimit(10_000)

        def rjoin(d: int) -> Iterator[Tuple[int, ...]]:
            if d == n:
                self.counters.tuples_emitted += 1
                yield tuple(mu)
                return
            parts = self.at_depth[d]
            iters = [(self.tries[ai].trie, lvl, *ranges[d][ai])
                     for ai, lvl in parts]
            for a, sub in leapfrog_intersection(iters, self.counters):
                mu[d] = a
                nxt = dict(ranges[d])
                for (ai, _lvl), (s, e) in zip(parts, sub):
                    nxt[ai] = (s, e)
                ranges[d + 1] = nxt
                yield from rjoin(d + 1)

        yield from rjoin(0)


def lftj_count(q: CQ, order: Sequence[str], db: Database,
               counters: Optional[Counters] = None) -> int:
    return LFTJ(q, order, db, counters).count()


def lftj_evaluate(q: CQ, order: Sequence[str], db: Database,
                  counters: Optional[Counters] = None,
                  ) -> List[Tuple[int, ...]]:
    return list(LFTJ(q, order, db, counters).evaluate())
