"""Databases of integer relations + execution counters.

Relations are numpy ``(N, k)`` int64 matrices (deduplicated).  The counters
implement the paper's "memory accesses" analysis (§1): every trie probe is a
binary-search (log-many accesses) and every scanned value is one access.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np


class JoinBudgetExceeded(RuntimeError):
    """Raised when an engine exceeds its memory-access budget (the
    benchmark-harness analogue of the paper's 10-hour timeout)."""


@dataclass
class Counters:
    """Memory-access proxy counters, shared by all engines."""

    seeks: int = 0              # binary searches issued
    mem_accesses: int = 0       # weighted access proxy (log2 per seek, 1/scan)
    values_scanned: int = 0     # trie values materialized/visited
    tuples_emitted: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    cache_inserts: int = 0
    cache_skipped: int = 0      # admissions declined by policy/capacity
    intermediate_tuples: int = 0  # YTD: materialized intermediate tuples
    hash_probes: int = 0
    budget: Optional[int] = None  # mem-access cap; exceeding raises

    def _check(self) -> None:
        if self.budget is not None and self.mem_accesses > self.budget:
            raise JoinBudgetExceeded(f"budget {self.budget} exceeded")

    def count_seek(self, n: int) -> None:
        self.seeks += 1
        self.mem_accesses += max(1, int(math.ceil(math.log2(max(2, n)))))
        self._check()

    def count_scan(self, n: int = 1) -> None:
        self.values_scanned += n
        self.mem_accesses += n
        self._check()

    def count_hash(self, n: int = 1) -> None:
        self.hash_probes += n
        self.mem_accesses += n
        self._check()

    def snapshot(self) -> Dict[str, int]:
        d = dict(self.__dict__)
        d.pop("budget", None)
        return d


def _canonical(rows: np.ndarray) -> np.ndarray:
    """Deduplicate + lexicographically sort rows (leftmost column primary)."""
    rows = np.asarray(rows, dtype=np.int64)
    if rows.ndim != 2:
        raise ValueError("relation must be (N, k)")
    if rows.shape[0] == 0:
        return rows
    rows = np.unique(rows, axis=0)  # unique sorts lexicographically by rows
    return rows


class Database:
    """name -> (N, k) relation; caches per-column-permutation sorted copies."""

    def __init__(self, relations: Dict[str, np.ndarray]):
        self.relations: Dict[str, np.ndarray] = {
            name: _canonical(arr) for name, arr in relations.items()}
        self._sorted_cache: Dict[Tuple[str, Tuple[int, ...]], np.ndarray] = {}

    def arity(self, name: str) -> int:
        return self.relations[name].shape[1]

    def size(self, name: str) -> int:
        return self.relations[name].shape[0]

    def sorted_view(self, name: str, perm: Sequence[int]) -> np.ndarray:
        """Rows with columns permuted by ``perm``, lex-sorted (a trie view)."""
        key = (name, tuple(perm))
        if key not in self._sorted_cache:
            rows = self.relations[name][:, list(perm)]
            self._sorted_cache[key] = _canonical(rows)
        return self._sorted_cache[key]

    def stats(self):
        from .decompose import DBStats
        tuples = {n: r.shape[0] for n, r in self.relations.items()}
        distinct = {}
        for n, r in self.relations.items():
            for c in range(r.shape[1]):
                distinct[(n, c)] = int(np.unique(r[:, c]).size)
        return DBStats(tuples=tuples, distinct=distinct)


def graph_db(edges: np.ndarray, name: str = "E",
             symmetrize: bool = False) -> Database:
    edges = np.asarray(edges, dtype=np.int64)
    if symmetrize:
        edges = np.concatenate([edges, edges[:, ::-1]], axis=0)
    # drop self loops, in line with the paper's graph workloads
    edges = edges[edges[:, 0] != edges[:, 1]]
    return Database({name: edges})
