"""Columnar trie over a sorted relation (paper §2.4, "cascading vectors").

A trie level i of atom R(v_1..v_k) (variables pre-permuted into the global
order) is simply column i of the lex-sorted tuple matrix restricted to the row
range selected by the bound prefix.  Sibling lists are contiguous sorted
slices, so seek/next are binary searches — this matches the complexity
contract of LFTJ's balanced-tree tries and is the representation the paper's
own YTD implementation uses.

Reference: ``repro/core/trie.py`` (this module is a copy of it).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .db import Counters


@dataclass(frozen=True)
class Trie:
    rows: np.ndarray  # (N, k) lex-sorted unique

    @property
    def num_rows(self) -> int:
        return self.rows.shape[0]

    @property
    def arity(self) -> int:
        return self.rows.shape[1]

    def full_range(self) -> Tuple[int, int]:
        return (0, self.num_rows)

    def column(self, level: int, lo: int, hi: int) -> np.ndarray:
        return self.rows[lo:hi, level]

    def equal_range(self, level: int, lo: int, hi: int, value: int,
                    counters: Optional[Counters] = None) -> Tuple[int, int]:
        """Sub-range of rows whose ``level`` column equals ``value``."""
        col = self.rows[lo:hi, level]
        if counters is not None:
            counters.count_seek(hi - lo)
            counters.count_seek(hi - lo)
        s = int(np.searchsorted(col, value, side="left"))
        e = int(np.searchsorted(col, value, side="right"))
        return lo + s, lo + e

    def seek(self, level: int, lo: int, hi: int, value: int,
             counters: Optional[Counters] = None,
             ) -> Optional[Tuple[int, int, int]]:
        """Leapfrog seek: least value' >= value in the sibling list; returns
        (value', lo', hi') or None when exhausted."""
        col = self.rows[lo:hi, level]
        if counters is not None:
            counters.count_seek(hi - lo)
        s = int(np.searchsorted(col, value, side="left"))
        if s == col.shape[0]:
            return None
        v = int(col[s])
        if counters is not None:
            counters.count_scan()
            counters.count_seek(hi - lo)
        e = int(np.searchsorted(col, v, side="right"))
        return v, lo + s, lo + e

    def distinct_values(self, level: int, lo: int, hi: int,
                        counters: Optional[Counters] = None) -> np.ndarray:
        col = self.rows[lo:hi, level]
        if col.shape[0] == 0:
            return col
        mask = np.empty(col.shape[0], dtype=bool)
        mask[0] = True
        np.not_equal(col[1:], col[:-1], out=mask[1:])
        vals = col[mask]
        if counters is not None:
            counters.count_scan(int(vals.shape[0]))
        return vals


@dataclass
class AtomTrie:
    """Binding of one atom to a trie consistent with a global variable order.

    ``var_order``: the atom's variables sorted by global order position —
    trie level j corresponds to ``var_order[j]``.  Repeated variables inside
    an atom are handled by pre-filtering rows to equality and dropping the
    duplicate columns (so levels always bind distinct variables).
    """

    atom_vars: Tuple[str, ...]
    trie: Trie
    var_order: Tuple[str, ...]

    @staticmethod
    def build(db, relation: str, atom_vars: Sequence[str],
              global_order: Sequence[str]) -> "AtomTrie":
        pos = {x: i for i, x in enumerate(global_order)}
        uniq: List[str] = []
        first_col = {}
        for c, v in enumerate(atom_vars):
            if v not in first_col:
                first_col[v] = c
                uniq.append(v)
        ordered = tuple(sorted(uniq, key=lambda v: pos[v]))
        rows = db.relations[relation]
        # repeated-variable filter (e.g. E(x, x))
        for c, v in enumerate(atom_vars):
            if first_col[v] != c:
                rows = rows[rows[:, c] == rows[:, first_col[v]]]
        perm = [first_col[v] for v in ordered]
        sorted_rows = db.sorted_view(relation, perm) if rows is db.relations[relation] \
            else _sort_rows(rows[:, perm])
        return AtomTrie(tuple(atom_vars), Trie(sorted_rows), ordered)

    def level_of(self, var: str) -> int:
        return self.var_order.index(var)


def _sort_rows(rows: np.ndarray) -> np.ndarray:
    if rows.shape[0] == 0:
        return rows
    return np.unique(rows, axis=0)


def leapfrog_intersection(
        iters: List[Tuple[Trie, int, int, int]],
        counters: Optional[Counters] = None,
) -> Iterator[Tuple[int, List[Tuple[int, int]]]]:
    """Leapfrog join of the sibling lists of several tries (paper §2.4).

    ``iters``: per atom (trie, level, lo, hi).  Yields (value, per-atom
    equal-ranges).  The classic discipline — the iterator with the least head
    seeks to the running maximum — is preserved; seeks are galloping binary
    searches whose cost is logged into ``counters``.
    """
    k = len(iters)
    assert k >= 1
    heads: List[Tuple[int, int, int]] = []  # (value, lo', hi') per atom
    x = None
    for trie, level, lo, hi in iters:
        got = trie.seek(level, lo, hi, -(2 ** 62), counters)
        if got is None:
            return
        heads.append(got)
        x = got[0] if x is None else max(x, got[0])
    while True:
        # align all iterators on x
        aligned = 0
        i = 0
        while aligned < k:
            v, s, e = heads[i]
            if v == x:
                aligned += 1
            else:  # v < x: seek forward
                trie, level, lo, hi = iters[i]
                got = trie.seek(level, s, hi, x, counters)
                if got is None:
                    return
                heads[i] = got
                if got[0] > x:
                    x = got[0]
                    aligned = 1
                else:
                    aligned += 1
            i = (i + 1) % k
        yield x, [(s, e) for (_, s, e) in heads]
        # advance: next distinct value after x on iterator 0
        trie, level, lo, hi = iters[0]
        got = trie.seek(level, heads[0][2], hi, x + 1, counters)
        if got is None:
            return
        heads[0] = got
        x = got[0]
