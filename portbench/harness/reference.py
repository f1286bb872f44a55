"""The plain reference: the answers of the benchmark's queries worked out
again from the raw edge draw, in NumPy and SciPy.

It imports nothing of the program and takes nothing the program made: it
builds its own relation (:func:`graphs.edge_set`), its own adjacency and
its own join.  Counts come from matrix products for the paper's query
families (:meth:`Reference.count`); rows from a plain join that adds one
variable at a time, each row extended from the smallest neighbour list
of its bound atoms and filtered by the others (:meth:`Reference.rows`).
The tests hold the two against each other on small draws.

``as_set=False`` keeps the draw's duplicate edges (bag semantics): that
breaks the deployments' stated guarantee that a relation is a set, and
is the control that the comparison must fail (``portbench/control.py``).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import scipy.sparse as sp

from .graphs import edge_set
from .queries import atoms

__all__ = ["Reference", "row_difference"]

_CANDIDATES = 1 << 23   # candidate rows extended at once (bounds memory)


class Reference:
    """The relation ``E`` of one run and the answers over it."""

    def __init__(self, raw: np.ndarray, nv: int, symmetrize: bool,
                 as_set: bool = True):
        if as_set:
            e = edge_set(raw, symmetrize)
        else:
            e = np.asarray(raw, dtype=np.int64)
            if symmetrize:
                e = np.concatenate([e, e[:, ::-1]], axis=0)
            e = e[e[:, 0] != e[:, 1]]
            e = e[np.lexsort((e[:, 1], e[:, 0]))]
        self.nv = int(nv)
        self.edges = e
        ones = np.ones(len(e), np.int64)
        self.A = sp.csr_matrix((ones, (e[:, 0], e[:, 1])),
                               shape=(self.nv, self.nv))
        self.A.sum_duplicates()
        # neighbour lists with multiplicity (a bag keeps its duplicates)
        self._out = _csr_lists(e[:, 0], e[:, 1], self.nv)
        self._in = _csr_lists(e[:, 1], e[:, 0], self.nv)
        self._keys, self._mult = np.unique(e[:, 0] * self.nv + e[:, 1],
                                           return_counts=True)
        self._counts: Dict[str, int] = {}
        self._rows: Dict[str, np.ndarray] = {}

    # -- counts ----------------------------------------------------------
    def count(self, spec: dict) -> int:
        """The number of matches of ``spec``'s query."""
        key = f"{spec['shape']}{int(spec['size'])}"
        if key not in self._counts:
            self._counts[key] = self._count(spec["shape"], int(spec["size"]))
        return self._counts[key]

    def _count(self, shape: str, k: int) -> int:
        A = self.A
        if shape == "path":
            v = np.ones(self.nv, np.int64)
            for _ in range(k - 1):
                v = A @ v
            return int(v.sum())
        if shape == "cycle" or (shape == "clique" and k == 3):
            # sum over (x1, x_{k-1}) of A^{k-2} times the common
            # out-neighbours of x1 and x_{k-1} (the closing x_k)
            P = A
            for _ in range(k - 3):
                P = P @ A
            return int(P.multiply(A @ A.T).sum())
        if shape == "clique" and k == 4:
            total = 0
            for x1 in range(self.nv):
                nb = A.indices[A.indptr[x1]:A.indptr[x1 + 1]]
                if nb.size < 3:
                    continue
                # E(x1, x2), E(x1, x3) and E(x1, x4) weigh each of x2,
                # x3 and x4 by its edge's multiplicity (1 in a set)
                D = sp.diags(A.data[A.indptr[x1]:A.indptr[x1 + 1]],
                             dtype=np.int64)
                S = A[nb][:, nb]
                total += int((D @ S @ D).multiply(S @ D @ S).sum())
            return total
        return int(self.rows({"shape": shape, "size": k}).shape[0])

    # -- rows ------------------------------------------------------------
    def rows(self, spec: dict) -> np.ndarray:
        """Every match of ``spec``'s query, ``(N, k)`` int64 over the
        canonical variables ``x1..xk``, in no particular order."""
        key = f"{spec['shape']}{int(spec['size'])}"
        if key not in self._rows:
            self._rows[key] = self._join(
                atoms(spec["shape"], int(spec["size"])), int(spec["size"]))
        return self._rows[key]

    def _multiplicity(self, u: np.ndarray, v: np.ndarray) -> np.ndarray:
        """How often each edge ``(u, v)`` is in ``E`` (0 or 1 in a set)."""
        k = u * self.nv + v
        pos = np.minimum(np.searchsorted(self._keys, k), self._keys.size - 1)
        return np.where(self._keys[pos] == k, self._mult[pos], 0)

    def _join(self, ats: Sequence[Tuple[str, str]], k: int) -> np.ndarray:
        idx = {f"x{i + 1}": i for i in range(k)}
        at = [(idx[a], idx[b]) for a, b in ats]
        a0, b0 = at[0]
        table = self.edges.copy()
        cols: List[int] = [a0, b0]
        table = np.repeat(table, self._filters(table, cols, at, skip=0),
                          axis=0)
        while len(cols) < k:
            links = {}
            for w in range(k):
                if w in cols:
                    continue
                links[w] = ([(cols.index(a), self._out) for a, b in at
                             if b == w and a in cols]
                            + [(cols.index(b), self._in) for a, b in at
                               if a == w and b in cols])
            w = max(links, key=lambda v: (len(links[v]), -v))
            if not links[w]:
                raise ValueError("the reference joins connected queries only")
            table = self._extend(table, links[w], cols, w, at)
            cols.append(w)
        out = np.empty_like(table)
        out[:, cols] = table
        return out

    def _filters(self, table, cols, at, skip) -> np.ndarray:
        """How often each row of ``table`` holds: the product of the
        multiplicities of the atoms over its bound columns, but ``skip``."""
        times = np.ones(len(table), np.int64)
        for j, (a, b) in enumerate(at):
            if j != skip and a in cols and b in cols:
                times *= self._multiplicity(table[:, cols.index(a)],
                                            table[:, cols.index(b)])
        return times

    def _extend(self, table, links, cols, w, at) -> np.ndarray:
        """``table`` joined with the new variable ``w``: each row extended
        by the neighbour list of its bound atom with the fewest entries,
        then kept where every other atom between ``w`` and a bound
        variable holds (repeated by the atoms' multiplicities in a bag)."""
        degs = np.stack([lists[0][table[:, c] + 1] - lists[0][table[:, c]]
                         for c, lists in links])
        pick = np.argmin(degs, axis=0)
        parts = []
        for j, (c, (ptr, nbr)) in enumerate(links):
            rows = table[pick == j]
            deg = degs[j][pick == j]
            ends = np.cumsum(deg)
            start = 0
            while start < len(rows):
                base = ends[start - 1] if start else 0
                stop = max(start + 1, int(np.searchsorted(
                    ends, base + _CANDIDATES, side="right")))
                r, d = rows[start:stop], deg[start:stop]
                rep = np.repeat(np.arange(len(r)), d)
                off = np.arange(rep.size) - np.repeat(np.cumsum(d) - d, d)
                new = nbr[ptr[r[rep, c]] + off]
                cand = np.concatenate([r[rep], new[:, None]], axis=1)
                times = np.ones(len(cand), np.int64)
                for j2, (c2, lists) in enumerate(links):
                    if j2 == j:
                        continue
                    if lists is self._out:      # E(cols[c2], w)
                        times *= self._multiplicity(cand[:, c2], new)
                    else:                       # E(w, cols[c2])
                        times *= self._multiplicity(new, cand[:, c2])
                parts.append(np.repeat(cand, times, axis=0))
                start = stop
        return (np.concatenate(parts) if parts
                else np.zeros((0, len(cols) + 1), np.int64))


def _csr_lists(src: np.ndarray, dst: np.ndarray, nv: int):
    order = np.lexsort((dst, src))
    ptr = np.zeros(nv + 1, np.int64)
    np.cumsum(np.bincount(src, minlength=nv), out=ptr[1:])
    return ptr, dst[order]


def _keys(rows: np.ndarray, nv: int) -> np.ndarray:
    """One sortable key a row: the columns packed into an int64 where they
    fit, else the rows as one void scalar each."""
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    bits = max(1, int(nv - 1).bit_length())
    if rows.shape[1] * bits <= 63:
        key = np.zeros(len(rows), np.int64)
        for j in range(rows.shape[1]):
            key = (key << bits) | rows[:, j]
        return key
    return rows.view(np.dtype((np.void, rows.dtype.itemsize * rows.shape[1])
                              )).ravel()


def row_difference(got: np.ndarray, want: np.ndarray, nv: int) -> int:
    """The size of the multiset symmetric difference of two row arrays of
    one width: 0 exactly when they hold the same rows, each as often."""
    if got.shape[1:] != want.shape[1:]:
        return max(len(got), len(want)) or 1
    a, b = np.sort(_keys(got, nv)), np.sort(_keys(want, nv))
    if a.shape == b.shape and np.array_equal(a, b):
        return 0
    ka, ca = np.unique(a, return_counts=True)
    kb, cb = np.unique(b, return_counts=True)
    keys = np.union1d(ka, kb)
    na = np.zeros(len(keys), np.int64)
    nb = np.zeros(len(keys), np.int64)
    na[np.searchsorted(keys, ka)] = ca
    nb[np.searchsorted(keys, kb)] = cb
    return int(np.abs(na - nb).sum())
