"""Carry the reference's state across to the port.

The join has no weights: its state is the database, the query and the
plan.  :func:`from_reference` rebuilds the port's objects from plain
Python and numpy values that the reference's objects expose (relations,
atoms, TD bags and parents, variable order), so both engines can run the
same plan and a difference in planning cannot hide a difference in
execution.
"""
from __future__ import annotations

from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np

from .core.cq import CQ, Atom
from .core.db import Database
from .core.td import TreeDecomposition

__all__ = ["from_reference"]


def from_reference(relations: Dict[str, np.ndarray],
                   atoms: Sequence[Tuple[str, Tuple[str, ...]]],
                   bags: Sequence[FrozenSet[str]], parent: Sequence[int],
                   order: Sequence[str],
                   children: Optional[Sequence[Sequence[int]]] = None,
                   ) -> Tuple[Database, CQ, TreeDecomposition,
                              Tuple[str, ...]]:
    """The port's ``(Database, CQ, TreeDecomposition, order)``.

    ``relations`` maps names to ``(N, k)`` integer arrays, ``atoms`` lists
    ``(relation, variables)`` pairs in query order, ``bags``/``parent``
    describe the TD (``parent[root] == -1``) and ``children``, when given,
    keeps the reference's child order (by default children follow node
    index order)."""
    db = Database({name: np.asarray(rows, dtype=np.int64)
                   for name, rows in relations.items()})
    q = CQ(tuple(Atom(rel, tuple(vs)) for rel, vs in atoms))
    kids: List[List[int]] = ([] if children is None
                             else [list(c) for c in children])
    td = TreeDecomposition([frozenset(b) for b in bags],
                           [int(p) for p in parent], kids)
    return db, q, td, tuple(order)
