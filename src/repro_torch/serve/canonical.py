"""Canonical labeling of query shapes — the plan-cache key derivation.

Copied from the reference (``repro/serve/canonical.py``), with its
imports pointed at the port, so both derive the same keys.

Two queries that differ only by a variable renaming (and/or atom
reordering) are the *same join* up to output column names; the serving
layer must hand both the same compiled plan.  ``canonical_cq`` computes a
canonical form of a :class:`~repro_torch.core.cq.CQ`: a renaming of its
variables to ``v0..v{n-1}`` plus a sorted atom tuple that is identical
for every isomorphic input.  The algorithm is the classic
color-refinement + individualization scheme specialized to query
hypergraphs:

1. **Initial colors**: each variable's multiset of occurrences
   ``(relation, arity, position)``.
2. **Refinement (1-WL)**: iterate ``color(v) <- (color(v), sorted multiset
   of (relation, position, colors of the atom's full var tuple)))`` to a
   fixpoint.  Colors are canonical integers (ranks of sorted color
   values), so they are comparable *across* isomorphic queries.
3. **Minimal serialization**: among all orderings that list color classes
   in rank order and permute only within a class, pick the one whose
   sorted atom tuple is lexicographically minimal.  Isomorphic queries
   enumerate the same candidate set, hence agree on the minimum.

Step 3 is exponential in the largest color-class sizes (``∏ |class|!``);
queries are tiny (the paper's families top out around 10 variables) and
refinement usually splits everything, but a pathological input (e.g. a
large star's interchangeable rays — where any within-class order yields
the same key anyway, except the search cannot know that in general) is
cut off by ``budget``: past it we fall back to a *deterministic but not
isomorphism-invariant* order (first-occurrence within class).  The
fallback only costs plan-cache *sharing* between renamed copies of such
queries — never correctness, because a key is a faithful serialization of
the query: equal keys always mean genuinely isomorphic queries.

``canonical_td`` canonicalizes a tree decomposition *under* the query's
variable renaming (children sorted by their canonical subtree), and
``config_key`` serializes a :class:`JoinEngineConfig`.  The triple is the
plan-cache key.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import math
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.cq import CQ, Atom
from ..core.td import TreeDecomposition

__all__ = ["canonical_cq", "canonical_td", "config_key", "rename_query",
           "DEFAULT_BUDGET"]

# max orderings enumerated by the exact minimal-serialization search
DEFAULT_BUDGET = 40_320  # 8!


def _refine(q: CQ) -> Dict[str, int]:
    """Color refinement to fixpoint; returns canonical integer colors
    (equal across isomorphic queries, by construction from relation
    names/positions/ranks only)."""
    variables = q.variables
    occ: Dict[str, List[Tuple[str, int, Atom]]] = {v: [] for v in variables}
    for a in q.atoms:
        for i, v in enumerate(a.vars):
            occ[v].append((a.relation, i, a))
    color_val = {v: tuple(sorted((r, len(a.vars), i)
                                 for r, i, a in occ[v]))
                 for v in variables}
    ranks = {c: i for i, c in enumerate(sorted(set(color_val.values())))}
    color = {v: ranks[color_val[v]] for v in variables}
    for _ in range(len(variables)):
        n_classes = len(set(color.values()))
        new_val = {}
        for v in variables:
            sig = sorted((r, i, tuple(color[u] for u in a.vars))
                         for r, i, a in occ[v])
            new_val[v] = (color[v], tuple(sig))
        ranks = {c: i for i, c in enumerate(sorted(set(new_val.values())))}
        color = {v: ranks[new_val[v]] for v in variables}
        if len(set(color.values())) == n_classes:
            break
    return color


def _serialize(q: CQ, pos: Dict[str, int]
               ) -> Tuple[Tuple[str, Tuple[int, ...]], ...]:
    return tuple(sorted((a.relation, tuple(pos[v] for v in a.vars))
                        for a in q.atoms))


def canonical_cq(q: CQ, budget: int = DEFAULT_BUDGET
                 ) -> Tuple[CQ, Dict[str, int], str]:
    """Returns ``(canonical query, position map, key string)``.

    ``position map`` sends each original variable to its canonical index
    ``i`` (canonical name ``v{i}``); the canonical query is ``q`` with
    variables renamed through it and atoms sorted.  The key string is the
    canonical query's serialization — equal keys iff the canonical forms
    coincide (always for isomorphic queries within ``budget``; see the
    module docstring for the over-budget fallback)."""
    variables = q.variables
    color = _refine(q)
    classes: List[List[str]] = []
    for rank in sorted(set(color.values())):
        classes.append([v for v in variables if color[v] == rank])
    n_orderings = 1
    for c in classes:
        n_orderings *= math.factorial(len(c))
        if n_orderings > budget:
            break
    if n_orderings <= budget:
        best: Optional[Tuple[tuple, Dict[str, int]]] = None
        for perms in itertools.product(
                *[itertools.permutations(c) for c in classes]):
            flat = [v for grp in perms for v in grp]
            pos = {v: i for i, v in enumerate(flat)}
            ser = _serialize(q, pos)
            if best is None or ser < best[0]:
                best = (ser, pos)
        assert best is not None
        ser, pos = best
    else:
        # deterministic fallback: classes in rank order, first-occurrence
        # within class (exact-repeat queries still share; renamed copies
        # of pathological shapes may not)
        first = {v: i for i, v in enumerate(variables)}
        flat = [v for c in classes for v in sorted(c, key=first.get)]
        pos = {v: i for i, v in enumerate(flat)}
        ser = _serialize(q, pos)
    canon = CQ(tuple(Atom(rel, tuple(f"v{i}" for i in idxs))
                     for rel, idxs in ser))
    key = ";".join(f"{rel}({','.join(f'v{i}' for i in idxs)})"
                   for rel, idxs in ser)
    return canon, pos, key


def rename_query(q: CQ, mapping: Dict[str, str]) -> CQ:
    """Rename variables through ``mapping`` (atom order preserved)."""
    return CQ(tuple(Atom(a.relation, tuple(mapping[v] for v in a.vars))
                    for a in q.atoms))


def canonical_td(td: TreeDecomposition, pos: Dict[str, int]
                 ) -> Tuple[TreeDecomposition, str]:
    """Canonicalize a TD under the query's canonical renaming: bags are
    renamed through ``pos``, children are ordered by their canonical
    subtree serialization, nodes renumbered in the resulting preorder.
    Returns the rebuilt TD (over ``v{i}`` names) and its key string.

    The rebuilt TD — not the caller's — parameterizes the cached engine,
    so two isomorphic ``(q, td)`` pairs whose TDs differ only by child
    order or node numbering lower to the *same* schedule."""

    def node_key(v: int):
        bag = tuple(sorted(pos[x] for x in td.bags[v]))
        return (bag, tuple(sorted(node_key(c) for c in td.children[v])))

    bags: List[frozenset] = []
    parent: List[int] = []

    def build(v: int, parent_idx: int) -> None:
        idx = len(bags)
        bags.append(frozenset(f"v{pos[x]}" for x in td.bags[v]))
        parent.append(parent_idx)
        for c in sorted(td.children[v], key=node_key):
            build(c, idx)

    build(td.root, -1)
    out = TreeDecomposition(bags, parent)
    return out, repr(node_key(td.root))


def config_key(config) -> str:
    """Stable serialization of a ``JoinEngineConfig`` (all fields are
    primitives, so a JSON dump with sorted keys is canonical)."""
    return json.dumps(dataclasses.asdict(config), sort_keys=True,
                      default=str)
