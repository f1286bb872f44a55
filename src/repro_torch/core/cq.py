"""Conjunctive queries (full CQs, no projection) — paper §2.2.

A full CQ is a sequence of subgoals ``R(t1..tk)``; here terms are variable
names (strings). Constants are supported by pre-filtering relations, which is
how every system in the paper's experimental section handles them, so the core
engine only sees variables.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple


@dataclass(frozen=True)
class Atom:
    """One subgoal R(x1..xk).  ``relation`` names the relation in the DB."""

    relation: str
    vars: Tuple[str, ...]

    def __post_init__(self):
        if len(self.vars) == 0:
            raise ValueError("nullary atoms are not supported")

    @property
    def arity(self) -> int:
        return len(self.vars)

    def __str__(self) -> str:  # pragma: no cover - debugging aid
        return f"{self.relation}({', '.join(self.vars)})"


@dataclass(frozen=True)
class CQ:
    """A full conjunctive query: a tuple of atoms."""

    atoms: Tuple[Atom, ...]

    def __post_init__(self):
        if not self.atoms:
            raise ValueError("empty query")

    @property
    def variables(self) -> Tuple[str, ...]:
        """All variables, in first-occurrence order (deterministic)."""
        seen: Dict[str, None] = {}
        for a in self.atoms:
            for v in a.vars:
                seen.setdefault(v)
        return tuple(seen)

    def atoms_with(self, var: str) -> Tuple[Atom, ...]:
        return tuple(a for a in self.atoms if var in a.vars)

    def __str__(self) -> str:  # pragma: no cover - debugging aid
        return ", ".join(str(a) for a in self.atoms)


def cq(*specs: Tuple[str, Sequence[str]]) -> CQ:
    """Convenience constructor: ``cq(("E", "ab"), ("E", "bc"))``."""
    return CQ(tuple(Atom(rel, tuple(vs)) for rel, vs in specs))


# ---------------------------------------------------------------------------
# Query families used throughout the paper's experiments (§5.2.2)
# ---------------------------------------------------------------------------

def _vname(i: int) -> str:
    return f"x{i}"


def path_query(length: int, relation: str = "E") -> CQ:
    """k-path: E(x1,x2), E(x2,x3), ..., E(xk, x{k+1}).

    The paper's "k-path" has k edges (a 4-path comprises E(a,b),E(b,c),E(c,d)
    — the paper's example shows 3 atoms for a 4-path, i.e. k-1 edges over k
    nodes; we follow *edges = length - 1* to match: a valid 4-path comprises
    three atoms)."""
    if length < 2:
        raise ValueError("path needs >= 2 nodes")
    return CQ(tuple(Atom(relation, (_vname(i), _vname(i + 1)))
                    for i in range(1, length)))


def cycle_query(length: int, relation: str = "E") -> CQ:
    """k-cycle: E(x1,x2), ..., E(x{k-1},xk), E(x1,xk) — paper §5.2.2."""
    if length < 3:
        raise ValueError("cycle needs >= 3 nodes")
    atoms = [Atom(relation, (_vname(i), _vname(i + 1))) for i in range(1, length)]
    atoms.append(Atom(relation, (_vname(1), _vname(length))))
    return CQ(tuple(atoms))


def clique_query(size: int, relation: str = "E") -> CQ:
    """k-clique — included because the paper *discusses* cliques (no TD)."""
    if size < 2:
        raise ValueError("clique needs >= 2 nodes")
    atoms = [Atom(relation, (_vname(i), _vname(j)))
             for i in range(1, size) for j in range(i + 1, size + 1)]
    return CQ(tuple(atoms))


def lollipop_query(clique_size: int = 3, tail_len: int = 2,
                   relation: str = "E") -> CQ:
    """{clique_size, tail_len}-lollipop (paper Fig 12: {3,2}-lollipop).

    A clique on x1..xc plus a path of ``tail_len`` extra edges hanging off xc.
    """
    atoms = [Atom(relation, (_vname(i), _vname(j)))
             for i in range(1, clique_size) for j in range(i + 1, clique_size + 1)]
    for i in range(clique_size, clique_size + tail_len):
        atoms.append(Atom(relation, (_vname(i), _vname(i + 1))))
    return CQ(tuple(atoms))


def bowtie_query(relation: str = "E") -> CQ:
    """Bowtie: two triangles sharing the hub x1 — a TD with two recurring
    bags keyed on the same hub variable (the evaluation-mode row-block
    cache's clique-style workload)."""
    return CQ((Atom(relation, ("x1", "x2")), Atom(relation, ("x2", "x3")),
               Atom(relation, ("x1", "x3")), Atom(relation, ("x1", "x4")),
               Atom(relation, ("x4", "x5")), Atom(relation, ("x1", "x5"))))


def star_query(rays: int, relation: str = "E") -> CQ:
    """k-star: E(x1,x2), E(x1,x3), ..., E(x1,x{k+1}) — hub x1, k rays.

    Acyclic with singleton adhesions ({x1}); the extreme cache-friendly
    shape (every ray subtree keys on the hub value alone)."""
    if rays < 1:
        raise ValueError("star needs >= 1 ray")
    return CQ(tuple(Atom(relation, (_vname(1), _vname(i + 2)))
                    for i in range(rays)))


def random_graph_query(n: int, p: float, seed: int,
                       relation: str = "E") -> CQ:
    """Erdős–Rényi query graph, connected, no self edges (paper §5.2.2).

    Deterministic for a given (n, p, seed); resamples until connected.
    """
    import numpy as np

    rng = np.random.default_rng(seed)
    for _attempt in range(10_000):
        edges = [(i, j) for i in range(1, n) for j in range(i + 1, n + 1)
                 if rng.random() < p]
        if not edges:
            continue
        # connectivity check (union-find)
        parent = list(range(n + 1))

        def find(a: int) -> int:
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        for i, j in edges:
            parent[find(i)] = find(j)
        if len({find(i) for i in range(1, n + 1)}) == 1:
            return CQ(tuple(Atom(relation, (_vname(i), _vname(j)))
                            for i, j in edges))
    raise RuntimeError("could not sample a connected graph")


def two_relation_cycle_query(length: int, relations: Sequence[str]) -> CQ:
    """Cycle alternating over the given relation names (IMDB-style 4/6-cycle
    over male_cast/female_cast, paper Fig 14)."""
    if length < 3:
        raise ValueError("cycle needs >= 3 nodes")
    atoms = []
    for i in range(1, length):
        atoms.append(Atom(relations[(i - 1) % len(relations)],
                          (_vname(i), _vname(i + 1))))
    atoms.append(Atom(relations[(length - 1) % len(relations)],
                      (_vname(1), _vname(length))))
    return CQ(tuple(atoms))
