"""GenericDecompose (paper Fig 4) and TD enumeration / selection (§4).

``RecursiveTD(g, C)`` consumes a solver for the side-constrained graph
separation problem and returns an ordered TD whose root bag contains C.  The
enumeration variant replaces the single ConstrainedSep call with the ranked
separator enumeration of ``separators.py`` (by increasing size), explores a
bounded number of choices per call, and scores the resulting TDs with the
§4.3 heuristic (small adhesions, many bags, low depth, Chu-style cost).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Callable, Dict, FrozenSet, Iterator, List, Optional, Sequence, Set, Tuple

from .cq import CQ
from .gaifman import (Graph, connected_components, gaifman_graph,
                      induced_subgraph, remove_nodes)
from .separators import enumerate_constrained_separators
from .td import TreeDecomposition, singleton_td

# A ConstrainedSep solver returns (S, U) per the paper's convention, or None.
SepChoice = Tuple[FrozenSet[str], FrozenSet[str]]
SepSolver = Callable[[Graph, Set[str]], Optional[SepChoice]]


def _split(g: Graph, C: Set[str], S: FrozenSet[str]) -> SepChoice:
    """Compute U = union of components of g-S intersecting C (paper §4.1);
    if none intersects C, U is the first component (deterministic)."""
    comps = connected_components(remove_nodes(g, S))
    touching = [c for c in comps if c & C]
    U = set().union(*touching) if touching else set(comps[0])
    return S, frozenset(U)


def first_separator_solver(max_adhesion: Optional[int] = None) -> SepSolver:
    """ConstrainedSep = the smallest C-constrained separating set."""

    def solver(g: Graph, C: Set[str]) -> Optional[SepChoice]:
        for S in enumerate_constrained_separators(g, C, max_size=max_adhesion,
                                                  max_results=1):
            return _split(g, C, S)
        return None

    return solver


# ---------------------------------------------------------------------------
# RecursiveTD (paper Fig 4)
# ---------------------------------------------------------------------------

def recursive_td(g: Graph, C: Set[str], solver: SepSolver) -> TreeDecomposition:
    res = solver(g, C)
    if res is None:
        return singleton_td(sorted(g))
    S, U = res
    # line 4: TD of g[S ∪ U] whose root bag contains C ∪ S
    td0 = recursive_td(induced_subgraph(g, S | U), C | set(S), solver)
    parts: List[TreeDecomposition] = [td0]
    for Vi in connected_components(remove_nodes(g, S | U)):
        parts.append(recursive_td(induced_subgraph(g, set(S) | Vi), set(S), solver))
    return _graft(parts)


def _graft(parts: Sequence[TreeDecomposition]) -> TreeDecomposition:
    """Connect roots of parts[1:] as children of parts[0]'s root (Fig 4 l.8)."""
    bags: List[FrozenSet[str]] = []
    parent: List[int] = []
    offsets = []
    for td in parts:
        offsets.append(len(bags))
        base = len(bags)
        for v in range(td.num_nodes):
            bags.append(td.bags[v])
            parent.append(td.parent[v] + base if td.parent[v] >= 0 else -2)
        parent[base + td.root] = -2  # placeholder
    root0 = offsets[0] + parts[0].root
    for i, td in enumerate(parts):
        r = offsets[i] + td.root
        parent[r] = -1 if i == 0 else root0
    # fix placeholders for non-root roots already set; roots of parts>0 point
    # at root0, root of part 0 is the global root.
    for i in range(len(parent)):
        if parent[i] == -2:
            parent[i] = -1
    return TreeDecomposition(bags, parent)


def generic_decompose(q: CQ, solver: Optional[SepSolver] = None,
                      simplify: bool = True) -> TreeDecomposition:
    """Paper Fig 4's GenericDecompose: one ordered TD of q."""
    g = gaifman_graph(q)
    td = recursive_td(g, set(), solver or first_separator_solver())
    if simplify:
        td = td.eliminate_redundant_bags()
    td.validate(q)
    return td


# ---------------------------------------------------------------------------
# Enumeration of TDs (paper §4.2-4.3)
# ---------------------------------------------------------------------------

def enumerate_tds(q: CQ, max_adhesion: int = 2, per_step: int = 3,
                  limit: int = 32, simplify: bool = True,
                  ) -> List[TreeDecomposition]:
    """Enumerate TDs by branching RecursiveTD over the ``per_step`` smallest
    C-constrained separators at every call (paper: "replace line 1 with a
    procedure that efficiently enumerates C-constrained separating sets").

    Deduplicates by canonical signature.  Bounded by ``limit`` TDs.
    """
    g0 = gaifman_graph(q)
    out: List[TreeDecomposition] = []
    seen: Set[Tuple] = set()

    def rec(g: Graph, C: Set[str]) -> Iterator[TreeDecomposition]:
        found = False
        for S in enumerate_constrained_separators(
                g, C, max_size=max_adhesion, max_results=per_step):
            found = True
            S, U = _split(g, C, S)
            sub0 = list(itertools.islice(rec(induced_subgraph(g, set(S) | set(U)),
                                             C | set(S)), per_step))
            rest = connected_components(remove_nodes(g, set(S) | set(U)))
            subs_per_comp = [
                list(itertools.islice(rec(induced_subgraph(g, set(S) | Vi),
                                          set(S)), per_step))
                for Vi in rest]
            for combo in itertools.islice(
                    itertools.product(sub0, *subs_per_comp), per_step):
                yield _graft(list(combo))
        if not found:
            yield singleton_td(sorted(g))

    for td in rec(g0, set()):
        if simplify:
            td = td.eliminate_redundant_bags()
        td.validate(q)
        sig = _signature(td)
        if sig not in seen:
            seen.add(sig)
            out.append(td)
        if len(out) >= limit:
            break
    return out


def _signature(td: TreeDecomposition) -> Tuple:
    bags = tuple(sorted(tuple(sorted(b)) for b in td.bags))
    edges = tuple(sorted(
        (tuple(sorted(td.bags[v])), tuple(sorted(td.bags[td.parent[v]])))
        for v in range(td.num_nodes) if td.parent[v] >= 0))
    return bags, edges


# ---------------------------------------------------------------------------
# Cost heuristics (paper §4.3) and plan selection
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DBStats:
    """Cardinality statistics used by the Chu-et-al-style cost estimate."""

    tuples: Dict[str, int]            # relation -> |R|
    distinct: Dict[Tuple[str, int], int]  # (relation, column) -> #distinct


def td_heuristic_key(td: TreeDecomposition) -> Tuple:
    """§4.3: small max adhesion first, then many bags, then low depth."""
    return (td.max_adhesion_size(), -td.num_nodes, td.depth(), td.width())


def order_cost(q: CQ, order: Sequence[str], stats: Optional[DBStats]) -> float:
    """A Chu-et-al-flavoured cost estimate for a variable ordering: walk the
    order and multiply an expected blow-up per variable, derived from
    per-relation selectivities (|R| / prod(distinct)).  Coarse, monotone in
    the right things (constraining early variables with selective atoms is
    cheap); used only to rank orders/TDs.
    """
    if stats is None:
        return 0.0
    bound: Set[str] = set()
    cost = 0.0
    size = 1.0
    for x in order:
        # candidate growth: min over atoms covering x of expected extensions
        growth = None
        for atom in q.atoms_with(x):
            nbound = sum(1 for v in atom.vars if v in bound)
            n = stats.tuples.get(atom.relation, 1)
            d = 1.0
            for i, v in enumerate(atom.vars):
                if v in bound:
                    d *= max(1, stats.distinct.get((atom.relation, i), 1))
            est = max(1.0, n / d)
            growth = est if growth is None else min(growth, est)
        growth = growth if growth is not None else 1.0
        size *= growth
        cost += size
        bound.add(x)
    return cost


def choose_plan(q: CQ, stats: Optional[DBStats] = None,
                max_adhesion: int = 2, limit: int = 24,
                ) -> Tuple[TreeDecomposition, Tuple[str, ...]]:
    """Enumerate TDs, rank by (§4.3 heuristic, order cost), return the best
    TD plus a strongly compatible variable ordering."""
    tds = enumerate_tds(q, max_adhesion=max_adhesion, limit=limit)
    best = None
    for td in tds:
        order = td.strongly_compatible_order()
        key = (td_heuristic_key(td), order_cost(q, order, stats))
        if best is None or key < best[0]:
            best = (key, td, order)
    assert best is not None
    _, td, order = best
    return td, order
