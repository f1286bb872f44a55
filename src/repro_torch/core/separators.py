"""Constrained separator enumeration (paper §4.2, Lemma 4.3 / Theorem 4.4).

Given an undirected graph ``g`` and a node set ``C``, a *C-constrained
separating set* is a set S of nodes such that

  (1) g - S is disconnected, and
  (2) at least one connected component of g - S is disjoint from C.

We enumerate these by **increasing size, without repetition, with polynomial
delay**, via Lawler–Murty's procedure over a minimum-solution oracle that
supports membership constraints (forced-in set I, excluded set X).  The oracle
reduces to minimum vertex s-t cut via the standard node-splitting max-flow
construction; source-side nodes (the C nodes) stay cuttable, which the paper
needs because S may intersect C.
"""
from __future__ import annotations

import heapq
import itertools
from collections import deque
from typing import Dict, FrozenSet, Iterator, List, Optional, Set, Tuple

from .gaifman import Graph, connected_components, is_separating_set, remove_nodes

INF = 10 ** 9


# ---------------------------------------------------------------------------
# Max-flow (Edmonds–Karp) on a tiny node-split network
# ---------------------------------------------------------------------------

class _FlowNet:
    """Dict-based capacities; adequate for query graphs (<= ~dozens of nodes)."""

    def __init__(self) -> None:
        self.cap: Dict[Tuple[str, str], int] = {}
        self.adj: Dict[str, List[str]] = {}

    def add_edge(self, u: str, v: str, c: int) -> None:
        if (u, v) not in self.cap:
            self.adj.setdefault(u, []).append(v)
            self.adj.setdefault(v, []).append(u)
            self.cap[(u, v)] = 0
            self.cap.setdefault((v, u), 0)
        self.cap[(u, v)] += c

    def max_flow(self, s: str, t: str) -> int:
        flow = 0
        while True:
            # BFS for an augmenting path
            parent: Dict[str, str] = {s: s}
            q = deque([s])
            while q and t not in parent:
                u = q.popleft()
                for v in self.adj.get(u, ()):
                    if v not in parent and self.cap[(u, v)] > 0:
                        parent[v] = u
                        q.append(v)
            if t not in parent:
                return flow
            # find bottleneck
            b = INF
            v = t
            while v != s:
                u = parent[v]
                b = min(b, self.cap[(u, v)])
                v = u
            v = t
            while v != s:
                u = parent[v]
                self.cap[(u, v)] -= b
                self.cap[(v, u)] += b
                v = u
            flow += b

    def source_side(self, s: str) -> Set[str]:
        """Nodes reachable from s in the residual network (after max_flow)."""
        seen = {s}
        q = deque([s])
        while q:
            u = q.popleft()
            for v in self.adj.get(u, ()):
                if v not in seen and self.cap[(u, v)] > 0:
                    seen.add(v)
                    q.append(v)
        return seen


def _min_vertex_cut(g: Graph, sources: Set[str], sink: str,
                    removable_penalty: Dict[str, int]) -> Optional[Set[str]]:
    """Minimum-cardinality node set disjoint from {sink} whose removal
    disconnects every source from ``sink``.  ``removable_penalty[v]`` is the
    cost of cutting v (INF = not removable).  Source nodes ARE removable when
    their penalty is finite.  Returns None if no finite cut exists.
    """
    if sink in sources:
        return None
    net = _FlowNet()
    SRC = "#src"
    for v in g:
        c = INF if v == sink else removable_penalty.get(v, 1)
        net.add_edge(f"{v}.i", f"{v}.o", c)
    for u in g:
        for w in g[u]:
            net.add_edge(f"{u}.o", f"{w}.i", INF)
    for c_node in sources:
        net.add_edge(SRC, f"{c_node}.i", INF)  # entering at .i keeps c cuttable
    val = net.max_flow(SRC, f"{sink}.i")
    if val >= INF:
        return None
    side = net.source_side(SRC)
    cut = {v for v in g
           if f"{v}.i" in side and f"{v}.o" not in side}
    assert len(cut) == val, (cut, val)
    return cut


# ---------------------------------------------------------------------------
# The constrained-minimum oracle (Lemma 4.3's optimization problem)
# ---------------------------------------------------------------------------

def _is_valid(g: Graph, C: Set[str], S: Set[str]) -> bool:
    if not S <= set(g):
        return False
    comps = connected_components(remove_nodes(g, S))
    if len(comps) < 2:
        return False
    return any(not (comp & C) for comp in comps)


def min_constrained_separator(
        g: Graph, C: Set[str],
        forced: FrozenSet[str] = frozenset(),
        excluded: FrozenSet[str] = frozenset(),
) -> Optional[FrozenSet[str]]:
    """Minimum C-constrained separating set S with forced ⊆ S, S ∩ excluded = ∅.

    Two exhaustive cases (see DESIGN.md §2 / paper §4.2):
      (a) some c ∈ C survives (c ∉ S): S must isolate a C-free component, so
          for a witness node t ∉ C ∪ S, S separates t from every surviving
          C node — a min vertex cut with C as (cuttable) sources, t as sink.
          To guarantee the *extracted* min cut is itself valid, we pin one
          candidate survivor c (uncuttable) per run; any valid solution with
          surviving c is feasible for its (t, c) run, and every cut the run
          extracts is valid (c survives ⇒ disconnection + C-free component).
      (b) C ⊆ S: condition (2) is vacuous; S must merely disconnect g, so we
          force C into S and take a min s-t vertex cut over witness pairs,
          with both witnesses pinned uncuttable.
    Together the considered candidates include a true minimum, and all
    candidates are verified, so the returned set is an exact minimum.
    """
    V = set(g)
    if forced & excluded or not forced <= V:
        return None
    best: Optional[Set[str]] = None

    def consider(S: Optional[Set[str]]) -> None:
        nonlocal best
        if S is None:
            return
        if not (forced <= S) or (S & excluded):
            return
        if _is_valid(g, C, S) and (best is None or len(S) < len(best)):
            best = S

    g1 = remove_nodes(g, forced)  # forced nodes are in S by fiat
    penalty = {v: (INF if v in excluded else 1) for v in g1}

    # Case (a): witness t outside C ∪ S; pinned survivor c ∈ C.
    sources_a = (C - forced) & set(g1)
    for t in sorted(set(g1) - C):
        for c in sorted(sources_a):
            pen = dict(penalty)
            pen[c] = INF  # c must survive
            cut = _min_vertex_cut(g1, sources_a, t, pen)
            if cut is not None:
                consider(cut | set(forced))

    # Case (b): C ⊆ S (also covers C = ∅).
    forced_b = set(forced) | (C & V)
    if not (forced_b & excluded):
        g2 = remove_nodes(g, forced_b)
        penalty2 = {v: (INF if v in excluded else 1) for v in g2}
        nodes2 = sorted(g2)
        for i, s in enumerate(nodes2):
            for t in nodes2[i + 1:]:
                if s in g2[t]:
                    continue  # adjacent ⇒ no vertex cut separates them
                pen = dict(penalty2)
                pen[s] = INF  # both witnesses must survive
                cut = _min_vertex_cut(g2, {s}, t, pen)
                if cut is not None:
                    consider(cut | forced_b)

    return frozenset(best) if best is not None else None


# ---------------------------------------------------------------------------
# Lawler–Murty ranked enumeration (Theorem 4.4)
# ---------------------------------------------------------------------------

def enumerate_constrained_separators(
        g: Graph, C: Set[str],
        max_size: Optional[int] = None,
        max_results: Optional[int] = None,
) -> Iterator[FrozenSet[str]]:
    """Yield all C-constrained separating sets by increasing size.

    Lawler–Murty: pop the globally smallest solution S of an open subproblem
    (I, X); branch into child subproblems that partition "solutions ≠ S":
      * for v_i ∈ S \\ I (ordered): solutions containing v_1..v_{i-1}, not v_i;
      * strict supersets of S: for candidate u_j ∉ S ∪ X (ordered): solutions
        ⊇ S ∪ {u_j} excluding u_1..u_{j-1}.
    Disjointness of the child spaces gives no-repetition; the heap gives
    increasing size; each branch costs one polynomial oracle call ⇒
    polynomial delay.
    """
    first = min_constrained_separator(g, C)
    if first is None:
        return
    counter = itertools.count()  # heap tie-break
    heap: List[Tuple[int, int, FrozenSet[str], FrozenSet[str], FrozenSet[str]]] = []
    heapq.heappush(heap, (len(first), next(counter), first,
                          frozenset(), frozenset()))
    emitted: Set[FrozenSet[str]] = set()
    n_out = 0
    while heap:
        size, _, S, I, X = heapq.heappop(heap)
        if max_size is not None and size > max_size:
            return
        assert S not in emitted, "Lawler–Murty spaces must be disjoint"
        emitted.add(S)
        yield S
        n_out += 1
        if max_results is not None and n_out >= max_results:
            return
        # children: exclude one element of S \ I at a time
        delta = sorted(S - I)
        for i, v in enumerate(delta):
            I_i = I | frozenset(delta[:i])
            X_i = X | frozenset([v])
            S_i = min_constrained_separator(g, C, I_i, X_i)
            if S_i is not None:
                heapq.heappush(heap, (len(S_i), next(counter), S_i, I_i, X_i))
        # children: strict supersets of S
        cands = sorted(set(g) - S - X)
        for j, u in enumerate(cands):
            I_j = S | frozenset([u])
            X_j = X | frozenset(cands[:j])
            S_j = min_constrained_separator(g, C, I_j, X_j)
            if S_j is not None:
                heapq.heappush(heap, (len(S_j), next(counter), S_j, I_j, X_j))


def brute_force_constrained_separators(
        g: Graph, C: Set[str], max_size: Optional[int] = None,
) -> List[FrozenSet[str]]:
    """Exponential oracle for tests: all valid S, sorted by (size, lex)."""
    V = sorted(g)
    out = []
    bound = len(V) if max_size is None else max_size
    for k in range(0, bound + 1):
        for sub in itertools.combinations(V, k):
            S = set(sub)
            if _is_valid(g, C, S):
                out.append(frozenset(S))
    return sorted(out, key=lambda s: (len(s), tuple(sorted(s))))
