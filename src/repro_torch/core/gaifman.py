"""Gaifman graph and basic undirected-graph utilities (paper §2.1, §2.2).

Plain Python adjacency sets — query graphs have a handful of nodes; planning
runs on the host, never on the accelerator.
"""
from __future__ import annotations

from typing import Dict, FrozenSet, Iterable, List, Set, Tuple

from .cq import CQ

Graph = Dict[str, Set[str]]


def gaifman_graph(q: CQ) -> Graph:
    """Undirected graph on vars(q); edge iff co-occurrence in a subgoal."""
    g: Graph = {v: set() for v in q.variables}
    for atom in q.atoms:
        vs = atom.vars
        for i in range(len(vs)):
            for j in range(i + 1, len(vs)):
                if vs[i] != vs[j]:
                    g[vs[i]].add(vs[j])
                    g[vs[j]].add(vs[i])
    return g


def induced_subgraph(g: Graph, nodes: Iterable[str]) -> Graph:
    """g[U] — the subgraph induced by ``nodes`` (paper notation g[U])."""
    ns = set(nodes)
    return {v: (g[v] & ns) for v in g if v in ns}


def remove_nodes(g: Graph, removed: Iterable[str]) -> Graph:
    """g - S."""
    rs = set(removed)
    return induced_subgraph(g, set(g) - rs)


def connected_components(g: Graph) -> List[Set[str]]:
    """Connected components, deterministic order (sorted roots)."""
    seen: Set[str] = set()
    comps: List[Set[str]] = []
    for root in sorted(g):
        if root in seen:
            continue
        comp = {root}
        stack = [root]
        while stack:
            u = stack.pop()
            for w in g[u]:
                if w not in comp:
                    comp.add(w)
                    stack.append(w)
        seen |= comp
        comps.append(comp)
    return comps


def is_connected(g: Graph) -> bool:
    return len(connected_components(g)) <= 1 if g else True


def is_separating_set(g: Graph, s: Set[str]) -> bool:
    """S separates g iff g - S is disconnected (paper §2.1).

    Note the paper's definition requires g - S to be *disconnected*, which in
    particular requires it to have >= 2 nodes.
    """
    rest = remove_nodes(g, s)
    return len(connected_components(rest)) >= 2


def neighbors_of_set(g: Graph, s: Set[str]) -> Set[str]:
    out: Set[str] = set()
    for v in s:
        out |= g[v]
    return out - s
