"""The deployments' relations, drawn from their configuration files.

A deployment's graph is a Graph 500 Kronecker graph
(:func:`kronecker_edges`, the specification's reference generator,
``kronecker_generator.m``, in NumPy): each of ``edgefactor * 2**scale``
edges picks one quadrant of the adjacency matrix a bit, with the
initiator probabilities ``A``, ``B``, ``C`` and ``1 - A - B - C``.  The
edges' structure comes from the configuration's fixed ``draw_seed``, so
every run serves the same graph up to isomorphism; the run's ``--seed``
draws the generator's last two steps, the random relabelling of the
vertices and the shuffle of the edge list.  Every seed so offers the
same work (the same counts at every level of a join) over other vertex
numbers, trie orders and cache slots.
"""
from __future__ import annotations

import numpy as np

__all__ = ["rng", "kronecker_edges", "vertices", "draw", "edge_set"]


def rng(seed: int, stream: str) -> np.random.Generator:
    """The generator of one named stream of a run's draws: ``seed`` is any
    whole number (negative ones and ones past 64 bits wrap), ``stream``
    keeps the streams apart."""
    words = [int(seed) % (1 << 64)] + [ord(c) for c in stream]
    return np.random.default_rng(words)


def kronecker_edges(scale: int, edgefactor: int, a: float, b: float,
                    c: float, draw_seed: int) -> np.ndarray:
    """The ``(edgefactor * 2**scale, 2)`` edge list of a Kronecker graph
    over ``2**scale`` vertices, before relabelling: duplicates and self
    loops included, as the generator makes them."""
    g = np.random.default_rng(draw_seed)
    m = edgefactor << scale
    ij = np.zeros((m, 2), dtype=np.int64)
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    for bit in range(scale):
        ii = g.random(m) > ab
        jj = g.random(m) > np.where(ii, c_norm, a_norm)
        ij[:, 0] += ii.astype(np.int64) << bit
        ij[:, 1] += jj.astype(np.int64) << bit
    return ij


def vertices(graph: dict) -> int:
    """The number of vertex ids of a configuration's graph."""
    return 1 << int(graph["scale"])


def draw(graph: dict, seed: int) -> np.ndarray:
    """The raw edge list a configuration's ``graph`` section describes
    under the run's ``seed``: the fixed draw with its vertices relabelled
    by a permutation and its edges shuffled, both from ``seed``.  This is
    what the program receives."""
    if graph["generator"] != "kronecker":
        raise ValueError(f"unknown graph generator {graph['generator']!r}")
    e = kronecker_edges(int(graph["scale"]), int(graph["edgefactor"]),
                        float(graph["A"]), float(graph["B"]),
                        float(graph["C"]), int(graph["draw_seed"]))
    g = rng(seed, "labels")
    label = g.permutation(vertices(graph))
    return label[e][g.permutation(len(e))]


def edge_set(raw: np.ndarray, symmetrize: bool) -> np.ndarray:
    """The relation the configuration states: the set of distinct
    directed edges of the draw (both directions when ``symmetrize``),
    self loops removed, sorted."""
    e = np.asarray(raw, dtype=np.int64)
    if symmetrize:
        e = np.concatenate([e, e[:, ::-1]], axis=0)
    e = e[e[:, 0] != e[:, 1]]
    return np.unique(e, axis=0)
