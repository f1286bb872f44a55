"""Synthetic graph workloads, skew-matched to the paper's datasets (§5.2.1).

SNAP/IMDB are not available offline; the paper's performance story rests on
*value-distribution skew* (hubs make adhesion keys recur), so we generate:

  * ``erdos_renyi``     — balanced degrees (p2p-Gnutella04 analogue),
  * ``barabasi_albert`` — heavy-tailed degrees (wiki-Vote / ego-* analogue),
  * ``zipf_graph``      — one edge table, Zipf-distributed endpoint
    popularity (hot vertices make adhesion keys recur — the conformance
    zoo's and the kernel benchmarks' shared skew source),
  * ``zipf_bipartite``  — two-table person/movie workload with separately
    tunable per-attribute skew (IMDB cast_info analogue, Fig 13/14).

Node ids stay < 2^21 so adhesion keys pack into int64 (cached_frontier).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..core.db import Database, graph_db


def erdos_renyi(n: int, m_edges: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    e = rng.integers(0, n, size=(int(m_edges * 1.3), 2))
    e = e[e[:, 0] != e[:, 1]][:m_edges]
    return e.astype(np.int64)


def barabasi_albert(n: int, m_per_node: int = 3, seed: int = 0) -> np.ndarray:
    """Preferential attachment — heavy-tailed degree distribution.

    The reference's draws, edge for edge: the endpoint list it samples
    from is kept in a numpy buffer and its distinct count as a set,
    where the reference converts the whole list on every draw."""
    rng = np.random.default_rng(seed)
    repeated = np.empty(m_per_node + 2 * m_per_node * max(n, 0), np.int64)
    repeated[:m_per_node] = np.arange(m_per_node)
    size = m_per_node
    distinct = set(range(m_per_node))
    edges = []
    for v in range(m_per_node, n):
        chosen = rng.choice(repeated[:size], size=m_per_node,
                            replace=False) \
            if len(distinct) >= m_per_node else \
            rng.integers(0, v, size=m_per_node)
        for u in set(int(u) for u in chosen):
            edges.append((v, u))
            repeated[size:size + 2] = (v, u)
            size += 2
            distinct.update((v, u))
    return np.asarray(edges, np.int64)


def zipf_graph(nv: int, ne: int, a: float, seed: int = 0) -> np.ndarray:
    """Edges with Zipf(``a``)-distributed endpoint popularity."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, nv + 1, dtype=np.float64)
    p = ranks ** (-a)
    p /= p.sum()
    return np.stack([rng.choice(nv, size=ne, p=p),
                     rng.choice(nv, size=ne, p=p)], axis=1).astype(np.int64)


def zipf_bipartite(n_left: int, n_right: int, m: int, a_left: float,
                   a_right: float, seed: int = 0) -> np.ndarray:
    """Bipartite edges with Zipf-distributed endpoint popularity."""
    rng = np.random.default_rng(seed)

    def zipf_ids(n, a, size):
        ranks = np.arange(1, n + 1, dtype=np.float64)
        p = ranks ** (-a)
        p /= p.sum()
        return rng.choice(n, size=size, p=p)

    left = zipf_ids(n_left, a_left, m)
    right = zipf_ids(n_right, a_right, m)
    return np.stack([left, right], axis=1).astype(np.int64)


# ---------------------------------------------------------------------------
# Named datasets standing in for the paper's workloads
# ---------------------------------------------------------------------------

def dataset(name: str) -> Database:
    if name == "wiki-vote-like":        # small, skewed
        return graph_db(barabasi_albert(1200, 6, seed=1), symmetrize=False)
    if name == "gnutella-like":         # small, balanced
        return graph_db(erdos_renyi(2500, 7000, seed=2))
    if name == "ca-grqc-like":          # collaboration: symmetric, skewed
        return graph_db(barabasi_albert(1500, 4, seed=3), symmetrize=True)
    if name == "ego-facebook-like":     # denser, skewed
        return graph_db(barabasi_albert(800, 10, seed=4), symmetrize=True)
    if name == "ego-twitter-like":      # large, very skewed
        return graph_db(barabasi_albert(2000, 8, seed=5))
    if name == "imdb-like":             # two relations, per-attr skew
        male = zipf_bipartite(4000, 2500, 12000, 1.2, 0.6, seed=6)
        female = zipf_bipartite(4000, 2500, 12000, 1.2, 0.6, seed=7)
        return Database({"male_cast": male, "female_cast": female})
    raise KeyError(name)


DATASETS = ("wiki-vote-like", "gnutella-like", "ca-grqc-like",
            "ego-facebook-like", "ego-twitter-like", "imdb-like")
