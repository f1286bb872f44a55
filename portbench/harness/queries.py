"""Query shapes and the query log of a traffic mix.

A shape is ``{"shape": "cycle" | "path" | "clique", "size": k}`` over the
one binary relation of a deployment.  :func:`atoms` gives its atoms over
the variables ``x1..xk``, as the paper's query families define them
(§5.2.2; the program's ``core/cq.py`` builds the same atoms).  The log
of a mix is a list of :class:`Query`, each an isomorphic renaming of one
shape: its variables renamed and its atoms listed in another order, so
that it reaches the program as a new query text that the plan cache has
to recognise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .graphs import rng

__all__ = ["Query", "atoms", "shape_key", "renamed", "query_log",
           "shape_counts", "warmup_queries", "canonical_rows"]

Atoms = Tuple[Tuple[str, str], ...]


def atoms(shape: str, size: int) -> Atoms:
    """The atoms ``E(u, v)`` of ``shape`` of ``size`` over ``x1..x{size}``
    (a path of ``size`` vertices has ``size - 1`` edges; a cycle closes
    with ``E(x1, x{size})``; a clique has ``E(xi, xj)`` for ``i < j``)."""
    x = [f"x{i}" for i in range(1, size + 1)]
    if shape == "path" and size >= 2:
        return tuple((x[i], x[i + 1]) for i in range(size - 1))
    if shape == "cycle" and size >= 3:
        return tuple((x[i], x[i + 1]) for i in range(size - 1)) + (
            (x[0], x[-1]),)
    if shape == "clique" and size >= 2:
        return tuple((x[i], x[j]) for i in range(size)
                     for j in range(i + 1, size))
    raise ValueError(f"unknown query shape {shape!r} of size {size}")


def shape_key(spec: dict) -> str:
    return f"{spec['shape']}{int(spec['size'])}"


@dataclass(frozen=True)
class Query:
    """One query of the log: ``shape`` (its key, e.g. ``cycle4``),
    ``atoms`` over the client's variable names, and ``names``, the
    client's name of each canonical variable ``x1..xk`` in order."""

    shape: str
    atoms: Atoms
    names: Tuple[str, ...]


def renamed(spec: dict, g: np.random.Generator, tag: str) -> Query:
    """An isomorphic copy of ``spec``'s query: variable ``x{i}`` renamed
    ``{tag}_{p(i)}`` for a permutation ``p`` and the atoms shuffled."""
    base = atoms(spec["shape"], int(spec["size"]))
    k = int(spec["size"])
    names = tuple(f"{tag}_{j}" for j in g.permutation(k))
    name_of = {f"x{i + 1}": names[i] for i in range(k)}
    order = g.permutation(len(base))
    return Query(shape_key(spec),
                 tuple((name_of[base[i][0]], name_of[base[i][1]])
                       for i in order), names)


def shape_counts(queries: Sequence[dict], block: int,
                 zipf_s: float) -> List[int]:
    """How many queries of each shape one block of the log holds: the
    block's ``block`` queries shared out by Zipf(``zipf_s``) weights over
    the shapes in their listed order (largest remainders rounded up)."""
    w = np.arange(1, len(queries) + 1, dtype=np.float64) ** (-zipf_s)
    exact = block * w / w.sum()
    n = np.floor(exact).astype(int)
    for i in np.argsort(-(exact - n), kind="stable")[:block - n.sum()]:
        n[i] += 1
    return [int(v) for v in n]


def query_log(traffic: dict, seed: int, length: int) -> List[Query]:
    """The first ``length`` queries of the mix's log under ``seed``.

    The log is a run of blocks of ``traffic["block"]`` queries.  Every
    block holds the same number of each shape (:func:`shape_counts`), in
    an order drawn from the seed, so every seed offers the same work in
    another order; each query is a fresh renaming."""
    qs = traffic["queries"]
    block = int(traffic.get("block", 1))
    per_block = shape_counts(qs, block, float(traffic.get("zipf_s", 1.0)))
    g = rng(seed, "log")
    out: List[Query] = []
    while len(out) < length:
        idx = np.repeat(np.arange(len(qs)), per_block)
        for i in g.permutation(idx):
            out.append(renamed(qs[int(i)], g, f"q{len(out)}"))
    return out[:length]


def warmup_queries(traffic: dict, seed: int) -> List[Query]:
    """One renaming of each shape of the mix, in listed order."""
    g = rng(seed, "warmup")
    return [renamed(q, g, f"w{i}") for i, q in enumerate(traffic["queries"])]


def canonical_rows(q: Query, order: Sequence[str],
                   rows: np.ndarray) -> np.ndarray:
    """``rows`` over the client's column ``order`` put back in the
    canonical column order ``x1..xk``."""
    pos: Dict[str, int] = {v: i for i, v in enumerate(order)}
    return rows[:, [pos[name] for name in q.names]]
