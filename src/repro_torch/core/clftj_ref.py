"""The TD/order correspondence the cached trie join is lowered from.

Only :class:`Plan` is carried over from the reference's host CLFTJ module
(``repro/core/clftj_ref.py``); the host oracles stay in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

from .td import TreeDecomposition


@dataclass
class Plan:
    """Precomputed TD/order correspondence used by CLFTJ."""

    td: TreeDecomposition
    order: Tuple[str, ...]
    owner_of: List[int]          # depth -> owning node
    first_d: Dict[int, int]      # node -> first owned depth
    last_d: Dict[int, int]       # node -> last owned depth
    subtree_last: Dict[int, int]  # node -> last depth owned within t|v
    adhesion_idx: Dict[int, Tuple[int, ...]]  # node -> order positions of α

    @staticmethod
    def build(td: TreeDecomposition, order: Sequence[str]) -> "Plan":
        order = tuple(order)
        if not td.is_strongly_compatible(order):
            raise ValueError("TD must be strongly compatible with the order")
        owner = td.owners()
        pos = {x: i for i, x in enumerate(order)}
        owner_of = [owner[x] for x in order]
        first_d: Dict[int, int] = {}
        last_d: Dict[int, int] = {}
        for d, v in enumerate(owner_of):
            first_d.setdefault(v, d)
            last_d[v] = d
        for v in range(td.num_nodes):
            if v not in first_d:
                if td.parent[v] >= 0:
                    raise ValueError(
                        f"non-root bag {v} owns no variable; run "
                        "eliminate_redundant_bags() first")
                continue
            # owned depths must be contiguous (strong compatibility)
            owned = [d for d, o in enumerate(owner_of) if o == v]
            assert owned == list(range(first_d[v], last_d[v] + 1))
        subtree_last: Dict[int, int] = {}
        for v in reversed(td.preorder()):
            sl = last_d.get(v, -1)
            for c in td.children[v]:
                sl = max(sl, subtree_last[c])
            subtree_last[v] = sl
        adhesion_idx = {
            v: tuple(sorted(pos[x] for x in td.adhesion(v)))
            for v in range(td.num_nodes)}
        return Plan(td, order, owner_of, first_d, last_d, subtree_last,
                    adhesion_idx)
