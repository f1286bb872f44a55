"""Ordered tree decompositions (paper §2.3).

A TD of a full CQ q is ⟨t, χ⟩ with (1) every subgoal's vars inside some bag,
(2) for every variable the bags containing it induce a connected subtree.
An *ordered* TD roots and orders t; adhesion(v) = χ(v) ∩ χ(parent(v)).
owner(x) = the preorder-minimal bag containing x.  A TD is *strongly
compatible* with an ordering ⟨x1..xn⟩ iff owner(x_i) ≺pre owner(x_j) ⇒ i < j.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from .cq import CQ


@dataclass
class TreeDecomposition:
    """Rooted, ordered tree decomposition.

    ``parent[v]`` is -1 for the root; ``children[v]`` is ordered (tree order).
    ``bags[v]`` is the bag χ(v).
    """

    bags: List[FrozenSet[str]]
    parent: List[int]
    children: List[List[int]] = field(default_factory=list)

    def __post_init__(self):
        n = len(self.bags)
        if len(self.parent) != n:
            raise ValueError("parent/bags length mismatch")
        if not self.children:
            self.children = [[] for _ in range(n)]
            for v in range(n):
                if self.parent[v] >= 0:
                    self.children[self.parent[v]].append(v)
        roots = [v for v in range(n) if self.parent[v] < 0]
        if len(roots) != 1:
            raise ValueError(f"expected exactly one root, got {roots}")
        self._root = roots[0]

    # -- basic structure ----------------------------------------------------
    @property
    def root(self) -> int:
        return self._root

    @property
    def num_nodes(self) -> int:
        return len(self.bags)

    def preorder(self) -> List[int]:
        """Nodes in preorder (≺pre of the paper), respecting child order."""
        out: List[int] = []
        stack = [self.root]
        while stack:
            v = stack.pop()
            out.append(v)
            stack.extend(reversed(self.children[v]))
        return out

    def adhesion(self, v: int) -> FrozenSet[str]:
        """χ(v) ∩ χ(parent(v)); empty for the root."""
        p = self.parent[v]
        if p < 0:
            return frozenset()
        return self.bags[v] & self.bags[p]

    def adhesions(self) -> List[FrozenSet[str]]:
        return [self.adhesion(v) for v in range(self.num_nodes)]

    def max_adhesion_size(self) -> int:
        return max((len(self.adhesion(v)) for v in range(self.num_nodes)
                    if self.parent[v] >= 0), default=0)

    def width(self) -> int:
        """Treewidth-style width: max bag size - 1."""
        return max(len(b) for b in self.bags) - 1

    def depth(self) -> int:
        d = {self.root: 0}
        for v in self.preorder()[1:]:
            d[v] = d[self.parent[v]] + 1
        return max(d.values())

    def subtree_nodes(self, v: int) -> List[int]:
        out = []
        stack = [v]
        while stack:
            u = stack.pop()
            out.append(u)
            stack.extend(reversed(self.children[u]))
        return out

    # -- owners & orderings ---------------------------------------------------
    def owners(self) -> Dict[str, int]:
        """owner(x) = preorder-minimal bag containing x."""
        owner: Dict[str, int] = {}
        for v in self.preorder():
            for x in self.bags[v]:
                owner.setdefault(x, v)
        return owner

    def owned_vars(self) -> Dict[int, List[str]]:
        """Variables owned per node, each list sorted for determinism."""
        owner = self.owners()
        out: Dict[int, List[str]] = {v: [] for v in range(self.num_nodes)}
        for x, v in owner.items():
            out[v].append(x)
        for v in out:
            out[v].sort()
        return out

    def strongly_compatible_order(
            self, within_bag: Optional[Dict[int, Sequence[str]]] = None,
    ) -> Tuple[str, ...]:
        """Emit a variable ordering the TD is strongly compatible with.

        Walk the preorder; at each node emit its owned variables.  Any
        within-bag order is legal (owners are all equal); callers may pass one
        (e.g. from a cost model), else sorted order is used.
        """
        owned = self.owned_vars()
        order: List[str] = []
        for v in self.preorder():
            vs = list(within_bag[v]) if within_bag and v in within_bag else owned[v]
            if sorted(vs) != sorted(owned[v]):
                raise ValueError(f"within_bag[{v}] must permute owned vars")
            order.extend(vs)
        return tuple(order)

    def is_compatible(self, order: Sequence[str]) -> bool:
        """Joglekar-et-al compatibility: owner parent-of owner ⇒ earlier."""
        pos = {x: i for i, x in enumerate(order)}
        owner = self.owners()
        for xi in order:
            for xj in order:
                oi, oj = owner[xi], owner[xj]
                if self.parent[oj] == oi and pos[xi] >= pos[xj] and oi != oj:
                    return False
        return True

    def is_strongly_compatible(self, order: Sequence[str]) -> bool:
        """owner(x_i) ≺pre owner(x_j) ⇒ i < j (paper §2.3)."""
        pos = {x: i for i, x in enumerate(order)}
        pre_rank = {v: r for r, v in enumerate(self.preorder())}
        owner = self.owners()
        for xi in order:
            for xj in order:
                if pre_rank[owner[xi]] < pre_rank[owner[xj]] and pos[xi] >= pos[xj]:
                    return False
        return True

    # -- validity -------------------------------------------------------------
    def validate(self, q: CQ) -> None:
        """Raise if not a valid TD of q (both paper conditions)."""
        allvars = set(q.variables)
        bagvars = set().union(*self.bags) if self.bags else set()
        if bagvars != allvars:
            raise ValueError(f"bag vars {bagvars} != query vars {allvars}")
        for atom in q.atoms:
            if not any(set(atom.vars) <= b for b in self.bags):
                raise ValueError(f"no bag covers atom {atom}")
        # connectedness: for each var, bags containing it form a subtree.
        for x in allvars:
            holders = [v for v in range(self.num_nodes) if x in self.bags[v]]
            hs = set(holders)
            # the subtree condition holds iff all holders minus the
            # preorder-minimal one have their parent's path reaching another
            # holder through holders only; equivalently: each holder except
            # the shallowest has a parent in the holder set once we take the
            # holder closest to the root as the subtree root.
            pre_rank = {v: r for r, v in enumerate(self.preorder())}
            top = min(holders, key=lambda v: pre_rank[v])
            for v in holders:
                if v == top:
                    continue
                if self.parent[v] not in hs:
                    raise ValueError(
                        f"variable {x}: bags {holders} not connected (node {v})")

    # -- cleanup ----------------------------------------------------------------
    def eliminate_redundant_bags(self) -> "TreeDecomposition":
        """Remove bags contained in an adjacent bag (paper §4.1 remark).

        Children of a removed bag re-attach to the surviving neighbour.
        Applied to fixpoint.
        """
        bags = [set(b) for b in self.bags]
        parent = list(self.parent)
        children = [list(c) for c in self.children]
        alive = [True] * len(bags)

        changed = True
        while changed:
            changed = False
            for v in range(len(bags)):
                if not alive[v]:
                    continue
                p = parent[v]
                # child contained in parent -> merge child into parent
                if p >= 0 and alive[p] and bags[v] <= bags[p]:
                    children[p].remove(v)
                    for c in children[v]:
                        parent[c] = p
                        children[p].append(c)
                    children[v] = []
                    alive[v] = False
                    changed = True
                    continue
                # parent contained in (only) child -> merge parent into child
                if p >= 0 and alive[p] and bags[p] <= bags[v] and \
                        len(children[p]) == 1 and parent[p] >= 0:
                    gp = parent[p]
                    children[gp][children[gp].index(p)] = v
                    parent[v] = gp
                    alive[p] = False
                    changed = True

        # root containment: if root's bag ⊆ its single child, drop the root
        # (handled by re-rooting).
        idx = {v: i for i, v in enumerate([v for v in range(len(bags)) if alive[v]])}
        new_bags = [frozenset(bags[v]) for v in range(len(bags)) if alive[v]]
        new_parent = [idx[parent[v]] if parent[v] >= 0 else -1
                      for v in range(len(bags)) if alive[v]]
        return TreeDecomposition(new_bags, new_parent)


def singleton_td(variables: Sequence[str]) -> TreeDecomposition:
    """The trivial one-bag decomposition (paper Fig 4, line 3)."""
    return TreeDecomposition([frozenset(variables)], [-1])
